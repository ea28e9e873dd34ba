// Shallow-water device functions shared by the dense kernels
// (sw2d_dense.cu: one block per scenario, whole mesh in shared memory) and
// the blocked kernels (sw2d_blocked.cu: one block per chunk of elements,
// neighbours read from global memory): the operator set, everything a trace
// node needs from the state, the pointwise flux, source and limiter
// formulas, and the pointwise parts of the hand-derived adjoint.
//
// The same derivation, in tensor code, is ops/sw2d_fused.py (_rhs_plain,
// _rhs_vjp_plain), where it is tested against torch.autograd. Tie rules of
// the adjoint: at max(spdM, spdP) a tie gives half of the cotangent to each
// side; the per-face maximum splits its cotangent evenly over the nodes that
// attain it; max(0, x) of the star depths passes the cotangent where x > 0;
// the velocity norm has zero gradient at the origin.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

// Mirror of _SwDesc in ops/sw2d_fused.py.
struct SwDesc {
  int K, Np, Nfaces, Nfp, n_ctrl;
  int wb, has_bathy, has_tidal;
  int has_sponge, wetdry;
  int blocked;  // the float buffer carries H and SPNG after BV
  float g, cd, fcor;
  float tide_h0, tide_amp, tide_omega, tide_tau;
  float h_floor;
};

struct Ops {
  const float *Dr, *Ds, *lift, *filt;
  const float *rx, *sx, *ry, *sy;
  const float *nx, *ny, *fscale, *wall, *obc, *HMt, *HPt;
  const float *Hx, *Hy, *BU, *BV;
  const float *H, *SPNG;  // blocked set only
  const int *vmapM, *vmapP, *invM_ptr, *invM_idx, *invP_ptr, *invP_idx;
  int K, Np, Ntr, Nfp, nV, nT, n_ctrl;
  int wb, has_bathy, has_tidal, has_sponge, wetdry;
  float g, cd, fcor, tide_h0, tide_amp, tide_omega, tide_tau, h_floor;
};

// The packed operator buffers: the order here is the order in which the
// operator sets pack them (ops/sw2d_fused.py, _pack_buffers).
static Ops make_ops(const SwDesc& d, const float* f, const int* i) {
  Ops o;
  o.K = d.K; o.Np = d.Np; o.Ntr = d.Nfaces * d.Nfp; o.Nfp = d.Nfp;
  o.nV = d.K * d.Np; o.nT = d.K * o.Ntr; o.n_ctrl = d.n_ctrl;
  o.wb = d.wb; o.has_bathy = d.has_bathy; o.has_tidal = d.has_tidal;
  o.has_sponge = d.has_sponge; o.wetdry = d.wetdry;
  o.g = d.g; o.cd = d.cd; o.fcor = d.fcor;
  o.tide_h0 = d.tide_h0; o.tide_amp = d.tide_amp;
  o.tide_omega = d.tide_omega; o.tide_tau = d.tide_tau;
  o.h_floor = d.h_floor;
  const int np2 = d.Np * d.Np, nV = o.nV, nT = o.nT;
  o.Dr = f; f += np2;
  o.Ds = f; f += np2;
  o.lift = f; f += d.Np * o.Ntr;
  o.filt = f; f += np2;
  o.rx = f; f += nV;  o.sx = f; f += nV;
  o.ry = f; f += nV;  o.sy = f; f += nV;
  o.nx = f; f += nT;  o.ny = f; f += nT;  o.fscale = f; f += nT;
  o.wall = f; f += nT;  o.obc = f; f += nT;
  o.HMt = f; f += nT;  o.HPt = f; f += nT;
  o.Hx = f; f += nV;  o.Hy = f; f += nV;
  o.BU = f; f += d.n_ctrl * nV;
  o.BV = f; f += d.n_ctrl * nV;
  o.H = nullptr; o.SPNG = nullptr;
  if (d.blocked) {
    o.H = f; f += nV;
    o.SPNG = f; f += nV;
  }
  o.vmapM = i; i += nT;
  o.vmapP = i; i += nT;
  o.invM_ptr = i; i += nV + 1;
  o.invM_idx = i; i += nT;
  o.invP_ptr = i; i += nV + 1;
  o.invP_idx = i; i += nT;
  return o;
}

__device__ __forceinline__ float safe_norm(float u, float v) {
  const float r2 = u * u + v * v;
  return r2 > 0.0f ? sqrtf(r2) : 0.0f;
}

__device__ __forceinline__ float tidal_depth(const Ops& o, float t) {
  if (!o.has_tidal) return 0.0f;
  const float ramp = o.tide_tau > 0.0f ? fminf(t / o.tide_tau, 1.0f) : 1.0f;
  return o.tide_h0 + o.tide_amp * cosf(o.tide_omega * t) * ramp;
}

// The smaller value when the signs agree, else 0 (not the textbook
// smaller-magnitude minmod: see ops/limiters.py).
__device__ __forceinline__ float minmod(float a, float b) {
  const bool same = a * b > 0.0f;
  if (same && a < b) return a;
  if (same && b < a) return b;
  return 0.0f;
}

// Hydrostatic minmod reconstruction of the two water columns at a trace
// node for wetting/drying (ops/limiters.py::surface_reconstruction).
__device__ __forceinline__ void surface_reconstruction(
    float etaM, float hM, float etaP, float hP, float h_floor, float& hMs,
    float& hPs) {
  const float zM = etaM - hM;
  float zP = etaP - hP;
  const float dz = (zP - 0.5f * minmod(zP - zM, 1e-3f))
                   - (zM + 0.5f * minmod(zM - zP, -1e-3f));
  const float corr = fminf(zM - zP - dz, etaM - etaP);
  if (corr > 0.0f) etaP += corr;
  zP = etaP - hP;
  const float maxz = fmaxf(zM, zP);
  hMs = fmaxf(etaM - maxz, h_floor);
  hPs = fmaxf(etaP - maxz, h_floor);
}

// 1/h that goes to zero, not to infinity, as h goes to the floor.
__device__ __forceinline__ float desingularized_inv(float h, float h_floor) {
  const float eps = 4.0f * h_floor, h2 = h * h;
  return 2.0f * h / (h2 + fmaxf(h2, eps * eps));
}

// Everything a trace node needs from the state, shared by the forward flux
// and by both passes of the adjoint.
struct TraceVals {
  float nx, ny;
  float hM, hP, huM, hvM, huP, hvP;
  float uM, vM, uP, vP;
  float hMs, hPs;      // star depths (== hM, hP on a flat bottom)
  bool passM, passP;   // max(0, x) passed its argument
  float spdM, spdP;
  bool wall;
  float obc;
};

// h, hu, hv: one scenario's state, indexed by global volume node (shared or
// global memory); i: global trace node.
__device__ __forceinline__ void trace_values(
    const Ops& o, int i, const float* h, const float* hu, const float* hv,
    float h_bc, TraceVals& tv) {
  const int vm = o.vmapM[i], vp = o.vmapP[i];
  tv.nx = o.nx[i]; tv.ny = o.ny[i];
  tv.hM = h[vm];  tv.hP = h[vp];
  tv.huM = hu[vm]; tv.hvM = hv[vm];
  tv.huP = hu[vp]; tv.hvP = hv[vp];
  tv.wall = o.wall[i] != 0.0f;
  if (tv.wall) {  // reflect the normal momentum
    const float un2 = 2.0f * (tv.huM * tv.nx + tv.hvM * tv.ny);
    tv.huP = tv.huM - un2 * tv.nx;
    tv.hvP = tv.hvM - un2 * tv.ny;
  }
  tv.obc = 0.0f;
  if (o.has_tidal) {  // prescribed total depth on BC_OUT nodes
    tv.obc = o.obc[i];
    tv.hP = tv.hP + tv.obc * (h_bc - tv.hP);
  }
  tv.passM = tv.passP = true;
  if (o.wetdry) {
    const float HM = o.HMt[i], HP = o.HPt[i];
    surface_reconstruction(tv.hM - HM, tv.hM, tv.hP - HP, tv.hP, o.h_floor,
                           tv.hMs, tv.hPs);
    const float iM = desingularized_inv(tv.hM, o.h_floor);
    const float iP = desingularized_inv(tv.hP, o.h_floor);
    tv.uM = tv.huM * iM; tv.vM = tv.hvM * iM;
    tv.uP = tv.huP * iP; tv.vP = tv.hvP * iP;
  } else {
    tv.uM = tv.huM / tv.hM; tv.vM = tv.hvM / tv.hM;
    tv.uP = tv.huP / tv.hP; tv.vP = tv.hvP / tv.hP;
    if (o.wb) {
      const float HM = o.HMt[i], HP = o.HPt[i];
      const float bstar = fmaxf(-HM, -HP);
      const float aM = tv.hM - HM - bstar, aP = tv.hP - HP - bstar;
      tv.passM = aM > 0.0f; tv.passP = aP > 0.0f;
      tv.hMs = fmaxf(0.0f, aM); tv.hPs = fmaxf(0.0f, aP);
    } else {
      tv.hMs = tv.hM; tv.hPs = tv.hP;
    }
  }
  tv.spdM = safe_norm(tv.uM, tv.vM) + sqrtf(o.g * tv.hMs);
  tv.spdP = safe_norm(tv.uP, tv.vP) + sqrtf(o.g * tv.hPs);
}

// The jumps dq_i that the Lax-Friedrichs speed multiplies.
__device__ __forceinline__ void trace_jumps(
    const Ops& o, const TraceVals& tv, float& dq1, float& dq2, float& dq3) {
  if (o.wb || o.wetdry) {
    dq1 = tv.hMs - tv.hPs;
    dq2 = tv.hMs * tv.uM - tv.hPs * tv.uP;
    dq3 = tv.hMs * tv.vM - tv.hPs * tv.vP;
  } else {
    dq1 = tv.hM - tv.hP;
    dq2 = tv.huM - tv.huP;
    dq3 = tv.hvM - tv.hvP;
  }
}

// The part of the three flux jumps that does not depend on the face speed:
// 0.5*(dF nx + dG ny) plus the well-balancing correction.
__device__ __forceinline__ void trace_flux_pre(
    const Ops& o, const TraceVals& tv, float& p1, float& p2, float& p3) {
  const float g = o.g;
  float F1M, F2M, F3M, G1M, G3M, F1P, F2P, F3P, G1P, G3P;
  float c1 = 0.0f, c2 = 0.0f, c3 = 0.0f;
  if (o.wb || o.wetdry) {
    const float pM = 0.5f * g * tv.hMs * tv.hMs;
    const float pP = 0.5f * g * tv.hPs * tv.hPs;
    F1M = tv.hMs * tv.uM; G1M = tv.hMs * tv.vM;
    F2M = tv.hMs * tv.uM * tv.uM + pM;
    F3M = tv.hMs * tv.uM * tv.vM;
    G3M = tv.hMs * tv.vM * tv.vM + pM;
    F1P = tv.hPs * tv.uP; G1P = tv.hPs * tv.vP;
    F2P = tv.hPs * tv.uP * tv.uP + pP;
    F3P = tv.hPs * tv.uP * tv.vP;
    G3P = tv.hPs * tv.vP * tv.vP + pP;
    const float corr = (tv.hM - tv.hMs) * (tv.uM * tv.nx + tv.vM * tv.ny);
    c1 = corr; c2 = corr * tv.uM; c3 = corr * tv.vM;
  } else {
    const float iM = 1.0f / tv.hM, iP = 1.0f / tv.hP;
    const float pM = 0.5f * g * tv.hM * tv.hM;
    const float pP = 0.5f * g * tv.hP * tv.hP;
    F1M = tv.huM; G1M = tv.hvM;
    F2M = tv.huM * tv.huM * iM + pM;
    F3M = tv.huM * tv.hvM * iM;
    G3M = tv.hvM * tv.hvM * iM + pM;
    F1P = tv.huP; G1P = tv.hvP;
    F2P = tv.huP * tv.huP * iP + pP;
    F3P = tv.huP * tv.hvP * iP;
    G3P = tv.hvP * tv.hvP * iP + pP;
  }
  p1 = 0.5f * ((F1M - F1P) * tv.nx + (G1M - G1P) * tv.ny) + c1;
  p2 = 0.5f * ((F2M - F2P) * tv.nx + (F3M - F3P) * tv.ny) + c2;
  p3 = 0.5f * ((F3M - F3P) * tv.nx + (G3M - G3P) * tv.ny) + c3;
}

// Volume fluxes of one node: F2, F3 (= G2), G3 (F1 = hu, G1 = hv).
__device__ __forceinline__ void volume_fluxes(
    const Ops& o, float h, float hu, float hv, float& F2, float& F3,
    float& G3) {
  const float p = 0.5f * o.g * h * h;
  if (o.wetdry) {
    const float inv = desingularized_inv(h, o.h_floor);
    const float u = hu * inv, v = hv * inv;
    F2 = h * u * u + p; F3 = h * u * v; G3 = h * v * v + p;
  } else {
    const float inv = 1.0f / h;
    F2 = hu * hu * inv + p; F3 = hu * hv * inv; G3 = hv * hv * inv + p;
  }
}

// Bed slope, drag, Coriolis and control forcing of volume node v.
// ctrl: this scenario's n_ctrl controls, or null.
__device__ __forceinline__ void add_sources(
    const Ops& o, int v, float h, float hu, float hv,
    const float* __restrict__ ctrl, float& r2, float& r3) {
  if (o.has_bathy) {
    // wet/dry: no bed-slope forcing in dry cells
    const float wet = (o.wetdry && !(h > 5.0f * o.h_floor)) ? 0.0f : 1.0f;
    r2 += o.g * h * o.Hx[v] * wet;
    r3 += o.g * h * o.Hy[v] * wet;
  }
  if (o.cd != 0.0f) {
    float u, vv;
    if (o.wetdry) {
      const float inv = desingularized_inv(h, o.h_floor);
      u = hu * inv; vv = hv * inv;
    } else {
      u = hu / h; vv = hv / h;
    }
    const float nrm = safe_norm(u, vv);
    r2 -= o.cd * nrm * u;
    r3 -= o.cd * nrm * vv;
  }
  if (o.fcor != 0.0f) {
    r2 += o.fcor * hv;
    r3 -= o.fcor * hu;
  }
  if (ctrl != nullptr) {
    for (int c = 0; c < o.n_ctrl; ++c) {
      const float cc = ctrl[c];
      r2 += cc * o.BU[c * o.nV + v];
      r3 += cc * o.BV[c * o.nV + v];
    }
  }
}

// ---------------------------------------------------------------------------
// Pointwise parts of the adjoint (flat and well-balanced regimes; the
// wet/dry branch has no adjoint)
// ---------------------------------------------------------------------------

// Volume node v: from the cotangents of its six fluxes (Fb*, Gb*: the
// transposed divergence of the RHS cotangent) and the RHS cotangent itself
// (w2, w3, for the sources) to the cotangent of (h, hu, hv).
// F1=hu, F2=hu^2/h+p, F3=G2=hu*hv/h, G1=hv, G3=hv^2/h+p, p=g/2 h^2.
__device__ __forceinline__ void volume_vjp_point(
    const Ops& o, int v, float h, float hu, float hv, float Fb1, float Fb2,
    float Fb3, float Gb1, float Gb2, float Gb3, float w2, float w3,
    float& hb, float& hub, float& hvb) {
  const float g = o.g;
  const float inv = 1.0f / h, u = hu * inv, vv = hv * inv;
  const float w23 = Fb3 + Gb2;
  hub = Fb1 + 2.0f * u * Fb2 + vv * w23;
  hvb = Gb1 + 2.0f * vv * Gb3 + u * w23;
  hb = (g * h - u * u) * Fb2 + (g * h - vv * vv) * Gb3 - u * vv * w23;
  if (o.has_bathy) hb += g * (o.Hx[v] * w2 + o.Hy[v] * w3);
  if (o.cd != 0.0f) {
    const float nrm = safe_norm(u, vv);
    if (nrm > 0.0f) {
      const float a2 = -o.cd * w2, a3 = -o.cd * w3, in = 1.0f / nrm;
      const float ub = a2 * (nrm + u * u * in) + a3 * (u * vv * in);
      const float vb = a2 * (u * vv * in) + a3 * (nrm + vv * vv * in);
      hub += ub * inv; hvb += vb * inv;
      hb -= (ub * u + vb * vv) * inv;
    }
  }
  if (o.fcor != 0.0f) {
    hvb += o.fcor * w2;
    hub -= o.fcor * w3;
  }
}

// Trace node: the whole chain rule of the face flux. d1..d3: cotangents of
// the (unscaled) flux jumps; lam: the face speed; sb: this node's share of
// the face speed's cotangent. Out: cotangents of the '-' traces (h, hu, hv)
// and of the '+' traces.
__device__ __forceinline__ void face_vjp_point(
    const Ops& o, const TraceVals& tv, float lam, float sb, float d1,
    float d2, float d3, float* tM, float* tP) {
  const float g = o.g;
  const float wM = tv.spdM > tv.spdP ? 1.0f
                   : (tv.spdM == tv.spdP ? 0.5f : 0.0f);
  const float spdMb = sb * wM, spdPb = sb - spdMb;
  const float nx = tv.nx, ny = tv.ny;
  // cotangents of the '-' side fluxes; the '+' side gets the negatives
  const float q1 = -0.5f * lam * d1, q2 = -0.5f * lam * d2;
  const float q3 = -0.5f * lam * d3;
  const float Fb1 = 0.5f * nx * d1 + q2, Gb1 = 0.5f * ny * d1 + q3;
  const float Fb2 = 0.5f * nx * d2, Gb3 = 0.5f * ny * d3;
  const float w23 = 0.5f * nx * d3 + 0.5f * ny * d2;

  float hMsb = q1, hPsb = -q1;
  float uMb = 0.0f, vMb = 0.0f, uPb = 0.0f, vPb = 0.0f;
  float hMb = 0.0f, hPb = 0.0f;
  if (o.wb) {
    const float corr_b = d1 + tv.uM * d2 + tv.vM * d3;
    const float corr = (tv.hM - tv.hMs) * (tv.uM * nx + tv.vM * ny);
    const float unM = tv.uM * nx + tv.vM * ny;
    uMb += corr * d2; vMb += corr * d3;
    hMb += corr_b * unM; hMsb -= corr_b * unM;
    const float tb = corr_b * (tv.hM - tv.hMs);
    uMb += tb * nx; vMb += tb * ny;
  }
  // fluxes from (h*, u, v):  F1=h*u, G1=h*v, F2=h*u^2+p, F3=G2=h*uv,
  // G3=h*v^2+p, p=g/2 h*^2
  {
    const float hs = tv.hMs, u = tv.uM, v = tv.vM;
    hMsb += u * Fb1 + v * Gb1 + (u * u + g * hs) * Fb2
            + (v * v + g * hs) * Gb3 + u * v * w23;
    uMb += hs * (Fb1 + 2.0f * u * Fb2 + v * w23);
    vMb += hs * (Gb1 + 2.0f * v * Gb3 + u * w23);
  }
  {
    const float hs = tv.hPs, u = tv.uP, v = tv.vP;
    hPsb -= u * Fb1 + v * Gb1 + (u * u + g * hs) * Fb2
            + (v * v + g * hs) * Gb3 + u * v * w23;
    uPb -= hs * (Fb1 + 2.0f * u * Fb2 + v * w23);
    vPb -= hs * (Gb1 + 2.0f * v * Gb3 + u * w23);
  }
  // speeds: |(u, v)| + sqrt(g h*)
  {
    const float nM = safe_norm(tv.uM, tv.vM);
    if (nM > 0.0f) { uMb += spdMb * tv.uM / nM; vMb += spdMb * tv.vM / nM; }
    if (tv.hMs > 0.0f) hMsb += spdMb * 0.5f * sqrtf(g / tv.hMs);
    const float nP = safe_norm(tv.uP, tv.vP);
    if (nP > 0.0f) { uPb += spdPb * tv.uP / nP; vPb += spdPb * tv.vP / nP; }
    if (tv.hPs > 0.0f) hPsb += spdPb * 0.5f * sqrtf(g / tv.hPs);
  }
  if (tv.passM) hMb += hMsb;
  if (tv.passP) hPb += hPsb;
  // u = hu / h
  float huMb = uMb / tv.hM, hvMb = vMb / tv.hM;
  hMb -= (uMb * tv.uM + vMb * tv.vM) / tv.hM;
  float huPb = uPb / tv.hP, hvPb = vPb / tv.hP;
  hPb -= (uPb * tv.uP + vPb * tv.vP) / tv.hP;
  hPb *= (1.0f - tv.obc);  // a prescribed depth does not see the state
  if (tv.wall) {           // reflection: '+' momentum is a map of '-'
    const float unb = -2.0f * (nx * huPb + ny * hvPb);
    huMb += huPb + nx * unb;
    hvMb += hvPb + ny * unb;
    huPb = 0.0f; hvPb = 0.0f;
  }
  tM[0] = hMb; tM[1] = huMb; tM[2] = hvMb;
  tP[0] = hPb; tP[1] = huPb; tP[2] = hvPb;
}

// This node's share of the face speed's cotangent: the face's summed
// cotangent, split evenly over the nodes that attain the face maximum.
// spd, lamb: per-trace-node arrays holding the face's Nfp nodes from f0 on.
__device__ __forceinline__ float face_speed_share(
    const float* spd, const float* lamb, int f0, int Nfp, float my_spd,
    float& lam) {
  lam = spd[f0];
  float lsum = lamb[f0];
  for (int j = 1; j < Nfp; ++j) {
    lam = fmaxf(lam, spd[f0 + j]);
    lsum += lamb[f0 + j];
  }
  int cnt = 0;
  for (int j = 0; j < Nfp; ++j) cnt += (spd[f0 + j] == lam) ? 1 : 0;
  return (my_spd == lam) ? lsum / (float)cnt : 0.0f;
}

struct Vec3 { float *a, *b, *c; };

__device__ __forceinline__ Vec3 carve(float*& p, int n) {
  Vec3 v; v.a = p; v.b = p + n; v.c = p + 2 * n; p += 3 * n; return v;
}

template <typename Kern>
static int prepare(Kern kern, size_t bytes) {
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
