// Fused shallow-water kernels for the dense (small-mesh) MPC regime, sm_90a.
//
// Three kernels, one block per scenario, the state held in shared memory
// for the whole time loop:
//   sw2d_step_kernel         one SSP-RK2 step
//   sw2d_rollout_kernel      the whole horizon, every step-start state stored
//   sw2d_rollout_bwd_kernel  the reverse (adjoint) sweep over that trajectory
//
// They replace the Pallas TPU kernels _step_kernel, _rollout_kernel and
// _rollout_bwd_kernel of blitzdg_tpu/ops/sw2d_pallas.py. The arithmetic is
// the same; the layout is not. The TPU kernels multiply by dense trace and
// block-diagonal derivative operators; here '-'/'+' traces are index gathers
// through vmapM/vmapP, wall reflection and the tidal depth are applied on
// flagged trace nodes, and derivative, lift and filter are per-element
// (Np x Np) / (Np x Ntr) products done with FMAs. States are unpadded
// (B, K*Np), controls unpadded (B, H, n_ctrl).
//
// The adjoint of the RHS is derived by hand (CUDA has no autodiff); the same
// derivation, step by step, is sw2d_rollout_bwd_plain in ops/sw2d_fused.py,
// where it is tested against torch.autograd. Tie rules: at
// max(spdM, spdP) a tie gives half of the cotangent to each side; the
// per-face maximum splits its cotangent evenly over the nodes that attain
// it; max(0, x) of the star depths passes the cotangent where x > 0; the
// velocity norm has zero gradient at the origin.
//
// Plain C interface (extern "C" at the end), loaded with ctypes. Launches go
// to the stream that is passed in; nothing here synchronises or allocates.

#include <cuda_runtime.h>
#include <math.h>

struct SwDesc {
  int K, Np, Nfaces, Nfp, n_ctrl;
  int wb, has_bathy, has_tidal;
  float g, cd, fcor;
  float tide_h0, tide_amp, tide_omega, tide_tau;
};

struct Ops {
  const float *Dr, *Ds, *lift, *filt;
  const float *rx, *sx, *ry, *sy;
  const float *nx, *ny, *fscale, *wall, *obc, *HMt, *HPt;
  const float *Hx, *Hy, *BU, *BV;
  const int *vmapM, *vmapP, *invM_ptr, *invM_idx, *invP_ptr, *invP_idx;
  int K, Np, Ntr, Nfp, nV, nT, n_ctrl;
  int wb, has_bathy, has_tidal;
  float g, cd, fcor, tide_h0, tide_amp, tide_omega, tide_tau;
};

// The packed operator buffers: the order here is the order in which
// FusedStepOps packs them (ops/sw2d_fused.py, _pack_buffers).
static Ops make_ops(const SwDesc& d, const float* f, const int* i) {
  Ops o;
  o.K = d.K; o.Np = d.Np; o.Ntr = d.Nfaces * d.Nfp; o.Nfp = d.Nfp;
  o.nV = d.K * d.Np; o.nT = d.K * o.Ntr; o.n_ctrl = d.n_ctrl;
  o.wb = d.wb; o.has_bathy = d.has_bathy; o.has_tidal = d.has_tidal;
  o.g = d.g; o.cd = d.cd; o.fcor = d.fcor;
  o.tide_h0 = d.tide_h0; o.tide_amp = d.tide_amp;
  o.tide_omega = d.tide_omega; o.tide_tau = d.tide_tau;
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

// Everything a trace node needs from the state, shared by the forward flux
// and by both passes of the adjoint.
struct TraceVals {
  float nx, ny;
  float hM, hP, huM, hvM, huP, hvP;
  float uM, vM, uP, vP;
  float hMs, hPs;      // star depths (== hM, hP without well-balancing)
  bool passM, passP;   // max(0, x) passed its argument
  float spdM, spdP;
  bool wall;
  float obc;
};

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
  tv.uM = tv.huM / tv.hM; tv.vM = tv.hvM / tv.hM;
  tv.uP = tv.huP / tv.hP; tv.vP = tv.hvP / tv.hP;
  if (o.wb) {
    const float HM = o.HMt[i], HP = o.HPt[i];
    const float bstar = fmaxf(-HM, -HP);
    const float aM = tv.hM - HM - bstar, aP = tv.hP - HP - bstar;
    tv.passM = aM > 0.0f; tv.passP = aP > 0.0f;
    tv.hMs = fmaxf(0.0f, aM); tv.hPs = fmaxf(0.0f, aP);
  } else {
    tv.passM = tv.passP = true;
    tv.hMs = tv.hM; tv.hPs = tv.hP;
  }
  tv.spdM = safe_norm(tv.uM, tv.vM) + sqrtf(o.g * tv.hMs);
  tv.spdP = safe_norm(tv.uP, tv.vP) + sqrtf(o.g * tv.hPs);
}

// The jumps dq_i that the Lax-Friedrichs speed multiplies.
__device__ __forceinline__ void trace_jumps(
    const Ops& o, const TraceVals& tv, float& dq1, float& dq2, float& dq3) {
  if (o.wb) {
    dq1 = tv.hMs - tv.hPs;
    dq2 = tv.hMs * tv.uM - tv.hPs * tv.uP;
    dq3 = tv.hMs * tv.vM - tv.hPs * tv.vP;
  } else {
    dq1 = tv.hM - tv.hP;
    dq2 = tv.huM - tv.huP;
    dq3 = tv.hvM - tv.hvP;
  }
}

struct Vec3 { float *a, *b, *c; };

__device__ __forceinline__ Vec3 carve(float*& p, int n) {
  Vec3 v; v.a = p; v.b = p + n; v.c = p + 2 * n; p += 3 * n; return v;
}

struct FwdScratch {
  Vec3 vflux;  // F2, F3 (= G2), G3 at volume nodes
  Vec3 r;      // unfiltered RHS
  Vec3 pre;    // 0.5*(dF nx + dG ny) + correction, then the scaled jump
  Vec3 dq;
  float* spd;
};

// One filtered, control-forced RHS for the block's scenario.
// S: state in shared memory; Kout: 3*nV of shared memory, not aliasing S.
__device__ void eval_rhs(const Ops& o, const Vec3& S, float t,
                         const float* __restrict__ ctrl, int use_filter,
                         const FwdScratch& w, const Vec3& Kout) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const float g = o.g;
  const float h_bc = tidal_depth(o, t);

  for (int v = tid; v < o.nV; v += nth) {
    const float h = S.a[v], hu = S.b[v], hv = S.c[v];
    const float inv = 1.0f / h, p = 0.5f * g * h * h;
    w.vflux.a[v] = hu * hu * inv + p;
    w.vflux.b[v] = hu * hv * inv;
    w.vflux.c[v] = hv * hv * inv + p;
  }
  for (int i = tid; i < o.nT; i += nth) {
    TraceVals tv;
    trace_values(o, i, S.a, S.b, S.c, h_bc, tv);
    float F1M, F2M, F3M, G1M, G3M, F1P, F2P, F3P, G1P, G3P;
    float c1 = 0.0f, c2 = 0.0f, c3 = 0.0f;
    if (o.wb) {
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
    float dq1, dq2, dq3;
    trace_jumps(o, tv, dq1, dq2, dq3);
    w.pre.a[i] = 0.5f * ((F1M - F1P) * tv.nx + (G1M - G1P) * tv.ny) + c1;
    w.pre.b[i] = 0.5f * ((F2M - F2P) * tv.nx + (F3M - F3P) * tv.ny) + c2;
    w.pre.c[i] = 0.5f * ((F3M - F3P) * tv.nx + (G3M - G3P) * tv.ny) + c3;
    w.dq.a[i] = dq1; w.dq.b[i] = dq2; w.dq.c[i] = dq3;
    w.spd[i] = fmaxf(tv.spdM, tv.spdP);
  }
  __syncthreads();

  // per-face maximum wavespeed, then the jump scaled for the lift
  for (int i = tid; i < o.nT; i += nth) {
    const int f0 = (i / o.Nfp) * o.Nfp;
    float lam = w.spd[f0];
    for (int j = 1; j < o.Nfp; ++j) lam = fmaxf(lam, w.spd[f0 + j]);
    const float fs = o.fscale[i], hl = 0.5f * lam;
    w.pre.a[i] = (w.pre.a[i] - hl * w.dq.a[i]) * fs;
    w.pre.b[i] = (w.pre.b[i] - hl * w.dq.b[i]) * fs;
    w.pre.c[i] = (w.pre.c[i] - hl * w.dq.c[i]) * fs;
  }
  __syncthreads();

  const Vec3& R = use_filter ? w.r : Kout;
  for (int v = tid; v < o.nV; v += nth) {
    const int k = v / o.Np, n = v - k * o.Np;
    const int e0 = k * o.Np, t0 = k * o.Ntr;
    float l1 = 0.0f, l2 = 0.0f, l3 = 0.0f;
    for (int j = 0; j < o.Ntr; ++j) {
      const float lf = o.lift[n * o.Ntr + j];
      l1 += lf * w.pre.a[t0 + j];
      l2 += lf * w.pre.b[t0 + j];
      l3 += lf * w.pre.c[t0 + j];
    }
    float rF1 = 0, sF1 = 0, rG1 = 0, sG1 = 0, rF2 = 0, sF2 = 0;
    float rF3 = 0, sF3 = 0, rG3 = 0, sG3 = 0;
    for (int m = 0; m < o.Np; ++m) {
      const float dr = o.Dr[n * o.Np + m], ds = o.Ds[n * o.Np + m];
      const float f1 = S.b[e0 + m], g1 = S.c[e0 + m];
      const float f2 = w.vflux.a[e0 + m], f3 = w.vflux.b[e0 + m];
      const float g3 = w.vflux.c[e0 + m];
      rF1 += dr * f1; sF1 += ds * f1; rG1 += dr * g1; sG1 += ds * g1;
      rF2 += dr * f2; sF2 += ds * f2; rF3 += dr * f3; sF3 += ds * f3;
      rG3 += dr * g3; sG3 += ds * g3;
    }
    const float rx = o.rx[v], sx = o.sx[v], ry = o.ry[v], sy = o.sy[v];
    float r1 = l1 - (rx * rF1 + sx * sF1 + ry * rG1 + sy * sG1);
    float r2 = l2 - (rx * rF2 + sx * sF2 + ry * rF3 + sy * sF3);
    float r3 = l3 - (rx * rF3 + sx * sF3 + ry * rG3 + sy * sG3);
    const float h = S.a[v], hu = S.b[v], hv = S.c[v];
    if (o.has_bathy) {
      r2 += g * h * o.Hx[v];
      r3 += g * h * o.Hy[v];
    }
    if (o.cd != 0.0f) {
      const float u = hu / h, vv = hv / h, nrm = safe_norm(u, vv);
      r2 -= o.cd * nrm * u;
      r3 -= o.cd * nrm * vv;
    }
    if (o.fcor != 0.0f) {
      r2 += o.fcor * hv;
      r3 -= o.fcor * hu;
    }
    for (int c = 0; c < o.n_ctrl; ++c) {
      const float cc = ctrl[c];
      r2 += cc * o.BU[c * o.nV + v];
      r3 += cc * o.BV[c * o.nV + v];
    }
    R.a[v] = r1; R.b[v] = r2; R.c[v] = r3;
  }
  __syncthreads();
  if (use_filter) {
    for (int v = tid; v < o.nV; v += nth) {
      const int k = v / o.Np, n = v - k * o.Np, e0 = k * o.Np;
      float a = 0.0f, b = 0.0f, c = 0.0f;
      for (int m = 0; m < o.Np; ++m) {
        const float fl = o.filt[n * o.Np + m];
        a += fl * w.r.a[e0 + m];
        b += fl * w.r.b[e0 + m];
        c += fl * w.r.c[e0 + m];
      }
      Kout.a[v] = a; Kout.b[v] = b; Kout.c[v] = c;
    }
    __syncthreads();
  }
}

// dst = base + c * k on the three fields, then a barrier.
__device__ __forceinline__ void axpy3(const Ops& o, const Vec3& dst,
                                      const Vec3& base, float c,
                                      const Vec3& k) {
  for (int v = threadIdx.x; v < o.nV; v += blockDim.x) {
    dst.a[v] = base.a[v] + c * k.a[v];
    dst.b[v] = base.b[v] + c * k.b[v];
    dst.c[v] = base.c[v] + c * k.c[v];
  }
  __syncthreads();
}

// u1 = u + dt/2 R(u, t);  u <- u + dt R(u1, t + dt/2)
__device__ void ssprk2_step(const Ops& o, const Vec3& S, const Vec3& S1,
                            const Vec3& Kb, float t, float dt,
                            const float* ctrl, int use_filter,
                            const FwdScratch& w) {
  eval_rhs(o, S, t, ctrl, use_filter, w, Kb);
  axpy3(o, S1, S, 0.5f * dt, Kb);
  eval_rhs(o, S1, t + 0.5f * dt, ctrl, use_filter, w, Kb);
  axpy3(o, S, S, dt, Kb);
}

__device__ __forceinline__ FwdScratch carve_fwd(float*& p, const Ops& o) {
  FwdScratch w;
  w.vflux = carve(p, o.nV);
  w.r = carve(p, o.nV);
  w.pre = carve(p, o.nT);
  w.dq = carve(p, o.nT);
  w.spd = p; p += o.nT;
  return w;
}

static size_t fwd_smem_floats(const Ops& o) {
  return (size_t)15 * o.nV + (size_t)7 * o.nT;
}

extern __shared__ float smem[];

__global__ void sw2d_step_kernel(
    Ops o, const float* __restrict__ h, const float* __restrict__ hu,
    const float* __restrict__ hv, const float* __restrict__ ctrl,
    float* __restrict__ oh, float* __restrict__ ohu, float* __restrict__ ohv,
    float dt, float t0, int use_filter) {
  float* p = smem;
  const Vec3 S = carve(p, o.nV), S1 = carve(p, o.nV), Kb = carve(p, o.nV);
  const FwdScratch w = carve_fwd(p, o);
  const size_t row = (size_t)blockIdx.x * o.nV;
  for (int v = threadIdx.x; v < o.nV; v += blockDim.x) {
    S.a[v] = h[row + v]; S.b[v] = hu[row + v]; S.c[v] = hv[row + v];
  }
  __syncthreads();
  ssprk2_step(o, S, S1, Kb, t0, dt, ctrl + (size_t)blockIdx.x * o.n_ctrl,
              use_filter, w);
  for (int v = threadIdx.x; v < o.nV; v += blockDim.x) {
    oh[row + v] = S.a[v]; ohu[row + v] = S.b[v]; ohv[row + v] = S.c[v];
  }
}

__global__ void sw2d_rollout_kernel(
    Ops o, const float* __restrict__ h, const float* __restrict__ hu,
    const float* __restrict__ hv, const float* __restrict__ ctrls,
    float* __restrict__ th, float* __restrict__ thu, float* __restrict__ thv,
    int n_ctrl_steps, int spc, float dt, float t0, int use_filter) {
  float* p = smem;
  const Vec3 S = carve(p, o.nV), S1 = carve(p, o.nV), Kb = carve(p, o.nV);
  const FwdScratch w = carve_fwd(p, o);
  const int n_steps = n_ctrl_steps * spc;
  const size_t row = (size_t)blockIdx.x * o.nV;
  const size_t trow = (size_t)blockIdx.x * (n_steps + 1) * o.nV;
  const float* cb = ctrls + (size_t)blockIdx.x * n_ctrl_steps * o.n_ctrl;
  for (int v = threadIdx.x; v < o.nV; v += blockDim.x) {
    S.a[v] = h[row + v]; S.b[v] = hu[row + v]; S.c[v] = hv[row + v];
  }
  __syncthreads();
  for (int t = 0; t <= n_steps; ++t) {
    const size_t off = trow + (size_t)t * o.nV;
    for (int v = threadIdx.x; v < o.nV; v += blockDim.x) {
      th[off + v] = S.a[v]; thu[off + v] = S.b[v]; thv[off + v] = S.c[v];
    }
    if (t == n_steps) break;
    const float tt = t0 + (float)t * dt;
    ssprk2_step(o, S, S1, Kb, tt, dt, cb + (t / spc) * o.n_ctrl, use_filter,
                w);
  }
}

// ---------------------------------------------------------------------------
// Adjoint
// ---------------------------------------------------------------------------

struct BwdScratch {
  Vec3 wf;     // filtered-back, scaled cotangent of the RHS
  Vec3 dfb;    // cotangent of the (unscaled) flux jumps
  float* spd;
  float* lamb; // cotangent of the face speed, per node before the face sum
  Vec3 tM;     // cotangents of the '-' traces (h, hu, hv)
  Vec3 tP;     // cotangents of the '+' traces
};

// Vector-Jacobian product of eval_rhs at state S:
//   Aout = scale * J_R(S)^T W,   cpart[c][tid] += d/d ctrl_c.
// W, Aout: 3*nV of shared memory each; Aout aliases neither S nor W.
__device__ void eval_rhs_vjp(const Ops& o, const Vec3& S, float t,
                             const Vec3& W, float scale, int use_filter,
                             const BwdScratch& w, const Vec3& Aout,
                             float* cpart) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const float g = o.g;
  const float h_bc = tidal_depth(o, t);

  // filter transpose, and the control cotangent (the control enters the
  // RHS before the filter)
  for (int v = tid; v < o.nV; v += nth) {
    float a, b, c;
    if (use_filter) {
      const int k = v / o.Np, m = v - k * o.Np, e0 = k * o.Np;
      a = b = c = 0.0f;
      for (int n = 0; n < o.Np; ++n) {
        const float fl = o.filt[n * o.Np + m];
        a += fl * W.a[e0 + n]; b += fl * W.b[e0 + n]; c += fl * W.c[e0 + n];
      }
    } else {
      a = W.a[v]; b = W.b[v]; c = W.c[v];
    }
    a *= scale; b *= scale; c *= scale;
    w.wf.a[v] = a; w.wf.b[v] = b; w.wf.c[v] = c;
    for (int cc = 0; cc < o.n_ctrl; ++cc)
      cpart[cc * nth + tid] += o.BU[cc * o.nV + v] * b + o.BV[cc * o.nV + v] * c;
  }
  __syncthreads();

  // volume part: divergence transpose, volume fluxes, sources
  for (int v = tid; v < o.nV; v += nth) {
    const int k = v / o.Np, m = v - k * o.Np, e0 = k * o.Np;
    float Fb1 = 0, Fb2 = 0, Fb3 = 0, Gb1 = 0, Gb2 = 0, Gb3 = 0;
    for (int n = 0; n < o.Np; ++n) {
      const float dr = o.Dr[n * o.Np + m], ds = o.Ds[n * o.Np + m];
      const float dx = dr * o.rx[e0 + n] + ds * o.sx[e0 + n];
      const float dy = dr * o.ry[e0 + n] + ds * o.sy[e0 + n];
      const float w1 = w.wf.a[e0 + n], w2 = w.wf.b[e0 + n];
      const float w3 = w.wf.c[e0 + n];
      Fb1 -= dx * w1; Fb2 -= dx * w2; Fb3 -= dx * w3;
      Gb1 -= dy * w1; Gb2 -= dy * w2; Gb3 -= dy * w3;
    }
    const float h = S.a[v], hu = S.b[v], hv = S.c[v];
    const float inv = 1.0f / h, u = hu * inv, vv = hv * inv;
    const float w23 = Fb3 + Gb2;
    // F1=hu, F2=hu^2/h+p, F3=G2=hu*hv/h, G1=hv, G3=hv^2/h+p, p=g/2 h^2
    float hub = Fb1 + 2.0f * u * Fb2 + vv * w23;
    float hvb = Gb1 + 2.0f * vv * Gb3 + u * w23;
    float hb = (g * h - u * u) * Fb2 + (g * h - vv * vv) * Gb3 - u * vv * w23;
    const float w2 = w.wf.b[v], w3 = w.wf.c[v];
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
    Aout.a[v] = hb; Aout.b[v] = hub; Aout.c[v] = hvb;
  }
  // lift transpose; first trace pass: speeds and the speed's cotangent
  for (int i = tid; i < o.nT; i += nth) {
    const int k = i / o.Ntr, j = i - k * o.Ntr, e0 = k * o.Np;
    float d1 = 0.0f, d2 = 0.0f, d3 = 0.0f;
    for (int n = 0; n < o.Np; ++n) {
      const float lf = o.lift[n * o.Ntr + j];
      d1 += lf * w.wf.a[e0 + n]; d2 += lf * w.wf.b[e0 + n];
      d3 += lf * w.wf.c[e0 + n];
    }
    const float fs = o.fscale[i];
    d1 *= fs; d2 *= fs; d3 *= fs;
    w.dfb.a[i] = d1; w.dfb.b[i] = d2; w.dfb.c[i] = d3;
    TraceVals tv;
    trace_values(o, i, S.a, S.b, S.c, h_bc, tv);
    float dq1, dq2, dq3;
    trace_jumps(o, tv, dq1, dq2, dq3);
    w.spd[i] = fmaxf(tv.spdM, tv.spdP);
    w.lamb[i] = -0.5f * (dq1 * d1 + dq2 * d2 + dq3 * d3);
  }
  __syncthreads();

  // second trace pass: the whole chain rule of the face flux
  for (int i = tid; i < o.nT; i += nth) {
    TraceVals tv;
    trace_values(o, i, S.a, S.b, S.c, h_bc, tv);
    const int f0 = (i / o.Nfp) * o.Nfp;
    float lam = w.spd[f0], lsum = w.lamb[f0];
    for (int j = 1; j < o.Nfp; ++j) {
      lam = fmaxf(lam, w.spd[f0 + j]);
      lsum += w.lamb[f0 + j];
    }
    int cnt = 0;
    for (int j = 0; j < o.Nfp; ++j) cnt += (w.spd[f0 + j] == lam) ? 1 : 0;
    const float spd = fmaxf(tv.spdM, tv.spdP);
    const float sb = (spd == lam) ? lsum / (float)cnt : 0.0f;
    const float wM = tv.spdM > tv.spdP ? 1.0f
                     : (tv.spdM == tv.spdP ? 0.5f : 0.0f);
    const float spdMb = sb * wM, spdPb = sb - spdMb;

    const float d1 = w.dfb.a[i], d2 = w.dfb.b[i], d3 = w.dfb.c[i];
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
    w.tM.a[i] = hMb; w.tM.b[i] = huMb; w.tM.c[i] = hvMb;
    w.tP.a[i] = hPb; w.tP.b[i] = huPb; w.tP.c[i] = hvPb;
  }
  __syncthreads();

  // gather transpose: every volume node sums the trace nodes that read it
  for (int v = tid; v < o.nV; v += nth) {
    float a = Aout.a[v], b = Aout.b[v], c = Aout.c[v];
    for (int q = o.invM_ptr[v]; q < o.invM_ptr[v + 1]; ++q) {
      const int i = o.invM_idx[q];
      a += w.tM.a[i]; b += w.tM.b[i]; c += w.tM.c[i];
    }
    for (int q = o.invP_ptr[v]; q < o.invP_ptr[v + 1]; ++q) {
      const int i = o.invP_idx[q];
      a += w.tP.a[i]; b += w.tP.b[i]; c += w.tP.c[i];
    }
    Aout.a[v] = a; Aout.b[v] = b; Aout.c[v] = c;
  }
  __syncthreads();
}

static size_t bwd_smem_floats(const Ops& o, int threads) {
  // S, S1, L, Wb, A, Bv, wf, r, vflux: 27 nV; trace scratch 11 nT (the
  // forward's 7 nT lies inside it); control partial sums
  return (size_t)27 * o.nV + (size_t)11 * o.nT + (size_t)o.n_ctrl * threads;
}

__global__ void sw2d_rollout_bwd_kernel(
    Ops o, const float* __restrict__ th, const float* __restrict__ thu,
    const float* __restrict__ thv, const float* __restrict__ tbh,
    const float* __restrict__ tbhu, const float* __restrict__ tbhv,
    const float* __restrict__ ctrls, float* __restrict__ xbh,
    float* __restrict__ xbhu, float* __restrict__ xbhv,
    float* __restrict__ cbar, int n_ctrl_steps, int spc, float dt, float t0,
    int use_filter) {
  float* p = smem;
  const Vec3 S = carve(p, o.nV), S1 = carve(p, o.nV), L = carve(p, o.nV);
  const Vec3 Wb = carve(p, o.nV), A = carve(p, o.nV), Bv = carve(p, o.nV);
  BwdScratch bw;
  bw.wf = carve(p, o.nV);
  FwdScratch fw;
  fw.r = carve(p, o.nV);
  fw.vflux = carve(p, o.nV);
  // trace scratch, shared by the forward recompute and the adjoint
  float* q = p;
  fw.pre = carve(q, o.nT); fw.dq = carve(q, o.nT); fw.spd = q;
  bw.dfb = carve(p, o.nT);
  bw.tM = carve(p, o.nT);
  bw.tP = carve(p, o.nT);
  bw.spd = p; p += o.nT;
  bw.lamb = p; p += o.nT;
  float* cpart = p;

  const int tid = threadIdx.x, nth = blockDim.x;
  const int n_steps = n_ctrl_steps * spc;
  const size_t row = (size_t)blockIdx.x * o.nV;
  const size_t trow = (size_t)blockIdx.x * (n_steps + 1) * o.nV;
  const size_t crow = (size_t)blockIdx.x * n_ctrl_steps * o.n_ctrl;

  for (int v = tid; v < o.nV; v += nth) { L.a[v] = 0; L.b[v] = 0; L.c[v] = 0; }
  for (int c = 0; c < o.n_ctrl; ++c) cpart[c * nth + tid] = 0.0f;

  for (int t = n_steps - 1; t >= 0; --t) {
    const size_t off = trow + (size_t)t * o.nV;
    for (int v = tid; v < o.nV; v += nth) {
      S.a[v] = th[off + v]; S.b[v] = thu[off + v]; S.c[v] = thv[off + v];
      // inject the cotangent of the stored state s_{t+1}
      Wb.a[v] = L.a[v] + tbh[off + o.nV + v];
      Wb.b[v] = L.b[v] + tbhu[off + o.nV + v];
      Wb.c[v] = L.c[v] + tbhv[off + o.nV + v];
    }
    __syncthreads();
    const int j = t / spc;
    const float* ctrl = ctrls + crow + (size_t)j * o.n_ctrl;
    const float tt = t0 + (float)t * dt;
    // recompute stage 1 (A is free until the first product below)
    eval_rhs(o, S, tt, ctrl, use_filter, fw, A);
    axpy3(o, S1, S, 0.5f * dt, A);
    // a = VJP_R(s_half)[dt * lambda];  b = VJP_R(s_t)[dt/2 * a]
    eval_rhs_vjp(o, S1, tt + 0.5f * dt, Wb, dt, use_filter, bw, A, cpart);
    eval_rhs_vjp(o, S, tt, A, 0.5f * dt, use_filter, bw, Bv, cpart);
    for (int v = tid; v < o.nV; v += nth) {
      L.a[v] = Wb.a[v] + A.a[v] + Bv.a[v];
      L.b[v] = Wb.b[v] + A.b[v] + Bv.b[v];
      L.c[v] = Wb.c[v] + A.c[v] + Bv.c[v];
    }
    __syncthreads();
    if (t % spc == 0) {  // first step of control block j: its sum is complete
      if (tid < 32) {
        for (int c = 0; c < o.n_ctrl; ++c) {
          float s = 0.0f;
          for (int k = tid; k < nth; k += 32) s += cpart[c * nth + k];
          for (int d = 16; d > 0; d >>= 1)
            s += __shfl_down_sync(0xffffffffu, s, d);
          if (tid == 0) cbar[crow + (size_t)j * o.n_ctrl + c] = s;
        }
      }
      __syncthreads();
      for (int c = 0; c < o.n_ctrl; ++c) cpart[c * nth + tid] = 0.0f;
    }
  }
  // initial-state adjoint: lambda + cotangent of the stored initial state
  for (int v = tid; v < o.nV; v += nth) {
    xbh[row + v] = L.a[v] + tbh[trow + v];
    xbhu[row + v] = L.b[v] + tbhu[trow + v];
    xbhv[row + v] = L.c[v] + tbhv[trow + v];
  }
}

// ---------------------------------------------------------------------------
// C interface
// ---------------------------------------------------------------------------

template <typename Kern>
static int prepare(Kern kern, size_t bytes) {
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

extern "C" {

// Bytes of dynamic shared memory one block needs: which = 0 step/rollout,
// 1 backward.
long long sw2d_smem_bytes(const SwDesc* d, int which, int threads) {
  Ops o = make_ops(*d, nullptr, nullptr);
  const size_t n = which == 0 ? fwd_smem_floats(o) : bwd_smem_floats(o, threads);
  return (long long)(n * sizeof(float));
}

int sw2d_step(const SwDesc* d, const float* fops, const int* iops,
              const float* h, const float* hu, const float* hv,
              const float* ctrl, float* oh, float* ohu, float* ohv, int B,
              float dt, float t0, int use_filter, int threads, void* stream) {
  Ops o = make_ops(*d, fops, iops);
  const size_t bytes = fwd_smem_floats(o) * sizeof(float);
  int e = prepare(sw2d_step_kernel, bytes);
  if (e) return e;
  sw2d_step_kernel<<<B, threads, bytes, (cudaStream_t)stream>>>(
      o, h, hu, hv, ctrl, oh, ohu, ohv, dt, t0, use_filter);
  return (int)cudaGetLastError();
}

int sw2d_rollout(const SwDesc* d, const float* fops, const int* iops,
                 const float* h, const float* hu, const float* hv,
                 const float* ctrls, float* th, float* thu, float* thv, int B,
                 int n_ctrl_steps, int spc, float dt, float t0, int use_filter,
                 int threads, void* stream) {
  Ops o = make_ops(*d, fops, iops);
  const size_t bytes = fwd_smem_floats(o) * sizeof(float);
  int e = prepare(sw2d_rollout_kernel, bytes);
  if (e) return e;
  sw2d_rollout_kernel<<<B, threads, bytes, (cudaStream_t)stream>>>(
      o, h, hu, hv, ctrls, th, thu, thv, n_ctrl_steps, spc, dt, t0,
      use_filter);
  return (int)cudaGetLastError();
}

int sw2d_rollout_bwd(const SwDesc* d, const float* fops, const int* iops,
                     const float* th, const float* thu, const float* thv,
                     const float* tbh, const float* tbhu, const float* tbhv,
                     const float* ctrls, float* xbh, float* xbhu, float* xbhv,
                     float* cbar, int B, int n_ctrl_steps, int spc, float dt,
                     float t0, int use_filter, int threads, void* stream) {
  Ops o = make_ops(*d, fops, iops);
  const size_t bytes = bwd_smem_floats(o, threads) * sizeof(float);
  int e = prepare(sw2d_rollout_bwd_kernel, bytes);
  if (e) return e;
  sw2d_rollout_bwd_kernel<<<B, threads, bytes, (cudaStream_t)stream>>>(
      o, th, thu, thv, tbh, tbhu, tbhv, ctrls, xbh, xbhu, xbhv, cbar,
      n_ctrl_steps, spc, dt, t0, use_filter);
  return (int)cudaGetLastError();
}

}  // extern "C"
