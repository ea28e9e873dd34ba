// Curved weak-form shallow-water kernels (cubature volume integrals, Gauss
// face fluxes, per-element mass inverses, four fields), sm_90a.
//
//   sw2d_curved_step_kernel         one SSP-RK2 (midpoint) step
//   sw2d_curved_rollout_kernel      n_steps steps, optional stored trajectory
//   sw2d_curved_rollout_bwd_kernel  the reverse (adjoint) sweep
//
// They replace the Pallas TPU kernels _step_kernel, _rollout_kernel and
// _rollout_bwd_kernel of blitzdg_tpu/ops/sw2d_curved_blocked.py. Those pack
// one scenario's mesh as (p, NP, M), stack the four fields on the lane axis,
// apply every reference operator as kron(I_p, Op) and exchange Gauss traces
// through roll-combination tables. None of that is carried over: states are
// (B, K*Np) per field and the work unit is (scenario, chunk of E elements),
// as in sw2d_blocked.cu. A block keeps the six reference operators (cubature
// interpolation V, weak Dr^T and Ds^T, Gauss interpolation GI, filter,
// V V^T) and its chunk's nodal state, cubature terms and Gauss fluxes in
// shared memory. Every product of the RHS is a short FMA loop of one thread:
//   cubature point  <- V row . nodal values            (Np FMAs a field)
//   Gauss point     <- GI row . nodal values           (Np FMAs a field)
//   nodal value     <- Dr^T, Ds^T rows . cubature terms, GI column . fluxes
//   nodal value     <- mass inverse row, then filter row
//
// The '+' value at a Gauss point is an INTERPOLATED neighbour value. Forward,
// a thread recomputes it from the neighbour's nodal values in the stage's
// input in global memory (Np FMAs a field, the same loop that gave the
// neighbour its own '-' value, so both sides see the same bits). That costs
// about a tenth of a stage's arithmetic and saves a grid barrier and a
// (B, nT, 4) round trip per stage: a stage depends on the previous stage of
// the whole grid and on nothing else, as in sw2d_blocked.cu. One persistent
// cooperative launch per call, 2 grid barriers per step.
//
// Adjoint (derived by hand; tensor-code twin and its test against autograd:
// ops/sw2d_curved_blocked.py). The transposed '+' gather crosses blocks and
// the neighbour's cotangent cannot be recomputed locally (it hangs on the
// neighbour's incoming cotangent through its mass inverse and filter), so
// each RHS adjoint runs in two phases around a grid barrier: the first
// writes, per Gauss point, the cotangents of its '-' and '+' values to a
// global (B, nT, 8) scratch; the second sums, per Gauss point, its own row
// and the rows of the points that read it (inverse CSR map of mapP) into
// shared memory and applies GI^T from there. 3 barriers per step. No float
// atomics: a rerun gives the same bits. Control cotangents are summed per
// work unit and reduced over the chunks in a fixed order at the end. A
// cotangent trajectory may be a null pointer (nothing used that field): read
// as zero.
//
// Bound on the card: float32 operations (8 nV floats of traffic per step
// against some two thousand operations per node). What the kernels wait for
// is, as in sw2d_blocked.cu, latency of the short dependent loops and the
// block barriers between a stage's six passes. Three things that each cost a
// factor of 1.4 to 2 when they were wrong (PERF.md): the nodal passes run
// over (field, node) pairs, so a chunk holds as many elements as give
// 4 E Np <= blockDim; nothing is indexed by a run-time field number except
// through a base pointer and a stride (Sh4) or selects (pick), because a
// pointer table indexed at run time is put into local memory; and the
// kernels are instantiated for the sizes of N=3 (Sizes: the short loops
// unroll and the index divisions have constant divisors) beside one
// instantiation that reads the sizes at run time, for every other order.
//
// Plain C interface (extern "C" at the end), loaded with ctypes. Launches go
// to the stream that is passed in; nothing here synchronises or allocates.

#include "sw2d_common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

extern __shared__ float smem[];

#define NF 4  // h, hu, hv, hN
// Largest block the kernels are compiled for (THREADS of the wrappers), and
// the blocks per SM the register budget is cut to: 64 registers a thread,
// which ptxas meets without spills; measured 6-8 % faster than 3 a SM.
#define MAX_THREADS 256
#define BLOCKS_PER_SM 4

// Mirror of _CurvedDesc in ops/sw2d_curved_blocked.py.
struct CurvedDesc {
  int K, Np, Ncub, NG, n_ctrl;
  int affine, has_bed;
  float g, cd, fcor;
};

struct COps {
  const float *V, *DrT, *DsT, *GI, *filt, *VVT;  // reference operators
  const float *WRX, *WRY, *WSX, *WSY;            // (K*Ncub)
  const float *GNX, *GNY, *GW, *WALL;            // (K*NT)
  const float *INVJ;                             // (K)
  const float *MINV;                             // (K, Np, Np), general mode
  const float *ZX, *ZY;                          // (nV)
  const float *BU, *BV;                          // (n_ctrl, nV)
  const int *mapP, *invP_ptr, *invP_idx;
  int K, Np, Ncub, NG, NT, nV, nT, n_ctrl, affine, has_bed;
  float g, cd, fcor;
};

// The packed operator buffers: the order here is the order in which
// build_curved_blocked_ops packs them (_FORDER).
static COps make_cops(const CurvedDesc& d, const float* f, const int* i) {
  COps o;
  o.K = d.K; o.Np = d.Np; o.Ncub = d.Ncub; o.NG = d.NG; o.NT = 3 * d.NG;
  o.nV = d.K * d.Np; o.nT = d.K * o.NT; o.n_ctrl = d.n_ctrl;
  o.affine = d.affine; o.has_bed = d.has_bed;
  o.g = d.g; o.cd = d.cd; o.fcor = d.fcor;
  const int np2 = d.Np * d.Np, nc = d.Ncub * d.Np, nC = d.K * d.Ncub;
  o.V = f; f += nc;  o.DrT = f; f += nc;  o.DsT = f; f += nc;
  o.GI = f; f += o.NT * d.Np;
  o.filt = f; f += np2;  o.VVT = f; f += np2;
  o.WRX = f; f += nC;  o.WRY = f; f += nC;
  o.WSX = f; f += nC;  o.WSY = f; f += nC;
  o.GNX = f; f += o.nT;  o.GNY = f; f += o.nT;
  o.GW = f; f += o.nT;  o.WALL = f; f += o.nT;
  o.INVJ = f; f += d.K;
  o.MINV = f; f += d.affine ? 0 : d.K * np2;
  o.ZX = f; f += o.nV;  o.ZY = f; f += o.nV;
  o.BU = f; f += d.n_ctrl * o.nV;
  o.BV = f; f += d.n_ctrl * o.nV;
  o.mapP = i; i += o.nT;
  o.invP_ptr = i; i += o.nT + 1;
  o.invP_idx = i;
  return o;
}

// Nodes, cubature points and Gauss points per face of one element: constants
// of the instantiation where the template gives them (loops unroll, index
// divisions become multiplications), else read from the operator set.
template <int NP, int NCUB, int NGP>
struct Sizes {
  __device__ __forceinline__ static int Np(const COps& o) {
    return NP ? NP : o.Np;
  }
  __device__ __forceinline__ static int Ncub(const COps& o) {
    return NCUB ? NCUB : o.Ncub;
  }
  __device__ __forceinline__ static int NG(const COps& o) {
    return NGP ? NGP : o.NG;
  }
};
typedef Sizes<0, 0, 0> AnyOrder;
// N=3 with its order-12 cubature and 8 Gauss points a face: the order of
// the MPC configurations.
typedef Sizes<10, 34, 8> Order3;

static bool is_order3(const CurvedDesc& d) {
  return d.Np == 10 && d.Ncub == 34 && d.NG == 8;
}

struct P4 { const float* f[NF]; };
struct W4 { float* f[NF]; };

__device__ __forceinline__ P4 at4(const float* const* p, size_t off) {
  P4 r;
  #pragma unroll
  for (int i = 0; i < NF; ++i)
    r.f[i] = p[i] == nullptr ? nullptr : p[i] + off;
  return r;
}

__device__ __forceinline__ W4 atw4(float* const* p, size_t off) {
  W4 r;
  #pragma unroll
  for (int i = 0; i < NF; ++i)
    r.f[i] = p[i] == nullptr ? nullptr : p[i] + off;
  return r;
}

// The four fields of one (B, nV)-per-field scratch buffer, scenario b.
__device__ __forceinline__ W4 fields_of(float* base, size_t fs, size_t off) {
  W4 r;
  #pragma unroll
  for (int i = 0; i < NF; ++i) r.f[i] = base + i * fs + off;
  return r;
}

// The field pointer for an index known only at run time, by selects: a
// dynamically indexed pointer array would be put into local memory.
__device__ __forceinline__ const float* pick(const P4& p, int f) {
  return f == 0 ? p.f[0] : f == 1 ? p.f[1] : f == 2 ? p.f[2] : p.f[3];
}

__device__ __forceinline__ float* pick(const W4& p, int f) {
  return f == 0 ? p.f[0] : f == 1 ? p.f[1] : f == 2 ? p.f[2] : p.f[3];
}

// Four fields of n floats each, one behind the other, in shared memory.
struct Sh4 {
  float* p;
  int n;
  __device__ __forceinline__ float* f(int i) const { return p + i * n; }
};

__device__ __forceinline__ P4 readonly(const W4& w) {
  P4 r;
  #pragma unroll
  for (int i = 0; i < NF; ++i) r.f[i] = w.f[i];
  return r;
}

// Per-unit scratch in shared memory; EN = E*Np, EC = E*Ncub, ET = E*NT
// floats per field.
struct CScratch {
  Sh4 S;    // the chunk's nodal state
  Sh4 A;    // forward: mass-weighted RHS | adjoint: scaled cotangent, then
            //                              its mass-inverse transpose
  Sh4 Bn;   // forward: unfiltered RHS    | adjoint: filter^T cotangent
  Sh4 TR;   // forward: W (rx F + ry G)   | adjoint: cubature cotangents
  Sh4 TS;   // forward: W (sx F + sy G)
  Sh4 pre;  // forward: central flux, then the weighted flux | adjoint: e_i
  Sh4 dq;   // forward: jumps qM - qP     | adjoint: '-' Gauss values
  Sh4 Pv;   //                              adjoint: '+' Gauss values
  float *spd, *lamb, *wM;  // per Gauss point
  float* red;              // 32: block reduction
};

static size_t cop_floats(const COps& o) {
  return (size_t)3 * o.Ncub * o.Np + (size_t)o.NT * o.Np
         + (size_t)2 * o.Np * o.Np;
}

static size_t csmem_floats(const COps& o, int E) {
  return cop_floats(o) + (size_t)12 * E * o.Np + (size_t)8 * E * o.Ncub
         + (size_t)15 * E * o.NT + 32;
}

__device__ __forceinline__ Sh4 carve4(float*& p, int n) {
  Sh4 v;
  v.p = p; v.n = n; p += NF * n;
  return v;
}

// Copy the reference-element operators to shared memory, point the operator
// set at the copies and carve the per-unit scratch behind them.
__device__ CScratch setup_cblock(COps& o, int E) {
  const int np2 = o.Np * o.Np, nc = o.Ncub * o.Np, ng = o.NT * o.Np;
  float* p = smem;
  float *sV = p, *sDr = p + nc, *sDs = p + 2 * nc, *sG = p + 3 * nc;
  float *sF = sG + ng, *sM = sF + np2;
  p = sM + np2;
  for (int i = threadIdx.x; i < nc; i += blockDim.x) {
    sV[i] = o.V[i]; sDr[i] = o.DrT[i]; sDs[i] = o.DsT[i];
  }
  for (int i = threadIdx.x; i < ng; i += blockDim.x) sG[i] = o.GI[i];
  for (int i = threadIdx.x; i < np2; i += blockDim.x) {
    sF[i] = o.filt[i]; sM[i] = o.VVT[i];
  }
  o.V = sV; o.DrT = sDr; o.DsT = sDs; o.GI = sG; o.filt = sF; o.VVT = sM;
  CScratch s;
  const int EN = E * o.Np, EC = E * o.Ncub, ET = E * o.NT;
  s.S = carve4(p, EN); s.A = carve4(p, EN); s.Bn = carve4(p, EN);
  s.TR = carve4(p, EC); s.TS = carve4(p, EC);
  s.pre = carve4(p, ET); s.dq = carve4(p, ET); s.Pv = carve4(p, ET);
  s.spd = p; p += ET;
  s.lamb = p; p += ET;
  s.wM = p; p += ET;
  s.red = p;
  __syncthreads();
  return s;
}

// ---------------------------------------------------------------------------
// Pointwise formulas of the four-field system
// ---------------------------------------------------------------------------

// F and G at point values q = (h, hu, hv, hN).
__device__ __forceinline__ void fluxes4(float g, const float* q, float* F,
                                        float* G) {
  const float inv = 1.0f / q[0], u = q[1] * inv, v = q[2] * inv;
  const float pr = 0.5f * g * q[0] * q[0];
  F[0] = q[1]; F[1] = q[1] * u + pr; F[2] = q[1] * v; F[3] = q[3] * u;
  G[0] = q[2]; G[1] = q[1] * v; G[2] = q[2] * v + pr; G[3] = q[3] * v;
}

// Cotangent of q from the cotangents of F(q) and G(q).
__device__ __forceinline__ void fluxes4_vjp(float g, const float* q,
                                            const float* Fb, const float* Gb,
                                            float* qb) {
  const float inv = 1.0f / q[0];
  const float u = q[1] * inv, v = q[2] * inv, c = q[3] * inv;
  const float w23 = Fb[2] + Gb[1], t4 = u * Fb[3] + v * Gb[3];
  qb[1] = Fb[0] + 2.0f * u * Fb[1] + v * w23 + c * Fb[3];
  qb[2] = Gb[0] + 2.0f * v * Gb[2] + u * w23 + c * Gb[3];
  qb[0] = (g * q[0] - u * u) * Fb[1] + (g * q[0] - v * v) * Gb[2]
          - u * v * w23 - c * t4;
  qb[3] = t4;
}

__device__ __forceinline__ float speed4(float g, const float* q) {
  return safe_norm(q[1] / q[0], q[2] / q[0]) + sqrtf(g * q[0]);
}

// Adds the cotangent of |(u, v)| + sqrt(g h) to qb[0..2].
__device__ __forceinline__ void speed4_vjp(float g, const float* q,
                                           float sbar, float* qb) {
  const float h = q[0], u = q[1] / h, v = q[2] / h;
  const float nrm = safe_norm(u, v);
  qb[0] += sbar * (0.5f * sqrtf(g / h) - nrm / h);
  if (nrm > 0.0f) {
    qb[1] += sbar * u / nrm / h;
    qb[2] += sbar * v / nrm / h;
  }
}

// '-' and '+' values of the four fields at Gauss point j of local element k
// (global Gauss point i), the wall reflection applied. S: the chunk's nodal
// state in shared memory; in: the scenario's whole state in global memory,
// from which the neighbour's value is interpolated.
template <class Z>
__device__ __forceinline__ void gauss_values(const COps& o, const Sh4& S,
                                             const P4& in, int k, int j, int i,
                                             float* M, float* P, float& nx,
                                             float& ny, bool& wall) {
  const int Np = Z::Np(o), NT = 3 * Z::NG(o);
  const float* gi = o.GI + j * Np;
  #pragma unroll
  for (int f = 0; f < NF; ++f) {
    float a = 0.0f;
    for (int n = 0; n < Np; ++n) a += gi[n] * S.f(f)[k * Np + n];
    M[f] = a;
  }
  const int p = o.mapP[i];
  if (p == i) {  // boundary point
    #pragma unroll
    for (int f = 0; f < NF; ++f) P[f] = M[f];
  } else {
    const int k2 = p / NT, j2 = p - k2 * NT;
    const float* gp = o.GI + j2 * Np;
    #pragma unroll
    for (int f = 0; f < NF; ++f) {
      const float* src = in.f[f] + (size_t)k2 * Np;
      float a = 0.0f;
      for (int n = 0; n < Np; ++n) a += gp[n] * src[n];
      P[f] = a;
    }
  }
  nx = o.GNX[i]; ny = o.GNY[i];
  wall = o.WALL[i] != 0.0f;
  if (wall) {  // reflect the normal momentum
    const float un2 = 2.0f * (M[1] * nx + M[2] * ny);
    P[1] = M[1] - un2 * nx;
    P[2] = M[2] - un2 * ny;
  }
}

// Coriolis, drag and bed slope of field f (1: hu, 2: hv) at volume node v.
__device__ __forceinline__ float source4(const COps& o, int f, int v, float h,
                                         float hu, float hv) {
  float r = 0.0f;
  if (o.cd != 0.0f || o.fcor != 0.0f) {
    const float u = hu / h, vv = hv / h;
    const float cdn = o.cd * safe_norm(u, vv);
    r = f == 1 ? o.fcor * hv - cdn * u : -o.fcor * hu - cdn * vv;
  }
  if (o.has_bed) r -= o.g * h * (f == 1 ? o.ZX[v] : o.ZY[v]);
  return r;
}

// Cotangent of field f (0: h, 1: hu, 2: hv) at volume node v from the
// sources, given the cotangents w2, w3 of the two momentum equations.
__device__ __forceinline__ float source4_vjp(const COps& o, int f, int v,
                                             float h, float hu, float hv,
                                             float w2, float w3) {
  float r = 0.0f;
  if (o.cd != 0.0f || o.fcor != 0.0f) {
    const float inv = 1.0f / h, u = hu * inv, vv = hv * inv;
    const float nrm = safe_norm(u, vv);
    float ub = 0.0f, vb = 0.0f;
    if (nrm > 0.0f) {
      const float a2 = -o.cd * w2, a3 = -o.cd * w3, in = 1.0f / nrm;
      ub = a2 * (nrm + u * u * in) + a3 * (u * vv * in);
      vb = a2 * (u * vv * in) + a3 * (nrm + vv * vv * in);
    }
    if (f == 0) r = -(ub * u + vb * vv) * inv;
    else if (f == 1) r = ub * inv - o.fcor * w3;
    else r = vb * inv + o.fcor * w2;
  }
  if (o.has_bed && f == 0) r -= o.g * (o.ZX[v] * w2 + o.ZY[v] * w3);
  return r;
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// One RK stage of one work unit (elements e0 .. e0+ne of one scenario):
//   out = base + coef * R(in) on the unit's own nodes.
// in: the scenario's whole stage input in global memory (neighbours are read
// from it); base, out: the scenario's fields, touched at own nodes only (they
// may be the same buffer); copy: where to store the unit's part of `in` as
// well, or null pointers.
template <class Z>
__device__ void cstage(const COps& o, const CScratch& s, int e0, int ne,
                       const P4& in, const P4& base, const W4& out,
                       const W4& copy, float coef, const float* ctrl,
                       int use_filter) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int Np = Z::Np(o), Ncub = Z::Ncub(o), NG = Z::NG(o), NT = 3 * NG;
  const int nl = ne * Np, cl = ne * Ncub, tl = ne * NT;
  const int v0 = e0 * Np, c0 = e0 * Ncub, i0 = e0 * NT;
  const float g = o.g;

  for (int l = tid; l < nl; l += nth) {
    #pragma unroll
    for (int f = 0; f < NF; ++f) {
      const float x = in.f[f][v0 + l];
      s.S.f(f)[l] = x;
      if (copy.f[0] != nullptr) copy.f[f][v0 + l] = x;
    }
  }
  __syncthreads();

  // volume: interpolate to the cubature points, weighted fluxes
  for (int l = tid; l < cl; l += nth) {
    const int k = l / Ncub, c = l - k * Ncub;
    const float* vr = o.V + c * Np;
    float q[NF] = {0.0f, 0.0f, 0.0f, 0.0f}, F[NF], G[NF];
    for (int n = 0; n < Np; ++n) {
      const float w = vr[n];
      #pragma unroll
      for (int f = 0; f < NF; ++f) q[f] += w * s.S.f(f)[k * Np + n];
    }
    fluxes4(g, q, F, G);
    const float wrx = o.WRX[c0 + l], wry = o.WRY[c0 + l];
    const float wsx = o.WSX[c0 + l], wsy = o.WSY[c0 + l];
    #pragma unroll
    for (int f = 0; f < NF; ++f) {
      s.TR.f(f)[l] = wrx * F[f] + wry * G[f];
      s.TS.f(f)[l] = wsx * F[f] + wsy * G[f];
    }
  }
  // surface: Gauss values, central flux, jumps, speeds
  for (int l = tid; l < tl; l += nth) {
    const int k = l / NT, j = l - k * NT;
    float M[NF], P[NF], FM[NF], GM[NF], FP[NF], GP[NF], nx, ny;
    bool wall;
    gauss_values<Z>(o, s.S, in, k, j, i0 + l, M, P, nx, ny, wall);
    fluxes4(g, M, FM, GM);
    fluxes4(g, P, FP, GP);
    #pragma unroll
    for (int f = 0; f < NF; ++f) {
      s.pre.f(f)[l] = 0.5f * ((FM[f] + FP[f]) * nx + (GM[f] + GP[f]) * ny);
      s.dq.f(f)[l] = M[f] - P[f];
    }
    s.spd[l] = fmaxf(speed4(g, M), speed4(g, P));
  }
  __syncthreads();

  // per-face maximum speed (a face lies inside one element), weighted flux
  for (int l = tid; l < tl; l += nth) {
    const int f0 = (l / NG) * NG;
    float lam = s.spd[f0];
    for (int j = 1; j < NG; ++j) lam = fmaxf(lam, s.spd[f0 + j]);
    const float gw = o.GW[i0 + l], hl = 0.5f * lam;
    #pragma unroll
    for (int f = 0; f < NF; ++f)
      s.pre.f(f)[l] = gw * (s.pre.f(f)[l] + hl * s.dq.f(f)[l]);
  }
  __syncthreads();

  // weak divergence minus the lifted fluxes, per (field, node)
  for (int l = tid; l < NF * nl; l += nth) {
    const int f = l / nl, r = l - f * nl, k = r / Np, n = r - k * Np;
    const float *dr = o.DrT + n * Ncub, *ds = o.DsT + n * Ncub;
    const float *tr = s.TR.f(f) + k * Ncub, *ts = s.TS.f(f) + k * Ncub;
    float a = 0.0f;
    for (int c = 0; c < Ncub; ++c) a += dr[c] * tr[c] + ds[c] * ts[c];
    const float* fl = s.pre.f(f) + k * NT;
    for (int j = 0; j < NT; ++j) a -= o.GI[j * Np + n] * fl[j];
    s.A.f(f)[r] = a;
  }
  __syncthreads();

  // per-element mass inverse, nodal sources
  for (int l = tid; l < NF * nl; l += nth) {
    const int f = l / nl, r = l - f * nl, k = r / Np, n = r - k * Np;
    const float* mm = s.A.f(f) + k * Np;
    float a = 0.0f;
    if (o.affine) {
      for (int m = 0; m < Np; ++m) a += o.VVT[n * Np + m] * mm[m];
      a *= o.INVJ[e0 + k];
    } else {
      const float* mi = o.MINV + ((size_t)(e0 + k) * Np + n) * Np;
      for (int m = 0; m < Np; ++m) a += mi[m] * mm[m];
    }
    if (f == 1 || f == 2)
      a += source4(o, f, v0 + r, s.S.f(0)[r], s.S.f(1)[r], s.S.f(2)[r]);
    s.Bn.f(f)[r] = a;
  }
  __syncthreads();

  // modal filter, control forcing, stage update
  for (int l = tid; l < NF * nl; l += nth) {
    const int f = l / nl, r = l - f * nl, k = r / Np, n = r - k * Np;
    const int v = v0 + r;
    float a;
    if (use_filter) {
      const float* rr = s.Bn.f(f) + k * Np;
      a = 0.0f;
      for (int m = 0; m < Np; ++m) a += o.filt[n * Np + m] * rr[m];
    } else {
      a = s.Bn.f(f)[r];
    }
    if (ctrl != nullptr && (f == 1 || f == 2)) {
      const float* inj = f == 1 ? o.BU : o.BV;
      for (int c = 0; c < o.n_ctrl; ++c) a += ctrl[c] * inj[(size_t)c * o.nV + v];
    }
    pick(out, f)[v] = pick(base, f)[v] + coef * a;
  }
  __syncthreads();  // the scratch is reused by the block's next unit
}

struct CFwdArgs {
  const float* s0[NF];  // (B, nV) initial fields
  const float* ctrls;   // (B, n_cs, n_ctrl) or null
  float* o[NF];         // (B, nV) final fields, the resident state buffer
  float* s1[NF];        // (B, nV) stage scratch
  float* t[NF];         // (B, n_steps+1, nV) trajectories or null
  int B, n_steps, n_cs, spc, E, use_filter;
  float dt;
};

// n_steps SSP-RK2 steps: u1 = u + dt/2 R(u); u <- u + dt R(u1), with a grid
// barrier after each stage.
template <class Z>
__device__ void cforward_body(const COps& og, const CFwdArgs& a) {
  cg::grid_group grid = cg::this_grid();
  COps o = og;
  const CScratch s = setup_cblock(o, a.E);
  const int n_chunks = (o.K + a.E - 1) / a.E, n_units = a.B * n_chunks;
  const size_t nV = (size_t)o.nV, trow = (size_t)(a.n_steps + 1) * nV;
  const bool traj = a.t[0] != nullptr;
  W4 none;
  #pragma unroll
  for (int f = 0; f < NF; ++f) none.f[f] = nullptr;

  for (int t = 0; t < a.n_steps; ++t) {
    for (int phase = 0; phase < 2; ++phase) {
      for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
        const int b = u / n_chunks, c = u - b * n_chunks;
        const int e0 = c * a.E, ne = min(a.E, o.K - e0);
        P4 cur;  // the step-start state
        if (t == 0) cur = at4(a.s0, b * nV);
        else if (traj) cur = at4(a.t, b * trow + t * nV);
        else cur = at4(a.o, b * nV);
        const W4 s1 = atw4(a.s1, b * nV);
        const float* ctrl = a.ctrls == nullptr ? nullptr
            : a.ctrls + ((size_t)b * a.n_cs + t / a.spc) * o.n_ctrl;
        if (phase == 0) {
          const W4 row0 = (traj && t == 0) ? atw4(a.t, b * trow) : none;
          cstage<Z>(o, s, e0, ne, cur, cur, s1, row0, 0.5f * a.dt, ctrl,
                 a.use_filter);
        } else {
          const W4 nxt = traj ? atw4(a.t, b * trow + (t + 1) * nV)
                              : atw4(a.o, b * nV);
          cstage<Z>(o, s, e0, ne, readonly(s1), cur, nxt, none, a.dt, ctrl,
                 a.use_filter);
        }
      }
      grid.sync();
    }
  }
}

template <class Z>
__global__ void __launch_bounds__(MAX_THREADS, BLOCKS_PER_SM)
sw2d_curved_step_kernel(COps o, CFwdArgs a) {
  cforward_body<Z>(o, a);
}

template <class Z>
__global__ void __launch_bounds__(MAX_THREADS, BLOCKS_PER_SM)
sw2d_curved_rollout_kernel(COps o, CFwdArgs a) {
  cforward_body<Z>(o, a);
}

// ---------------------------------------------------------------------------
// Adjoint
// ---------------------------------------------------------------------------

// Transposed '+' gather for one work unit: the cotangent of every Gauss
// point's interpolated value, into s.pre. It is what the point wrote for its
// own '-' value (slots 0..3) plus what every point that reads it as its '+'
// value wrote (slots 4..7). T: one scenario's (nT, 8) scratch, 32-byte rows.
template <class Z>
__device__ __forceinline__ void gather_gauss(const COps& o, const CScratch& s,
                                             const float* T, int e0, int ne) {
  const int NT = 3 * Z::NG(o), tl = ne * NT, i0 = e0 * NT;
  const float4* T4 = reinterpret_cast<const float4*>(T);
  for (int l = threadIdx.x; l < tl; l += blockDim.x) {
    const int i = i0 + l;
    float4 t = T4[(size_t)i * 2];
    for (int q = o.invP_ptr[i]; q < o.invP_ptr[i + 1]; ++q) {
      const float4 p = T4[(size_t)o.invP_idx[q] * 2 + 1];
      t.x += p.x; t.y += p.y; t.z += p.z; t.w += p.w;
    }
    s.pre.f(0)[l] = t.x; s.pre.f(1)[l] = t.y;
    s.pre.f(2)[l] = t.z; s.pre.f(3)[l] = t.w;
  }
  __syncthreads();
}

// Transposed Gauss interpolation at node n of local element k, field f, of
// the cotangents that gather_gauss left in s.pre.
template <class Z>
__device__ __forceinline__ float lift_gathered(const COps& o,
                                               const CScratch& s, int k, int n,
                                               int f) {
  const int Np = Z::Np(o), NT = 3 * Z::NG(o);
  const float* t = s.pre.f(f) + k * NT;
  float a = 0.0f;
  for (int j = 0; j < NT; ++j) a += o.GI[j * Np + n] * t[j];
  return a;
}

// First phase of the vector-Jacobian product of the filtered, control-forced
// RHS at state S for one work unit, against the cotangent scale * W. It
//   adds  d/d ctrl_c  to cpart[c],
//   writes the volume and source part of J_R(S)^T (scale W) to Avol at the
//   unit's nodes,
//   writes the cotangents of the unit's Gauss values to T (nT, 8).
// The product is complete once every volume node has gathered its element's
// entries of T (gather_gauss), after a grid barrier.
// S: the scenario's whole state (global); W, Avol: the scenario's fields,
// touched at own nodes only.
template <class Z>
__device__ void cvjp_phase(const COps& o, const CScratch& s, int e0, int ne,
                           const P4& S, const P4& W, float scale,
                           int use_filter, const W4& Avol, float* T,
                           float* cpart) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int Np = Z::Np(o), Ncub = Z::Ncub(o), NG = Z::NG(o), NT = 3 * NG;
  const int nl = ne * Np, cl = ne * Ncub, tl = ne * NT;
  const int v0 = e0 * Np, c0 = e0 * Ncub, i0 = e0 * NT;
  const float g = o.g;

  for (int l = tid; l < nl; l += nth) {
    #pragma unroll
    for (int f = 0; f < NF; ++f) {
      s.S.f(f)[l] = S.f[f][v0 + l];
      s.A.f(f)[l] = W.f[f][v0 + l] * scale;
    }
  }
  __syncthreads();
  // the control enters after the filter: its cotangent is the product of
  // the incoming momentum cotangents with the (folded) injectors
  for (int cc = 0; cc < o.n_ctrl; ++cc) {
    float part = 0.0f;
    for (int l = tid; l < nl; l += nth)
      part += o.BU[(size_t)cc * o.nV + v0 + l] * s.A.f(1)[l]
              + o.BV[(size_t)cc * o.nV + v0 + l] * s.A.f(2)[l];
    const float tot = block_sum(part, s.red);
    if (tid == 0) cpart[cc] += tot;
  }
  // filter transpose
  for (int l = tid; l < NF * nl; l += nth) {
    const int f = l / nl, r = l - f * nl, k = r / Np, m = r - k * Np;
    float a;
    if (use_filter) {
      const float* w = s.A.f(f) + k * Np;
      a = 0.0f;
      for (int n = 0; n < Np; ++n) a += o.filt[n * Np + m] * w[n];
    } else {
      a = s.A.f(f)[r];
    }
    s.Bn.f(f)[r] = a;
  }
  __syncthreads();
  // mass inverse transpose
  for (int l = tid; l < NF * nl; l += nth) {
    const int f = l / nl, r = l - f * nl, k = r / Np, m = r - k * Np;
    const float* w = s.Bn.f(f) + k * Np;
    float a = 0.0f;
    if (o.affine) {
      for (int n = 0; n < Np; ++n) a += o.VVT[n * Np + m] * w[n];
      a *= o.INVJ[e0 + k];
    } else {
      const float* mi = o.MINV + (size_t)(e0 + k) * Np * Np + m;
      for (int n = 0; n < Np; ++n) a += mi[n * Np] * w[n];
    }
    s.A.f(f)[r] = a;
  }
  __syncthreads();

  // volume: cotangents of the cubature values
  for (int l = tid; l < cl; l += nth) {
    const int k = l / Ncub, c = l - k * Ncub;
    const float* vr = o.V + c * Np;
    float q[NF] = {0.0f, 0.0f, 0.0f, 0.0f}, Fb[NF], Gb[NF], qb[NF];
    for (int n = 0; n < Np; ++n) {
      const float w = vr[n];
      #pragma unroll
      for (int f = 0; f < NF; ++f) q[f] += w * s.S.f(f)[k * Np + n];
    }
    const float wrx = o.WRX[c0 + l], wry = o.WRY[c0 + l];
    const float wsx = o.WSX[c0 + l], wsy = o.WSY[c0 + l];
    #pragma unroll
    for (int f = 0; f < NF; ++f) {
      const float* mb = s.A.f(f) + k * Np;
      float trb = 0.0f, tsb = 0.0f;
      for (int n = 0; n < Np; ++n) {
        trb += o.DrT[n * Ncub + c] * mb[n];
        tsb += o.DsT[n * Ncub + c] * mb[n];
      }
      Fb[f] = wrx * trb + wsx * tsb;
      Gb[f] = wry * trb + wsy * tsb;
    }
    fluxes4_vjp(g, q, Fb, Gb, qb);
    #pragma unroll
    for (int f = 0; f < NF; ++f) s.TR.f(f)[l] = qb[f];
  }
  // surface, first pass: Gauss values, flux cotangents, speeds and the
  // speed's cotangent
  for (int l = tid; l < tl; l += nth) {
    const int k = l / NT, j = l - k * NT, i = i0 + l;
    float M[NF], P[NF], nx, ny;
    bool wall;
    gauss_values<Z>(o, s.S, S, k, j, i, M, P, nx, ny, wall);
    const float hw = 0.5f * o.GW[i];
    float lb = 0.0f;
    #pragma unroll
    for (int f = 0; f < NF; ++f) {
      const float* mb = s.A.f(f) + k * Np;
      float a = 0.0f;
      for (int n = 0; n < Np; ++n) a += o.GI[j * Np + n] * mb[n];
      const float e = -hw * a;
      s.pre.f(f)[l] = e;
      s.dq.f(f)[l] = M[f];
      s.Pv.f(f)[l] = P[f];
      lb += e * (M[f] - P[f]);
    }
    const float sM = speed4(g, M), sP = speed4(g, P);
    s.spd[l] = fmaxf(sM, sP);
    s.wM[l] = sM > sP ? 1.0f : (sM == sP ? 0.5f : 0.0f);
    s.lamb[l] = lb;
  }
  __syncthreads();
  // surface, second pass: the whole chain rule of the face flux
  for (int l = tid; l < tl; l += nth) {
    const int i = i0 + l;
    float lam;
    // (this point's speed as the first pass stored it, not a recomputed one)
    const float sb = face_speed_share(s.spd, s.lamb, (l / NG) * NG, NG,
                                      s.spd[l], lam);
    const float nx = o.GNX[i], ny = o.GNY[i];
    float M[NF], P[NF], Fe[NF], Ge[NF], Mb[NF], Pb[NF];
    #pragma unroll
    for (int f = 0; f < NF; ++f) {
      M[f] = s.dq.f(f)[l]; P[f] = s.Pv.f(f)[l];
      const float e = s.pre.f(f)[l];
      Fe[f] = e * nx; Ge[f] = e * ny;
    }
    fluxes4_vjp(g, M, Fe, Ge, Mb);
    fluxes4_vjp(g, P, Fe, Ge, Pb);
    #pragma unroll
    for (int f = 0; f < NF; ++f) {
      const float le = lam * s.pre.f(f)[l];
      Mb[f] += le; Pb[f] -= le;
    }
    const float sMb = sb * s.wM[l];
    speed4_vjp(g, M, sMb, Mb);
    speed4_vjp(g, P, sb - sMb, Pb);
    if (o.WALL[i] != 0.0f) {  // reflection: '+' momentum is a map of '-'
      const float unb = -2.0f * (nx * Pb[1] + ny * Pb[2]);
      Mb[1] += Pb[1] + nx * unb;
      Mb[2] += Pb[2] + ny * unb;
      Pb[1] = 0.0f; Pb[2] = 0.0f;
    }
    float* out = T + (size_t)i * 8;
    #pragma unroll
    for (int f = 0; f < NF; ++f) { out[f] = Mb[f]; out[4 + f] = Pb[f]; }
  }
  // volume part at the nodes: cubature interpolation transpose, sources
  for (int l = tid; l < NF * nl; l += nth) {
    const int f = l / nl, r = l - f * nl, k = r / Np, n = r - k * Np;
    const float* cb = s.TR.f(f) + k * Ncub;
    float a = 0.0f;
    for (int c = 0; c < Ncub; ++c) a += o.V[c * Np + n] * cb[c];
    if (f < 3)
      a += source4_vjp(o, f, v0 + r, s.S.f(0)[r], s.S.f(1)[r], s.S.f(2)[r],
                       s.Bn.f(1)[r], s.Bn.f(2)[r]);
    pick(Avol, f)[v0 + r] = a;
  }
  __syncthreads();  // the scratch is reused by the block's next unit
}

struct CBwdArgs {
  const float* t[NF];   // (B, n_steps+1, nV) stored trajectories
  const float* tb[NF];  // their cotangents; null: zero
  const float* ctrls;   // (B, n_cs, n_ctrl)
  float* xb[NF];        // (B, nV) out: initial-state cotangents
  float* cbar;          // (B, n_cs, n_ctrl) out
  // scratch, each (B, nV) per field: stage state, cotangent W of the step's
  // output, g1 = VJP_R(s1)[dt W], volume part of VJP_R(s_t)[dt/2 g1]
  float *s1, *W, *A, *Bv;
  float *T1, *T2;  // (B, nT, 8) Gauss cotangents of the two products
  float* cpart;    // (B, n_chunks, n_cs, n_ctrl) control partial sums
  int B, n_cs, spc, E, use_filter;
  float dt;
};

// Reverse sweep. For each step t (T-1 .. 0), with s_t the stored step-start
// state and lambda the adjoint of s_{t+1}:
//   W      = lambda + tbar_{t+1}
//   s1     = s_t + dt/2 R(s_t)                   (recomputed)
//   g1     = VJP_R(s1)[dt W]
//   lambda = W + g1 + VJP_R(s_t)[dt/2 g1].
// Three phases per step, a grid barrier after each:
//   1. finish the previous step's second product (gather T2), form W,
//      recompute s1;
//   2. first half of the product at s1 (T1, volume part into A);
//   3. gather T1 into A; first half of the product at s_t (T2, Bv).
template <class Z>
__global__ void __launch_bounds__(MAX_THREADS, BLOCKS_PER_SM)
sw2d_curved_rollout_bwd_kernel(COps og, CBwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  COps o = og;
  const int Np = Z::Np(o);
  const CScratch s = setup_cblock(o, a.E);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int n_chunks = (o.K + a.E - 1) / a.E, n_units = a.B * n_chunks;
  const int n_steps = a.n_cs * a.spc;
  const size_t nV = (size_t)o.nV, nT8 = (size_t)o.nT * 8;
  const size_t fs = (size_t)a.B * nV;  // floats per field of a scratch
  const size_t trow = (size_t)(n_steps + 1) * nV;
  const int n_cc = a.n_cs * o.n_ctrl;
  W4 none;
  #pragma unroll
  for (int f = 0; f < NF; ++f) none.f[f] = nullptr;

  for (int u = blockIdx.x; u < n_units; u += gridDim.x)
    for (int k = tid; k < n_cc; k += nth) a.cpart[(size_t)u * n_cc + k] = 0.0f;

  for (int t = n_steps - 1; t >= -1; --t) {
    // ---- phase 1 (for t = -1: only the initial-state cotangent) ----
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const int b = u / n_chunks, c = u - b * n_chunks;
      const int e0 = c * a.E, ne = min(a.E, o.K - e0);
      const int nl = ne * Np, v0 = e0 * Np;
      const size_t sb = b * nV;
      const P4 tb = at4(a.tb, b * trow + (t + 1) * nV);
      if (t < n_steps - 1) gather_gauss<Z>(o, s, a.T2 + b * nT8, e0, ne);
      for (int l = tid; l < NF * nl; l += nth) {
        const int f = l / nl, r = l - f * nl, k = r / Np, n = r - k * Np;
        const int v = v0 + r;
        const size_t at = f * fs + sb + v;
        float lam = 0.0f;
        if (t < n_steps - 1)
          lam = a.Bv[at] + lift_gathered<Z>(o, s, k, n, f) + a.W[at] + a.A[at];
        const float* tbf = pick(tb, f);
        if (tbf != nullptr) lam += tbf[v];
        if (t < 0) a.xb[f][sb + v] = lam;
        else a.W[at] = lam;
      }
      __syncthreads();  // s.pre is read above and written by the next unit
      if (t < 0) continue;
      const P4 st = at4(a.t, b * trow + t * nV);
      const float* ctrl = a.ctrls + ((size_t)b * a.n_cs + t / a.spc) * o.n_ctrl;
      cstage<Z>(o, s, e0, ne, st, st, fields_of(a.s1, fs, sb), none,
             0.5f * a.dt, ctrl, a.use_filter);
    }
    if (t < 0) break;
    grid.sync();

    const int j = t / a.spc;
    // ---- phase 2: g1 = VJP_R(s1)[dt W], first half ----
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const int b = u / n_chunks, c = u - b * n_chunks;
      const int e0 = c * a.E, ne = min(a.E, o.K - e0);
      const size_t sb = b * nV;
      cvjp_phase<Z>(o, s, e0, ne, readonly(fields_of(a.s1, fs, sb)),
                 readonly(fields_of(a.W, fs, sb)), a.dt, a.use_filter,
                 fields_of(a.A, fs, sb), a.T1 + b * nT8,
                 a.cpart + ((size_t)u * a.n_cs + j) * o.n_ctrl);
    }
    grid.sync();

    // ---- phase 3: complete g1; VJP_R(s_t)[dt/2 g1], first half ----
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const int b = u / n_chunks, c = u - b * n_chunks;
      const int e0 = c * a.E, ne = min(a.E, o.K - e0);
      const int nl = ne * Np, v0 = e0 * Np;
      const size_t sb = b * nV;
      gather_gauss<Z>(o, s, a.T1 + b * nT8, e0, ne);
      for (int l = tid; l < NF * nl; l += nth) {
        const int f = l / nl, r = l - f * nl, k = r / Np, n = r - k * Np;
        a.A[f * fs + sb + v0 + r] += lift_gathered<Z>(o, s, k, n, f);
      }
      __syncthreads();
      cvjp_phase<Z>(o, s, e0, ne, at4(a.t, b * trow + t * nV),
                 readonly(fields_of(a.A, fs, sb)), 0.5f * a.dt, a.use_filter,
                 fields_of(a.Bv, fs, sb), a.T2 + b * nT8,
                 a.cpart + ((size_t)u * a.n_cs + j) * o.n_ctrl);
    }
    grid.sync();
  }

  // control cotangents: the chunks' partial sums, added in a fixed order.
  // The last of them were written before the barrier that ended step 0.
  for (int k = blockIdx.x * nth + tid; k < a.B * n_cc; k += gridDim.x * nth) {
    const int b = k / n_cc, r = k - b * n_cc;
    float tot = 0.0f;
    for (int c = 0; c < n_chunks; ++c)
      tot += a.cpart[((size_t)b * n_chunks + c) * n_cc + r];
    a.cbar[k] = tot;
  }
}

// ---------------------------------------------------------------------------
// C interface
// ---------------------------------------------------------------------------

extern "C" {

// Bytes of dynamic shared memory one block needs with chunks of E elements.
long long sw2d_curved_smem_bytes(const CurvedDesc* d, int E) {
  COps o = make_cops(*d, nullptr, nullptr);
  return (long long)(csmem_floats(o, E) * sizeof(float));
}

// Blocks of the last launch (for reporting).
int sw2d_curved_last_grid() { return g_last_grid; }

static int launch_cforward(const void* kern, const CurvedDesc* d,
                           const float* fops, const int* iops, CFwdArgs a,
                           int threads, void* stream) {
  if (threads > MAX_THREADS) return (int)cudaErrorInvalidValue;
  COps o = make_cops(*d, fops, iops);
  const size_t bytes = csmem_floats(o, a.E) * sizeof(float);
  const int n_units = a.B * ((o.K + a.E - 1) / a.E);
  void* args[] = {&o, &a};
  return coop_launch(kern, args, n_units, threads, bytes, stream);
}

// ctrl: (B, n_ctrl) or null. s1: 4*B*nV floats of scratch.
int sw2d_curved_step(const CurvedDesc* d, const float* fops, const int* iops,
                     const float* h, const float* hu, const float* hv,
                     const float* hN, const float* ctrl, float* oh,
                     float* ohu, float* ohv, float* ohN, float* s1, int B,
                     float dt, int use_filter, int E, int threads,
                     void* stream) {
  const size_t n = (size_t)B * d->K * d->Np;
  CFwdArgs a = {{h, hu, hv, hN}, ctrl, {oh, ohu, ohv, ohN},
                {s1, s1 + n, s1 + 2 * n, s1 + 3 * n},
                {nullptr, nullptr, nullptr, nullptr},
                B, 1, 1, 1, E, use_filter, dt};
  const void* kern = is_order3(*d)
      ? (const void*)sw2d_curved_step_kernel<Order3>
      : (const void*)sw2d_curved_step_kernel<AnyOrder>;
  return launch_cforward(kern, d, fops, iops, a, threads, stream);
}

// ctrls: (B, n_cs, n_ctrl) or null. With th..thN (B, n_steps+1, nV) the
// trajectories are stored and oh..ohN are not touched; without, the final
// fields go to oh..ohN. s1: 4*B*nV floats of scratch.
int sw2d_curved_rollout(const CurvedDesc* d, const float* fops,
                        const int* iops, const float* h, const float* hu,
                        const float* hv, const float* hN, const float* ctrls,
                        float* oh, float* ohu, float* ohv, float* ohN,
                        float* th, float* thu, float* thv, float* thN,
                        float* s1, int B, int n_steps, int n_cs, int spc,
                        float dt, int use_filter, int E, int threads,
                        void* stream) {
  const size_t n = (size_t)B * d->K * d->Np;
  CFwdArgs a = {{h, hu, hv, hN}, ctrls, {oh, ohu, ohv, ohN},
                {s1, s1 + n, s1 + 2 * n, s1 + 3 * n}, {th, thu, thv, thN},
                B, n_steps, n_cs, spc, E, use_filter, dt};
  const void* kern = is_order3(*d)
      ? (const void*)sw2d_curved_rollout_kernel<Order3>
      : (const void*)sw2d_curved_rollout_kernel<AnyOrder>;
  return launch_cforward(kern, d, fops, iops, a, threads, stream);
}

// Floats of scratch that sw2d_curved_rollout_bwd needs in `work`.
long long sw2d_curved_bwd_work_floats(const CurvedDesc* d, int B, int n_cs,
                                      int E) {
  const long long nV = (long long)d->K * d->Np;
  const long long nT = (long long)d->K * 3 * d->NG;
  const long long n_chunks = (d->K + E - 1) / E;
  return 16 * B * nV + 16 * B * nT + (long long)B * n_chunks * n_cs * d->n_ctrl;
}

// tbh..tbhN: cotangent trajectories; a null pointer stands for zeros.
int sw2d_curved_rollout_bwd(const CurvedDesc* d, const float* fops,
                            const int* iops, const float* th,
                            const float* thu, const float* thv,
                            const float* thN, const float* tbh,
                            const float* tbhu, const float* tbhv,
                            const float* tbhN, const float* ctrls, float* xbh,
                            float* xbhu, float* xbhv, float* xbhN,
                            float* cbar, float* work, int B, int n_cs,
                            int spc, float dt, int use_filter, int E,
                            int threads, void* stream) {
  if (threads > MAX_THREADS) return (int)cudaErrorInvalidValue;
  COps o = make_cops(*d, fops, iops);
  const size_t n4 = (size_t)NF * B * o.nV, t8 = (size_t)8 * B * o.nT;
  CBwdArgs a;
  a.t[0] = th; a.t[1] = thu; a.t[2] = thv; a.t[3] = thN;
  a.tb[0] = tbh; a.tb[1] = tbhu; a.tb[2] = tbhv; a.tb[3] = tbhN;
  a.ctrls = ctrls;
  a.xb[0] = xbh; a.xb[1] = xbhu; a.xb[2] = xbhv; a.xb[3] = xbhN;
  a.cbar = cbar;
  a.s1 = work; a.W = work + n4; a.A = work + 2 * n4; a.Bv = work + 3 * n4;
  a.T1 = work + 4 * n4; a.T2 = a.T1 + t8; a.cpart = a.T2 + t8;
  a.B = B; a.n_cs = n_cs; a.spc = spc; a.E = E; a.use_filter = use_filter;
  a.dt = dt;
  const size_t bytes = csmem_floats(o, E) * sizeof(float);
  const int n_units = B * ((o.K + E - 1) / E);
  void* args[] = {&o, &a};
  const void* kern = is_order3(*d)
      ? (const void*)sw2d_curved_rollout_bwd_kernel<Order3>
      : (const void*)sw2d_curved_rollout_bwd_kernel<AnyOrder>;
  return coop_launch(kern, args, n_units, threads, bytes, stream);
}

}  // extern "C"
