// Element-blocked shallow-water kernels for the large-mesh regime, sm_90a.
//
//   sw2d_blocked_step_kernel         one SSP-RK2 step
//   sw2d_blocked_rollout_kernel      n_steps steps, optional stored trajectory
//   sw2d_blocked_rollout_bwd_kernel  the reverse (adjoint) sweep
//   sw2d_stage_kernel                one RK stage of an element-sharded set
//   sw2d_stage_bwd_kernel            its adjoint (see the section below)
//   sw2d_step_rdma_kernel            one whole SSP-RK2 step of an
//                                    element-sharded set, the inter-stage
//                                    halo exchanged inside the launch
//
// The first three replace the Pallas TPU kernels _step_kernel,
// _rollout_kernel and _rollout_bwd_kernel of blitzdg_tpu/ops/sw2d_blocked.py
// (the sharded kernels: their own sections below; the stage kernel and the
// one-launch step share a design of their own, P lanes an element). Those
// run one scenario's whole mesh on one core, packed (p, NP, M) with
// roll-based trace exchange. Here a mesh of thousands of elements does not fit one block's
// shared memory, so the work unit is (scenario, chunk of E elements): a block
// holds its chunk's state, fluxes and jumps in shared memory and does
// derivative, lift, filter and limiter per element with FMAs, while the '+'
// traces of every RHS are index gathers through vmapP from the stage's input
// in GLOBAL memory (L2-resident at these sizes), for any element numbering.
//
// Every RK stage therefore depends on the whole grid's previous stage. The
// design taken, fixed at build time: ONE persistent cooperative launch per
// call (cudaLaunchCooperativeKernel; the grid is no larger than what is
// co-resident, blocks loop over work units) with cooperative_groups grid
// barriers between the phases: 2 per step forward, 3 per step in the adjoint.
// State buffers ping-pong (a stage never writes what another block reads in
// the same phase); with a stored trajectory its rows are the step-start
// buffers, so nothing is copied.
//
// Adjoint: the transposed '+' gather crosses blocks. Each RHS adjoint runs in
// two phases: the first writes, per trace node, the cotangents of its '-' and
// '+' side values to a global scratch; after a grid barrier the second
// gathers them into each volume node through the inverse CSR maps. No float
// atomics: the result does not change from run to run. Control cotangents are
// summed per work unit and reduced over the chunks in a fixed order at the
// end. The wet/dry branch (minmod reconstruction, positivity limiter) exists
// forward only.
//
// Bound on the card: float32 operations, not bytes (one state in and one
// out against some hundred operations per node and stage). The design keeps
// the working set in L2 and shared memory, so device memory sees little
// more than that. What the kernels wait for is latency: chained gathers
// (vmapP, then the state) and the block barriers inside a stage; the grid
// barriers are a small share (PERF.md has the measured shares).
//
// Plain C interface (extern "C" at the end), loaded with ctypes. Launches go
// to the stream that is passed in; nothing here synchronises or allocates.

#include "sw2d_common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

extern __shared__ float smem[];

// Per-unit scratch in shared memory; EN = E*Np, ET = E*Ntr floats per field.
struct Scratch {
  Vec3 S;      // the chunk's stage input        | adjoint: incoming cotangent
  Vec3 vflux;  // F2, F3 (= G2), G3              | adjoint: wf
  Vec3 R;      // unfiltered RHS
  Vec3 Out;    // stage output before the limiter
  Vec3 pre;    // speed-independent flux jump, then the scaled jump | dfb
  Vec3 dq;     // jumps                          | adjoint: spd, lamb
  float* spd;
  float* elem;  // 4 per element: theta, mean h, mean hu, mean hv
  float* red;   // 32: block reduction
};

static size_t op_floats(const Ops& o) {
  return (size_t)3 * o.Np * o.Np + (size_t)o.Np * o.Ntr;
}

static size_t smem_floats(const Ops& o, int E) {
  return op_floats(o) + (size_t)12 * E * o.Np + (size_t)7 * E * o.Ntr
         + (size_t)4 * E + 32;
}

// Copy the reference-element operators to shared memory, point the operator
// set at the copies and carve the per-unit scratch behind them.
__device__ Scratch setup_block(Ops& o, int E) {
  const int np2 = o.Np * o.Np, nl = o.Np * o.Ntr;
  float* p = smem;
  float *sDr = p, *sDs = p + np2, *sF = p + 2 * np2, *sL = p + 3 * np2;
  p += 3 * np2 + nl;
  for (int i = threadIdx.x; i < np2; i += blockDim.x) {
    sDr[i] = o.Dr[i]; sDs[i] = o.Ds[i]; sF[i] = o.filt[i];
  }
  for (int i = threadIdx.x; i < nl; i += blockDim.x) sL[i] = o.lift[i];
  o.Dr = sDr; o.Ds = sDs; o.filt = sF; o.lift = sL;
  Scratch s;
  const int EN = E * o.Np, ET = E * o.Ntr;
  s.S = carve(p, EN); s.vflux = carve(p, EN);
  s.R = carve(p, EN); s.Out = carve(p, EN);
  s.pre = carve(p, ET); s.dq = carve(p, ET);
  s.spd = p; p += ET;
  s.elem = p; p += 4 * E;
  s.red = p;
  __syncthreads();
  return s;
}

struct P3 { const float *a, *b, *c; };
struct W3 { float *a, *b, *c; };

__device__ __forceinline__ P3 at(const float* a, const float* b,
                                 const float* c, size_t off) {
  P3 r; r.a = a + off; r.b = b + off; r.c = c + off; return r;
}

__device__ __forceinline__ W3 atw(float* a, float* b, float* c, size_t off) {
  W3 r; r.a = a + off; r.b = b + off; r.c = c + off; return r;
}

// Where a shard's send slots are stored. Slot j goes to buf + 3 j (the
// shard's own (n_send, 3) send buffer of one scenario) or, with a shard
// table, to buf + shard[j] * stride + 3 j: slot j of the receive buffer of
// the shard that receives it (the in-kernel exchange of the one-launch step).
struct SendTo {
  float* buf;              // null: no send slots are written
  const long long* shard;  // (n_send,) receiving shard of each slot, or null
  size_t stride;           // floats from one shard's buffer to the next
};

__device__ __forceinline__ float* send_slot(const SendTo& to, int j) {
  float* p = to.buf + 3 * j;
  return to.shard == nullptr ? p : p + __ldg(to.shard + j) * to.stride;
}

// Sponge relaxation toward rest (h = H where there is bathymetry, no flow)
// of volume node v.
__device__ __forceinline__ void sponge_relax(const Ops& o, int v, float dt,
                                             float& h, float& hu, float& hv) {
  const float fac = 1.0f / (1.0f + dt * __ldg(o.SPNG + v));
  if (o.has_bathy) { const float H = __ldg(o.H + v); h = H + (h - H) * fac; }
  hu *= fac; hv *= fac;
}

// The sponge (if asked), then the store of one volume node.
__device__ __forceinline__ void finish_node(const Ops& o, int v, float h,
                                            float hu, float hv, bool sponge,
                                            float dt, const W3& out) {
  if (sponge) sponge_relax(o, v, dt, h, hu, hv);
  out.a[v] = h; out.b[v] = hu; out.c[v] = hv;
}

// One RK stage of one work unit (elements e0 .. e0+ne of one scenario):
//   out = base + coef * R(in, t), then the positivity limiter (limit) and the
//   sponge (sponge), on the unit's own nodes.
// in: the scenario's whole stage input in global memory (neighbours are read
// from it); base, out: the scenario's fields, touched at own nodes only (they
// may be the same buffer); copy: where to store the unit's part of `in` as
// well, or null pointers. (The sharded kernels have a stage of their own,
// qstage below.)
__device__ void stage(const Ops& o, const Scratch& s, int e0, int ne,
                      const P3& in, const P3& base, const W3& out,
                      const W3& copy, float coef, float t, float dt,
                      const float* ctrl, int use_filter, bool limit,
                      bool sponge) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int Np = o.Np, Ntr = o.Ntr, Nfp = o.Nfp;
  const int nl = ne * Np, tl = ne * Ntr, v0 = e0 * Np, i0 = e0 * Ntr;
  const float h_bc = tidal_depth(o, t);

  for (int l = tid; l < nl; l += nth) {
    const int v = v0 + l;
    const float h = in.a[v], hu = in.b[v], hv = in.c[v];
    s.S.a[l] = h; s.S.b[l] = hu; s.S.c[l] = hv;
    volume_fluxes(o, h, hu, hv, s.vflux.a[l], s.vflux.b[l], s.vflux.c[l]);
    if (copy.a != nullptr) { copy.a[v] = h; copy.b[v] = hu; copy.c[v] = hv; }
  }
  for (int l = tid; l < tl; l += nth) {
    TraceVals tv;
    trace_values(o, i0 + l, in.a, in.b, in.c, h_bc, tv);
    trace_flux_pre(o, tv, s.pre.a[l], s.pre.b[l], s.pre.c[l]);
    trace_jumps(o, tv, s.dq.a[l], s.dq.b[l], s.dq.c[l]);
    s.spd[l] = fmaxf(tv.spdM, tv.spdP);
  }
  __syncthreads();

  // per-face maximum wavespeed (a face lies inside one element), then the
  // jump scaled for the lift
  for (int l = tid; l < tl; l += nth) {
    const int f0 = (l / Nfp) * Nfp;
    float lam = s.spd[f0];
    for (int j = 1; j < Nfp; ++j) lam = fmaxf(lam, s.spd[f0 + j]);
    const float fs = o.fscale[i0 + l], hl = 0.5f * lam;
    s.pre.a[l] = (s.pre.a[l] - hl * s.dq.a[l]) * fs;
    s.pre.b[l] = (s.pre.b[l] - hl * s.dq.b[l]) * fs;
    s.pre.c[l] = (s.pre.c[l] - hl * s.dq.c[l]) * fs;
  }
  __syncthreads();

  for (int l = tid; l < nl; l += nth) {
    const int k = l / Np, n = l - k * Np;
    const int le0 = k * Np, lt0 = k * Ntr, v = v0 + l;
    float l1 = 0.0f, l2 = 0.0f, l3 = 0.0f;
    for (int j = 0; j < Ntr; ++j) {
      const float lf = o.lift[n * Ntr + j];
      l1 += lf * s.pre.a[lt0 + j];
      l2 += lf * s.pre.b[lt0 + j];
      l3 += lf * s.pre.c[lt0 + j];
    }
    float rF1 = 0, sF1 = 0, rG1 = 0, sG1 = 0, rF2 = 0, sF2 = 0;
    float rF3 = 0, sF3 = 0, rG3 = 0, sG3 = 0;
    for (int m = 0; m < Np; ++m) {
      const float dr = o.Dr[n * Np + m], ds = o.Ds[n * Np + m];
      const float f1 = s.S.b[le0 + m], g1 = s.S.c[le0 + m];
      const float f2 = s.vflux.a[le0 + m], f3 = s.vflux.b[le0 + m];
      const float g3 = s.vflux.c[le0 + m];
      rF1 += dr * f1; sF1 += ds * f1; rG1 += dr * g1; sG1 += ds * g1;
      rF2 += dr * f2; sF2 += ds * f2; rF3 += dr * f3; sF3 += ds * f3;
      rG3 += dr * g3; sG3 += ds * g3;
    }
    const float rx = o.rx[v], sx = o.sx[v], ry = o.ry[v], sy = o.sy[v];
    float r1 = l1 - (rx * rF1 + sx * sF1 + ry * rG1 + sy * sG1);
    float r2 = l2 - (rx * rF2 + sx * sF2 + ry * rF3 + sy * sF3);
    float r3 = l3 - (rx * rF3 + sx * sF3 + ry * rG3 + sy * sG3);
    add_sources(o, v, s.S.a[l], s.S.b[l], s.S.c[l], ctrl, r2, r3);
    s.R.a[l] = r1; s.R.b[l] = r2; s.R.c[l] = r3;
  }
  __syncthreads();

  // modal filter, stage update
  for (int l = tid; l < nl; l += nth) {
    const int k = l / Np, n = l - k * Np, le0 = k * Np, v = v0 + l;
    float a, b, c;
    if (use_filter) {
      a = b = c = 0.0f;
      for (int m = 0; m < Np; ++m) {
        const float fl = o.filt[n * Np + m];
        a += fl * s.R.a[le0 + m];
        b += fl * s.R.b[le0 + m];
        c += fl * s.R.c[le0 + m];
      }
    } else {
      a = s.R.a[l]; b = s.R.b[l]; c = s.R.c[l];
    }
    a = base.a[v] + coef * a;
    b = base.b[v] + coef * b;
    c = base.c[v] + coef * c;
    if (limit) {
      s.Out.a[l] = a; s.Out.b[l] = b; s.Out.c[l] = c;
    } else {
      finish_node(o, v, a, b, c, sponge, dt, out);
    }
  }
  if (limit) {
    // positivity limiter: squash toward the element's arithmetic nodal mean
    // where its minimum is below the floor, then taper near-dry momentum
    __syncthreads();
    const float floor_ = o.h_floor;
    for (int e = tid; e < ne; e += nth) {
      float hmin = s.Out.a[e * Np], sh = 0.0f, shu = 0.0f, shv = 0.0f;
      for (int m = 0; m < Np; ++m) {
        const float h = s.Out.a[e * Np + m];
        hmin = fminf(hmin, h);
        sh += h; shu += s.Out.b[e * Np + m]; shv += s.Out.c[e * Np + m];
      }
      const float hmean = sh / (float)Np;
      float theta = 1.0f;
      if (hmin < floor_) {
        const float denom = hmean - hmin;
        theta = (hmean - floor_) / (denom > 0.0f ? denom : 1.0f);
        theta = fminf(fmaxf(theta, 0.0f), 1.0f);
      }
      s.elem[4 * e] = theta; s.elem[4 * e + 1] = hmean;
      s.elem[4 * e + 2] = shu / (float)Np;
      s.elem[4 * e + 3] = shv / (float)Np;
    }
    __syncthreads();
    for (int l = tid; l < nl; l += nth) {
      const int e = l / Np;
      const float theta = s.elem[4 * e], hmean = s.elem[4 * e + 1];
      const float humean = s.elem[4 * e + 2], hvmean = s.elem[4 * e + 3];
      const float h = hmean + theta * (s.Out.a[l] - hmean);
      const float hu = humean + theta * (s.Out.b[l] - humean);
      const float hv = hvmean + theta * (s.Out.c[l] - hvmean);
      const float taper =
          fminf(fmaxf((h - floor_) / (4.0f * floor_), 0.0f), 1.0f);
      finish_node(o, v0 + l, h, hu * taper, hv * taper, sponge, dt, out);
    }
  }
  __syncthreads();  // the scratch is reused by the block's next unit
}

struct FwdArgs {
  const float *h, *hu, *hv;  // (B, nV) initial states
  const float* ctrls;        // (B, n_cs, n_ctrl) or null
  float *oh, *ohu, *ohv;     // (B, nV) final state, the resident state buffer
  float *s1h, *s1hu, *s1hv;  // (B, nV) stage scratch
  float *th, *thu, *thv;     // (B, n_steps+1, nV) trajectory or null
  int B, n_steps, n_cs, spc, E, use_filter;
  float dt, t0;
};

// n_steps SSP-RK2 steps: u1 = u + dt/2 R(u, t); u <- u + dt R(u1, t + dt/2),
// with a grid barrier after each stage.
__device__ void forward_body(const Ops& og, const FwdArgs& a) {
  cg::grid_group grid = cg::this_grid();
  Ops o = og;
  const Scratch s = setup_block(o, a.E);
  const int n_chunks = (o.K + a.E - 1) / a.E, n_units = a.B * n_chunks;
  const size_t nV = (size_t)o.nV, trow = (size_t)(a.n_steps + 1) * nV;
  const bool traj = a.th != nullptr;
  const W3 none = {nullptr, nullptr, nullptr};

  for (int t = 0; t < a.n_steps; ++t) {
    const float tt = a.t0 + (float)t * a.dt;
    for (int phase = 0; phase < 2; ++phase) {
      for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
        const int b = u / n_chunks, c = u - b * n_chunks;
        const int e0 = c * a.E, ne = min(a.E, o.K - e0);
        P3 cur;  // the step-start state
        if (t == 0) cur = at(a.h, a.hu, a.hv, b * nV);
        else if (traj) cur = at(a.th, a.thu, a.thv, b * trow + t * nV);
        else cur = at(a.oh, a.ohu, a.ohv, b * nV);
        const W3 s1 = atw(a.s1h, a.s1hu, a.s1hv, b * nV);
        const float* ctrl = a.ctrls == nullptr ? nullptr
            : a.ctrls + ((size_t)b * a.n_cs + t / a.spc) * o.n_ctrl;
        if (phase == 0) {
          const W3 row0 = (traj && t == 0)
              ? atw(a.th, a.thu, a.thv, b * trow) : none;
          stage(o, s, e0, ne, cur, cur, s1, row0, 0.5f * a.dt, tt, a.dt,
                ctrl, a.use_filter, o.wetdry != 0, false);
        } else {
          const W3 nxt = traj
              ? atw(a.th, a.thu, a.thv, b * trow + (t + 1) * nV)
              : atw(a.oh, a.ohu, a.ohv, b * nV);
          const P3 in = {s1.a, s1.b, s1.c};
          stage(o, s, e0, ne, in, cur, nxt, none, a.dt, tt + 0.5f * a.dt,
                a.dt, ctrl, a.use_filter, o.wetdry != 0, o.has_sponge != 0);
        }
      }
      grid.sync();
    }
  }
}

__global__ void sw2d_blocked_step_kernel(Ops o, FwdArgs a) {
  forward_body(o, a);
}

__global__ void sw2d_blocked_rollout_kernel(Ops o, FwdArgs a) {
  forward_body(o, a);
}

// ---------------------------------------------------------------------------
// Adjoint
// ---------------------------------------------------------------------------

// Transposed gathers at volume node v: add the cotangents of the trace nodes
// that read it as their '-' value (slots 0..2) or '+' value (slots 3..5).
// T: one scenario's (nT, 6) scratch.
__device__ __forceinline__ void gather_traces(const Ops& o, const float* T,
                                              int v, float& a, float& b,
                                              float& c) {
  for (int q = o.invM_ptr[v]; q < o.invM_ptr[v + 1]; ++q) {
    const float* p = T + (size_t)o.invM_idx[q] * 6;
    a += p[0]; b += p[1]; c += p[2];
  }
  for (int q = o.invP_ptr[v]; q < o.invP_ptr[v + 1]; ++q) {
    const float* p = T + (size_t)o.invP_idx[q] * 6 + 3;
    a += p[0]; b += p[1]; c += p[2];
  }
}

// First phase of the vector-Jacobian product of the filtered, control-forced
// RHS at state S for one work unit. With wf = scale * filter^T W on the
// unit's elements it
//   adds  d/d ctrl_c  to cpart[c],
//   writes the volume part of J_R(S)^T wf to Avol at the unit's nodes,
//   writes the cotangents of the unit's trace values to T (nT, 6).
// The product is complete once every volume node has gathered its trace
// nodes' entries of T (gather_traces), after a grid barrier.
// S: the scenario's whole state (global); W, Avol: the scenario's fields,
// touched at own nodes only. rb: as in stage().
__device__ void vjp_phase(const Ops& o, const Scratch& s, int e0, int ne,
                          const P3& S, float t, const P3& W, float scale,
                          int use_filter, const W3& Avol, float* T,
                          float* cpart, const float* rb = nullptr) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int Np = o.Np, Ntr = o.Ntr, Nfp = o.Nfp;
  const int nl = ne * Np, tl = ne * Ntr, v0 = e0 * Np, i0 = e0 * Ntr;
  const float h_bc = tidal_depth(o, t);
  const Vec3 &Win = s.S, &wf = s.vflux, &dfb = s.pre;
  float *spd = s.dq.a, *lamb = s.dq.b;

  for (int l = tid; l < nl; l += nth) {
    Win.a[l] = W.a[v0 + l]; Win.b[l] = W.b[v0 + l]; Win.c[l] = W.c[v0 + l];
  }
  __syncthreads();
  // filter transpose (the control enters the RHS before the filter)
  for (int l = tid; l < nl; l += nth) {
    float a, b, c;
    if (use_filter) {
      const int k = l / Np, m = l - k * Np, le0 = k * Np;
      a = b = c = 0.0f;
      for (int n = 0; n < Np; ++n) {
        const float fl = o.filt[n * Np + m];
        a += fl * Win.a[le0 + n]; b += fl * Win.b[le0 + n];
        c += fl * Win.c[le0 + n];
      }
    } else {
      a = Win.a[l]; b = Win.b[l]; c = Win.c[l];
    }
    wf.a[l] = a * scale; wf.b[l] = b * scale; wf.c[l] = c * scale;
  }
  __syncthreads();
  for (int cc = 0; cc < o.n_ctrl; ++cc) {
    float part = 0.0f;
    for (int l = tid; l < nl; l += nth)
      part += o.BU[(size_t)cc * o.nV + v0 + l] * wf.b[l]
              + o.BV[(size_t)cc * o.nV + v0 + l] * wf.c[l];
    const float tot = block_sum(part, s.red);
    if (tid == 0) cpart[cc] += tot;
  }

  // volume part: divergence transpose, volume fluxes, sources
  for (int l = tid; l < nl; l += nth) {
    const int k = l / Np, m = l - k * Np, le0 = k * Np, v = v0 + l;
    float Fb1 = 0, Fb2 = 0, Fb3 = 0, Gb1 = 0, Gb2 = 0, Gb3 = 0;
    for (int n = 0; n < Np; ++n) {
      const float dr = o.Dr[n * Np + m], ds = o.Ds[n * Np + m];
      const int vn = v0 + le0 + n;
      const float dx = dr * o.rx[vn] + ds * o.sx[vn];
      const float dy = dr * o.ry[vn] + ds * o.sy[vn];
      const float w1 = wf.a[le0 + n], w2 = wf.b[le0 + n], w3 = wf.c[le0 + n];
      Fb1 -= dx * w1; Fb2 -= dx * w2; Fb3 -= dx * w3;
      Gb1 -= dy * w1; Gb2 -= dy * w2; Gb3 -= dy * w3;
    }
    float hb, hub, hvb;
    volume_vjp_point(o, v, S.a[v], S.b[v], S.c[v], Fb1, Fb2, Fb3, Gb1, Gb2,
                     Gb3, wf.b[l], wf.c[l], hb, hub, hvb);
    Avol.a[v] = hb; Avol.b[v] = hub; Avol.c[v] = hvb;
  }
  // lift transpose; first trace pass: speeds and the speed's cotangent
  for (int l = tid; l < tl; l += nth) {
    const int k = l / Ntr, j = l - k * Ntr, le0 = k * Np, i = i0 + l;
    float d1 = 0.0f, d2 = 0.0f, d3 = 0.0f;
    for (int n = 0; n < Np; ++n) {
      const float lf = o.lift[n * Ntr + j];
      d1 += lf * wf.a[le0 + n]; d2 += lf * wf.b[le0 + n];
      d3 += lf * wf.c[le0 + n];
    }
    const float fs = o.fscale[i];
    d1 *= fs; d2 *= fs; d3 *= fs;
    dfb.a[l] = d1; dfb.b[l] = d2; dfb.c[l] = d3;
    TraceVals tv;
    trace_values(o, i, S.a, S.b, S.c, h_bc, tv, rb);
    float dq1, dq2, dq3;
    trace_jumps(o, tv, dq1, dq2, dq3);
    spd[l] = fmaxf(tv.spdM, tv.spdP);
    lamb[l] = -0.5f * (dq1 * d1 + dq2 * d2 + dq3 * d3);
  }
  __syncthreads();
  // second trace pass: the whole chain rule of the face flux
  for (int l = tid; l < tl; l += nth) {
    const int i = i0 + l;
    TraceVals tv;
    trace_values(o, i, S.a, S.b, S.c, h_bc, tv, rb);
    float lam;
    // (this node's speed as the first pass stored it: a recomputed value
    // may be contracted differently and miss the equality with the maximum)
    const float sb = face_speed_share(spd, lamb, (l / Nfp) * Nfp, Nfp,
                                      spd[l], lam);
    float* out = T + (size_t)i * 6;
    face_vjp_point(o, tv, lam, sb, dfb.a[l], dfb.b[l], dfb.c[l], out,
                   out + 3);
  }
  __syncthreads();  // the scratch is reused by the block's next unit
}

struct BwdArgs {
  const float *th, *thu, *thv;     // (B, n_steps+1, nV) stored trajectory
  const float *tbh, *tbhu, *tbhv;  // its cotangents
  const float* ctrls;              // (B, n_cs, n_ctrl)
  float *xbh, *xbhu, *xbhv;        // (B, nV) out: initial-state cotangents
  float* cbar;                     // (B, n_cs, n_ctrl) out
  // scratch, each (B, nV) per field: stage state, cotangent W of the step's
  // raw output, a = VJP_R(s_half)[dt W], volume part of VJP_R(s_t)[dt/2 a]
  float *s1, *W, *A, *Bv;
  float *T1, *T2;  // (B, nT, 6) trace cotangents of the two products
  float* cpart;    // (B, n_chunks, n_cs, n_ctrl) control partial sums
  int B, n_cs, spc, E, use_filter;
  float dt, t0;
};

// Reverse sweep. For each step t (T-1 .. 0), with s_t the stored step-start
// state and lambda the adjoint of s_{t+1}:
//   W      = (lambda + tbar_{t+1}) * sponge factor
//   s_half = s_t + dt/2 R(s_t)                   (recomputed)
//   a      = VJP_R(s_half)[dt W]
//   lambda = W + a + VJP_R(s_t)[dt/2 a].
// Three phases per step, a grid barrier after each:
//   1. finish the previous step's second product (gather T2), form W,
//      recompute s_half;
//   2. first half of the product at s_half (T1, volume part into A);
//   3. gather T1 into A; first half of the product at s_t (T2, Bv).
__global__ void sw2d_blocked_rollout_bwd_kernel(Ops og, BwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  Ops o = og;
  const Scratch s = setup_block(o, a.E);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int n_chunks = (o.K + a.E - 1) / a.E, n_units = a.B * n_chunks;
  const int n_steps = a.n_cs * a.spc;
  const size_t nV = (size_t)o.nV, nT6 = (size_t)o.nT * 6;
  const size_t fs = (size_t)a.B * nV;  // floats per field of a scratch
  const size_t trow = (size_t)(n_steps + 1) * nV;
  const int n_cc = a.n_cs * o.n_ctrl;
  const W3 none = {nullptr, nullptr, nullptr};

  for (int u = blockIdx.x; u < n_units; u += gridDim.x)
    for (int k = tid; k < n_cc; k += nth) a.cpart[(size_t)u * n_cc + k] = 0.0f;

  for (int t = n_steps - 1; t >= -1; --t) {
    // ---- phase 1 (for t = -1: only the initial-state cotangent) ----
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const int b = u / n_chunks, c = u - b * n_chunks;
      const int e0 = c * a.E, ne = min(a.E, o.K - e0);
      const int nl = ne * o.Np, v0 = e0 * o.Np;
      const size_t sb = b * nV;
      const P3 tb = at(a.tbh, a.tbhu, a.tbhv, b * trow + (t + 1) * nV);
      for (int l = tid; l < nl; l += nth) {
        const int v = v0 + l;
        float l1 = 0.0f, l2 = 0.0f, l3 = 0.0f;
        if (t < n_steps - 1) {
          l1 = a.Bv[sb + v]; l2 = a.Bv[fs + sb + v]; l3 = a.Bv[2 * fs + sb + v];
          gather_traces(o, a.T2 + b * nT6, v, l1, l2, l3);
          l1 += a.W[sb + v] + a.A[sb + v];
          l2 += a.W[fs + sb + v] + a.A[fs + sb + v];
          l3 += a.W[2 * fs + sb + v] + a.A[2 * fs + sb + v];
        }
        l1 += tb.a[v]; l2 += tb.b[v]; l3 += tb.c[v];
        if (t < 0) {
          a.xbh[sb + v] = l1; a.xbhu[sb + v] = l2; a.xbhv[sb + v] = l3;
          continue;
        }
        if (o.has_sponge) {  // the stored s_{t+1} is the relaxed state
          const float fac = 1.0f / (1.0f + a.dt * o.SPNG[v]);
          if (o.has_bathy) l1 *= fac;
          l2 *= fac; l3 *= fac;
        }
        a.W[sb + v] = l1; a.W[fs + sb + v] = l2; a.W[2 * fs + sb + v] = l3;
      }
      if (t < 0) continue;
      const P3 st = at(a.th, a.thu, a.thv, b * trow + t * nV);
      const float* ctrl = a.ctrls + ((size_t)b * a.n_cs + t / a.spc) * o.n_ctrl;
      stage(o, s, e0, ne, st, st, atw(a.s1, a.s1 + fs, a.s1 + 2 * fs, sb),
            none, 0.5f * a.dt, a.t0 + (float)t * a.dt, a.dt, ctrl,
            a.use_filter, false, false);
    }
    if (t < 0) break;
    grid.sync();

    const float tt = a.t0 + (float)t * a.dt;
    const int j = t / a.spc;
    // ---- phase 2: a = VJP_R(s_half)[dt W], first half ----
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const int b = u / n_chunks, c = u - b * n_chunks;
      const int e0 = c * a.E, ne = min(a.E, o.K - e0);
      const size_t sb = b * nV;
      vjp_phase(o, s, e0, ne, at(a.s1, a.s1 + fs, a.s1 + 2 * fs, sb),
                tt + 0.5f * a.dt, at(a.W, a.W + fs, a.W + 2 * fs, sb), a.dt,
                a.use_filter, atw(a.A, a.A + fs, a.A + 2 * fs, sb),
                a.T1 + b * nT6,
                a.cpart + ((size_t)u * a.n_cs + j) * o.n_ctrl);
    }
    grid.sync();

    // ---- phase 3: complete a; VJP_R(s_t)[dt/2 a], first half ----
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const int b = u / n_chunks, c = u - b * n_chunks;
      const int e0 = c * a.E, ne = min(a.E, o.K - e0);
      const int nl = ne * o.Np, v0 = e0 * o.Np;
      const size_t sb = b * nV;
      for (int l = tid; l < nl; l += nth) {
        const int v = v0 + l;
        float a1 = a.A[sb + v], a2 = a.A[fs + sb + v], a3 = a.A[2 * fs + sb + v];
        gather_traces(o, a.T1 + b * nT6, v, a1, a2, a3);
        a.A[sb + v] = a1; a.A[fs + sb + v] = a2; a.A[2 * fs + sb + v] = a3;
      }
      __syncthreads();
      vjp_phase(o, s, e0, ne, at(a.th, a.thu, a.thv, b * trow + t * nV), tt,
                at(a.A, a.A + fs, a.A + 2 * fs, sb), 0.5f * a.dt,
                a.use_filter, atw(a.Bv, a.Bv + fs, a.Bv + 2 * fs, sb),
                a.T2 + b * nT6,
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

// n grid barriers and nothing else: what one barrier costs at a given grid
// (a measuring aid; no path of the solver runs it).
__global__ void sw2d_blocked_barrier_probe_kernel(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}

// ---------------------------------------------------------------------------
// The element-sharded set: one RK stage (B7) and one whole step (B9)
// ---------------------------------------------------------------------------
//
// sw2d_stage_kernel replaces _stage_kernel / sw2d_stage_blocked (lean-I/O
// mode) and sw2d_step_rdma_kernel replaces _step_kernel_rdma /
// sw2d_step_rdma_blocked of blitzdg_tpu/ops/sw2d_blocked.py. The TPU kernels
// run one shard's packed mesh a program and move the halo with one-hot
// matmuls (the stage) or by remote DMA after a READY handshake (the step).
// Here one launch covers every shard of a stacked set (each shard's
// operators are one row of the packed buffers), the receive buffer is read
// where vmapP points past the shard's own nodes, and each send slot is
// written by the lane that owns its node, through the inverse of the send
// list: one writer a slot, no atomics, the same bits on a rerun.
//
// The one-launch step runs two phases around ONE grid barrier:
//   1. stage 1 (c_dt = dt/2, no sponge) from the step-start state and the
//      step-boundary receive buffer rb; s1 goes to a scratch triple, and
//      each of s1's send slots is stored straight into slot j of the
//      RECEIVING shard's stage-2 receive buffer rb2 (shard s, chunk d ->
//      shard (s + offs[d]) mod S: the ring exchange's reverse source
//      table). That is the remote copy of the TPU kernel, and how a store
//      into a peer card's memory would go;
//   2. the grid barrier stands for the READY handshake and for stage 2's
//      reads of s1 at neighbours that other blocks wrote;
//   3. stage 2 (c_dt = dt, stage time t + dt/2, the sponge) from s1, base
//      the step-start state, rb2; the output and its own send buffer for
//      the step-boundary exchange outside.
// Without ring offsets every slot is empty and rb2 is zeros, as the TPU
// kernel zeroes its receive buffer. No wet/dry branch in the step (its
// wrapper refuses a wet/dry set, as the TPU wrapper does); the stage kernel
// has the limiter. Both kernels run the same stage code (qstage), so the
// step gives the bits of two stage launches with the exchange between.
//
// Work unit: P lanes of one warp per (shard, scenario, element) item, the
// element innermost (neighbouring items read neighbouring addresses); a
// block holds blockDim/P items, and blocks loop over the items where the
// grid is smaller than the work. At N=3 (Np 10, Nfp 4, three faces, with
// or without two controls: compile-time sizes, every loop unrolled, the
// lane's values in registers) P = Nfp = 4: lane p holds node p of each
// face (its three trace nodes) and the volume nodes p, p+4, p+8. The face
// maximum over a face's four nodes is two shuffles across the lanes; the
// fluxes the derivatives need and the scaled jumps the lift needs go
// through the item's own slots in shared memory behind a warp barrier.
// Other orders (run-time sizes, arrays in local memory) take one lane an
// item. A stage has no block barrier; a launch has one, after the
// reference operators (Dr and Ds interleaved, lift, filter) are copied to
// shared memory, where every lane reads them as broadcasts.
//
// The block size is chosen by the launcher (q_plan): the largest of 256,
// 128, 64, 32 threads that still gives every SM a block (S=4 x B=1 x 512
// elements is 8192 lanes: 256 blocks of one warp) and whose shared memory
// fits (at N=6 one of 256 would not), and the step's grid is
// what the device reports as co-resident. Where that grid covers every
// item in one pass, the step keeps each lane's stage-1 nodes and its
// step-start nodes in registers across the grid barrier; only the
// neighbours' traces then go through global memory (L2) in stage 2.
//
// Bound on the card: float32 operations (the step: two RHS evaluations per
// node against one state in and one out; a stage alone: bytes, its six
// state reads and three writes outweighing one RHS at the card's rate).
// The '+' traces are gathers through vmapP, whose indices do not depend on
// the stage's data and are loaded ahead of it. The speeds that decide the
// face maximum are computed in IEEE arithmetic (C8).

struct StageArgs {
  const float* fops;  // (S, fstride) packed float operators, a row a shard
  const int* iops;    // (S, istride) packed index tables
  long long fstride, istride;
  int S, B, use_filter, sponge;
  const float *bh, *bhu, *bhv;  // (S, B, nV) axpy base
  const float *ch, *chu, *chv;  // (S, B, nV) stage input
  const float* rb;              // (S, B, n_recv, 3) receive buffer
  const float* ctrl;            // (n_ctrl,), shared by all, or null
  float *oh, *ohu, *ohv;        // (S, B, nV) out
  float* sb;                    // (S, B, n_send, 3) out: send buffer
  float c_dt, t;
};

struct RdmaArgs {
  const float* fops;
  const int* iops;
  long long fstride, istride;
  int S, B, use_filter, sponge;
  const float *h, *hu, *hv;     // (S, B, nV) step-start state
  const float* rb;              // (S, B, n_recv, 3) step-boundary receive buffer
  const float* ctrl;            // (n_ctrl,), shared by all, or null
  const long long* dest;        // (S, n_send) receiving shard of each slot,
                                // or null without ring offsets
  float *s1h, *s1hu, *s1hv;     // (S, B, nV) scratch: the stage-1 state
  float* rb2;                   // (S, B, n_recv, 3) scratch: stage 2's rb
  float *oh, *ohu, *ohv;        // (S, B, nV) out
  float* sb;                    // (S, B, n_send, 3) out: send buffer
  float dt, t1, t2;             // step, the two stage times
};

// Shard sh's operator set; the reference-element operators are the block's
// shared-memory copies (the same for every shard).
__device__ __forceinline__ Ops shard_ops(const SwDesc& d, const float* fops,
                                         const int* iops, long long fstride,
                                         long long istride, int sh,
                                         const Ops& blk) {
  Ops o = make_ops(d, fops + sh * fstride, iops + sh * istride);
  o.Dr = blk.Dr; o.Ds = blk.Ds; o.lift = blk.lift; o.filt = blk.filt;
  return o;
}

#define QMAX_THREADS 256
// Room of the run-time-size instantiation's arrays: nodes (N=6), nodes a
// face.
#define QMAX_NP 28
#define QMAX_NFP 7

__host__ __device__ constexpr int qround4(int n) { return (n + 3) & ~3; }

// Floats of the reference operators in shared memory: (Dr, Ds) interleaved
// [n][m], lift [n][j], filter [n][m].
__host__ __device__ inline int q_ops_floats(int Np, int Ntr) {
  return qround4(3 * Np * Np + Np * Ntr);
}

// Floats of one item's slots: (hu, hv, F2, F3) a node, then the filter's
// input (r1, r2, r3) a node in the same place; G3 a node; the scaled jumps
// (a1, a2, a3) a trace node.
__host__ __device__ inline int q_item_floats(int Np, int Ntr) {
  return 4 * Np + qround4(Np) + 4 * Ntr;
}

// Nodes, nodes a face, controls and lanes an item: constants of the
// instantiation where the template gives them, else (0 sizes, NC < 0)
// read at run time.
template <int NP, int NFP, int NC, int LANES>
struct QSizes {
  static constexpr int P = LANES;
  static constexpr int CNP = NP ? (NP + LANES - 1) / LANES : QMAX_NP;
  static constexpr int CFP = NP ? NFP / LANES : QMAX_NFP;  // a face's, a lane
  __device__ __forceinline__ static int np(const Ops& o) {
    return NP ? NP : o.Np;
  }
  __device__ __forceinline__ static int nfp(const Ops& o) {
    return NP ? NFP : o.Nfp;
  }
  __device__ __forceinline__ static int ntr(const Ops& o) {
    return NP ? 3 * NFP : o.Ntr;
  }
  __device__ __forceinline__ static int nc(const Ops& o) {
    return NC >= 0 ? NC : o.n_ctrl;
  }
  // node slots of a lane, and the nodes of a face a lane holds
  __device__ __forceinline__ static int nslots(const Ops& o) {
    return NP ? CNP : (o.Np + LANES - 1) / LANES;
  }
  __device__ __forceinline__ static int nface(const Ops& o) {
    return NP ? CFP : o.Nfp / LANES;
  }
};
typedef QSizes<10, 4, 2, 4> QOrder3Ctrl;  // N=3 with two controls
typedef QSizes<10, 4, -1, 4> QOrder3;     // N=3, other control counts
typedef QSizes<0, 0, -1, 1> QAnyOrder;

// One lane's values at its node slots.
template <class Z>
struct Own {
  float h[Z::CNP], hu[Z::CNP], hv[Z::CNP];
};

// The lane's item of one pass over the items, and its shard's rows of the
// packed buffers: every lane reads its shard's fields through the block's
// operator set (the first shard's, the same in every lane), a float field's
// entry j at fo + j, an index table's at io + j. Lanes past the last item
// compute the last item again and store nothing (they take part in the
// warp's shuffles and barriers).
struct QLane {
  int sc, b, e, p, fo, io, sh;
  bool active;
};

template <class Z>
__device__ __forceinline__ QLane q_lane(int first, int n_items, int B,
                                        int K, long long fstride,
                                        long long istride) {
  QLane l;
  int it = first + (int)threadIdx.x / Z::P;
  l.active = it < n_items;
  if (!l.active) it = n_items - 1;
  l.p = (int)threadIdx.x % Z::P;
  l.sc = it / K;
  l.e = it - l.sc * K;
  l.sh = l.sc / B;
  l.b = l.sc - l.sh * B;
  l.fo = (int)(l.sh * fstride);
  l.io = (int)(l.sh * istride);
  return l;
}

// The reference operators into shared memory (every thread of the block
// must call it; a block barrier follows).
__device__ void q_setup_ops(const Ops& o, float* s) {
  const int Np = o.Np, Ntr = o.Ntr, np2 = Np * Np;
  float* lf = s + 2 * np2;
  float* fl = lf + Np * Ntr;
  for (int i = threadIdx.x; i < np2; i += blockDim.x) {
    s[2 * i] = o.Dr[i];
    s[2 * i + 1] = o.Ds[i];
    fl[i] = o.filt[i];
  }
  for (int i = threadIdx.x; i < Np * Ntr; i += blockDim.x) lf[i] = o.lift[i];
}

template <class Z>
__device__ __forceinline__ void load_own(const Ops& o, int e, int p,
                                         const P3& f, Own<Z>& x) {
  const int Np = Z::np(o), ns = Z::nslots(o);
#pragma unroll
  for (int i = 0; i < ns; ++i) {
    const int n = p + Z::P * i;
    const int v = e * Np + (n < Np ? n : 0);
    x.h[i] = f.a[v]; x.hu[i] = f.b[v]; x.hv[i] = f.c[v];
  }
}

// Zeros in the empty send slots (send_node < 0) of every (shard, scenario):
// slot(sh, b, j) says where slot j goes. A grid-stride loop.
template <class Slot>
__device__ void q_zero_empty(const Ops& g, long long istride, int S, int B,
                             const Slot& slot) {
  const int L = g.n_send, n = S * B * L;
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += gridDim.x * blockDim.x) {
    const int sc = k / L, j = k - sc * L, sh = sc / B;
    if (g.send_node[sh * istride + j] < 0) {
      float* q = slot(sh, sc - sh * B, j);
      q[0] = q[1] = q[2] = 0.0f;
    }
  }
}

// One RK stage of one item (element l.e of one shard and scenario) on lane
// l.p of its P lanes:
//   y = base + coef R(in, t), then the positivity limiter (limit) and the
//   sponge (sponge);
// stored at the element's nodes of `out` and at the send slots that read
// them (`to`). in: the stage input of the shard and scenario in global
// memory (the '-' and '+' traces are read from it, the '+' at a cut face
// from rb); x: the lane's own nodes of `in` (from memory, or kept in
// registers by the caller); the base: the lane's nodes in bs where BASE_REGS
// (kept by the caller), else read from `base` at the update; y: the lane's
// result. g: the block's operator set; scr: the item's slots in shared
// memory; sops: the reference operators.
template <class Z, bool BASE_REGS>
__device__ __forceinline__ void qstage(
    const Ops& g, const float* sops, float* scr, const QLane& l,
    const P3& in, const Own<Z>& x, const Own<Z>& bs, const P3& base,
    Own<Z>& y, const W3& out, const SendTo& to, const float* rb, float coef,
    float t, float dt, const float* ctrl, int use_filter, bool limit,
    bool sponge) {
  constexpr int P = Z::P;
  const int Np = Z::np(g), Ntr = Z::ntr(g), Nfp = Z::nfp(g);
  const int ns = Z::nslots(g), nfl = Z::nface(g), nc = Z::nc(g);
  const int e = l.e, p = l.p, v0 = e * Np, i0 = e * Ntr;
  const float2* DS = reinterpret_cast<const float2*>(sops);
  const float* LF = sops + 2 * Np * Np;
  const float* FL = LF + Np * Ntr;
  float4* X = reinterpret_cast<float4*>(scr);
  float* G = scr + 4 * Np;
  float4* A = reinterpret_cast<float4*>(G + qround4(Np));
  const float h_bc = tidal_depth(g, t);

  __syncwarp();  // the item's slots are free (a previous pass read them)
  // own nodes: the volume fluxes into the item's slots
#pragma unroll
  for (int i = 0; i < ns; ++i) {
    const int n = p + P * i;
    if (n < Np) {
      float F2, F3, G3;
      volume_fluxes(g, x.h[i], x.hu[i], x.hv[i], F2, F3, G3);
      X[n] = make_float4(x.hu[i], x.hv[i], F2, F3);
      G[n] = G3;
    }
  }
  // the lane's trace nodes (node p + P k of each face): their indices,
  // then the state at both sides, each round issued at once (the tables
  // are read-only for the launch: __ldg; the state may have been written
  // by this launch's first phase: plain loads)
  int vm[3][Z::CFP], vp[3][Z::CFP];
#pragma unroll
  for (int f = 0; f < 3; ++f)
#pragma unroll
    for (int k = 0; k < nfl; ++k) {
      const int gi = l.io + i0 + f * Nfp + p + P * k;
      vm[f][k] = __ldg(g.vmapM + gi);
      vp[f][k] = __ldg(g.vmapP + gi);
    }
  float sv[3][Z::CFP][6];
#pragma unroll
  for (int f = 0; f < 3; ++f)
#pragma unroll
    for (int k = 0; k < nfl; ++k) {
      const int m = vm[f][k], q = vp[f][k];
      sv[f][k][0] = in.a[m]; sv[f][k][1] = in.b[m]; sv[f][k][2] = in.c[m];
      const float* r = in.a + q;
      const float* ru = in.b + q;
      const float* rv = in.c + q;
      if (q >= g.nV) {  // a cut face: the receive slot
        r = rb + 3 * (q - g.nV); ru = r + 1; rv = r + 2;
      }
      sv[f][k][3] = *r; sv[f][k][4] = *ru; sv[f][k][5] = *rv;
    }
  // a face at a time: flux jumps and speeds, the face's maximum speed (its
  // other nodes lie in the item's other lanes: shuffles), the jumps scaled
  // for the lift
  const bool depths = g.wb || g.wetdry;
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    float p1[Z::CFP], p2[Z::CFP], p3[Z::CFP], q1[Z::CFP], q2[Z::CFP];
    float q3[Z::CFP], lam = 0.0f;
#pragma unroll
    for (int k = 0; k < nfl; ++k) {
      const int fi = l.fo + i0 + f * Nfp + p + P * k;
      TraceVals tv;
      tv.nx = __ldg(g.nx + fi); tv.ny = __ldg(g.ny + fi);
      tv.hM = sv[f][k][0]; tv.huM = sv[f][k][1]; tv.hvM = sv[f][k][2];
      tv.hP = sv[f][k][3]; tv.huP = sv[f][k][4]; tv.hvP = sv[f][k][5];
      trace_finish(g, h_bc, __ldg(g.wall + fi) != 0.0f,
                   g.has_tidal ? __ldg(g.obc + fi) : 0.0f,
                   depths ? __ldg(g.HMt + fi) : 0.0f,
                   depths ? __ldg(g.HPt + fi) : 0.0f, tv);
      trace_flux_pre(g, tv, p1[k], p2[k], p3[k]);
      trace_jumps(g, tv, q1[k], q2[k], q3[k]);
      const float sp = fmaxf(tv.spdM, tv.spdP);
      lam = k == 0 ? sp : fmaxf(lam, sp);
    }
#pragma unroll
    for (int m = 1; m < P; m <<= 1)
      lam = fmaxf(lam, __shfl_xor_sync(0xffffffffu, lam, m, P));
    const float hl = 0.5f * lam;
#pragma unroll
    for (int k = 0; k < nfl; ++k) {
      const int j = f * Nfp + p + P * k;
      const float fs = __ldg(g.fscale + l.fo + i0 + j);
      A[j] = make_float4((p1[k] - hl * q1[k]) * fs, (p2[k] - hl * q2[k]) * fs,
                         (p3[k] - hl * q3[k]) * fs, 0.0f);
    }
  }
  __syncwarp();

  // own nodes: lift, divergence of the fluxes, sources
  float r1[Z::CNP], r2[Z::CNP], r3[Z::CNP];
#pragma unroll
  for (int i = 0; i < ns; ++i) {
    const int n = p + P * i;
    r1[i] = r2[i] = r3[i] = 0.0f;
    if (n < Np) {
      float l1 = 0.0f, l2 = 0.0f, l3 = 0.0f;
#pragma unroll
      for (int j = 0; j < Ntr; ++j) {
        const float lf = LF[n * Ntr + j];
        const float4 a = A[j];
        l1 += lf * a.x; l2 += lf * a.y; l3 += lf * a.z;
      }
      float rF1 = 0, sF1 = 0, rG1 = 0, sG1 = 0, rF2 = 0, sF2 = 0;
      float rF3 = 0, sF3 = 0, rG3 = 0, sG3 = 0;
#pragma unroll
      for (int m = 0; m < Np; ++m) {
        const float2 ds = DS[n * Np + m];
        const float4 q = X[m];
        const float g3 = G[m];
        rF1 += ds.x * q.x; sF1 += ds.y * q.x; rG1 += ds.x * q.y;
        sG1 += ds.y * q.y; rF2 += ds.x * q.z; sF2 += ds.y * q.z;
        rF3 += ds.x * q.w; sF3 += ds.y * q.w; rG3 += ds.x * g3;
        sG3 += ds.y * g3;
      }
      const int v = l.fo + v0 + n;  // in the shard's float rows
      const float rx = __ldg(g.rx + v), sx = __ldg(g.sx + v);
      const float ry = __ldg(g.ry + v), sy = __ldg(g.sy + v);
      r1[i] = l1 - (rx * rF1 + sx * sF1 + ry * rG1 + sy * sG1);
      r2[i] = l2 - (rx * rF2 + sx * sF2 + ry * rF3 + sy * sF3);
      r3[i] = l3 - (rx * rF3 + sx * sF3 + ry * rG3 + sy * sG3);
      add_sources(g, v, x.h[i], x.hu[i], x.hv[i], nullptr, r2[i], r3[i]);
      if (ctrl != nullptr) {
#pragma unroll
        for (int c = 0; c < nc; ++c) {
          r2[i] += ctrl[c] * __ldg(g.BU + c * g.nV + v);
          r3[i] += ctrl[c] * __ldg(g.BV + c * g.nV + v);
        }
      }
    }
  }
  if (use_filter) {  // modal filter through the item's slots
    __syncwarp();
#pragma unroll
    for (int i = 0; i < ns; ++i) {
      const int n = p + P * i;
      if (n < Np) X[n] = make_float4(r1[i], r2[i], r3[i], 0.0f);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < ns; ++i) {
      const int n = p + P * i;
      if (n < Np) {
        float a = 0.0f, b = 0.0f, c = 0.0f;
#pragma unroll
        for (int m = 0; m < Np; ++m) {
          const float fl = FL[n * Np + m];
          const float4 q = X[m];
          a += fl * q.x; b += fl * q.y; c += fl * q.z;
        }
        r1[i] = a; r2[i] = b; r3[i] = c;
      }
    }
  }
  // the stage update
#pragma unroll
  for (int i = 0; i < ns; ++i) {
    const int n = p + P * i;
    float bh = x.h[i], bhu = x.hu[i], bhv = x.hv[i];  // (unused slot)
    if (BASE_REGS) {
      bh = bs.h[i]; bhu = bs.hu[i]; bhv = bs.hv[i];
    } else if (n < Np) {
      const int v = v0 + n;
      bh = base.a[v]; bhu = base.b[v]; bhv = base.c[v];
    }
    y.h[i] = bh + coef * r1[i];
    y.hu[i] = bhu + coef * r2[i];
    y.hv[i] = bhv + coef * r3[i];
  }
  if (limit) {
    // positivity limiter: squash toward the element's arithmetic nodal mean
    // where its minimum is below the floor, then taper near-dry momentum;
    // the element's minimum and sums over its lanes (the same bits in each)
    float hmin = INFINITY, sh = 0.0f, shu = 0.0f, shv = 0.0f;
#pragma unroll
    for (int i = 0; i < ns; ++i)
      if (p + P * i < Np) {
        hmin = fminf(hmin, y.h[i]);
        sh += y.h[i]; shu += y.hu[i]; shv += y.hv[i];
      }
#pragma unroll
    for (int m = 1; m < P; m <<= 1) {
      hmin = fminf(hmin, __shfl_xor_sync(0xffffffffu, hmin, m, P));
      sh += __shfl_xor_sync(0xffffffffu, sh, m, P);
      shu += __shfl_xor_sync(0xffffffffu, shu, m, P);
      shv += __shfl_xor_sync(0xffffffffu, shv, m, P);
    }
    const float floor_ = g.h_floor, hmean = sh / (float)Np;
    const float humean = shu / (float)Np, hvmean = shv / (float)Np;
    float theta = 1.0f;
    if (hmin < floor_) {
      const float denom = hmean - hmin;
      theta = (hmean - floor_) / (denom > 0.0f ? denom : 1.0f);
      theta = fminf(fmaxf(theta, 0.0f), 1.0f);
    }
#pragma unroll
    for (int i = 0; i < ns; ++i) {
      const float h = hmean + theta * (y.h[i] - hmean);
      const float taper =
          fminf(fmaxf((h - floor_) / (4.0f * floor_), 0.0f), 1.0f);
      y.hu[i] = (humean + theta * (y.hu[i] - humean)) * taper;
      y.hv[i] = (hvmean + theta * (y.hv[i] - hvmean)) * taper;
      y.h[i] = h;
    }
  }
  // the sponge, the store, the send slots
#pragma unroll
  for (int i = 0; i < ns; ++i) {
    const int n = p + P * i;
    if (n < Np) {
      const int v = v0 + n;
      if (sponge) sponge_relax(g, l.fo + v, dt, y.h[i], y.hu[i], y.hv[i]);
      if (l.active) {
        out.a[v] = y.h[i]; out.b[v] = y.hu[i]; out.c[v] = y.hv[i];
        if (to.buf != nullptr) {
          const int* ptr = g.send_ptr + l.io;
          const int q1 = __ldg(ptr + v + 1);
          for (int q = __ldg(ptr + v); q < q1; ++q) {
            float* s = send_slot(to, __ldg(g.send_idx + l.io + q));
            s[0] = y.h[i]; s[1] = y.hu[i]; s[2] = y.hv[i];
          }
        }
      }
    }
  }
}

// The item's slots: after the operators, blockDim/P items a block.
__device__ __forceinline__ float* q_item_slots(const Ops& o, int P) {
  return smem + q_ops_floats(o.Np, o.Ntr)
         + ((int)threadIdx.x / P) * q_item_floats(o.Np, o.Ntr);
}

template <class Z>
__global__ void __launch_bounds__(QMAX_THREADS, 2)
    sw2d_stage_kernel(SwDesc d, StageArgs a) {
  const Ops g = make_ops(d, a.fops, a.iops);
  q_setup_ops(g, smem);
  __syncthreads();
  const size_t ls = (size_t)d.n_send * 3;  // floats of one slot list
  q_zero_empty(g, a.istride, a.S, a.B, [&](int sh, int b, int j) {
    return a.sb + ((size_t)sh * a.B + b) * ls + 3 * j;
  });
  float* scr = q_item_slots(g, Z::P);
  const int ipb = blockDim.x / Z::P, n_items = a.S * a.B * d.K;
  for (int first = blockIdx.x * ipb; first < n_items;
       first += gridDim.x * ipb) {
    const QLane l = q_lane<Z>(first, n_items, a.B, d.K, a.fstride,
                              a.istride);
    const size_t off = (size_t)l.sc * g.nV;
    const P3 cur = at(a.ch, a.chu, a.chv, off);
    Own<Z> x, y;
    load_own<Z>(g, l.e, l.p, cur, x);
    qstage<Z, false>(g, smem, scr, l, cur, x, x, at(a.bh, a.bhu, a.bhv, off),
                     y, atw(a.oh, a.ohu, a.ohv, off),
                     SendTo{a.sb + l.sc * ls, nullptr, 0}, a.rb + l.sc * ls,
                     a.c_dt, a.t, a.c_dt, a.ctrl, a.use_filter,
                     g.wetdry != 0, a.sponge != 0);
  }
}

template <class Z>
__global__ void __launch_bounds__(QMAX_THREADS, 2)
    sw2d_step_rdma_kernel(SwDesc d, RdmaArgs a) {
  cg::grid_group grid = cg::this_grid();
  const Ops g = make_ops(d, a.fops, a.iops);
  q_setup_ops(g, smem);
  __syncthreads();
  // floats of one scenario's slot list (receive and send lists of a shard
  // have the same slots: slot j of the sender is slot j of the receiver)
  const size_t ls = (size_t)d.n_send * 3;
  // where shard sh's stage-1 slot j of scenario b goes: slot j of the
  // receiving shard's rb2 (the table picks the shard); without one (no
  // ring offsets), the shard's own slots
  auto push = [&](int sh, int b) {
    return a.dest != nullptr
               ? SendTo{a.rb2 + b * ls, a.dest + (size_t)sh * d.n_send,
                        (size_t)a.B * ls}
               : SendTo{a.rb2 + ((size_t)sh * a.B + b) * ls, nullptr, 0};
  };
  q_zero_empty(g, a.istride, a.S, a.B, [&](int sh, int b, int j) {
    return send_slot(push(sh, b), j);
  });
  q_zero_empty(g, a.istride, a.S, a.B, [&](int sh, int b, int j) {
    return a.sb + ((size_t)sh * a.B + b) * ls + 3 * j;
  });
  float* scr = q_item_slots(g, Z::P);
  const int ipb = blockDim.x / Z::P, n_items = a.S * a.B * d.K;
  // one pass covers every item: the lane's nodes stay in registers
  const bool resident = (long long)gridDim.x * ipb >= n_items;
  Own<Z> st, s1;
  for (int first = blockIdx.x * ipb; first < n_items;
       first += gridDim.x * ipb) {
    const QLane l = q_lane<Z>(first, n_items, a.B, d.K, a.fstride,
                              a.istride);
    const size_t off = (size_t)l.sc * g.nV;
    const P3 in = at(a.h, a.hu, a.hv, off);
    load_own<Z>(g, l.e, l.p, in, st);
    qstage<Z, true>(g, smem, scr, l, in, st, st, in, s1,
                    atw(a.s1h, a.s1hu, a.s1hv, off), push(l.sh, l.b),
                    a.rb + l.sc * ls, 0.5f * a.dt, a.t1, a.dt, a.ctrl,
                    a.use_filter, false, false);
  }
  grid.sync();
  for (int first = blockIdx.x * ipb; first < n_items;
       first += gridDim.x * ipb) {
    const QLane l = q_lane<Z>(first, n_items, a.B, d.K, a.fstride,
                              a.istride);
    const size_t off = (size_t)l.sc * g.nV;
    const P3 in = at(a.s1h, a.s1hu, a.s1hv, off);
    if (!resident) {
      load_own<Z>(g, l.e, l.p, in, s1);
      load_own<Z>(g, l.e, l.p, at(a.h, a.hu, a.hv, off), st);
    }
    Own<Z> y;
    qstage<Z, true>(g, smem, scr, l, in, s1, st, in, y,
                    atw(a.oh, a.ohu, a.ohv, off),
                    SendTo{a.sb + l.sc * ls, nullptr, 0}, a.rb2 + l.sc * ls,
                    a.dt, a.t2, a.dt, a.ctrl, a.use_filter, false,
                    a.sponge != 0);
  }
}

// ---------------------------------------------------------------------------
// The adjoint of one sharded stage
// ---------------------------------------------------------------------------
//
// sw2d_stage_bwd_kernel replaces _stage_bwd_kernel_v2 /
// sw2d_stage_bwd_blocked_v2 of blitzdg_tpu/ops/sw2d_blocked.py. Work unit:
// shard, scenario, chunk of elements (the blocked kernels' stage helpers).
// The transposed '+' gather crosses blocks: two phases around one grid
// barrier, as in the rollout adjoint above, and the receive slots'
// cotangents are the receive part of that gather. No atomics; the control
// cotangent is summed per unit and the units' sums are added in a fixed
// order.
//
// Bound on the card: bytes (the states and cotangents read and written
// outweigh one RHS adjoint per node at the card's float32 rate).

struct StageBwdArgs {
  const float* fops;
  const int* iops;
  long long fstride, istride;
  int S, B, E, use_filter, sponge;
  const float *ch, *chu, *chv;  // (S, B, nV) stage input
  const float* rb;              // (S, B, n_recv, 3)
  const float *lh, *lhu, *lhv;  // (S, B, nV) cotangent of the output
  const float* lsb;             // (S, B, n_send, 3) cotangent of the send buffer
  float *obh, *obhu, *obhv;     // (S, B, nV) out: cotangent of the base
  float *och, *ochu, *ochv;     // (S, B, nV) out: cotangent of the input
  float* orb;                   // (S, B, n_recv, 3) out
  float* octl;                  // (S, B, n_ctrl) out, or null
  float* T;                     // (S, B, nT, 6) scratch: trace cotangents
  float* cpart;                 // (S, B, n_chunks, n_ctrl) scratch
  float c_dt, t;
};

// With out = sponge(base + c_dt R(cur)) and sb = gather(out):
//   lam  = lam_out + gather^T lam_sb        (the inverse send list)
//   base cotangent = sponge factor * lam    (h only where there is bathymetry)
//   cur cotangent, rb cotangent, control cotangent = VJP_R(cur)[c_dt * that].
__global__ void sw2d_stage_bwd_kernel(SwDesc d, StageBwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  Ops blk = make_ops(d, a.fops, a.iops);
  const Scratch s = setup_block(blk, a.E);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int n_chunks = (blk.K + a.E - 1) / a.E;
  const int n_units = a.S * a.B * n_chunks;
  const size_t nV = (size_t)blk.nV, nT6 = (size_t)blk.nT * 6;
  const int nc = blk.n_ctrl, nr = blk.n_recv, ns = blk.n_send;

  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    const int sc = u / n_chunks, c = u - sc * n_chunks;
    const Ops o = shard_ops(d, a.fops, a.iops, a.fstride, a.istride,
                            sc / a.B, blk);
    const int e0 = c * a.E, ne = min(a.E, o.K - e0);
    const int nl = ne * o.Np, v0 = e0 * o.Np;
    const size_t off = (size_t)sc * nV;
    const float* lsb = a.lsb + (size_t)sc * ns * 3;
    for (int l = tid; l < nl; l += nth) {
      const size_t v = v0 + l;
      float l1 = a.lh[off + v], l2 = a.lhu[off + v], l3 = a.lhv[off + v];
      for (int q = o.send_ptr[v]; q < o.send_ptr[v + 1]; ++q) {
        const float* p = lsb + 3 * o.send_idx[q];
        l1 += p[0]; l2 += p[1]; l3 += p[2];
      }
      if (a.sponge) {
        const float fac = 1.0f / (1.0f + a.c_dt * o.SPNG[v]);
        if (o.has_bathy) l1 *= fac;
        l2 *= fac; l3 *= fac;
      }
      a.obh[off + v] = l1; a.obhu[off + v] = l2; a.obhv[off + v] = l3;
    }
    if (tid == 0)  // the same thread adds the block's sums in vjp_phase
      for (int k = 0; k < nc; ++k) a.cpart[(size_t)u * nc + k] = 0.0f;
    __syncthreads();
    vjp_phase(o, s, e0, ne, at(a.ch, a.chu, a.chv, off), a.t,
              at(a.obh, a.obhu, a.obhv, off), a.c_dt, a.use_filter,
              atw(a.och, a.ochu, a.ochv, off), a.T + sc * nT6,
              a.cpart + (size_t)u * nc, a.rb + (size_t)sc * nr * 3);
  }
  grid.sync();

  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    const int sc = u / n_chunks, c = u - sc * n_chunks;
    const Ops o = shard_ops(d, a.fops, a.iops, a.fstride, a.istride,
                            sc / a.B, blk);
    const int e0 = c * a.E, ne = min(a.E, o.K - e0);
    const int nl = ne * o.Np, v0 = e0 * o.Np;
    const size_t off = (size_t)sc * nV;
    for (int l = tid; l < nl; l += nth) {
      const int v = v0 + l;
      float c1 = a.och[off + v], c2 = a.ochu[off + v], c3 = a.ochv[off + v];
      gather_traces(o, a.T + sc * nT6, v, c1, c2, c3);
      a.och[off + v] = c1; a.ochu[off + v] = c2; a.ochv[off + v] = c3;
    }
  }
  // receive slots: the '+' cotangents of the trace nodes each slot fed
  const int gt = blockIdx.x * nth + tid, gn = gridDim.x * nth;
  for (int k = gt; k < a.S * a.B * nr; k += gn) {
    const int sc = k / nr, j = k - sc * nr;
    const long long so = (long long)(sc / a.B) * a.istride;
    const int* ptr = blk.invP_ptr + so;
    const int* idx = blk.invP_idx + so;
    const float* T = a.T + sc * nT6;
    float r0 = 0.0f, r1 = 0.0f, r2 = 0.0f;
    for (int q = ptr[nV + j]; q < ptr[nV + j + 1]; ++q) {
      const float* p = T + (size_t)idx[q] * 6 + 3;
      r0 += p[0]; r1 += p[1]; r2 += p[2];
    }
    a.orb[3 * (size_t)k] = r0; a.orb[3 * (size_t)k + 1] = r1;
    a.orb[3 * (size_t)k + 2] = r2;
  }
  // control cotangents: the units' sums, added in a fixed order
  if (a.octl != nullptr) {
    for (int k = gt; k < a.S * a.B * nc; k += gn) {
      const int sc = k / nc, r = k - sc * nc;
      float tot = 0.0f;
      for (int c = 0; c < n_chunks; ++c)
        tot += a.cpart[((size_t)sc * n_chunks + c) * nc + r];
      a.octl[k] = tot;
    }
  }
}

// ---------------------------------------------------------------------------
// C interface
// ---------------------------------------------------------------------------

typedef void (*StageKern)(SwDesc, StageArgs);
typedef void (*RdmaKern)(SwDesc, RdmaArgs);

// The instantiation of the sharded kernels for a set: N=3 with two
// controls (the MPC's), N=3 with others (a set built without injectors has
// one, which its rollouts never read), else the run-time sizes (-1 past
// their room).
static int q_kind(const SwDesc& d) {
  if (d.Nfaces != 3 || d.Np > QMAX_NP || d.Nfp > QMAX_NFP) return -1;
  if (d.Np == 10 && d.Nfp == 4) return d.n_ctrl == 2 ? 0 : 1;
  return 2;
}

static StageKern stage_kernel_of(const SwDesc& d) {
  switch (q_kind(d)) {
    case 0: return sw2d_stage_kernel<QOrder3Ctrl>;
    case 1: return sw2d_stage_kernel<QOrder3>;
    case 2: return sw2d_stage_kernel<QAnyOrder>;
    default: return nullptr;
  }
}

static RdmaKern rdma_kernel_of(const SwDesc& d) {
  switch (q_kind(d)) {
    case 0: return sw2d_step_rdma_kernel<QOrder3Ctrl>;
    case 1: return sw2d_step_rdma_kernel<QOrder3>;
    case 2: return sw2d_step_rdma_kernel<QAnyOrder>;
    default: return nullptr;
  }
}

// Lanes an item: a face's nodes at N=3, one otherwise.
static int q_lanes(const SwDesc& d) { return q_kind(d) == 2 ? 1 : 4; }

// Block size, grid and dynamic shared memory of the stage kernel
// (which = 0) or of the one-launch step kernel (which = 1) for S shards of
// B scenarios, from the occupancy the device reports: the largest block of
// 256, 128, 64, 32 threads that still gives every SM a block and whose
// shared memory fits the device's limit a block; the stage's
// grid covers every item, the step's is what is co-resident (its blocks
// loop over the rest). Sets the kernel's shared-memory limit. Run it once
// for a shape, before any launch of that shape (it is not a stream
// operation, and a launch issues nothing else). fstride, istride: the
// packed buffers' row lengths. plan: threads, grid, bytes, lanes an item.
// Returns a CUDA error.
static int q_plan(const SwDesc& d, int S, int B, int which, int* plan,
                  long long fstride, long long istride) {
  // the lanes address their shard's rows with 32-bit offsets
  if (q_kind(d) < 0 || S * fstride > 0x7fffffffLL ||
      S * istride > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const StageKern ks = stage_kernel_of(d);
  const RdmaKern kr = rdma_kernel_of(d);
  const int P = q_lanes(d);
  const long long lanes = (long long)S * B * d.K * P;
  cudaError_t e;
  int dev = 0, sms = 0, coop = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int threads = 32, optin = 0;
  for (int t = QMAX_THREADS; t >= 32; t /= 2)
    if ((lanes + t - 1) / t >= sms) { threads = t; break; }
  const int Ntr = d.Nfaces * d.Nfp;
  auto bytes_of = [&](int t) {
    return sizeof(float) * (q_ops_floats(d.Np, Ntr)
                            + (size_t)(t / P) * q_item_floats(d.Np, Ntr));
  };
  // high orders: a smaller block, until its shared memory fits (N=6 takes
  // 128 threads on the H100)
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  while (threads > 32 && bytes_of(threads) > (size_t)optin) threads /= 2;
  const size_t bytes = bytes_of(threads);
  if (bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  const int pe = which == 0 ? prepare(ks, bytes) : prepare(kr, bytes);
  if (pe != 0) return pe;
  int per_sm = 0;
  e = which == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &per_sm, ks, threads, bytes)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &per_sm, kr, threads, bytes);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  long long grid = (lanes + threads - 1) / threads;
  if (which == 1) {
    cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (!coop) return (int)cudaErrorNotSupported;
    if (grid > (long long)per_sm * sms) grid = (long long)per_sm * sms;
  }
  plan[0] = threads; plan[1] = (int)grid; plan[2] = (int)bytes; plan[3] = P;
  return 0;
}

// One launch of a planned shape (cooperative for the step: its blocks meet
// at a grid barrier); nothing but the launch, so that it can be captured
// into a CUDA graph.
template <class Args>
static int q_launch(void (*kern)(SwDesc, Args), const SwDesc& d,
                    const Args& a, const int* plan, bool coop, void* stream) {
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan[1]);
  cfg.blockDim = dim3(plan[0]);
  cfg.dynamicSmemBytes = (size_t)plan[2];
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = coop ? attr : nullptr;
  cfg.numAttrs = coop ? 1 : 0;
  g_last_grid = plan[1];
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, d, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" {

// Bytes of dynamic shared memory one block needs with chunks of E elements.
long long sw2d_blocked_smem_bytes(const SwDesc* d, int E) {
  Ops o = make_ops(*d, nullptr, nullptr);
  return (long long)(smem_floats(o, E) * sizeof(float));
}

// Blocks of the last launch (for reporting).
int sw2d_blocked_last_grid() { return g_last_grid; }

// One cooperative launch of `grid` blocks that passes n grid barriers.
int sw2d_blocked_barrier_probe(int n, int grid, int threads, void* stream) {
  void* args[] = {&n};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)sw2d_blocked_barrier_probe_kernel, dim3(grid),
      dim3(threads), args, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

static int launch_forward(const void* kern, const SwDesc* d,
                          const float* fops, const int* iops, FwdArgs a,
                          int threads, void* stream) {
  Ops o = make_ops(*d, fops, iops);
  const size_t bytes = smem_floats(o, a.E) * sizeof(float);
  const int n_units = a.B * ((o.K + a.E - 1) / a.E);
  void* args[] = {&o, &a};
  return coop_launch(kern, args, n_units, threads, bytes, stream);
}

// ctrl: (B, n_ctrl) or null. s1: 3*B*nV floats of scratch.
int sw2d_blocked_step(const SwDesc* d, const float* fops, const int* iops,
                      const float* h, const float* hu, const float* hv,
                      const float* ctrl, float* oh, float* ohu, float* ohv,
                      float* s1, int B, float dt, float t0, int use_filter,
                      int E, int threads, void* stream) {
  const size_t n = (size_t)B * d->K * d->Np;
  FwdArgs a = {h, hu, hv, ctrl, oh, ohu, ohv, s1, s1 + n, s1 + 2 * n,
               nullptr, nullptr, nullptr, B, 1, 1, 1, E, use_filter, dt, t0};
  return launch_forward((const void*)sw2d_blocked_step_kernel, d, fops, iops,
                        a, threads, stream);
}

// ctrls: (B, n_cs, n_ctrl) or null. With th/thu/thv (B, n_steps+1, nV) the
// trajectory is stored and oh/ohu/ohv are not touched; without, the final
// state goes to oh/ohu/ohv. s1: 3*B*nV floats of scratch.
int sw2d_blocked_rollout(const SwDesc* d, const float* fops, const int* iops,
                         const float* h, const float* hu, const float* hv,
                         const float* ctrls, float* oh, float* ohu,
                         float* ohv, float* th, float* thu, float* thv,
                         float* s1, int B, int n_steps, int n_cs, int spc,
                         float dt, float t0, int use_filter, int E,
                         int threads, void* stream) {
  const size_t n = (size_t)B * d->K * d->Np;
  FwdArgs a = {h, hu, hv, ctrls, oh, ohu, ohv, s1, s1 + n, s1 + 2 * n,
               th, thu, thv, B, n_steps, n_cs, spc, E, use_filter, dt, t0};
  return launch_forward((const void*)sw2d_blocked_rollout_kernel, d, fops,
                        iops, a, threads, stream);
}

// Floats of scratch that sw2d_blocked_rollout_bwd needs in `work`.
long long sw2d_blocked_bwd_work_floats(const SwDesc* d, int B, int n_cs,
                                       int E) {
  const long long nV = (long long)d->K * d->Np;
  const long long nT = (long long)d->K * d->Nfaces * d->Nfp;
  const long long n_chunks = (d->K + E - 1) / E;
  return 12 * B * nV + 12 * B * nT + (long long)B * n_chunks * n_cs * d->n_ctrl;
}

int sw2d_blocked_rollout_bwd(const SwDesc* d, const float* fops,
                             const int* iops, const float* th,
                             const float* thu, const float* thv,
                             const float* tbh, const float* tbhu,
                             const float* tbhv, const float* ctrls,
                             float* xbh, float* xbhu, float* xbhv,
                             float* cbar, float* work, int B, int n_cs,
                             int spc, float dt, float t0, int use_filter,
                             int E, int threads, void* stream) {
  Ops o = make_ops(*d, fops, iops);
  const size_t n3 = (size_t)3 * B * o.nV, t6 = (size_t)6 * B * o.nT;
  BwdArgs a;
  a.th = th; a.thu = thu; a.thv = thv;
  a.tbh = tbh; a.tbhu = tbhu; a.tbhv = tbhv;
  a.ctrls = ctrls;
  a.xbh = xbh; a.xbhu = xbhu; a.xbhv = xbhv; a.cbar = cbar;
  a.s1 = work; a.W = work + n3; a.A = work + 2 * n3; a.Bv = work + 3 * n3;
  a.T1 = work + 4 * n3; a.T2 = a.T1 + t6; a.cpart = a.T2 + t6;
  a.B = B; a.n_cs = n_cs; a.spc = spc; a.E = E; a.use_filter = use_filter;
  a.dt = dt; a.t0 = t0;
  const size_t bytes = smem_floats(o, E) * sizeof(float);
  const int n_units = B * ((o.K + E - 1) / E);
  void* args[] = {&o, &a};
  return coop_launch((const void*)sw2d_blocked_rollout_bwd_kernel, args,
                     n_units, threads, bytes, stream);
}

int sw2d_shard_plan(const SwDesc* d, int S, int B, int which,
                    long long fstride, long long istride, int* plan) {
  return q_plan(*d, S, B, which, plan, fstride, istride);
}

// One RK stage on every shard of a stacked sharded set: out = base +
// c_dt R(cur) with the cut faces' '+' values from rb, then the limiter
// (wet/dry) and the sponge (sponge != 0), and the send buffer of out.
// fops/iops: (S, fstride) / (S, istride); ctrl: (n_ctrl,) or null; plan:
// sw2d_shard_plan's for (S, B, 0).
int sw2d_stage(const SwDesc* d, const float* fops, const int* iops,
               long long fstride, long long istride, int S, int B,
               const float* bh, const float* bhu, const float* bhv,
               const float* ch, const float* chu, const float* chv,
               const float* rb, const float* ctrl, float* oh, float* ohu,
               float* ohv, float* sb, float c_dt, float t, int use_filter,
               int sponge, const int* plan, void* stream) {
  StageArgs a = {fops, iops, fstride, istride, S, B, use_filter, sponge,
                 bh, bhu, bhv, ch, chu, chv, rb, ctrl, oh, ohu, ohv, sb,
                 c_dt, t};
  return q_launch(stage_kernel_of(*d), *d, a, plan, false, stream);
}

// One SSP-RK2 step on every shard of a stacked sharded set in one
// cooperative launch, the stage-1 halo pushed into rb2 inside it (see
// sw2d_step_rdma_kernel). dest: (S, n_send) receiving shard of each send
// slot, or null without ring offsets; s1: 3*S*B*nV floats and rb2:
// S*B*n_recv*3 floats of scratch; t1, t2: the stage times; ctrl: (n_ctrl,)
// or null; plan: sw2d_shard_plan's for (S, B, 1).
int sw2d_step_rdma(const SwDesc* d, const float* fops, const int* iops,
                   long long fstride, long long istride, int S, int B,
                   const float* h, const float* hu, const float* hv,
                   const float* rb, const float* ctrl,
                   const long long* dest,
                   float* s1, float* rb2, float* oh, float* ohu, float* ohv,
                   float* sb, float dt, float t1, float t2, int use_filter,
                   int sponge, const int* plan, void* stream) {
  const size_t n = (size_t)S * B * d->K * d->Np;
  RdmaArgs a = {fops, iops, fstride, istride, S, B, use_filter, sponge,
                h, hu, hv, rb, ctrl, dest, s1, s1 + n, s1 + 2 * n, rb2,
                oh, ohu, ohv, sb, dt, t1, t2};
  return q_launch(rdma_kernel_of(*d), *d, a, plan, true, stream);
}

// Floats of scratch that sw2d_stage_bwd needs in `work`.
long long sw2d_stage_bwd_work_floats(const SwDesc* d, int S, int B, int E) {
  const long long nT = (long long)d->K * d->Nfaces * d->Nfp;
  const long long n_chunks = (d->K + E - 1) / E;
  return 6LL * S * B * nT + (long long)S * B * n_chunks * d->n_ctrl;
}

// The adjoint of sw2d_stage: cotangents of (out, sb) to those of (base,
// cur, rb) and, with octl, the control cotangent per shard and scenario.
int sw2d_stage_bwd(const SwDesc* d, const float* fops, const int* iops,
                   long long fstride, long long istride, int S, int B,
                   const float* ch, const float* chu, const float* chv,
                   const float* rb, const float* lh, const float* lhu,
                   const float* lhv, const float* lsb, float* obh,
                   float* obhu, float* obhv, float* och, float* ochu,
                   float* ochv, float* orb, float* octl, float* work,
                   float c_dt, float t, int use_filter, int sponge, int E,
                   int threads, void* stream) {
  Ops o = make_ops(*d, nullptr, nullptr);
  StageBwdArgs a;
  a.fops = fops; a.iops = iops; a.fstride = fstride; a.istride = istride;
  a.S = S; a.B = B; a.E = E; a.use_filter = use_filter; a.sponge = sponge;
  a.ch = ch; a.chu = chu; a.chv = chv; a.rb = rb;
  a.lh = lh; a.lhu = lhu; a.lhv = lhv; a.lsb = lsb;
  a.obh = obh; a.obhu = obhu; a.obhv = obhv;
  a.och = och; a.ochu = ochu; a.ochv = ochv; a.orb = orb; a.octl = octl;
  a.T = work; a.cpart = work + (size_t)6 * S * B * o.nT;
  a.c_dt = c_dt; a.t = t;
  const size_t bytes = smem_floats(o, E) * sizeof(float);
  const int n_units = S * B * ((o.K + E - 1) / E);
  SwDesc dd = *d;
  void* args[] = {&dd, &a};
  return coop_launch((const void*)sw2d_stage_bwd_kernel, args, n_units,
                     threads, bytes, stream);
}

}  // extern "C"
