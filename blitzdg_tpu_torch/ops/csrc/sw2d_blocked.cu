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
// They replace the Pallas TPU kernels _step_kernel, _rollout_kernel and
// _rollout_bwd_kernel of blitzdg_tpu/ops/sw2d_blocked.py. Those run one
// scenario's whole mesh on one core, packed (p, NP, M) with roll-based trace
// exchange. Here a mesh of thousands of elements does not fit one block's
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
  return to.shard == nullptr ? p : p + to.shard[j] * to.stride;
}

// Zeros in the empty send slots (the one slot of an unsharded plan).
__device__ __forceinline__ void zero_empty_slots(const Ops& o,
                                                 const SendTo& to) {
  for (int j = threadIdx.x; j < o.n_send; j += blockDim.x)
    if (o.send_node[j] < 0) {
      float* p = send_slot(to, j);
      p[0] = p[1] = p[2] = 0.0f;
    }
}

// Sponge relaxation toward rest (h = H where there is bathymetry, no flow),
// then the store of one volume node, and of the send slots that read it.
__device__ __forceinline__ void finish_node(const Ops& o, int v, float h,
                                            float hu, float hv, bool sponge,
                                            float dt, const W3& out,
                                            const SendTo& sb) {
  if (sponge) {
    const float fac = 1.0f / (1.0f + dt * o.SPNG[v]);
    if (o.has_bathy) { const float H = o.H[v]; h = H + (h - H) * fac; }
    hu *= fac; hv *= fac;
  }
  out.a[v] = h; out.b[v] = hu; out.c[v] = hv;
  if (sb.buf != nullptr) {
    for (int q = o.send_ptr[v]; q < o.send_ptr[v + 1]; ++q) {
      float* p = send_slot(sb, o.send_idx[q]);
      p[0] = h; p[1] = hu; p[2] = hv;
    }
  }
}

// One RK stage of one work unit (elements e0 .. e0+ne of one scenario):
//   out = base + coef * R(in, t), then the positivity limiter (limit) and the
//   sponge (sponge), on the unit's own nodes.
// in: the scenario's whole stage input in global memory (neighbours are read
// from it); base, out: the scenario's fields, touched at own nodes only (they
// may be the same buffer); copy: where to store the unit's part of `in` as
// well, or null pointers. One shard of a sharded set: rb, the scenario's
// receive buffer (cut-face '+' values), and sb, where its send slots go
// (written at the slots that read the unit's own nodes); none otherwise.
__device__ void stage(const Ops& o, const Scratch& s, int e0, int ne,
                      const P3& in, const P3& base, const W3& out,
                      const W3& copy, float coef, float t, float dt,
                      const float* ctrl, int use_filter, bool limit,
                      bool sponge, const float* rb = nullptr,
                      SendTo sb = SendTo{nullptr, nullptr, 0}) {
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
    trace_values(o, i0 + l, in.a, in.b, in.c, h_bc, tv, rb);
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
      finish_node(o, v, a, b, c, sponge, dt, out, sb);
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
      finish_node(o, v0 + l, h, hu * taper, hv * taper, sponge, dt, out, sb);
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
// One RK stage of an element-sharded set, and its adjoint
// ---------------------------------------------------------------------------
//
// sw2d_stage_kernel replaces _stage_kernel / sw2d_stage_blocked (lean-I/O
// mode) and sw2d_stage_bwd_kernel replaces _stage_bwd_kernel_v2 /
// sw2d_stage_bwd_blocked_v2 of blitzdg_tpu/ops/sw2d_blocked.py. The TPU
// kernels run one shard's packed mesh per program and move the halo with
// one-hot matmuls (RG/RL in, SGEM/SL out). Here a launch covers every shard
// of a stacked set (work unit: shard, scenario, chunk of elements; each
// shard's operators are one row of the packed buffers), the receive buffer
// is read where vmapP points past the shard's own nodes, and the send
// buffer is written through the inverse of the send list by the unit that
// owns each node. A stage reads `cur` and writes `out`, so the forward needs
// no grid barrier: an ordinary launch. The adjoint's transposed '+' gather
// crosses blocks: two phases around one grid barrier, as in the rollout
// adjoint above, and the receive slots' cotangents are the receive part of
// that gather. No atomics; the control cotangent is summed per unit and the
// units' sums are added in a fixed order.
//
// Bound on the card: bytes (the states read and written outweigh one RHS
// or one RHS adjoint per node at the card's float32 rate). At the sharded configuration's shapes a
// stage is a few microseconds of work, so launch and host time dominate a
// step (PERF.md).

struct StageArgs {
  const float* fops;  // (S, fstride) packed float operators, a row a shard
  const int* iops;    // (S, istride) packed index tables
  long long fstride, istride;
  int S, B, E, use_filter, sponge;
  const float *bh, *bhu, *bhv;  // (S, B, nV) axpy base
  const float *ch, *chu, *chv;  // (S, B, nV) stage input
  const float* rb;              // (S, B, n_recv, 3) receive buffer
  const float* ctrl;            // (n_ctrl,), shared by all, or null
  float *oh, *ohu, *ohv;        // (S, B, nV) out
  float* sb;                    // (S, B, n_send, 3) out: send buffer
  float c_dt, t;
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

__global__ void sw2d_stage_kernel(SwDesc d, StageArgs a) {
  Ops blk = make_ops(d, a.fops, a.iops);
  const Scratch s = setup_block(blk, a.E);
  const int n_chunks = (blk.K + a.E - 1) / a.E;
  const int n_units = a.S * a.B * n_chunks;
  const W3 none = {nullptr, nullptr, nullptr};
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    const int sc = u / n_chunks, c = u - sc * n_chunks;  // sc = shard*B + b
    const Ops o = shard_ops(d, a.fops, a.iops, a.fstride, a.istride,
                            sc / a.B, blk);
    const int e0 = c * a.E, ne = min(a.E, o.K - e0);
    const size_t off = (size_t)sc * o.nV;
    const SendTo sb = {a.sb + (size_t)sc * o.n_send * 3, nullptr, 0};
    stage(o, s, e0, ne, at(a.ch, a.chu, a.chv, off),
          at(a.bh, a.bhu, a.bhv, off), atw(a.oh, a.ohu, a.ohv, off), none,
          a.c_dt, a.t, a.c_dt, a.ctrl, a.use_filter, o.wetdry != 0,
          a.sponge != 0, a.rb + (size_t)sc * o.n_recv * 3, sb);
    if (c == 0) zero_empty_slots(o, sb);
  }
}

// ---------------------------------------------------------------------------
// One whole step of an element-sharded set in one launch
// ---------------------------------------------------------------------------
//
// sw2d_step_rdma_kernel replaces _step_kernel_rdma / sw2d_step_rdma_blocked
// of blitzdg_tpu/ops/sw2d_blocked.py. The TPU kernel runs one shard per
// device: it zeroes its receive buffer, signals READY to the peers that send
// to it, computes stage 1, waits for READY from its destinations, sends the
// stage-1 cut-face values by one remote DMA per ring offset into the peers'
// receive buffers and computes stage 2 from its own. Here one cooperative
// launch covers every shard of a stacked set (work unit: shard, scenario,
// chunk of elements, as in sw2d_stage_kernel) in two phases around ONE grid
// barrier:
//   1. stage 1 (c_dt = dt/2, no sponge) from the step-start state and the
//      step-boundary receive buffer rb; s1 goes to a scratch triple, and each
//      of s1's send slots is stored straight into slot j of the RECEIVING
//      shard's stage-2 receive buffer rb2 (shard s, chunk d -> shard
//      (s + offs[d]) mod S: the ring exchange's reverse source table). That
//      is the remote copy of the TPU kernel, and how a store into a peer
//      card's memory would go. The unit that owns a node writes its
//      slots through the inverse send list, so every slot has one writer: no
//      atomics, the same bits on a rerun;
//   2. the grid barrier stands for the READY handshake and for stage 2's
//      reads of s1 at neighbours that other units wrote;
//   3. stage 2 (c_dt = dt, stage time t + dt/2, the sponge) from s1, base the
//      step-start state, rb2; the output and its own send buffer for the
//      step-boundary exchange outside.
// Without ring offsets every slot is empty and rb2 is zeros, as the TPU
// kernel zeroes its receive buffer. No wet/dry branch (the wrapper refuses a
// wet/dry set, as the TPU wrapper does).
//
// Bound on the card: float32 operations of the two RHS evaluations against
// one state in and one out. What it saves over two stage launches is host
// time: one launch and one exchange a step instead of two of each.

struct RdmaArgs {
  const float* fops;
  const int* iops;
  long long fstride, istride;
  int S, B, E, use_filter, sponge;
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

__global__ void sw2d_step_rdma_kernel(SwDesc d, RdmaArgs a) {
  cg::grid_group grid = cg::this_grid();
  Ops blk = make_ops(d, a.fops, a.iops);
  const Scratch s = setup_block(blk, a.E);
  const int n_chunks = (blk.K + a.E - 1) / a.E;
  const int n_units = a.S * a.B * n_chunks;
  // floats of one scenario's slot list (receive and send lists of a shard
  // have the same slots: slot j of the sender is slot j of the receiver)
  const size_t ls = (size_t)blk.n_send * 3;
  const W3 none = {nullptr, nullptr, nullptr};
  for (int phase = 0; phase < 2; ++phase) {
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const int sc = u / n_chunks, c = u - sc * n_chunks;  // sc = shard*B + b
      const int sh = sc / a.B, b = sc - sh * a.B;
      const Ops o = shard_ops(d, a.fops, a.iops, a.fstride, a.istride, sh,
                              blk);
      const int e0 = c * a.E, ne = min(a.E, o.K - e0);
      const size_t off = (size_t)sc * o.nV;
      const P3 st = at(a.h, a.hu, a.hv, off);
      if (phase == 0) {
        // scenario b's slots of shard 0's rb2, the table picking the
        // shard; without one (no ring offsets), the shard's own slots
        const SendTo push =
            a.dest != nullptr
                ? SendTo{a.rb2 + b * ls, a.dest + (size_t)sh * o.n_send,
                         (size_t)a.B * ls}
                : SendTo{a.rb2 + sc * ls, nullptr, 0};
        stage(o, s, e0, ne, st, st, atw(a.s1h, a.s1hu, a.s1hv, off), none,
              0.5f * a.dt, a.t1, a.dt, a.ctrl, a.use_filter, false, false,
              a.rb + sc * ls, push);
        if (c == 0) zero_empty_slots(o, push);
      } else {
        const SendTo own = {a.sb + sc * ls, nullptr, 0};
        stage(o, s, e0, ne, at(a.s1h, a.s1hu, a.s1hv, off), st,
              atw(a.oh, a.ohu, a.ohv, off), none, a.dt, a.t2, a.dt, a.ctrl,
              a.use_filter, false, a.sponge != 0, a.rb2 + sc * ls, own);
        if (c == 0) zero_empty_slots(o, own);
      }
    }
    if (phase == 0) grid.sync();
  }
}

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

// One RK stage on every shard of a stacked sharded set: out = base +
// c_dt R(cur) with the cut faces' '+' values from rb, then the limiter
// (wet/dry) and the sponge (sponge != 0), and the send buffer of out.
// fops/iops: (S, fstride) / (S, istride); ctrl: (n_ctrl,) or null.
int sw2d_stage(const SwDesc* d, const float* fops, const int* iops,
               long long fstride, long long istride, int S, int B,
               const float* bh, const float* bhu, const float* bhv,
               const float* ch, const float* chu, const float* chv,
               const float* rb, const float* ctrl, float* oh, float* ohu,
               float* ohv, float* sb, float c_dt, float t, int use_filter,
               int sponge, int E, int threads, void* stream) {
  StageArgs a = {fops, iops, fstride, istride, S, B, E, use_filter, sponge,
                 bh, bhu, bhv, ch, chu, chv, rb, ctrl, oh, ohu, ohv, sb,
                 c_dt, t};
  Ops o = make_ops(*d, nullptr, nullptr);
  const size_t bytes = smem_floats(o, E) * sizeof(float);
  const int n_units = S * B * ((o.K + E - 1) / E);
  const int pe = prepare(sw2d_stage_kernel, bytes);
  if (pe != 0) return pe;
  g_last_grid = n_units;
  sw2d_stage_kernel<<<n_units, threads, bytes, (cudaStream_t)stream>>>(*d, a);
  return (int)cudaGetLastError();
}

// One SSP-RK2 step on every shard of a stacked sharded set in one
// cooperative launch, the stage-1 halo pushed into rb2 inside it (see
// sw2d_step_rdma_kernel). dest: (S, n_send) receiving shard of each send
// slot, or null without ring offsets; s1: 3*S*B*nV floats and rb2: S*B*n_recv*3 floats of scratch;
// t1, t2: the stage times; ctrl: (n_ctrl,) or null.
int sw2d_step_rdma(const SwDesc* d, const float* fops, const int* iops,
                   long long fstride, long long istride, int S, int B,
                   const float* h, const float* hu, const float* hv,
                   const float* rb, const float* ctrl,
                   const long long* dest,
                   float* s1, float* rb2, float* oh, float* ohu, float* ohv,
                   float* sb, float dt, float t1, float t2, int use_filter,
                   int sponge, int E, int threads, void* stream) {
  Ops o = make_ops(*d, nullptr, nullptr);
  const size_t n = (size_t)S * B * o.nV;
  RdmaArgs a = {fops, iops, fstride, istride, S, B, E, use_filter, sponge,
                h, hu, hv, rb, ctrl, dest, s1, s1 + n, s1 + 2 * n, rb2,
                oh, ohu, ohv, sb, dt, t1, t2};
  const size_t bytes = smem_floats(o, E) * sizeof(float);
  const int n_units = S * B * ((o.K + E - 1) / E);
  SwDesc dd = *d;
  void* args[] = {&dd, &a};
  return coop_launch((const void*)sw2d_step_rdma_kernel, args, n_units,
                     threads, bytes, stream);
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
