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
// where it is tested against torch.autograd. The pointwise formulas (trace
// values, fluxes, sources, their adjoints and the tie rules) live in
// sw2d_common.cuh, shared with the blocked kernels.
//
// Plain C interface (extern "C" at the end), loaded with ctypes. Launches go
// to the stream that is passed in; nothing here synchronises or allocates.

#include "sw2d_common.cuh"

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
  const float h_bc = tidal_depth(o, t);

  for (int v = tid; v < o.nV; v += nth)
    volume_fluxes(o, S.a[v], S.b[v], S.c[v], w.vflux.a[v], w.vflux.b[v],
                  w.vflux.c[v]);
  for (int i = tid; i < o.nT; i += nth) {
    TraceVals tv;
    trace_values(o, i, S.a, S.b, S.c, h_bc, tv);
    trace_flux_pre(o, tv, w.pre.a[i], w.pre.b[i], w.pre.c[i]);
    trace_jumps(o, tv, w.dq.a[i], w.dq.b[i], w.dq.c[i]);
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
    add_sources(o, v, S.a[v], S.b[v], S.c[v], ctrl, r2, r3);
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
    float hb, hub, hvb;
    volume_vjp_point(o, v, S.a[v], S.b[v], S.c[v], Fb1, Fb2, Fb3, Gb1, Gb2,
                     Gb3, w.wf.b[v], w.wf.c[v], hb, hub, hvb);
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
    float lam;
    // (this node's speed as the first pass stored it: a recomputed value
    // may be contracted differently and miss the equality with the maximum)
    const float sb = face_speed_share(w.spd, w.lamb, (i / o.Nfp) * o.Nfp,
                                      o.Nfp, w.spd[i], lam);
    float tM[3], tP[3];
    face_vjp_point(o, tv, lam, sb, w.dfb.a[i], w.dfb.b[i], w.dfb.c[i], tM,
                   tP);
    w.tM.a[i] = tM[0]; w.tM.b[i] = tM[1]; w.tM.c[i] = tM[2];
    w.tP.a[i] = tP[0]; w.tP.b[i] = tP[1]; w.tP.c[i] = tP[2];
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
