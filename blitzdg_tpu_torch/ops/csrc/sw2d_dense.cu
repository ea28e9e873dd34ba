// Fused shallow-water kernels for the dense (small-mesh) MPC regime, sm_90a.
//
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
// Work unit: one thread per (element, scenario). A block holds a tile of Bs
// scenarios x all K elements of the mesh (the headline: 4 x 40 = 160
// threads forward, 8 x 40 in the adjoint); the grid covers the batch, and the lanes past K*Bs
// and the scenarios past B of a ragged last tile are masked (they only take
// part in the barriers). A thread keeps its element's state, RK stage and
// RHS accumulators in registers; the state a stage starts from, and in the
// adjoint lambda and the control partial sums, wait in the thread's own
// slots of shared memory while the RHS and its VJP take the registers (96 a
// thread: ptxas spills nothing). It meets its neighbours only in shared
// memory:
//   - each stage publishes, per scenario, the element's nodal values
//     (h, hu, hv, u = hu/h as a float4, v = hv/h beside it) and the speed
//     |(u, v)| + sqrt(g h*) of each of its '-' trace nodes, computed once by
//     the owner in IEEE arithmetic. A trace node reads its '+' values and
//     the '+' speed there (the neighbour's matching '-' trace node, found
//     once a launch from the inverse map of vmapM). So both sides of a face
//     compare the same bits, and the face maximum and its tie split (C6-C8)
//     see one value per side. Wall, tidal and unmatched trace nodes compute
//     their '+' side themselves, in the same IEEE arithmetic;
//   - in the adjoint, each trace node's '+' cotangent goes to shared memory
//     and, after a barrier, the owner of each volume node gathers it through
//     invP (CSR order). The '-' transpose (invM) stays in the thread. No
//     atomics: a rerun gives the same bits.
// Published states are double-buffered (stage input s and stage s1 in two
// areas), so that no barrier guards an overwrite. Block barriers a step:
//   forward: 2 (publish s, barrier, stage 1; publish s1, barrier, stage 2);
//   adjoint: 4 (publish s_t, barrier, recompute s_half; publish s_half,
//            barrier; VJP at s_half writes its '+' cotangents, barrier,
//            gather; VJP at s_t writes its '+' cotangents into the area of
//            s_half, which no one reads any more, barrier, gather).
// The control cotangent is summed per thread over a control interval and
// reduced over the scenario's elements, in element order, by one thread a
// scenario after the next barrier.
//
// Lane order: scenario innermost (thread = element * Bs + scenario). A
// warp holds 32/Bs elements of Bs scenarios, so the per-element tables
// (geometry, flags, maps) are read as broadcasts, and the shared areas,
// laid out [item][scenario], take a warp's reads of its own items without
// bank conflicts. The price is the trajectory store: each thread writes
// its element's nodes of its own scenario's row (12-byte runs per field at
// N=1; the elements of a scenario complete the sectors in L2).
//
// What is read once: the reference operators (Dr, Ds, lift, filt: 45
// floats at N=1) go to shared memory once a launch and are read as
// broadcasts; each element's geometry (rx, sx, ry, sy, Hx, Hy and the
// control injectors a node; nx, ny, fscale, HMt, HPt, the '+' node, the
// matching trace node and the flags a trace node; the first '+' readers of
// a node) is copied once a launch into a per-block table in shared memory,
// which the tile's scenarios share.
//
// Sizes: the kernels are instantiated for N=1 with two controls (Np 3, Nfp
// 2, n_ctrl 2: every node, face and control loop unrolled, the element's
// arrays in registers, its '-' node of each trace node known at compile
// time from the reference element's face mask {0,1},{1,2},{0,2}, which is
// vmapM - k Np of every element that specgrid/triangle.py builds), beside
// one instantiation that reads the sizes at run time (any other order up to
// MAX_NP nodes; its arrays live in local memory).
//
// Arithmetic: float32, IEEE division and square root wherever a value feeds
// a speed that can decide a tie, and in the whole forward; the adjoint's
// pointwise chain rules (volume_vjp_fast, face_vjp_fast) take the fast
// reciprocal (2 ulp). The pointwise formulas are those of sw2d_common.cuh.
//
// Bound on the card: float32 operations (the trajectory, 12 bytes a node a
// step, against about a thousand operations a node a step). What this design
// does about it: no phase barrier inside a RHS, no integer division in a
// loop, no operator or geometry reread from device memory, no '-' trace
// value computed twice. The RHS's loops are unrolled; the VJP's loop over
// faces runs at run time (one face's values live at a time: with it
// unrolled, ptxas spilled at 96 registers). The tile (Bs) is chosen by the
// launcher from the occupancy the device reports (pick_tile).
//
// Plain C interface (extern "C" at the end), loaded with ctypes. Launches go
// to the stream that is passed in; nothing here synchronises or allocates.

#include "sw2d_common.cuh"

// Largest block (one thread per element of a tile): also what ptxas cuts the
// registers to, 96 a thread, so that 20 warps share an SM (the headline's
// 2048 scenarios in one wave: four blocks of 160 threads an SM forward, two
// of 320 in the adjoint, whose shared memory is twice the forward's).
#define MAX_THREADS 640
// Room of the run-time-size instantiation's arrays: nodes (N=6), nodes a
// face, controls.
#define MAX_NP 28
#define MAX_NFP 7
#define MAX_CTRL 8

extern __shared__ __align__(16) float smem[];

// One argument block for the three kernels.
struct DenseArgs {
  const float *h, *hu, *hv;        // initial state (B, nV)
  const float* ctrls;              // (B, n_cs, n_ctrl)
  float *oh, *ohu, *ohv;           // final state | adjoint: its cotangent
  float *th, *thu, *thv;           // trajectory (B, n_steps+1, nV) or null
  const float *tbh, *tbhu, *tbhv;  // adjoint: the trajectory's cotangent
  float* cbar;                     // adjoint: (B, n_cs, n_ctrl)
  int B, n_cs, spc, Bs, use_filter;
  float dt, t0;
};

// N=1's '-' node of trace node j: the reference face mask.
__host__ __device__ constexpr int fmask_order1(int j) {
  return j == 0 ? 0 : (j == 1 || j == 2) ? 1 : j == 4 ? 0 : 2;
}

// Nodes, nodes a face and controls: constants of the instantiation where
// the template gives them (loops unroll, arrays are registers), else read
// from the operator set.
template <int NP, int NFP, int NC>
struct DSizes {
  static constexpr int CNP = NP ? NP : MAX_NP;   // room of a nodal array
  static constexpr int CFP = NP ? NFP : MAX_NFP;  // room of a face array
  static constexpr int CC = NP ? NC : MAX_CTRL;   // room of the controls
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
    return NP ? NC : o.n_ctrl;
  }
  // the element's local node of the '-' side of trace node j
  __device__ __forceinline__ static int fm(int j, int flags) {
    return NP ? fmask_order1(j) : flags >> 8;
  }
};
typedef DSizes<3, 2, 2> Order1;  // the headline: N=1, two controls
typedef DSizes<0, 0, 0> AnyOrder;

static bool is_order1(const SwDesc& d) {
  return d.Np == 3 && d.Nfp == 2 && d.Nfaces == 3 && d.n_ctrl == 2;
}

// Flags of a trace node in the table.
#define FL_WALL 1
#define FL_OBC 2
#define FL_LOCAL 4  // the '+' side is computed here (wall, tidal, unmatched)

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// One element's record in the block's table, in floats (ints stored as
// their bits). Per node n: rx, sx, ry, sy at M + 4n (float4); Hx, Hy at
// BA + 2n; (BU_c, BV_c) at CT + 2 (n n_ctrl + c). Per trace node j: nx,
// ny, fscale, HMt at TR + 4j (float4); HPt, '+' node, matching trace node,
// flags (bits 8+: the '-' node) at TI + 4j (int4). Per node: its first two
// '+' readers, its CSR start and count in invP at IP + 4n (int4).
struct Rec {
  int BA, CT, TR, TI, IP, size;
};

__host__ __device__ inline Rec rec_layout(int Np, int Ntr, int nc) {
  Rec r;
  r.BA = 4 * Np;
  r.CT = 6 * Np;
  r.TR = round4(6 * Np + 2 * Np * nc);
  r.TI = r.TR + 4 * Ntr;
  r.IP = r.TI + 4 * Ntr;
  r.size = r.IP + 4 * Np;
  return r;
}

// Offsets (floats) of the block's shared memory: operators, table, the two
// published states; for the adjoint its first cotangent area, the control
// partial sums ([control][thread]) and lambda ([field][node][thread]),
// each thread's own.
struct DenseLayout {
  int ops, tab, rec, pub, buf0, buf1, t1, cpart, lam, total;
};

__host__ __device__ inline DenseLayout dense_layout(int K, int Np, int Ntr,
                                                    int nc, int Bs, int bwd) {
  DenseLayout L;
  const int nV = K * Np, nT = K * Ntr;
  L.rec = rec_layout(Np, Ntr, nc).size;
  int p = 0;
  L.ops = p; p += round4(3 * Np * Np + Np * Ntr);
  L.tab = p; p += K * L.rec;
  L.pub = round4(Bs * (5 * nV + nT));
  // the adjoint's second cotangent area lies in the second state's
  if (bwd && round4(3 * nT * Bs) > L.pub) L.pub = round4(3 * nT * Bs);
  L.buf0 = p; p += L.pub;
  L.buf1 = p; p += L.pub;
  L.t1 = p; if (bwd) p += round4(3 * nT * Bs);
  L.cpart = p; if (bwd) p += round4(K * nc * Bs);
  L.lam = p; if (bwd) p += 3 * nV * Bs;
  L.total = p;
  return L;
}

// A published state of the tile, [item][scenario].
struct Pub {
  float4* n4;  // (h, hu, hv, u) a node
  float* v;    // hv / h a node
  float* spd;  // the '-' speed a trace node
};

__device__ __forceinline__ Pub pub_at(float* p, int nV, int Bs) {
  Pub s;
  s.n4 = reinterpret_cast<float4*>(p);
  s.v = p + 4 * nV * Bs;
  s.spd = s.v + nV * Bs;
  return s;
}

// ---------------------------------------------------------------------------
// Set-up: operators and the element table, once a launch
// ---------------------------------------------------------------------------

template <class Z>
__device__ void build_record(const Ops& o, int e, float* r) {
  const int Np = Z::np(o), Ntr = Z::ntr(o), nc = Z::nc(o);
  const Rec R = rec_layout(Np, Ntr, nc);
  int* ri = reinterpret_cast<int*>(r);
  for (int n = 0; n < Np; ++n) {
    const int v = e * Np + n;
    r[4 * n] = o.rx[v]; r[4 * n + 1] = o.sx[v];
    r[4 * n + 2] = o.ry[v]; r[4 * n + 3] = o.sy[v];
    r[R.BA + 2 * n] = o.Hx[v]; r[R.BA + 2 * n + 1] = o.Hy[v];
    for (int c = 0; c < nc; ++c) {
      r[R.CT + 2 * (n * nc + c)] = o.BU[c * o.nV + v];
      r[R.CT + 2 * (n * nc + c) + 1] = o.BV[c * o.nV + v];
    }
    const int start = o.invP_ptr[v], cnt = o.invP_ptr[v + 1] - start;
    ri[R.IP + 4 * n] = cnt > 0 ? o.invP_idx[start] : 0;
    ri[R.IP + 4 * n + 1] = cnt > 1 ? o.invP_idx[start + 1] : 0;
    ri[R.IP + 4 * n + 2] = start;
    ri[R.IP + 4 * n + 3] = cnt;
  }
  for (int j = 0; j < Ntr; ++j) {
    const int gi = e * Ntr + j;
    r[R.TR + 4 * j] = o.nx[gi]; r[R.TR + 4 * j + 1] = o.ny[gi];
    r[R.TR + 4 * j + 2] = o.fscale[gi]; r[R.TR + 4 * j + 3] = o.HMt[gi];
    const int vm = o.vmapM[gi], vp = o.vmapP[gi];
    int mp = gi, flags = 0;
    if (vp != vm) {  // the neighbour's trace node that reads vm as '+'
      mp = -1;
      for (int q = o.invM_ptr[vp]; q < o.invM_ptr[vp + 1]; ++q) {
        const int i2 = o.invM_idx[q];
        if (o.vmapP[i2] == vm) { mp = i2; break; }
      }
      if (mp < 0) { mp = gi; flags |= FL_LOCAL; }
    }
    if (o.wall[gi] != 0.0f) flags |= FL_WALL | FL_LOCAL;
    if (o.has_tidal && o.obc[gi] != 0.0f) flags |= FL_OBC | FL_LOCAL;
    flags |= (vm - e * Np) << 8;
    ri[R.TI + 4 * j] = __float_as_int(o.HPt[gi]);
    ri[R.TI + 4 * j + 1] = vp;
    ri[R.TI + 4 * j + 2] = mp;
    ri[R.TI + 4 * j + 3] = flags;
  }
}

template <class Z>
__device__ void setup_block(const Ops& o, const DenseLayout& L) {
  const int Np = Z::np(o), Ntr = Z::ntr(o);
  const int n_ops = 3 * Np * Np + Np * Ntr;  // Dr, Ds, lift, filt in a row
  for (int i = threadIdx.x; i < n_ops; i += blockDim.x)
    smem[L.ops + i] = o.Dr[i];
  for (int e = threadIdx.x; e < o.K; e += blockDim.x)
    build_record<Z>(o, e, smem + L.tab + e * L.rec);
}

// ---------------------------------------------------------------------------
// The stage: publish, and one RHS after the barrier
// ---------------------------------------------------------------------------

// Publishes the element's nodal values and its '-' speeds into S.
template <class Z>
__device__ __forceinline__ void publish(const Ops& o, const float* r,
                                        const Pub& S, int k, int b, int Bs,
                                        const float* h, const float* hu,
                                        const float* hv) {
  const int Np = Z::np(o), Ntr = Z::ntr(o);
  const Rec R = rec_layout(Np, Ntr, Z::nc(o));
  float u[Z::CNP], v[Z::CNP];
#pragma unroll
  for (int n = 0; n < Np; ++n) {
    const int vv = (k * Np + n) * Bs + b;
    u[n] = hu[n] / h[n];
    v[n] = hv[n] / h[n];
    S.n4[vv] = make_float4(h[n], hu[n], hv[n], u[n]);
    S.v[vv] = v[n];
  }
#pragma unroll
  for (int j = 0; j < Ntr; ++j) {
    const int flags = reinterpret_cast<const int*>(r)[R.TI + 4 * j + 3];
    const int n = Z::fm(j, flags);
    float hs = h[n];
    if (o.wb) {
      const float HM = r[R.TR + 4 * j + 3];
      const int* ri = reinterpret_cast<const int*>(r);
      const float HP = __int_as_float(ri[R.TI + 4 * j]);
      const float bstar = fmaxf(-HM, -HP);
      hs = fmaxf(0.0f, h[n] - HM - bstar);
    }
    S.spd[(k * Ntr + j) * Bs + b] = safe_norm(u[n], v[n]) + sqrtf(o.g * hs);
  }
}

// The trace values of the element's trace node j from a published state.
template <class Z>
__device__ __forceinline__ void trace_at(const Ops& o, const float* r,
                                         const Pub& S, int k, int j, int b,
                                         int Bs, float h_bc, TraceVals& tv) {
  const int Np = Z::np(o), Ntr = Z::ntr(o);
  const Rec R = rec_layout(Np, Ntr, Z::nc(o));
  const float4 g = *reinterpret_cast<const float4*>(r + R.TR + 4 * j);
  const int4 m = *reinterpret_cast<const int4*>(r + R.TI + 4 * j);
  const int vm = (k * Np + Z::fm(j, m.w)) * Bs + b, vp = m.y * Bs + b;
  tv.nx = g.x; tv.ny = g.y;
  const float4 M = S.n4[vm], P = S.n4[vp];
  tv.hM = M.x; tv.huM = M.y; tv.hvM = M.z; tv.uM = M.w; tv.vM = S.v[vm];
  tv.hP = P.x; tv.huP = P.y; tv.hvP = P.z; tv.uP = P.w; tv.vP = S.v[vp];
  tv.spdM = S.spd[(k * Ntr + j) * Bs + b];
  tv.wall = (m.w & FL_WALL) != 0;
  tv.obc = (m.w & FL_OBC) ? 1.0f : 0.0f;
  const bool local = (m.w & FL_LOCAL) != 0;
  if (local) {
    if (tv.wall) {  // reflect the normal momentum
      const float un2 = 2.0f * (tv.huM * tv.nx + tv.hvM * tv.ny);
      tv.huP = tv.huM - un2 * tv.nx;
      tv.hvP = tv.hvM - un2 * tv.ny;
    }
    if (o.has_tidal) tv.hP = tv.hP + tv.obc * (h_bc - tv.hP);
    tv.uP = tv.huP / tv.hP;
    tv.vP = tv.hvP / tv.hP;
  }
  tv.passM = tv.passP = true;
  if (o.wb) {
    const float HM = g.w, HP = __int_as_float(m.x);
    const float bstar = fmaxf(-HM, -HP);
    const float aM = tv.hM - HM - bstar, aP = tv.hP - HP - bstar;
    tv.passM = aM > 0.0f; tv.passP = aP > 0.0f;
    tv.hMs = fmaxf(0.0f, aM); tv.hPs = fmaxf(0.0f, aP);
  } else {
    tv.hMs = tv.hM; tv.hPs = tv.hP;
  }
  tv.spdP = local ? safe_norm(tv.uP, tv.vP) + sqrtf(o.g * tv.hPs)
                  : S.spd[m.z * Bs + b];
}

// One filtered, control-forced RHS of the element at the published state S
// (its own nodes included): K1..K3, Np values each. h_bc: the tidal depth
// at the stage's time (computed by the caller where few values are live).
template <class Z>
__device__ __forceinline__ void rhs(const Ops& o, const DenseLayout& L,
                                    const float* r, const Pub& S, int k,
                                    int b, int Bs, float h_bc,
                                    const float* ctrl,
                                    int use_filter, float* K1, float* K2,
                                    float* K3) {
  const int Np = Z::np(o), Ntr = Z::ntr(o), Nfp = Z::nfp(o), nc = Z::nc(o);
  const Rec R = rec_layout(Np, Ntr, nc);
  const float* Dr = smem + L.ops;
  const float* Ds = Dr + Np * Np;
  const float* lift = Ds + Np * Np;
  const float* filt = lift + Np * Ntr;

  // surface: per face, the speed-independent jumps, the face maximum, then
  // the scaled jumps lifted
  float l1[Z::CNP], l2[Z::CNP], l3[Z::CNP];
#pragma unroll
  for (int n = 0; n < Np; ++n) l1[n] = l2[n] = l3[n] = 0.0f;
#pragma unroll
  for (int f0 = 0; f0 < Ntr; f0 += Nfp) {
    float p1[Z::CFP], p2[Z::CFP], p3[Z::CFP];
    float q1[Z::CFP], q2[Z::CFP], q3[Z::CFP], sp[Z::CFP];
#pragma unroll
    for (int jj = 0; jj < Nfp; ++jj) {
      TraceVals tv;
      trace_at<Z>(o, r, S, k, f0 + jj, b, Bs, h_bc, tv);
      trace_flux_pre(o, tv, p1[jj], p2[jj], p3[jj]);
      trace_jumps(o, tv, q1[jj], q2[jj], q3[jj]);
      sp[jj] = fmaxf(tv.spdM, tv.spdP);
    }
    float lam = sp[0];
#pragma unroll
    for (int jj = 1; jj < Nfp; ++jj) lam = fmaxf(lam, sp[jj]);
    const float hl = 0.5f * lam;
#pragma unroll
    for (int jj = 0; jj < Nfp; ++jj) {
      const int j = f0 + jj;
      const float fs = r[R.TR + 4 * j + 2];
      const float a1 = (p1[jj] - hl * q1[jj]) * fs;
      const float a2 = (p2[jj] - hl * q2[jj]) * fs;
      const float a3 = (p3[jj] - hl * q3[jj]) * fs;
#pragma unroll
      for (int n = 0; n < Np; ++n) {
        const float lf = lift[n * Ntr + j];
        l1[n] += lf * a1; l2[n] += lf * a2; l3[n] += lf * a3;
      }
    }
  }

  // volume: divergence of the fluxes, sources
  float hh[Z::CNP], hu[Z::CNP], hv[Z::CNP];
  float F2[Z::CNP], F3[Z::CNP], G3[Z::CNP];
#pragma unroll
  for (int m = 0; m < Np; ++m) {
    const float4 q = S.n4[(k * Np + m) * Bs + b];
    hh[m] = q.x; hu[m] = q.y; hv[m] = q.z;
    volume_fluxes(o, q.x, q.y, q.z, F2[m], F3[m], G3[m]);
  }
  float r1[Z::CNP], r2[Z::CNP], r3[Z::CNP];
#pragma unroll
  for (int n = 0; n < Np; ++n) {
    float rF1 = 0, sF1 = 0, rG1 = 0, sG1 = 0, rF2 = 0, sF2 = 0;
    float rF3 = 0, sF3 = 0, rG3 = 0, sG3 = 0;
#pragma unroll
    for (int m = 0; m < Np; ++m) {
      const float dr = Dr[n * Np + m], ds = Ds[n * Np + m];
      rF1 += dr * hu[m]; sF1 += ds * hu[m]; rG1 += dr * hv[m];
      sG1 += ds * hv[m]; rF2 += dr * F2[m]; sF2 += ds * F2[m];
      rF3 += dr * F3[m]; sF3 += ds * F3[m]; rG3 += dr * G3[m];
      sG3 += ds * G3[m];
    }
    const float4 mt = *reinterpret_cast<const float4*>(r + 4 * n);
    const float rx = mt.x, sx = mt.y, ry = mt.z, sy = mt.w;
    r1[n] = l1[n] - (rx * rF1 + sx * sF1 + ry * rG1 + sy * sG1);
    r2[n] = l2[n] - (rx * rF2 + sx * sF2 + ry * rF3 + sy * sF3);
    r3[n] = l3[n] - (rx * rF3 + sx * sF3 + ry * rG3 + sy * sG3);
    const int vv = (k * Np + n) * Bs + b;
    const float2 ba = *reinterpret_cast<const float2*>(r + R.BA + 2 * n);
    add_sources_at(o, hh[n], hu[n], hv[n], S.n4[vv].w, S.v[vv], ba.x, ba.y,
                   ctrl,
                   reinterpret_cast<const float2*>(r + R.CT + 2 * n * nc), nc,
                   r2[n], r3[n]);
  }
  if (use_filter) {
#pragma unroll
    for (int n = 0; n < Np; ++n) {
      float a = 0.0f, c = 0.0f, d = 0.0f;
#pragma unroll
      for (int m = 0; m < Np; ++m) {
        const float fl = filt[n * Np + m];
        a += fl * r1[m]; c += fl * r2[m]; d += fl * r3[m];
      }
      K1[n] = a; K2[n] = c; K3[n] = d;
    }
  } else {
#pragma unroll
    for (int n = 0; n < Np; ++n) {
      K1[n] = r1[n]; K2[n] = r2[n]; K3[n] = r3[n];
    }
  }
}

// The thread's element and scenario.
struct Lane {
  int k, b, sc;
  bool active;
};

__device__ __forceinline__ Lane lane_of(const Ops& o, const DenseArgs& a) {
  Lane l;
  l.k = threadIdx.x / a.Bs;
  l.b = threadIdx.x - l.k * a.Bs;
  l.sc = blockIdx.x * a.Bs + l.b;
  l.active = l.k < o.K && l.sc < a.B;
  return l;
}

// The element's own nodal values from a published state (the state a stage
// starts from is not held in registers across the RHS).
template <class Z>
__device__ __forceinline__ void own_state(const Ops& o, const Pub& S, int k,
                                          int b, int Bs, float* h, float* hu,
                                          float* hv) {
  const int Np = Z::np(o);
#pragma unroll
  for (int n = 0; n < Np; ++n) {
    const float4 q = S.n4[(k * Np + n) * Bs + b];
    h[n] = q.x; hu[n] = q.y; hv[n] = q.z;
  }
}

template <class Z>
__device__ __forceinline__ void load_ctrl(const Ops& o, const DenseArgs& a,
                                          const Lane& l, int j, float* c) {
  const int nc = Z::nc(o);
  const float* p = a.ctrls + ((size_t)l.sc * a.n_cs + j) * nc;
#pragma unroll
  for (int i = 0; i < nc; ++i) c[i] = p[i];
}

// n_steps SSP-RK2 steps from (h, hu, hv); with a.th the step-start states
// are stored, else the final state goes to a.oh.
//   u1 = u + dt/2 R(u, t);  u <- u + dt R(u1, t + dt/2)
template <class Z>
__device__ void run_forward(const Ops& o, const DenseArgs& a) {
  const int Np = Z::np(o), nc = Z::nc(o);
  const DenseLayout L = dense_layout(o.K, Np, Z::ntr(o), nc, a.Bs, 0);
  setup_block<Z>(o, L);
  __syncthreads();
  const Lane l = lane_of(o, a);
  const float* r = smem + L.tab + l.k * L.rec;
  const Pub P0 = pub_at(smem + L.buf0, o.nV, a.Bs);
  const Pub P1 = pub_at(smem + L.buf1, o.nV, a.Bs);
  const int n_steps = a.n_cs * a.spc;
  const size_t e0 = (size_t)l.k * Np;
  float h[Z::CNP], hu[Z::CNP], hv[Z::CNP];
  float K1[Z::CNP], K2[Z::CNP], K3[Z::CNP], c[Z::CC];
  if (l.active) {
    const size_t row = (size_t)l.sc * o.nV + e0;
#pragma unroll
    for (int n = 0; n < Np; ++n) {
      h[n] = a.h[row + n]; hu[n] = a.hu[row + n]; hv[n] = a.hv[row + n];
    }
  }
  const size_t trow = (size_t)l.sc * (n_steps + 1) * o.nV + e0;
  for (int t = 0; t < n_steps; ++t) {
    if (l.active) {
      if (a.th != nullptr) {
        const size_t off = trow + (size_t)t * o.nV;
#pragma unroll
        for (int n = 0; n < Np; ++n) {
          a.th[off + n] = h[n]; a.thu[off + n] = hu[n]; a.thv[off + n] = hv[n];
        }
      }
      publish<Z>(o, r, P0, l.k, l.b, a.Bs, h, hu, hv);
    }
    const float tt = a.t0 + (float)t * a.dt;
    const float hb0 = tidal_depth(o, tt);
    const float hb1 = tidal_depth(o, tt + 0.5f * a.dt);
    __syncthreads();
    if (l.active) {
      if (t % a.spc == 0) load_ctrl<Z>(o, a, l, t / a.spc, c);
      rhs<Z>(o, L, r, P0, l.k, l.b, a.Bs, hb0, c, a.use_filter, K1, K2, K3);
      own_state<Z>(o, P0, l.k, l.b, a.Bs, h, hu, hv);
      const float hdt = 0.5f * a.dt;
#pragma unroll
      for (int n = 0; n < Np; ++n) {
        h[n] += hdt * K1[n]; hu[n] += hdt * K2[n]; hv[n] += hdt * K3[n];
      }
      publish<Z>(o, r, P1, l.k, l.b, a.Bs, h, hu, hv);
    }
    __syncthreads();
    if (l.active) {
      rhs<Z>(o, L, r, P1, l.k, l.b, a.Bs, hb1, c, a.use_filter, K1, K2, K3);
      own_state<Z>(o, P0, l.k, l.b, a.Bs, h, hu, hv);
#pragma unroll
      for (int n = 0; n < Np; ++n) {
        h[n] += a.dt * K1[n]; hu[n] += a.dt * K2[n]; hv[n] += a.dt * K3[n];
      }
    }
  }
  if (!l.active) return;
  float *oh = a.oh, *ohu = a.ohu, *ohv = a.ohv;
  size_t off = (size_t)l.sc * o.nV + e0;
  if (a.th != nullptr) {
    oh = a.th; ohu = a.thu; ohv = a.thv;
    off = trow + (size_t)n_steps * o.nV;
  }
#pragma unroll
  for (int n = 0; n < Np; ++n) {
    oh[off + n] = h[n]; ohu[off + n] = hu[n]; ohv[off + n] = hv[n];
  }
}

template <class Z>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    sw2d_step_kernel(Ops o, DenseArgs a) {
  run_forward<Z>(o, a);
}

template <class Z>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    sw2d_rollout_kernel(Ops o, DenseArgs a) {
  run_forward<Z>(o, a);
}

// ---------------------------------------------------------------------------
// Adjoint
// ---------------------------------------------------------------------------

// The cotangent of trace node j's flux jumps: fscale (lift^T w)_j.
template <class Z>
__device__ __forceinline__ void lift_t(const Ops& o, const float* lift,
                                       float fs, int j, const float* w1,
                                       const float* w2, const float* w3,
                                       float& d1, float& d2, float& d3) {
  const int Np = Z::np(o), Ntr = Z::ntr(o);
  float x = 0.0f, y = 0.0f, z = 0.0f;
#pragma unroll
  for (int n = 0; n < Np; ++n) {
    const float lf = lift[n * Ntr + j];
    x += lf * w1[n]; y += lf * w2[n]; z += lf * w3[n];
  }
  d1 = x * fs; d2 = y * fs; d3 = z * fs;
}

// Vector-Jacobian product of the element's RHS at the published state S
// (h_bc: the tidal depth at its time):
//   A = scale * J_R(S)^T W  (own part: volume terms and the '-' traces),
//   the '+' cotangent of each trace node to T (three planes of nT Bs),
//   cp[c cs] += d/d ctrl_c (the control enters the RHS before the filter).
// W and A may be the same arrays (W is read before A is written).
template <class Z>
__device__ __forceinline__ void rhs_vjp(const Ops& o, const DenseLayout& L,
                                        const float* r, const Pub& S,
                                        float* T, int k, int b, int Bs,
                                        float h_bc, const float* W1,
                                        const float* W2, const float* W3,
                                        float scale, int use_filter,
                                        float* A1, float* A2, float* A3,
                                        float* cp, int cs) {
  const int Np = Z::np(o), Ntr = Z::ntr(o), Nfp = Z::nfp(o), nc = Z::nc(o);
  const Rec R = rec_layout(Np, Ntr, nc);
  const float* Dr = smem + L.ops;
  const float* Ds = Dr + Np * Np;
  const float* lift = Ds + Np * Np;
  const float* filt = lift + Np * Ntr;
  const float hsg = 0.5f * sqrtf(o.g);
  const int tstride = o.nT * Bs;

  // filter transpose and scale; the control cotangent
  float w1[Z::CNP], w2[Z::CNP], w3[Z::CNP], cacc[Z::CC];
#pragma unroll
  for (int c = 0; c < nc; ++c) cacc[c] = 0.0f;
#pragma unroll
  for (int m = 0; m < Np; ++m) {
    float x = W1[m], y = W2[m], z = W3[m];
    if (use_filter) {
      x = y = z = 0.0f;
#pragma unroll
      for (int n = 0; n < Np; ++n) {
        const float fl = filt[n * Np + m];
        x += fl * W1[n]; y += fl * W2[n]; z += fl * W3[n];
      }
    }
    w1[m] = x * scale; w2[m] = y * scale; w3[m] = z * scale;
    const float2* bc = reinterpret_cast<const float2*>(r + R.CT + 2 * m * nc);
#pragma unroll
    for (int c = 0; c < nc; ++c) cacc[c] += bc[c].x * w2[m] + bc[c].y * w3[m];
  }
#pragma unroll
  for (int c = 0; c < nc; ++c) cp[c * cs] += cacc[c];

  // volume part: divergence transpose, volume fluxes, sources
#pragma unroll
  for (int m = 0; m < Np; ++m) {
    float Fb1 = 0, Fb2 = 0, Fb3 = 0, Gb1 = 0, Gb2 = 0, Gb3 = 0;
#pragma unroll
    for (int n = 0; n < Np; ++n) {
      const float4 mt = *reinterpret_cast<const float4*>(r + 4 * n);
      const float dr = Dr[n * Np + m], ds = Ds[n * Np + m];
      const float dx = dr * mt.x + ds * mt.y, dy = dr * mt.z + ds * mt.w;
      Fb1 -= dx * w1[n]; Fb2 -= dx * w2[n]; Fb3 -= dx * w3[n];
      Gb1 -= dy * w1[n]; Gb2 -= dy * w2[n]; Gb3 -= dy * w3[n];
    }
    const float4 q = S.n4[(k * Np + m) * Bs + b];
    const float2 ba = *reinterpret_cast<const float2*>(r + R.BA + 2 * m);
    volume_vjp_fast(o, ba.x, ba.y, q.x, q.y, q.z, Fb1, Fb2, Fb3, Gb1, Gb2,
                    Gb3, w2[m], w3[m], A1[m], A2[m], A3[m]);
  }

  // faces: lift transpose, the speeds' cotangents, the face's chain rule
  // (a loop at run time: one face's values live at a time)
#pragma unroll 1
  for (int f0 = 0; f0 < Ntr; f0 += Nfp) {
    float sp[Z::CFP], lb[Z::CFP];
#pragma unroll
    for (int jj = 0; jj < Nfp; ++jj) {
      const int j = f0 + jj;
      float d1, d2, d3;
      lift_t<Z>(o, lift, r[R.TR + 4 * j + 2], j, w1, w2, w3, d1, d2, d3);
      TraceVals tv;
      trace_at<Z>(o, r, S, k, j, b, Bs, h_bc, tv);
      float q1, q2, q3;
      trace_jumps(o, tv, q1, q2, q3);
      sp[jj] = fmaxf(tv.spdM, tv.spdP);
      lb[jj] = -0.5f * (q1 * d1 + q2 * d2 + q3 * d3);
    }
    float lam = sp[0], lsum = lb[0];
#pragma unroll
    for (int jj = 1; jj < Nfp; ++jj) {
      lam = fmaxf(lam, sp[jj]);
      lsum += lb[jj];
    }
    int cnt = 0;
#pragma unroll
    for (int jj = 0; jj < Nfp; ++jj) cnt += (sp[jj] == lam) ? 1 : 0;
#pragma unroll
    for (int jj = 0; jj < Nfp; ++jj) {
      const int j = f0 + jj;
      TraceVals tv;
      trace_at<Z>(o, r, S, k, j, b, Bs, h_bc, tv);
      const float sb = (sp[jj] == lam) ? lsum / (float)cnt : 0.0f;
      float d1, d2, d3;  // recomputed: fewer values live across the face
      lift_t<Z>(o, lift, r[R.TR + 4 * j + 2], j, w1, w2, w3, d1, d2, d3);
      float tM[3], tP[3];
      face_vjp_fast(o, tv, lam, sb, d1, d2, d3, hsg, tM, tP);
      const int flags = reinterpret_cast<const int*>(r)[R.TI + 4 * j + 3];
      const int n = Z::fm(j, flags);
#pragma unroll
      for (int q = 0; q < Np; ++q) {  // A stays in registers
        if (q == n) { A1[q] += tM[0]; A2[q] += tM[1]; A3[q] += tM[2]; }
      }
      const int ti = (k * Ntr + j) * Bs + b;
      T[ti] = tP[0]; T[tstride + ti] = tP[1]; T[2 * tstride + ti] = tP[2];
    }
  }
}

// Adds the '+' cotangents that read each of the element's nodes (invP, in
// its CSR order).
template <class Z>
__device__ __forceinline__ void gather_plus(const Ops& o, const float* r,
                                            const float* T, int k, int b,
                                            int Bs, float* A1, float* A2,
                                            float* A3) {
  const int Np = Z::np(o);
  const Rec R = rec_layout(Np, Z::ntr(o), Z::nc(o));
  const int tstride = o.nT * Bs;
#pragma unroll
  for (int n = 0; n < Np; ++n) {
    const int4 ip = *reinterpret_cast<const int4*>(r + R.IP + 4 * n);
    for (int q = 0; q < ip.w; ++q) {
      const int i = q == 0 ? ip.x : q == 1 ? ip.y : o.invP_idx[ip.z + q];
      const int ti = i * Bs + b;
      A1[n] += T[ti]; A2[n] += T[tstride + ti]; A3[n] += T[2 * tstride + ti];
    }
  }
}

// The control cotangent of interval j: the scenario's element partial sums,
// in element order, by the thread of element 0.
template <class Z>
__device__ __forceinline__ void reduce_ctrl(const Ops& o, const DenseArgs& a,
                                            const DenseLayout& L,
                                            const Lane& l, int j) {
  if (l.k != 0 || l.sc >= a.B) return;
  const int nc = Z::nc(o);
  const float* cpart = smem + L.cpart;
  for (int c = 0; c < nc; ++c) {
    float s = 0.0f;
    for (int e = 0; e < o.K; ++e) s += cpart[(c * o.K + e) * a.Bs + l.b];
    a.cbar[((size_t)l.sc * a.n_cs + j) * nc + c] = s;
  }
}

// For each step t (T-1 .. 0): reload s_t, recompute the first stage, and
//   a      = VJP_R(s_half)[dt lambda]
//   lambda = lambda + a + VJP_R(s_t)[(dt/2) a]
// (lambda carrying the cotangent of the stored state s_{t+1}).
template <class Z>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    sw2d_rollout_bwd_kernel(Ops o, DenseArgs a) {
  const int Np = Z::np(o), nc = Z::nc(o);
  const DenseLayout L = dense_layout(o.K, Np, Z::ntr(o), nc, a.Bs, 1);
  setup_block<Z>(o, L);
  __syncthreads();
  const Lane l = lane_of(o, a);
  const float* r = smem + L.tab + l.k * L.rec;
  const Pub P0 = pub_at(smem + L.buf0, o.nV, a.Bs);
  const Pub P1 = pub_at(smem + L.buf1, o.nV, a.Bs);
  float* T1 = smem + L.t1;
  float* T2 = smem + L.buf1;  // s_half is read no more when T2 is written
  const int n_steps = a.n_cs * a.spc;
  const int e0 = l.k * Np, srow = l.sc * (n_steps + 1);
  // lambda and the control partial sums: this thread's slots, a stride of
  // ls apart
  const int ls = o.K * a.Bs;
  float* lam = smem + L.lam + l.k * a.Bs + l.b;
  float* cp = lam + (L.cpart - L.lam);
  float A1[Z::CNP], A2[Z::CNP], A3[Z::CNP], c[Z::CC];
  if (l.active) {
#pragma unroll
    for (int i = 0; i < 3 * Np; ++i) lam[i * ls] = 0.0f;
  }
  // (few values are carried from step to step, and the tidal depths are
  // computed where they are used: the registers are all taken by the VJPs)
  for (int t = n_steps - 1; t >= 0; --t) {
    float h[Z::CNP], hu[Z::CNP], hv[Z::CNP];
    if (l.active) {
      const size_t off = (size_t)(srow + t) * o.nV + e0;
#pragma unroll
      for (int n = 0; n < Np; ++n) {
        h[n] = a.th[off + n]; hu[n] = a.thu[off + n]; hv[n] = a.thv[off + n];
        // inject the cotangent of the stored state s_{t+1}
        lam[n * ls] += a.tbh[off + o.nV + n];
        lam[(Np + n) * ls] += a.tbhu[off + o.nV + n];
        lam[(2 * Np + n) * ls] += a.tbhv[off + o.nV + n];
      }
      publish<Z>(o, r, P0, l.k, l.b, a.Bs, h, hu, hv);
    }
    __syncthreads();
    // the interval that ended with step t + 1 is complete: its sum
    if ((t + 1) % a.spc == 0 && t + 1 < n_steps)
      reduce_ctrl<Z>(o, a, L, l, (t + 1) / a.spc);
    if (l.active) {  // recompute stage 1 (A holds its RHS for a moment)
      load_ctrl<Z>(o, a, l, t / a.spc, c);
      const float hb0 = tidal_depth(o, a.t0 + (float)t * a.dt);
      rhs<Z>(o, L, r, P0, l.k, l.b, a.Bs, hb0, c, a.use_filter, A1, A2, A3);
      own_state<Z>(o, P0, l.k, l.b, a.Bs, h, hu, hv);
      const float hdt = 0.5f * a.dt;
#pragma unroll
      for (int n = 0; n < Np; ++n) {
        h[n] += hdt * A1[n]; hu[n] += hdt * A2[n]; hv[n] += hdt * A3[n];
      }
      publish<Z>(o, r, P1, l.k, l.b, a.Bs, h, hu, hv);
    }
    __syncthreads();
    if (l.active) {
      // the first step of interval j: its partial sums start (the last
      // interval's were read before the barrier above)
      if ((t + 1) % a.spc == 0) {
#pragma unroll
        for (int i = 0; i < nc; ++i) cp[i * ls] = 0.0f;
      }
#pragma unroll
      for (int n = 0; n < Np; ++n) {
        A1[n] = lam[n * ls]; A2[n] = lam[(Np + n) * ls];
        A3[n] = lam[(2 * Np + n) * ls];
      }
      const float tt = a.t0 + (float)t * a.dt;
      const float hb1 = tidal_depth(o, tt + 0.5f * a.dt);
      rhs_vjp<Z>(o, L, r, P1, T1, l.k, l.b, a.Bs, hb1, A1, A2, A3, a.dt,
                 a.use_filter, A1, A2, A3, cp, ls);
    }
    __syncthreads();
    if (l.active) {
      gather_plus<Z>(o, r, T1, l.k, l.b, a.Bs, A1, A2, A3);
#pragma unroll
      for (int n = 0; n < Np; ++n) {
        lam[n * ls] += A1[n]; lam[(Np + n) * ls] += A2[n];
        lam[(2 * Np + n) * ls] += A3[n];
      }
      const float hb0 = tidal_depth(o, a.t0 + (float)t * a.dt);
      rhs_vjp<Z>(o, L, r, P0, T2, l.k, l.b, a.Bs, hb0, A1, A2, A3,
                 0.5f * a.dt, a.use_filter, A1, A2, A3, cp, ls);
    }
    __syncthreads();
    if (l.active) {
      gather_plus<Z>(o, r, T2, l.k, l.b, a.Bs, A1, A2, A3);
#pragma unroll
      for (int n = 0; n < Np; ++n) {
        lam[n * ls] += A1[n]; lam[(Np + n) * ls] += A2[n];
        lam[(2 * Np + n) * ls] += A3[n];
      }
    }
  }
  __syncthreads();
  reduce_ctrl<Z>(o, a, L, l, 0);
  if (!l.active) return;
  // initial-state adjoint: lambda + cotangent of the stored initial state
  const size_t row = (size_t)l.sc * o.nV + e0;
  const size_t trow = (size_t)srow * o.nV + e0;
#pragma unroll
  for (int n = 0; n < Np; ++n) {
    a.oh[row + n] = lam[n * ls] + a.tbh[trow + n];
    a.ohu[row + n] = lam[(Np + n) * ls] + a.tbhu[trow + n];
    a.ohv[row + n] = lam[(2 * Np + n) * ls] + a.tbhv[trow + n];
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

typedef void (*DenseKern)(Ops, DenseArgs);

// which: 0 step, 1 rollout, 2 adjoint. Null for sizes no instantiation
// takes.
static DenseKern kernel_of(const SwDesc& d, int which) {
  if (is_order1(d))
    return which == 0 ? sw2d_step_kernel<Order1>
           : which == 1 ? sw2d_rollout_kernel<Order1>
                        : sw2d_rollout_bwd_kernel<Order1>;
  if (d.Nfaces != 3 || d.Np > MAX_NP || d.Nfp > MAX_NFP ||
      d.n_ctrl > MAX_CTRL)
    return nullptr;
  return which == 0 ? sw2d_step_kernel<AnyOrder>
         : which == 1 ? sw2d_rollout_kernel<AnyOrder>
                      : sw2d_rollout_bwd_kernel<AnyOrder>;
}

static size_t smem_bytes_of(const SwDesc& d, int which, int Bs) {
  return (size_t)dense_layout(d.K, d.Np, d.Nfaces * d.Nfp, d.n_ctrl, Bs,
                              which == 2).total * sizeof(float);
}

static int g_last_tile = 0;

// The tile of scenarios a block takes, from the occupancy the device reports
// for the kernel: among Bs = 1, 2, 4, .., 32 whose block (K Bs threads,
// rounded to warps) fits the kernel's limits and shared memory, the fewest
// waves of blocks over the SMs; then the fewest idle lanes launched (the
// lanes past K Bs and the scenarios past B); then the fewest threads on the
// busiest SM; then the smaller tile. Returns Bs, 0 if no tile fits, or a
// CUDA error as a negative number.
static int pick_tile(const SwDesc& d, int B, int which) {
  const DenseKern kern = kernel_of(d, which);
  if (kern == nullptr) return 0;
  int dev = 0, sms = 0, room = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return -(int)e;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&room, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  int best = 0;
  long long bw = 0, bidle = 0, bbusy = 0;
  for (int Bs = 1; Bs <= 32; Bs *= 2) {
    const int threads = (d.K * Bs + 31) & ~31;
    if (threads > MAX_THREADS) break;
    const size_t bytes = smem_bytes_of(d, which, Bs);
    if (bytes > (size_t)room) break;
    const int pe = prepare(kern, bytes);
    if (pe != 0) return -pe;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      bytes);
    if (e != cudaSuccess) return -(int)e;
    if (per_sm < 1) continue;
    const long long blocks = (B + Bs - 1) / Bs;
    const long long slots = (long long)per_sm * sms;
    const long long waves = (blocks + slots - 1) / slots;
    const long long idle = blocks * threads - (long long)d.K * B;
    const long long on_sm = (blocks + sms - 1) / sms;
    const long long busy = (on_sm < per_sm ? on_sm : per_sm) * threads;
    if (best == 0 || waves < bw || (waves == bw && idle < bidle) ||
        (waves == bw && idle == bidle && busy < bbusy)) {
      best = Bs; bw = waves; bidle = idle; bbusy = busy;
    }
  }
  return best;
}

static int launch(const SwDesc* d, const float* fops, const int* iops,
                  DenseArgs a, int which, void* stream) {
  const int Bs = pick_tile(*d, a.B, which);
  if (Bs < 0) return -Bs;
  if (Bs == 0) return (int)cudaErrorInvalidValue;
  const DenseKern kern = kernel_of(*d, which);
  Ops o = make_ops(*d, fops, iops);
  a.Bs = Bs;
  const size_t bytes = smem_bytes_of(*d, which, Bs);
  const int pe = prepare(kern, bytes);
  if (pe != 0) return pe;
  const int grid = (a.B + Bs - 1) / Bs, threads = (d->K * Bs + 31) & ~31;
  g_last_tile = Bs;
  void* args[] = {&o, &a};
  const cudaError_t e = cudaLaunchKernel(kern, dim3(grid), dim3(threads),
                                         args, bytes, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

static DenseArgs no_args() {
  DenseArgs a = {nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                 nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                 nullptr, nullptr, 0, 1, 1, 1, 1, 0.0f, 0.0f};
  return a;
}

extern "C" {

// Bytes of dynamic shared memory one block of a tile of Bs scenarios needs:
// which = 0 step, 1 rollout, 2 adjoint.
long long sw2d_smem_bytes(const SwDesc* d, int which, int Bs) {
  return (long long)smem_bytes_of(*d, which, Bs);
}

// The tile of scenarios the launcher takes for B scenarios (pick_tile):
// Bs, 0 where none fits, or a CUDA error as a negative number.
int sw2d_dense_tile(const SwDesc* d, int B, int which) {
  return pick_tile(*d, B, which);
}

// The tile of the last launch.
int sw2d_dense_last_tile() { return g_last_tile; }

int sw2d_step(const SwDesc* d, const float* fops, const int* iops,
              const float* h, const float* hu, const float* hv,
              const float* ctrl, float* oh, float* ohu, float* ohv, int B,
              float dt, float t0, int use_filter, void* stream) {
  DenseArgs a = no_args();
  a.h = h; a.hu = hu; a.hv = hv; a.ctrls = ctrl;
  a.oh = oh; a.ohu = ohu; a.ohv = ohv;
  a.B = B; a.use_filter = use_filter; a.dt = dt; a.t0 = t0;
  return launch(d, fops, iops, a, 0, stream);
}

int sw2d_rollout(const SwDesc* d, const float* fops, const int* iops,
                 const float* h, const float* hu, const float* hv,
                 const float* ctrls, float* th, float* thu, float* thv, int B,
                 int n_ctrl_steps, int spc, float dt, float t0, int use_filter,
                 void* stream) {
  DenseArgs a = no_args();
  a.h = h; a.hu = hu; a.hv = hv; a.ctrls = ctrls;
  a.th = th; a.thu = thu; a.thv = thv;
  a.B = B; a.n_cs = n_ctrl_steps; a.spc = spc; a.use_filter = use_filter;
  a.dt = dt; a.t0 = t0;
  return launch(d, fops, iops, a, 1, stream);
}

int sw2d_rollout_bwd(const SwDesc* d, const float* fops, const int* iops,
                     const float* th, const float* thu, const float* thv,
                     const float* tbh, const float* tbhu, const float* tbhv,
                     const float* ctrls, float* xbh, float* xbhu, float* xbhv,
                     float* cbar, int B, int n_ctrl_steps, int spc, float dt,
                     float t0, int use_filter, void* stream) {
  DenseArgs a = no_args();
  a.th = const_cast<float*>(th); a.thu = const_cast<float*>(thu);
  a.thv = const_cast<float*>(thv);
  a.tbh = tbh; a.tbhu = tbhu; a.tbhv = tbhv; a.ctrls = ctrls;
  a.oh = xbh; a.ohu = xbhu; a.ohv = xbhv; a.cbar = cbar;
  a.B = B; a.n_cs = n_ctrl_steps; a.spc = spc; a.use_filter = use_filter;
  a.dt = dt; a.t0 = t0;
  return launch(d, fops, iops, a, 2, stream);
}

}  // extern "C"
