// Element-blocked shallow-water kernels for the large-mesh regime, sm_90a.
//
//   sw2d_blocked_rollout_kernel      n_steps SSP-RK2 steps, optional stored
//                                    trajectory (launched for one step, the
//                                    step)
//   sw2d_blocked_rollout_bwd_kernel  the reverse (adjoint) sweep
//   sw2d_stage_kernel                one RK stage of an element-sharded set
//   sw2d_stage_bwd_kernel            its adjoint
//   sw2d_step_rdma_kernel            one whole SSP-RK2 step of an
//                                    element-sharded set, the inter-stage
//                                    halo exchanged inside the launch
//   sw2d_step_rdma_peer_kernel       the same step for one shard a rank,
//                                    the halo stored into the peers' memory
//   sw2d_stage_peer_kernel           the stage for one shard a rank, the
//                                    stage ring's exchange folded in
//   sw2d_stage_bwd_peer_kernel       its adjoint, the exchange's reverse
//                                    folded in
//
// The first two replace the Pallas TPU kernels _step_kernel,
// _rollout_kernel and _rollout_bwd_kernel of blitzdg_tpu/ops/sw2d_blocked.py
// (the others: their own sections below). Those run one scenario's whole
// mesh on one core, packed (p, NP, M) with roll-based trace exchange. Here
// a mesh of thousands of elements does not fit one block's shared memory:
// it is split over the blocks of the grid, and the '+' traces of every RHS
// are index gathers through vmapP from the stage's input in GLOBAL memory
// (L2-resident at these sizes), for any element numbering. Every RK stage
// depends on the whole grid's previous stage, so a kernel that runs several
// is ONE persistent cooperative launch whose stages end in grid barriers.
//
// Every kernel runs one RK stage, qstage, or its adjoint, qvjp, on items of
// P lanes of a warp each: one (shard, scenario, element) an item, lane p
// holding node p of each face and the volume nodes p, p+P, ... (their
// sections below). The wet/dry branch (minmod reconstruction, positivity
// limiter) exists forward only.
//
// Bound on the card: float32 operations, not bytes (one state in and one
// out against some hundred operations per node and stage), except the
// sharded stage and its adjoint alone (bytes). The design keeps the working
// set in L2 and shared memory, so device memory sees little more than that.
// What the kernels wait for is latency: the gathers of the neighbours'
// traces and an item's chain of warp barriers and shuffles; the grid
// barriers are a small share (PERF.md has the measured shares).
//
// Plain C interface (extern "C" at the end), loaded with ctypes. Launches go
// to the stream that is passed in; nothing here synchronises or allocates.

#include "sw2d_common.cuh"
#include "peer_flags.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

extern __shared__ float smem[];

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
// the shard that receives it (the in-kernel exchange of the one-launch
// step); with a peer table (the step's peer mode, one shard a rank), to
// peer[j / chunk] + off + 3 j: slot j of the stage-2 receive slots of the
// rank that ring offset j / chunk sends to, in its memory.
struct SendTo {
  float* buf;              // null: no send slots are written
  const long long* shard;  // (n_send,) receiving shard of each slot, or null
  size_t stride;           // floats from one shard's buffer to the next
  const long long* peer;   // (n_off,) receiving ranks' regions, or null
  int chunk;               // slots of one ring offset (peer mode)
  size_t off;              // floats to the scenario's slots (peer mode)
};

__device__ __forceinline__ float* send_slot(const SendTo& to, int j) {
  if (to.peer != nullptr)
    return reinterpret_cast<float*>(__ldg(to.peer + j / to.chunk)) + to.off +
           3 * j;
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
//      reads of s1 at neighbours that other blocks wrote (in the peer mode,
//      one shard a rank, the handshakes are flags in the ranks' memory:
//      rdma_step below);
//   3. stage 2 (c_dt = dt, stage time t + dt/2, the sponge) from s1, base
//      the step-start state, rb2; the output and its own send buffer for
//      the step-boundary exchange outside (in the peer mode also stored
//      into the receiving ranks' step-boundary slots: that exchange is
//      the launch's own, rdma_step below).
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
// At N=6 (Np 28, Nfp 7: compile-time sizes, the products unrolled by
// parts) P = 8: lane p holds node p of each face, lane 7 none (it redoes
// node 6, whose speed cannot move the face maximum, and stores nothing),
// and the volume nodes p, p+8, p+16, p+24. Quadrilaterals at N=4 (Np 25,
// Nfp 5) take QOrder4Quad in both kernels (and in both modes of the
// step), eight lanes an element the same way: lanes 5-7 redo node 4 of a
// face and store no trace slot; lane p holds the volume nodes p + 8k < 25
// (lane 0 alone a fourth, node 24), so the stores into out, into the send
// slots (the stage-1 halo into the receiving shard's or rank's rb2 among
// them) and the peer mode's copies into the step-boundary slots cover
// each node once. Other orders (run-time sizes, arrays in local memory)
// take one lane an item, and so do the adjoints at N=6. A stage has no
// block barrier; a launch has one, after the reference operators (Dr and
// Ds interleaved, lift, filter) are copied to shared memory, where every
// lane reads them as broadcasts.
//
// The block size is chosen by the launcher (q_plan): the largest of 256,
// 128, 64, 32 threads that still gives every SM a block (S=4 x B=1 x 512
// elements is 8192 lanes: 256 blocks of one warp) and whose shared memory
// fits (the adjoints' items at N=6 take 64), and the step's grid is
// what the device reports as co-resident. Where that grid covers every
// item in one pass, the step keeps each lane's stage-1 nodes and its
// step-start nodes in registers across the grid barrier (up to N=3:
// QSizes::KEEP); only the neighbours' traces then go through global memory
// (L2) in stage 2.
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
  // the peer mode (S = 1): the stage ring's table (peer_flags.cuh), the
  // epoch read from the forward slots (0: none, rb given; else rb is this
  // rank's forward slot set of e_in's parity), the epoch sent, and rbo
  // (1, B, n_recv, 3), where the slots read are copied
  const long long* peer;
  float* rbo;
  flag_t e_in, e_out;
  flag_t e_skip;  // (0: none) the forward epochs this rank will not read
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
  const long long* peer;        // peer mode: the ring's table
                                // (peer_flags.cuh), S = 1
};

#define QMAX_THREADS 256
// Room of the run-time-size instantiation's arrays: nodes (N=6), nodes a
// face, faces (a quadrilateral's).
#define QMAX_NP 28
#define QMAX_NFP 7
#define QMAX_NFACES 4

__host__ __device__ constexpr int qround4(int n) { return (n + 3) & ~3; }

// The least power of two >= n.
__host__ __device__ constexpr int qpow2(int n) {
  return n <= 1 ? 1 : 2 * qpow2((n + 1) / 2);
}

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

// Nodes, nodes a face, controls, lanes an item and faces: constants of the
// instantiation where the template gives them, else (0 sizes, NC < 0)
// read at run time. Faces: NFACES (three, triangles, or four,
// quadrilaterals) in the compile-time instances; the descriptor's in the
// run-time one, which qstage and qvjp take on triangles and
// quadrilaterals alike. The lanes of a face in qvjp (LPF) are LANES where
// a face has at least as many nodes, else the least power of two that
// holds its NFP nodes: each group of LPF lanes takes a face, one trace
// node a lane (the adjoint's wide items: several faces a pass), and where
// LPF > NFP (N=4 on quadrilaterals: eight lanes, five nodes) lanes NFP ..
// LPF-1 of the group are masked (FMASKED): they redo the face's last node
// and add and store nothing. A shuffle over a face's lanes then always has
// a width that is a power of two. qstage's lane p holds nodes p + LANES k,
// k < CFP, of every face; where the lanes do not divide a face (MASKED:
// N=6, quadrilaterals at N=4), the last of them lie past it on some lanes.
template <int NP, int NFP, int NC, int LANES, int NFACES = 3>
struct QSizes {
  static constexpr int P = LANES;
  static constexpr int LPF = NP && LANES > NFP ? qpow2(NFP) : LANES;
  static constexpr bool FMASKED = NP && NFP % LPF != 0;
  // shuffles over an item's lanes and over a face's must have a width that
  // is a power of two up to a warp, and a face's lanes tile the item's
  static_assert(LANES <= 32 && (LANES & (LANES - 1)) == 0,
                "an item's lanes: a power of two, at most a warp");
  static_assert(LPF <= 32 && (LPF & (LPF - 1)) == 0 && LANES % LPF == 0,
                "a face's lanes: a power of two that divides the item's");
  static constexpr int CNP = NP ? (NP + LANES - 1) / LANES : QMAX_NP;
  // a face's nodes, a lane
  static constexpr int CFP = NP ? (NFP + LPF - 1) / LPF : QMAX_NFP;
  // room of a lane's face arrays
  static constexpr int NF = NP ? NFACES : QMAX_NFACES;
  static constexpr bool MASKED = NP && NFP % LANES != 0;
  // whether the one-launch step's lanes may hold their step-start and
  // stage-1 nodes through its second stage (at N=6 and on quadrilaterals
  // at N=4 they and the stage's own values would pass the 128 registers
  // and spill: stage 2 reloads them)
  static constexpr bool KEEP = NP <= 10;
  // unroll factors of qstage's products over a node's columns (MU) and its
  // trace nodes (LU): complete at compile-time sizes up to 10 nodes,
  // partial above (N=6: unrolled completely, they spill; quadrilaterals at
  // N=4 take the same factors), none at run-time sizes
  static constexpr int MU = !NP ? 1 : NP > 10 ? 4 : NP;
  static constexpr int LU = !NP ? 1 : NP > 10 ? 3 : NFACES * NFP;
  // qvjp's passes over the faces: unrolled up to 10 nodes, rolled above
  // and at run-time sizes
  static constexpr int PU = NP && NP <= 10 ? QMAX_NFACES : 1;
  // blocks of QMAX_THREADS an SM that the adjoints' launch bounds ask for:
  // two (128 registers a thread), or one above 10 nodes (quadrilaterals at
  // N=4, whose eight-lane items would spill at 128: about 185 registers;
  // the quad path's grids, 144 blocks of 64 threads, are co-resident all
  // the same)
  static constexpr int BWD_MIN_BLOCKS = NP > 10 ? 1 : 2;
  __device__ __forceinline__ static int np(const Ops& o) {
    return NP ? NP : o.Np;
  }
  __device__ __forceinline__ static int nfp(const Ops& o) {
    return NP ? NFP : o.Nfp;
  }
  __device__ __forceinline__ static int ntr(const Ops& o) {
    return NP ? NFACES * NFP : o.Ntr;
  }
  __device__ __forceinline__ static int nfaces(const Ops& o) {
    return NP ? NFACES : o.Nfaces;
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
  // qvjp's passes over the element's faces: one face a pass, or all at
  // once; a constant at compile-time sizes (the pass loop unrolls), the
  // descriptor's face count at run-time sizes (a loop, one copy of its
  // body)
  __device__ __forceinline__ static int ng(const Ops& o) {
    return (nfaces(o) * LPF + LANES - 1) / LANES;
  }
};
typedef QSizes<10, 4, 2, 4> QOrder3Ctrl;  // N=3 with two controls
typedef QSizes<10, 4, -1, 4> QOrder3;     // N=3, other control counts
typedef QSizes<28, 7, -1, 8> QOrder6;     // N=6, the forward kernels
// quadrilaterals at N=4 (Np 25, Nfp 5), every q kernel's (the one-launch
// step's in both modes): eight lanes an element, lanes 5-7 masked on the
// faces, as at N=6
typedef QSizes<25, 5, -1, 8, 4> QOrder4Quad;
typedef QSizes<0, 0, -1, 1> QAnyOrder;
// the stage adjoint's wide items at small batches: 16 lanes an element at
// N=3; 8 at N=1 with two controls (the sharded MPC example's set)
typedef QSizes<10, 4, 2, 16> QOrder3CtrlWide;
typedef QSizes<10, 4, -1, 16> QOrder3Wide;
typedef QSizes<3, 2, 2, 8> QOrder1CtrlWide;

// One lane's values at its node slots.
template <class Z>
struct Own {
  float h[Z::CNP], hu[Z::CNP], hv[Z::CNP];
};

// qstage's trace node k of face-local lane p (a masked one: the face's
// last node, which it redoes), and whether the lane holds node k.
template <class Z>
__device__ __forceinline__ int q_fnode(int p, int k, int Nfp) {
  const int j = p + Z::P * k;
  return Z::MASKED && j >= Nfp ? Nfp - 1 : j;
}

template <class Z>
__device__ __forceinline__ bool q_fhas(int p, int k, int Nfp) {
  return !Z::MASKED || p + Z::P * k < Nfp;
}

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
  // (unrolled: in a block of one warp the iterations' loads go out together)
#pragma unroll 4
  for (int i = threadIdx.x; i < np2; i += blockDim.x) {
    s[2 * i] = o.Dr[i];
    s[2 * i + 1] = o.Ds[i];
    fl[i] = o.filt[i];
  }
#pragma unroll 4
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

// volume_fluxes with its roundings spelled out: the pressure's last
// product fused into each flux, F2 = h (0.5 g h) + hu hu / h. Left to it,
// the compiler may contract these products differently in two kernels
// that share qstage (it hoisted a lane's first pressure, shared with the
// wet/dry branch, and fused the flux's product instead in one instance and
// not in another), so that the one-launch step would not give two stage
// launches' bits. Spelled out, every kernel and instance rounds them
// alike. Wet/dry sets, which no step takes, keep volume_fluxes.
__device__ __forceinline__ void q_volume_fluxes(const Ops& o, float h,
                                                float hu, float hv,
                                                float& F2, float& F3,
                                                float& G3) {
  if (o.wetdry) {
    volume_fluxes(o, h, hu, hv, F2, F3, G3);
    return;
  }
  const float gh = __fmul_rn(0.5f * o.g, h), inv = 1.0f / h;
  F2 = __fmaf_rn(h, gh, __fmul_rn(__fmul_rn(hu, hu), inv));
  F3 = __fmul_rn(__fmul_rn(hu, hv), inv);
  G3 = __fmaf_rn(h, gh, __fmul_rn(__fmul_rn(hv, hv), inv));
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
// memory; sops: the reference operators; h_bc: the tidal depth at the
// stage time (tidal_depth, once a launch or phase: its cosine has a long
// slow path).
template <class Z, bool BASE_REGS>
__device__ __forceinline__ void qstage(
    const Ops& g, const float* sops, float* scr, const QLane& l,
    const P3& in, const Own<Z>& x, const Own<Z>& bs, const P3& base,
    Own<Z>& y, const W3& out, const SendTo& to, const float* rb, float coef,
    float h_bc, float dt, const float* ctrl, int use_filter, bool limit,
    bool sponge) {
  constexpr int P = Z::P;
  const int Np = Z::np(g), Ntr = Z::ntr(g), Nfp = Z::nfp(g);
  const int ns = Z::nslots(g), nfl = Z::nface(g), nc = Z::nc(g);
  const int nf = Z::nfaces(g);
  const int e = l.e, p = l.p, v0 = e * Np, i0 = e * Ntr;
  const float2* DS = reinterpret_cast<const float2*>(sops);
  const float* LF = sops + 2 * Np * Np;
  const float* FL = LF + Np * Ntr;
  float4* X = reinterpret_cast<float4*>(scr);
  float* G = scr + 4 * Np;
  float4* A = reinterpret_cast<float4*>(G + qround4(Np));

  __syncwarp();  // the item's slots are free (a previous pass read them)
  // own nodes: the volume fluxes into the item's slots
#pragma unroll
  for (int i = 0; i < ns; ++i) {
    const int n = p + P * i;
    if (n < Np) {
      float F2, F3, G3;
      q_volume_fluxes(g, x.h[i], x.hu[i], x.hv[i], F2, F3, G3);
      X[n] = make_float4(x.hu[i], x.hv[i], F2, F3);
      G[n] = G3;
    }
  }
  // the lane's trace nodes (q_fnode of each face): their indices, then the
  // state at both sides, each round issued at once (the tables are
  // read-only for the launch: __ldg; the state may have been written by
  // this launch's first phase: plain loads)
  int vm[Z::NF][Z::CFP], vp[Z::NF][Z::CFP];
#pragma unroll
  for (int f = 0; f < nf; ++f)
#pragma unroll
    for (int k = 0; k < nfl; ++k) {
      const int gi = l.io + i0 + f * Nfp + q_fnode<Z>(p, k, Nfp);
      vm[f][k] = __ldg(g.vmapM + gi);
      vp[f][k] = __ldg(g.vmapP + gi);
    }
  float sv[Z::NF][Z::CFP][6];
#pragma unroll
  for (int f = 0; f < nf; ++f)
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
  for (int f = 0; f < nf; ++f) {
    float p1[Z::CFP], p2[Z::CFP], p3[Z::CFP], q1[Z::CFP], q2[Z::CFP];
    float q3[Z::CFP], lam = 0.0f;
#pragma unroll
    for (int k = 0; k < nfl; ++k) {
      const int fi = l.fo + i0 + f * Nfp + q_fnode<Z>(p, k, Nfp);
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
      const int j = f * Nfp + q_fnode<Z>(p, k, Nfp);
      const float fs = __ldg(g.fscale + l.fo + i0 + j);
      if (q_fhas<Z>(p, k, Nfp))
        A[j] = make_float4((p1[k] - hl * q1[k]) * fs,
                           (p2[k] - hl * q2[k]) * fs,
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
#pragma unroll (Z::LU)
      for (int j = 0; j < Ntr; ++j) {
        const float lf = LF[n * Ntr + j];
        const float4 a = A[j];
        l1 += lf * a.x; l2 += lf * a.y; l3 += lf * a.z;
      }
      float rF1 = 0, sF1 = 0, rG1 = 0, sG1 = 0, rF2 = 0, sF2 = 0;
      float rF3 = 0, sF3 = 0, rG3 = 0, sG3 = 0;
#pragma unroll (Z::MU)
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
#pragma unroll (Z::MU)
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

// The send slots of lane l.p's nodes of an item, as the lane has just
// stored them into its shard's send buffer sb (one scenario's), copied
// into slot j of the slots, off floats into its region, of the rank that
// ring offset j / chunk sends to (region ranks[j / chunk]): the one-launch
// step's peer mode's exchange of the next step's rb (its step-boundary
// slots) and the stage's peer mode's exchange (the stage ring's forward
// slots).
template <class Z>
__device__ __forceinline__ void q_send_to_peers(const Ops& g, const QLane& l,
                                                const float* sb,
                                                const long long* ranks,
                                                int chunk, size_t off) {
  const int Np = Z::np(g), ns = Z::nslots(g);
  const int* ptr = g.send_ptr + l.io;
#pragma unroll
  for (int i = 0; i < ns; ++i) {
    const int n = l.p + Z::P * i;
    if (n < Np) {
      const int v = l.e * Np + n;
      const int q1 = __ldg(ptr + v + 1);
      for (int q = __ldg(ptr + v); q < q1; ++q) {
        const int j = __ldg(g.send_idx + l.io + q);
        const float* src = sb + 3 * j;
        float* dst = reinterpret_cast<float*>(__ldg(ranks + j / chunk)) +
                     off + 3 * j;
        dst[0] = src[0]; dst[1] = src[1]; dst[2] = src[2];
      }
    }
  }
}

// The item's slots: after the operators (ops floats), blockDim/P items a
// block of `item` floats each.
__device__ __forceinline__ float* q_item_slots(int ops, int item, int P) {
  return smem + ops + ((int)threadIdx.x / P) * item;
}

// Slot j of scenario b of the slot set at byte `set` in the region of the
// rank that ring offset j / chunk names in `ranks` (a part of a stage
// ring's table: the ranks each offset sends to, or receives from): where a
// folded launch stores a slot of its exchange.
__device__ __forceinline__ float* sr_peer_slot(const long long* ranks,
                                               int chunk, long long set,
                                               size_t ls, int b, int j) {
  return reinterpret_cast<float*>(__ldg(ranks + j / chunk) + set) +
         b * ls + 3 * j;
}

// The end of a folded launch (the stage's peer mode, or its adjoint's,
// `rev`): a block barrier, then the block's arrival on the rank's count
// after a fence at gpu scope (a release pattern: the block's reads of its
// slots and stores into the peers' are ordered before it); the last block
// to arrive then makes the launch's one fence at system scope (every
// block's arrival read, so all their memory operations are ordered before
// what follows), resets the count and stores, a ring offset i each, the
// GO flag of the epoch it read (e_in, not 0: the slot set read is free)
// at the rank that sent it, and the arrival of the epoch it sent (e_out,
// not 0) at the rank that receives it, as relaxed stores at system scope
// (flag_store): with the fence before them, release patterns that the
// peers' acquire loads synchronize with, through the causality order,
// which is transitive across the two scopes (PTX memory model). A system
// fence in every block and a release (a fence each) a flag in series cost
// 0.013 ms of the launch on the H100, this order 0.003-0.004 (PERF.md;
// acquire-release fences in place of these two measured the same).
__device__ __forceinline__ void sr_fold_end(const long long* tab, int rev,
                                            flag_t e_in, flag_t e_out) {
  __syncthreads();
  if (threadIdx.x != 0) return;
  __threadfence();
  unsigned* count = sr_count(tab, rev);
  if (atomicAdd(count, 1u) != gridDim.x - 1) return;
  __threadfence_system();
  *count = 0;
  const int go = rev ? SR_RGO : SR_FGO, in = rev ? SR_RIN : SR_FIN;
  for (int i = 0; i < (int)tab[SR_NOFF]; ++i) {
    const long long sender = rev ? sr_to(tab, i) : sr_from(tab, i);
    const long long receiver = rev ? sr_from(tab, i) : sr_to(tab, i);
    if (e_in != 0) flag_store(sr_flag(tab, sender, i, go), e_in + 1);
    if (e_out != 0) flag_store(sr_flag(tab, receiver, i, in), e_out);
  }
}

// The start of a folded launch: with e_skip (not 0), thread k of block 0
// first releases GO = e_skip + 1 at the rank that sends chunk k here:
// every epoch up to e_skip that this rank has not read, no launch will
// (the host knows: parallel/peer.py, StageRing._fold), so its slots are
// free; a sender's wait for the read of such an epoch would never end.
// Then thread k < n_off waits for the arrival of chunk k of epoch e_in
// (not 0) in this rank's slots, thread n_off + k for the GO of chunk k of
// epoch e_out (not 0: the receiving rank's slot set of e_out's parity is
// free, its epoch e_out - 2 read or skipped), each a flag in this rank's
// memory: a block's 2 n_off acquire loads in one round, not a chain; the
// block barrier after the operators' copy passes on what they acquired.
__device__ __forceinline__ void sr_fold_start(const long long* tab, int rev,
                                              flag_t e_in, flag_t e_out,
                                              flag_t e_skip) {
  const int n_off = (int)tab[SR_NOFF];
  const int go = rev ? SR_RGO : SR_FGO, in = rev ? SR_RIN : SR_FIN;
  if (e_skip != 0 && blockIdx.x == 0)
    for (int k = threadIdx.x; k < n_off; k += blockDim.x)
      flag_release(sr_flag(tab, rev ? sr_to(tab, k) : sr_from(tab, k), k, go),
                   e_skip + 1);
  for (int k = threadIdx.x; k < 2 * n_off; k += blockDim.x) {
    const bool arrival = k < n_off;
    const flag_t e = arrival ? e_in : e_out - 1;
    if (arrival ? e_in != 0 : e_out != 0)
      flag_wait(sr_flag(tab, tab[SR_OWN], arrival ? k : k - n_off,
                        arrival ? in : go),
                e, tab[SR_TIMEOUT]);
  }
}

// The sharded stage (B7) in its two modes: stacked (every shard in the
// launch) and, with PEER, one shard a rank (S = 1) over the stage ring
// (a.peer: its table, peer_flags.cuh), the ring's exchange between the RK
// stages folded into the launch. For the launch of epoch e_out:
//   1. (with e_skip, block 0 first releases FGO past the forward epochs
//      that no launch here will read: sr_fold_start) thread k waits for
//      FIN >= e_in of offset k (the peers' launches
//      that sent this rank's receive buffer have ended; e_in = 0: the
//      buffer is given in rb, a rollout's first stage after the standalone
//      exchange of peer.cu) and thread n_off + k for FGO >= e_out - 1 of
//      offset k (the receiving rank's slot set of e_out's parity is free);
//   2. the stage reads its receive buffer from this rank's forward slots
//      of e_in's parity (the launcher passes their address as rb: a
//      pointer chosen here and held through the stage spilled), every
//      block copying its share of them into rbo, memory torch owns, which
//      autograd keeps for B8;
//   3. the stage as B7 runs it (the same items and qstage: B7's bits),
//      each lane then copying its send slots, as it stored them into sb,
//      into slot j of the forward slots of e_out's parity of the rank that
//      ring offset j / chunk sends to (q_send_to_peers), the empty ones
//      zeros;
//   4. sr_fold_end: the last block releases FGO = e_in + 1 at each sender
//      (its slots are read) and FIN = e_out at each receiver.
// No wait cycle: a launch waits only on flags that the peers' launches of
// the round before release at their ends (FIN e_in: the sender's launch
// that sent it; FGO e_out - 1: the receiver's launch that read epoch
// e_out - 2), never on a launch of its own round, because the slots are
// two sets by the epoch's parity. So no launch needs its peers' launches
// of the same round resident beside it, and a rank may run a launch ahead
// of a slow peer. The memory order of the stores into the peers' slots
// before FIN, and of the reads of this rank's slots before FGO:
// sr_fold_end's (a fence at gpu scope a block before its arrival on the
// count, one system fence in the last block, the flags relaxed stores).
template <class Z, bool PEER>
__device__ __forceinline__ void stage_launch(const SwDesc& d,
                                             const StageArgs& a) {
  const Ops g = make_ops(d, a.fops, a.iops);
  if (PEER) sr_fold_start(a.peer, 0, a.e_in, a.e_out, a.e_skip);
  q_setup_ops(g, smem);
  __syncthreads();
  const size_t ls = (size_t)d.n_send * 3;  // floats of one slot list
  if (PEER && a.e_in != 0) {  // (rb: the slots; the launcher passes them)
    const int n = a.B * (int)ls;
    for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < n;
         k += gridDim.x * blockDim.x)
      a.rbo[k] = __ldcg(a.rb + k);
  }
  q_zero_empty(g, a.istride, a.S, a.B, [&](int sh, int b, int j) {
    return a.sb + ((size_t)sh * a.B + b) * ls + 3 * j;
  });
  if (PEER && a.peer[SR_NOFF] > 0) {
    const int chunk = d.n_send / (int)a.peer[SR_NOFF];
    const long long set = sr_slots(a.peer, 0, 0, a.e_out);
    q_zero_empty(g, a.istride, a.S, a.B, [&](int sh, int b, int j) {
      return sr_peer_slot(a.peer + SR_HEAD, chunk, set, ls, b, j);
    });
  }
  float* scr = q_item_slots(q_ops_floats(g.Np, g.Ntr),
                           q_item_floats(g.Np, g.Ntr), Z::P);
  const int ipb = blockDim.x / Z::P, n_items = a.S * a.B * d.K;
  const float h_bc = tidal_depth(g, a.t);
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
                     a.c_dt, h_bc, a.c_dt, a.ctrl, a.use_filter,
                     g.wetdry != 0, a.sponge != 0);
    // the table read here, not held through the stage (as rdma_step's)
    if (PEER && l.active && a.peer[SR_NOFF] > 0) {
      const int n_off = (int)a.peer[SR_NOFF];
      q_send_to_peers<Z>(g, l, a.sb + l.sc * ls, a.peer + SR_HEAD,
                         d.n_send / n_off,
                         (size_t)sr_slots(a.peer, 0, 0, a.e_out) /
                                 sizeof(float) + l.b * ls);
    }
  }
  if (PEER) sr_fold_end(a.peer, 0, a.e_in, a.e_out);
}

template <class Z>
__global__ void __launch_bounds__(QMAX_THREADS, 2)
    sw2d_stage_kernel(SwDesc d, StageArgs a) {
  stage_launch<Z, false>(d, a);
}

// The peer mode (S = 1): the items of the stacked stage kernel (four lanes
// an element at N=3, eight at N=6 and on quadrilaterals at N=4), so that a
// rank's bits are its shard's of B7 followed by the exchange. At the
// sharded MPC's shapes (K_loc = 512, B = 1, N=3) a rank's grid is 2048
// lanes, 64 blocks of one warp: S = 4 or 8 ranks' grids together hold at
// most 512 of the card's 132 x 16 block slots, so every rank's launch
// finds room beside its peers'.
template <class Z>
__global__ void __launch_bounds__(QMAX_THREADS, 2)
    sw2d_stage_peer_kernel(SwDesc d, StageArgs a) {
  stage_launch<Z, true>(d, a);
}

// The one-launch step, in its two modes: stacked (every shard in the
// launch, the grid barrier for READY) and, with PEER, one shard a rank
// (a.peer: the ring's table), both halos stored into the peers' memory and
// the handshakes through their flags (peer_flags.cuh), in this order for
// the launch of epoch e:
//   1. thread i of block 0 releases GO2 = e to the rank that sends to this
//      one at ring offset i: this rank's stage-2 slots are free (the launch
//      of epoch e - 1 has ended, its reads done), and thread 0 resets the
//      launch's count of blocks (step 5); in every block, thread i waits
//      for INB >= e of offset i (the sending rank's launch of epoch e - 1,
//      or for e = 1 its exchange of the initial send buffer, has written
//      rb) and thread n_off + i for GO2 >= e of offset i (the receiving
//      ranks' stage-2 slots are free for the stores, q_zero_empty's zeros
//      among them): the 2 n_off acquire loads of a block in one round, and
//      the block barrier after the operators' copy passes what they
//      acquired on to the block;
//   2. stage 1 and its stores into the peers' stage-2 slots; a block
//      barrier, then one system fence a block (below);
//   3. the grid barrier: stage 1's reads of rb are done, so block 0 bumps
//      the epoch, and its thread i releases GOB = e + 1 to the rank that
//      sends to this one at offset i (its stage 2 may overwrite rb) and
//      IN2 = e at the rank that offset i sends to;
//   4. in every block thread i waits for its own IN2 >= e of offset i (the
//      peers' stage-1 halo is in rb2) and thread n_off + i for GOB >= e + 1
//      of offset i (the receiving rank's stage 1 has read its step-boundary
//      slots), one round again, and a block barrier passes them on;
//   5. stage 2: its output and its own send buffer sb, each lane's send
//      slots then copied by the lane into the step-boundary slots of the
//      rank that the slot's ring offset sends to: the exchange of the next
//      step's rb, folded into this launch (no launch between steps); a
//      block barrier, one system fence a block and the block's arrival on
//      the count; the last block to arrive releases INB = e + 1 at the rank
//      that each offset sends to, which its launch of epoch e + 1 waits for
//      in step 1.
// No wait cycle: stage 2's waits are on stage-1 progress of the same epoch
// (IN2, GOB), and stage 1's on the launch start of the same epoch (GO2)
// and on the end of the peers' launches of the epoch before (INB).
// Memory order of the stores into a peer's memory (step 2): they must be
// visible at system scope before IN2 (step 5: INB) is. PTX's fences and
// releases are cumulative: a thread's fence also orders the stores of
// other threads that it has observed, here through the block barrier
// (bar.sync: CTA scope) and the grid barrier (the gpu-scope fences and
// atomics of cooperative groups' grid.sync). So thread 0 of each block
// fences at system scope after its block has met, and the release of IN2
// (system scope) follows the grid barrier: one fence a block, not one a thread
// (256 against 16 384 at K_loc=512, B=8). It is the pattern of grid.sync
// itself, which publishes a block's stores at gpu scope with one thread's
// __threadfence after __syncthreads. Step 5 orders its stores before INB
// the same way, with the count's atomic and the last block's fence in the
// place of the grid barrier (every block meets it, none waits at it).
// The epoch lives in device memory (the region's first flag word), read
// and bumped by the launch, not passed in, so that a captured launch
// replays. Both modes run the same stage code, so the bits are those of
// two B7 launches.
template <class Z, bool PEER>
__device__ __forceinline__ void rdma_step(const SwDesc& d,
                                          const RdmaArgs& a) {
  cg::grid_group grid = cg::this_grid();
  const Ops g = make_ops(d, a.fops, a.iops);
  const long long* tab = a.peer;
  const int n_off = PEER ? (int)tab[PT_NOFF] : 0;
  const flag_t e = PEER ? *peer_epoch(tab) + 1 : 0;
  if (PEER) {
    if (blockIdx.x == 0) {
      // (the blocks arrive after stage 2, past the grid barrier below)
      if (threadIdx.x == 0) *peer_arrivals(tab) = 0;
      for (int i = threadIdx.x; i < n_off; i += blockDim.x)
        flag_release(peer_flag(tab, peer_from(tab, i), i, PEER_GO2), e);
    }
    for (int k = threadIdx.x; k < 2 * n_off; k += blockDim.x)
      flag_wait(peer_flag(tab, tab[PT_OWN], k % n_off,
                          k < n_off ? PEER_INB : PEER_GO2),
                e, tab[PT_TIMEOUT]);
  }
  q_setup_ops(g, smem);
  __syncthreads();
  // floats of one scenario's slot list (receive and send lists of a shard
  // have the same slots: slot j of the sender is slot j of the receiver)
  const size_t ls = (size_t)d.n_send * 3;
  // where shard sh's stage-1 slot j of scenario b goes: slot j of the
  // receiving shard's rb2 (the table picks the shard, or in peer mode the
  // rank); without one (no ring offsets), the shard's own slots
  auto push = [&](int sh, int b) {
    if (PEER && n_off > 0)
      return SendTo{a.rb2, nullptr, 0, tab + PT_HEAD, (int)tab[PT_CHUNK],
                    b * ls};
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
  float* scr = q_item_slots(q_ops_floats(g.Np, g.Ntr),
                           q_item_floats(g.Np, g.Ntr), Z::P);
  const int ipb = blockDim.x / Z::P, n_items = a.S * a.B * d.K;
  // one pass covers every item: the lane's nodes stay in registers
  const bool resident = Z::KEEP && (long long)gridDim.x * ipb >= n_items;
  const float h_bc1 = tidal_depth(g, a.t1), h_bc2 = tidal_depth(g, a.t2);
  Own<Z> st, s1;
  for (int first = blockIdx.x * ipb; first < n_items;
       first += gridDim.x * ipb) {
    const QLane l = q_lane<Z>(first, n_items, a.B, d.K, a.fstride,
                              a.istride);
    const size_t off = (size_t)l.sc * g.nV;
    const P3 in = at(a.h, a.hu, a.hv, off);
    load_own<Z>(g, l.e, l.p, in, st);
    qstage<Z, Z::KEEP>(g, smem, scr, l, in, st, st, in, s1,
                       atw(a.s1h, a.s1hu, a.s1hv, off), push(l.sh, l.b),
                       a.rb + l.sc * ls, 0.5f * a.dt, h_bc1, a.dt, a.ctrl,
                       a.use_filter, false, false);
  }
  if (PEER) {  // the block's stores into the peers, at system scope
    __syncthreads();
    if (threadIdx.x == 0) __threadfence_system();
  }
  grid.sync();
  if (PEER) {
    if (blockIdx.x == 0) {
      if (threadIdx.x == 0) *peer_epoch(tab) = e;
      for (int i = threadIdx.x; i < n_off; i += blockDim.x) {
        flag_release(peer_flag(tab, peer_from(tab, i), i, PEER_GOB), e + 1);
        flag_release(peer_flag(tab, peer_to(tab, i), i, PEER_IN2), e);
      }
    }
    for (int k = threadIdx.x; k < 2 * n_off; k += blockDim.x)
      flag_wait(peer_flag(tab, tab[PT_OWN], k % n_off,
                          k < n_off ? PEER_IN2 : PEER_GOB),
                k < n_off ? e : e + 1, tab[PT_TIMEOUT]);
    __syncthreads();
  }
  for (int first = blockIdx.x * ipb; first < n_items;
       first += gridDim.x * ipb) {
    const QLane l = q_lane<Z>(first, n_items, a.B, d.K, a.fstride,
                              a.istride);
    const size_t off = (size_t)l.sc * g.nV;
    const P3 in = at(a.s1h, a.s1hu, a.s1hv, off);
    const P3 base = at(a.h, a.hu, a.hv, off);
    if (!resident) {
      load_own<Z>(g, l.e, l.p, in, s1);
      if (Z::KEEP) load_own<Z>(g, l.e, l.p, base, st);
    }
    Own<Z> y;
    qstage<Z, Z::KEEP>(g, smem, scr, l, in, s1, st, base, y,
                       atw(a.oh, a.ohu, a.ohv, off),
                       SendTo{a.sb + l.sc * ls, nullptr, 0},
                       a.rb2 + l.sc * ls, a.dt, h_bc2, a.dt, a.ctrl,
                       a.use_filter, false, a.sponge != 0);
    // the next step's rb: the lane's send slots of stage 2, which it has
    // just stored into sb, into the receiving ranks' step-boundary slots
    // (the table read here and below, not held from the launch's start:
    // held in registers through the stage, what it gives pushed the
    // stage's live set past 128 registers into spills)
    if (PEER && l.active && tab[PT_NOFF] > 0)
      q_send_to_peers<Z>(g, l, a.sb + l.sc * ls, tab + PT_HEAD,
                         (int)tab[PT_CHUNK],
                         (size_t)tab[PT_RBB] / sizeof(float) + l.b * ls);
  }
  // INB = e + 1 once every block's stores are visible at system scope: a
  // block barrier, one system fence a block and the block's arrival on the
  // launch's count; the last block to arrive releases (the order of a grid
  // barrier without its wait)
  if (PEER && tab[PT_NOFF] > 0) {
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence_system();
      if (atomicAdd(peer_arrivals(tab), 1u) == gridDim.x - 1) {
        __threadfence();
        const flag_t next = *peer_epoch(tab) + 1;  // (block 0 stored e)
        for (int i = 0; i < (int)tab[PT_NOFF]; ++i)
          flag_release(peer_flag(tab, peer_to(tab, i), i, PEER_INB), next);
      }
    }
  }
}

template <class Z>
__global__ void __launch_bounds__(QMAX_THREADS, 2)
    sw2d_step_rdma_kernel(SwDesc d, RdmaArgs a) {
  rdma_step<Z, false>(d, a);
}

// The peer mode: one shard a rank (S = 1), the ring's table in a.peer. Its
// items are the stacked step's (four lanes an element at N=3, eight at N=6
// and on quadrilaterals at N=4), so that a rank's bits are its shard's of
// the stacked step: wider items (sixteen lanes, as the stage adjoint takes
// at small batches) shorten a stage's chain, but round differently
// (PERF.md), and a grid that fills the card leaves no room for the other
// ranks of a ring that share it.
template <class Z>
__global__ void __launch_bounds__(QMAX_THREADS, 2)
    sw2d_step_rdma_peer_kernel(SwDesc d, RdmaArgs a) {
  rdma_step<Z, true>(d, a);
}

// ---------------------------------------------------------------------------
// The blocked forward rollout (B5) and step (B4)
// ---------------------------------------------------------------------------
//
// sw2d_blocked_rollout_kernel replaces _rollout_kernel /
// sw2d_rollout_blocked of blitzdg_tpu/ops/sw2d_blocked.py and, launched
// for one step with one control row, _step_kernel / sw2d_step_blocked: the
// step is a rollout of one step, so it gives step t of a rollout bit for
// bit. One cooperative launch runs n_steps SSP-RK2 steps on qstage's items
// (one shard, the whole mesh: B x K items), two grid barriers a step:
//   1. stage 1 (coef dt/2, stage time t, no sponge) from the step-start
//      state into the s1 scratch;
//   2. stage 2 (coef dt, stage time t + dt/2, the sponge) from s1, with the
//      step-start state as its base, into the next trajectory row or, with
//      no trajectory stored, the state buffer (read at own nodes only in
//      that phase, so written in place).
// On a wet/dry set the positivity limiter follows each stage (qstage's).
// Step t takes the controls ctrls[b, t / spc].
//
// Quadrilateral elements (four faces, tensor-product nodes) run here too:
// qstage's face loops go over four faces, and the rest of a stage (the
// lift over Ntr = 4 Nfp trace nodes, the operators' and the item's shared
// memory, the element-local limiter) is sized from the descriptor. At N=4
// (Np 25, Nfp 5: the quads path's order) the instance has compile-time
// sizes, QOrder4Quad: eight lanes an element, lane p holding node p of each
// face (lanes 5-7 redo node 4 and store nothing) and the volume nodes p,
// p+8, p+16, p+24, the products unrolled by parts, as at N=6. On the quads
// path (K=144, B=8) that is 288 warps on the card's 132 SMs where one lane
// an element gave 36. Other quadrilateral orders take the run-time-size
// instance (one lane an item), whose arrays' room reaches N=4 (Np 25 <=
// QMAX_NP, Nfp 5 <= QMAX_NFP).
//
// Each stage is the sharded stage kernel's (B7's) pass over the items: a
// lane reads its own nodes of the stage's input, the two sides of its
// trace nodes and, at the update, its base nodes, and holds nothing across
// a grid barrier (held in registers, the step-start and stage-1 nodes
// pushed the kernel into spills and cost a fifth of its time at N=3:
// PERF.md). The blocks loop over the items where the grid is smaller than
// the work, the same items every step.
//
// Stage times are formed in double, t0 + t dt and that plus dt/2, each sum
// rounded by itself (no fused multiply-add), then rounded once to float:
// the times a host forms for a one-step launch at t0 + t dt. The tidal
// depth at a stage time is q_tide, which the adjoint's recompute of stage 1
// (B6) takes too.

// The stage times of step t from t0 and dt (see above).
__device__ __forceinline__ void q_stage_times(double t0, double dt, int t,
                                              float& t1, float& t2) {
  const double ts = __dadd_rn(t0, __dmul_rn((double)t, dt));
  t1 = __double2float_rn(ts);
  t2 = __double2float_rn(__dadd_rn(ts, 0.5 * dt));
}

// The tidal depth at stage time tk: tidal_depth's formula with the cosine
// as cospif, whose argument reduction is exact and short, where cosf's slow
// path spills (the two differ by an ulp or two of the cosine).
__device__ __forceinline__ float q_tide(const Ops& g, float tk) {
  if (!g.has_tidal) return 0.0f;
  const float ramp = g.tide_tau > 0.0f ? fminf(tk / g.tide_tau, 1.0f) : 1.0f;
  return g.tide_h0 + g.tide_amp *
         cospif(g.tide_omega * tk * 0.3183098861837907f) * ramp;
}

struct FwdArgs {
  const float* fops;
  const int* iops;
  const float *h, *hu, *hv;  // (B, nV) initial states
  const float* ctrls;        // (B, n_cs, n_ctrl) or null
  float *oh, *ohu, *ohv;     // (B, nV) the state buffer: the final state
  float *s1h, *s1hu, *s1hv;  // (B, nV) scratch: the stage-1 state
  float *th, *thu, *thv;     // (B, n_steps+1, nV) trajectory or null
  int B, n_steps, n_cs, spc, use_filter;
  double dt, t0;
};

template <class Z>
__global__ void __launch_bounds__(QMAX_THREADS, 2)
    sw2d_blocked_rollout_kernel(SwDesc d, FwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  const Ops g = make_ops(d, a.fops, a.iops);
  q_setup_ops(g, smem);
  __syncthreads();
  float* scr = q_item_slots(q_ops_floats(g.Np, g.Ntr),
                            q_item_floats(g.Np, g.Ntr), Z::P);
  const int ipb = blockDim.x / Z::P, n_items = a.B * d.K;
  const int Np = Z::np(g), ns = Z::nslots(g);
  const size_t nV = (size_t)g.nV, trow = (size_t)(a.n_steps + 1) * nV;
  const bool traj = a.th != nullptr, limit = g.wetdry != 0;
  const bool sponge = g.has_sponge != 0;
  const float dt = (float)a.dt;
  const SendTo nosend = {nullptr, nullptr, 0};
  // the step-start state of scenario b at step t, and where the step ends
  auto start = [&](int b, int t) {
    return t == 0 ? at(a.h, a.hu, a.hv, b * nV)
           : traj ? at(a.th, a.thu, a.thv, b * trow + t * nV)
                  : at(a.oh, a.ohu, a.ohv, b * nV);
  };
  auto end = [&](int b, int t) {
    return traj ? atw(a.th, a.thu, a.thv, b * trow + (t + 1) * nV)
                : atw(a.oh, a.ohu, a.ohv, b * nV);
  };
  auto ctrl_of = [&](const QLane& l, int t) -> const float* {
    return a.ctrls == nullptr ? nullptr
        : a.ctrls + ((size_t)l.b * a.n_cs + t / a.spc) * g.n_ctrl;
  };
  for (int t = 0; t < a.n_steps; ++t) {
    float t1, t2;
    q_stage_times(a.t0, a.dt, t, t1, t2);
    const float hb1 = q_tide(g, t1);
    for (int first = blockIdx.x * ipb; first < n_items;
         first += gridDim.x * ipb) {
      const QLane l = q_lane<Z>(first, n_items, a.B, d.K, 0, 0);
      const P3 in = start(l.sc, t);
      Own<Z> x, y;
      load_own<Z>(g, l.e, l.p, in, x);
      if (t == 0 && traj && l.active) {  // trajectory row 0
        const W3 r0 = atw(a.th, a.thu, a.thv, l.sc * trow);
#pragma unroll
        for (int i = 0; i < ns; ++i) {
          const int n = l.p + Z::P * i, v = l.e * Np + n;
          if (n < Np) {
            r0.a[v] = x.h[i]; r0.b[v] = x.hu[i]; r0.c[v] = x.hv[i];
          }
        }
      }
      qstage<Z, false>(g, smem, scr, l, in, x, x, in, y,
                       atw(a.s1h, a.s1hu, a.s1hv, l.sc * nV), nosend,
                       nullptr, 0.5f * dt, hb1, dt, ctrl_of(l, t),
                       a.use_filter, limit, false);
    }
    grid.sync();
    const float hb2 = q_tide(g, t2);
    for (int first = blockIdx.x * ipb; first < n_items;
         first += gridDim.x * ipb) {
      const QLane l = q_lane<Z>(first, n_items, a.B, d.K, 0, 0);
      const P3 in = at(a.s1h, a.s1hu, a.s1hv, l.sc * nV);
      Own<Z> x, y;
      load_own<Z>(g, l.e, l.p, in, x);
      qstage<Z, false>(g, smem, scr, l, in, x, x, start(l.sc, t), y,
                       end(l.sc, t), nosend, nullptr, dt, hb2, dt,
                       ctrl_of(l, t), a.use_filter, limit, sponge);
    }
    if (t + 1 < a.n_steps) grid.sync();
  }
}

// ---------------------------------------------------------------------------
// The adjoint stage (qvjp): the adjoint of one sharded stage (B8) and the
// reverse sweep of the blocked rollout (B6)
// ---------------------------------------------------------------------------
//
// sw2d_stage_bwd_kernel replaces _stage_bwd_kernel_v2 /
// sw2d_stage_bwd_blocked_v2 and sw2d_blocked_rollout_bwd_kernel replaces
// _rollout_bwd_kernel / sw2d_rollout_bwd_blocked of
// blitzdg_tpu/ops/sw2d_blocked.py, whose pullbacks are jax.vjp traced in
// the kernel; here both run the hand adjoint of ops/sw2d_fused.py
// (_rhs_vjp_plain) in qvjp, the counterpart of qstage: the same items (P
// lanes of a warp per (shard, scenario, element), lane p holding node p of
// each face and the volume nodes p, p+4, p+8 at N=3; one lane an item at
// other orders), no block barrier, the face maximum, the summed speed
// cotangent and the count of nodes at the maximum by shuffles, the item's
// intermediate values in its slots behind warp barriers. Quadrilaterals
// (four faces) take the run-time instance, as in qstage: the passes over
// the faces, the neighbours' weights in the item's slots and the
// per-face sums (speed cotangents, face maximum, tie count) follow the
// descriptor's face count. At N=4 on quadrilaterals B6 takes B5's
// compile-time instance, QOrder4Quad (eight lanes an element, so that its
// recompute of stage 1 runs B5's items and gives B5's bits), and B8 takes
// it too (its cut faces' slots written by the real lanes only): qvjp then
// takes a face a pass over all eight lanes, lane p < 5 holding trace node
// p and lanes 5-7 masked (QSizes::FMASKED), four passes, the face sums by
// shuffles of width eight, the products over the 25 nodes unrolled by
// parts; 64-thread blocks of eight items (33 KB of shared memory), 144
// blocks at K=144, B=8 where one lane an element gave 36 of one warp (B8
// on the same mesh in four shards: the same 1152 items, 144 blocks).
//
// No scatter. A trace node's flux feeds the cotangents of its '-' node
// (the element's own) and of its '+' node (the neighbour's). Rather than
// writing the '+' share to memory for the neighbour to gather after a grid
// barrier, each lane completes its own nodes: for each face it also
// recomputes the flux adjoint of the trace node on the face's other side
// (the mirror table names it), in the neighbour's frame, from the
// neighbour's weights (read from wsrc) lifted through the filter and lift
// transposes composed into one operator, and keeps the '+' share of it.
// That is about twice the face work, against a global round trip and a
// grid barrier. On a boundary face the '+' node is the element's own; at a
// cut face the '+' share goes to the receive slot's cotangent, which its
// one reading trace node's lane writes. No atomics on data: the same bits
// on a rerun.
//
// B8 is one ordinary launch, planned once a shape: the base cotangent
// (the output's plus the transposed send gather, times the sponge factor)
// at the lane's nodes, and qvjp on it. At small batches (both shapes of
// the sharded MPC run B=1) the SMs hold a warp or two each and an
// element's chain sets the time: there B8 takes wide items, 16 lanes an
// element at N=3 (a lane a trace node and a volume node, four lanes a
// face, one pass over the faces) and 8 at N=1 with two controls. The
// control cotangent is a sum over elements, in a fixed order: each block
// sums its items' shares per shard-scenario (a segment), and the block
// that completes a shard-scenario (a counter each, reset by that block)
// adds its segments.
//
// B6 is one cooperative launch with two grid barriers a step. For step t
// (T-1 .. 0), with lambda the adjoint of s_{t+1}:
//   1. complete lambda_{t+1} = W + a + VJP_R(s_{t+1})[dt/2 a] of the step
//      after (qvjp), W = (lambda_{t+1} + tbar_{t+1}) * sponge factor, and
//      s_half = s_t + dt/2 R(s_t) (qstage);
//   2. a = VJP_R(s_half)[dt W] (qvjp).
// Phase 1 runs once more for t = -1 (the initial-state cotangent). W, a
// and s_half go to global memory (L2) for the neighbours' recomputes, and
// each lane reads its own nodes back from there: held in registers across
// the barriers, they pushed the adjoint past its 128 registers into
// spills. Control shares are added to a per-item row of each control step
// and summed over elements after the last barrier.
//
// The chain rule of a trace node and of a volume node takes the fast
// reciprocals (face_vjp_fast, volume_vjp_fast: 2 ulp); the speeds that
// decide the ties are computed exactly (trace_finish) and compared as
// computed (C8). The neighbour's frame of an inner face reuses this side's
// trace values swapped (q_swap), so its face maximum and tie count are
// this side's, bit for bit.
//
// Bound on the card: B8 bytes (its reads and writes outweigh one RHS
// adjoint per node at the card's float32 rate), B6 float32 operations. The
// neighbours' weights are gathers through the mirror table, whose indices
// do not depend on the data and are loaded ahead of it.

// Floats of the operators an adjoint launch keeps in shared memory: those
// of qstage, then the filter and lift transposes composed, C[n][j] =
// sum_m filt[n][m] lift[m][j] (the lift alone without the filter).
__host__ __device__ inline int q_adj_ops_floats(int Np, int Ntr) {
  return qround4(3 * Np * Np + 2 * Np * Ntr);
}

// Floats of one item's slots in qvjp: the weights, then the filtered
// weights, a node; the geometric factors (rx, sx, ry, sy) a node; the
// weights of each face's neighbour, a node (Nfaces of them); the trace
// nodes' cotangents with their '-' node.
__host__ __device__ inline int q_vjp_item_floats(int Np, int Ntr,
                                                 int Nfaces) {
  return (8 + 4 * Nfaces) * Np + 4 * Ntr;
}

// The operators into shared memory with the composed transpose, made from
// the shared copies (a block of one warp would wait on a chain of global
// loads); every thread of the block must call it, a block barrier follows.
__device__ void q_setup_adjoint_ops(const Ops& o, float* s, int use_filter) {
  q_setup_ops(o, s);
  __syncthreads();
  const int Np = o.Np, Ntr = o.Ntr;
  const float* lf = s + 2 * Np * Np;
  const float* fl = lf + Np * Ntr;
  float* cm = s + 3 * Np * Np + Np * Ntr;
  for (int i = threadIdx.x; i < Np * Ntr; i += blockDim.x) {
    const int n = i / Ntr, j = i - n * Ntr;
    float c = 0.0f;
    if (use_filter) {
      for (int m = 0; m < Np; ++m) c += fl[n * Np + m] * lf[m * Ntr + j];
    } else {
      c = lf[n * Ntr + j];
    }
    cm[i] = c;
  }
}

struct F3 { float a, b, c; };

// Weights read from one scenario's fields (written by this launch: plain
// loads).
struct WFields {
  const float *a, *b, *c;
  __device__ __forceinline__ F3 operator()(int v) const {
    F3 r;
    r.a = a[v]; r.b = b[v]; r.c = c[v];
    return r;
  }
};

// The base cotangent of a sharded stage at node v: the output's cotangent
// plus those of the send slots that read the node (the transposed send
// gather), times the sponge factor where the stage relaxes (h only where
// there is bathymetry).
// TWO (the stage adjoint's peer mode): the send buffer's cotangent in two
// parts, lsb (the ring's reverse slots) and lsb2 (autograd's, where a cost
// also takes the send buffer; null: none), added slot by slot before the
// inverse send list sums them, as the stacked steps' autograd adds the
// two before B8 reads them.
template <bool TWO>
struct StageLam {
  const float *lh, *lhu, *lhv;  // the shard's and scenario's rows
  const float* lsb;             // (n_send, 3) cotangent of the send buffer
  const int *ptr, *idx;         // the shard's inverse send list
  const float* spng;            // the shard's sponge row, or null
  bool bathy;
  float c_dt;
  const float* lsb2;            // (n_send, 3) with TWO: its second part
  __device__ __forceinline__ F3 operator()(int v) const {
    F3 r;
    r.a = __ldg(lh + v); r.b = __ldg(lhu + v); r.c = __ldg(lhv + v);
    const int q1 = __ldg(ptr + v + 1);
    for (int q = __ldg(ptr + v); q < q1; ++q) {
      const int j = 3 * __ldg(idx + q);
      float a = __ldg(lsb + j), b = __ldg(lsb + j + 1);
      float c = __ldg(lsb + j + 2);
      if (TWO && lsb2 != nullptr) {
        a += __ldg(lsb2 + j);
        b += __ldg(lsb2 + j + 1);
        c += __ldg(lsb2 + j + 2);
      }
      r.a += a; r.b += b; r.c += c;
    }
    if (spng != nullptr) {
      const float fac = 1.0f / (1.0f + c_dt * __ldg(spng + v));
      if (bathy) r.a *= fac;
      r.b *= fac; r.c *= fac;
    }
    return r;
  }
};

// A trace node's values from its raw states s (h, hu, hv of the '-' side,
// then of the '+' side) and its normal, flags and still-water depths.
__device__ __forceinline__ void q_trace(const Ops& g, float h_bc,
                                        const float* s, float nx, float ny,
                                        bool wall, float obc, float HM,
                                        float HP, TraceVals& tv) {
  tv.nx = nx; tv.ny = ny;
  tv.hM = s[0]; tv.huM = s[1]; tv.hvM = s[2];
  tv.hP = s[3]; tv.huP = s[4]; tv.hvP = s[5];
  trace_finish(g, h_bc, wall, obc, HM, HP, tv);
}

// The values of an inner face's trace node as the element across sees
// them, given this side's: the two sides swapped, the normal (nx, ny) the
// other element's. Every value is this side's, bit for bit, so its speeds,
// face maximum and tie count are this side's too.
__device__ __forceinline__ TraceVals q_swap(const TraceVals& a, float nx,
                                           float ny) {
  TraceVals b;
  b.nx = nx; b.ny = ny;
  b.hM = a.hP; b.hP = a.hM;
  b.huM = a.huP; b.hvM = a.hvP; b.huP = a.huM; b.hvP = a.hvM;
  b.uM = a.uP; b.vM = a.vP; b.uP = a.uM; b.vP = a.vM;
  b.hMs = a.hPs; b.hPs = a.hMs;
  b.passM = a.passP; b.passP = a.passM;
  b.spdM = a.spdP; b.spdP = a.spdM;
  b.wall = false;
  b.obc = 0.0f;
  return b;
}

// The vector-Jacobian product of the filtered, control-forced RHS at state
// `in` for one item (element l.e of one shard and scenario) on lane l.p of
// its P lanes. With W the weights of any node of the shard and scenario
// (wsrc(v)) and wf = scale * filter^T W:
//   out(v, hb, hub, hvb) at each of the lane's nodes v (active lanes only):
//          J_R(in)^T wf there, complete (the volume part, the '-' side of
//          the element's face fluxes, the '+' side of its neighbours' face
//          fluxes and, at a boundary face, of its own);
//   orb  = the '+' side at the cut faces' receive slots (null: none);
//   cdst = the item's share of d/d ctrl, written by its lane 0 (added to
//          what is there with acc; null: not asked).
// in: the shard and scenario's state in global memory; rb: its receive
// buffer (null: none); h_bc: the tidal depth at the stage time (as
// qstage takes it); scr: the item's slots
// (q_vjp_item_floats); sops: the operators (q_setup_adjoint_ops). The
// lane holds no value across a phase: what the phases share goes through
// the item's slots, so the live set stays that of one face.
template <class Z, class WSrc, class Out>
__device__ __forceinline__ void qvjp(
    const Ops& g, const float* sops, float* scr, const QLane& l, const P3& in,
    const float* rb, const WSrc& wsrc, float scale, float h_bc, int use_filter,
    const Out& out, float* orb, float* cdst, bool acc) {
  constexpr int P = Z::P;
  const int Np = Z::np(g), Ntr = Z::ntr(g), Nfp = Z::nfp(g);
  const int ns = Z::nslots(g), nfl = Z::nface(g), nc = Z::nc(g);
  const int nf = Z::nfaces(g);
  const int e = l.e, p = l.p, v0 = e * Np, i0 = e * Ntr;
  const float2* DS = reinterpret_cast<const float2*>(sops);
  const float* LF = sops + 2 * Np * Np;
  const float* FL = LF + Np * Ntr;
  const float* CM = FL + Np * Np;
  float4* X = reinterpret_cast<float4*>(scr);
  float4* GF = X + Np;
  float4* NW = GF + Np;
  float4* TT = NW + nf * Np;
  const float hsg = 0.5f * sqrtf(g.g);

  __syncwarp();  // the item's slots are free (a previous pass read them)
  // the weights at the element's nodes and at each inner face's neighbour's
#pragma unroll
  for (int i = 0; i < ns; ++i) {
    const int n = p + P * i;
    if (n < Np) {
      const F3 r = wsrc(v0 + n);
      X[n] = make_float4(r.a, r.b, r.c, 0.0f);
    }
  }
#pragma unroll
  for (int f = 0; f < nf; ++f) {
    // a face's nodes all have a neighbour in the shard, or none
    const int gi = l.io + i0 + f * Nfp;
    const int m0 = __ldg(g.vmapM + gi), q0 = __ldg(g.vmapP + gi);
    if (q0 != m0 && q0 < g.nV) {
      const int kn = __ldg(g.mirror + gi) / Ntr;
#pragma unroll
      for (int i = 0; i < ns; ++i) {
        const int n = p + P * i;
        if (n < Np) {
          const F3 r = wsrc(kn * Np + n);
          NW[f * Np + n] = make_float4(r.a, r.b, r.c, 0.0f);
        }
      }
    }
  }
  __syncwarp();

  // filter transpose (the control enters the RHS before the filter), the
  // control share; wf replaces the weights in the slots
  Own<Z> wf;
#pragma unroll
  for (int i = 0; i < ns; ++i) {
    const int n = p + P * i;
    float a = 0.0f, b = 0.0f, c = 0.0f;
    if (n < Np) {
      if (use_filter) {
#pragma unroll
        for (int m = 0; m < Np; ++m) {
          const float fl = FL[m * Np + n];
          const float4 q = X[m];
          a += fl * q.x; b += fl * q.y; c += fl * q.z;
        }
      } else {
        const float4 q = X[n];
        a = q.x; b = q.y; c = q.z;
      }
    }
    wf.h[i] = a * scale; wf.hu[i] = b * scale; wf.hv[i] = c * scale;
  }
  if (cdst != nullptr) {
    for (int cc = 0; cc < nc; ++cc) {
      float part = 0.0f;
#pragma unroll
      for (int i = 0; i < ns; ++i) {
        const int n = p + P * i;
        if (n < Np) {
          const int v = l.fo + cc * g.nV + v0 + n;
          part += __ldg(g.BU + v) * wf.hu[i] + __ldg(g.BV + v) * wf.hv[i];
        }
      }
#pragma unroll
      for (int m = 1; m < P; m <<= 1)
        part += __shfl_xor_sync(0xffffffffu, part, m, P);
      if (p == 0 && l.active) cdst[cc] = acc ? cdst[cc] + part : part;
    }
  }
  __syncwarp();  // the weights are read
#pragma unroll
  for (int i = 0; i < ns; ++i) {
    const int n = p + P * i;
    if (n < Np) {
      const int v = l.fo + v0 + n;
      X[n] = make_float4(wf.h[i], wf.hu[i], wf.hv[i], 0.0f);
      GF[n] = make_float4(__ldg(g.rx + v), __ldg(g.sx + v), __ldg(g.ry + v),
                          __ldg(g.sy + v));
    }
  }
  __syncwarp();

  // a face a pass (wide items: each group of LPF lanes its face, one pass):
  // the element's own flux adjoint at the lane's trace nodes of it, then,
  // on an inner face, the neighbour's at the trace nodes across (the same
  // values swapped, its normal and face scale, its weights lifted through
  // the composed transposes), into the trace nodes' cotangents. A masked
  // lane (FMASKED: its place lies past the face's nodes) redoes the face's
  // last node, whose speed cannot move the face maximum, and adds nothing
  // to the face's sums and tie count and stores nothing: the even split of
  // C6/C12 counts the real nodes at the maximum.
  constexpr int LPF = Z::LPF, FPP = P / LPF;  // lanes a face, faces a pass
  const bool depths = g.wb != 0;
  const int pf = p % LPF;  // the lane's place in its face
  const int ng = Z::ng(g);
  // unroll factors: the products', complete up to 10 nodes, by parts above
  // (quadrilaterals at N=4), none at run-time sizes; the passes', complete
  // up to 10 nodes, none above (at N=4 the rolled passes took 0.192 ms on
  // the quad path's shape, the unrolled 0.216, with 40 % more
  // instructions: PERF.md) and at run-time sizes
  constexpr int VU = Z::MU, PU = Z::PU;
#pragma unroll (PU)
  for (int it = 0; it < ng; ++it) {
    // (lanes past the last face redo it and store nothing)
    const bool has = it * FPP + p / LPF < nf;
    const int f = has ? it * FPP + p / LPF : nf - 1;
    TraceVals tv[Z::CFP];
    float spd[Z::CFP], d[Z::CFP][3], dn[Z::CFP][3], nxn[Z::CFP];
    float nyn[Z::CFP];
    int vm[Z::CFP], vp[Z::CFP], fn[Z::CFP];
    bool real[Z::CFP];
    float lam = 0.0f, lsum = 0.0f, lsn = 0.0f, cnt = 0.0f;
#pragma unroll
    for (int k = 0; k < nfl; ++k) {
      real[k] = !Z::FMASKED || pf + LPF * k < Nfp;
      fn[k] = real[k] ? pf + LPF * k : Nfp - 1;  // the node's place
      const int j = f * Nfp + fn[k], gi = l.io + i0 + j;
      const int fi = l.fo + i0 + j;
      const int m = __ldg(g.vmapM + gi), q = __ldg(g.vmapP + gi);
      vm[k] = m; vp[k] = q;
      float sv[6];
      sv[0] = in.a[m]; sv[1] = in.b[m]; sv[2] = in.c[m];
      const float* r = in.a + q;
      const float* ru = in.b + q;
      const float* rv = in.c + q;
      if (q >= g.nV) {  // a cut face: the receive slot
        r = rb + 3 * (q - g.nV); ru = r + 1; rv = r + 2;
      }
      sv[3] = *r; sv[4] = *ru; sv[5] = *rv;
      q_trace(g, h_bc, sv, __ldg(g.nx + fi), __ldg(g.ny + fi),
              __ldg(g.wall + fi) != 0.0f,
              g.has_tidal ? __ldg(g.obc + fi) : 0.0f,
              depths ? __ldg(g.HMt + fi) : 0.0f,
              depths ? __ldg(g.HPt + fi) : 0.0f, tv[k]);
      // lift transpose at this trace node
      float d1 = 0.0f, d2 = 0.0f, d3 = 0.0f;
#pragma unroll (VU)
      for (int mm = 0; mm < Np; ++mm) {
        const float lf = LF[mm * Ntr + j];
        const float4 wv = X[mm];
        d1 += lf * wv.x; d2 += lf * wv.y; d3 += lf * wv.z;
      }
      const float fs = __ldg(g.fscale + fi);
      d[k][0] = d1 * fs; d[k][1] = d2 * fs; d[k][2] = d3 * fs;
      spd[k] = fmaxf(tv[k].spdM, tv[k].spdP);
      float dq1, dq2, dq3;
      trace_jumps(g, tv[k], dq1, dq2, dq3);
      if (real[k])
        lsum += -0.5f * (dq1 * d[k][0] + dq2 * d[k][1] + dq3 * d[k][2]);
      lam = k == 0 ? spd[k] : fmaxf(lam, spd[k]);
    }
    const bool inner = vp[0] != vm[0] && vp[0] < g.nV;
#pragma unroll
    for (int k = 0; k < nfl; ++k) {
      // the neighbour's trace node across, its weights lifted
      const int gi = l.io + i0 + f * Nfp + fn[k];
      float d1 = 0.0f, d2 = 0.0f, d3 = 0.0f;
      nxn[k] = nyn[k] = 0.0f;
      if (inner) {
        const int jn = __ldg(g.mirror + gi), kn = jn / Ntr;
        const int jl = jn - kn * Ntr, fi = l.fo + jn;
#pragma unroll (VU)
        for (int n = 0; n < Np; ++n) {
          const float cm = CM[n * Ntr + jl];
          const float4 wv = NW[f * Np + n];
          d1 += cm * wv.x; d2 += cm * wv.y; d3 += cm * wv.z;
        }
        const float fs = __ldg(g.fscale + fi) * scale;
        d1 *= fs; d2 *= fs; d3 *= fs;
        nxn[k] = __ldg(g.nx + fi); nyn[k] = __ldg(g.ny + fi);
      }
      dn[k][0] = d1; dn[k][1] = d2; dn[k][2] = d3;
      float dq1, dq2, dq3;
      trace_jumps(g, q_swap(tv[k], nxn[k], nyn[k]), dq1, dq2, dq3);
      if (real[k]) lsn += -0.5f * (dq1 * d1 + dq2 * d2 + dq3 * d3);
    }
    // the face maximum, the summed speed cotangents of both frames and the
    // count of nodes at the maximum, over the face's lanes
#pragma unroll
    for (int m = 1; m < LPF; m <<= 1) {
      lam = fmaxf(lam, __shfl_xor_sync(0xffffffffu, lam, m, LPF));
      lsum += __shfl_xor_sync(0xffffffffu, lsum, m, LPF);
      lsn += __shfl_xor_sync(0xffffffffu, lsn, m, LPF);
    }
#pragma unroll
    for (int k = 0; k < nfl; ++k)
      cnt += real[k] && spd[k] == lam ? 1.0f : 0.0f;
#pragma unroll
    for (int m = 1; m < LPF; m <<= 1)
      cnt += __shfl_xor_sync(0xffffffffu, cnt, m, LPF);
    const float share = lsum / cnt, sharen = lsn / cnt;
#pragma unroll
    for (int k = 0; k < nfl; ++k) {
      // (this node's speed as computed above against the face maximum, C8)
      const bool top = spd[k] == lam;
      float tM[3], tP[3], T[3];
      face_vjp_fast(g, tv[k], lam, top ? share : 0.0f, d[k][0], d[k][1],
                    d[k][2], hsg, tM, tP);
      T[0] = tM[0]; T[1] = tM[1]; T[2] = tM[2];
      if (vp[k] == vm[k]) {  // a boundary face: the '+' node is this one
        T[0] += tP[0]; T[1] += tP[1]; T[2] += tP[2];
      } else if (vp[k] >= g.nV && l.active && has && real[k]) {
        // a cut face: its slot
        float* o = orb + 3 * (vp[k] - g.nV);
        o[0] = tP[0]; o[1] = tP[1]; o[2] = tP[2];
      }
      if (inner) {  // the '+' side of the flux across, this node's share
        face_vjp_fast(g, q_swap(tv[k], nxn[k], nyn[k]), lam,
                      top ? sharen : 0.0f, dn[k][0], dn[k][1], dn[k][2], hsg,
                      tM, tP);
        T[0] += tP[0]; T[1] += tP[1]; T[2] += tP[2];
      }
      if (has && real[k])
        TT[f * Nfp + fn[k]] =
            make_float4(T[0], T[1], T[2], (float)(vm[k] - v0));
    }
  }
  __syncwarp();

  // the lane's nodes, one at a time (a loop: one node's sums live at
  // once): divergence transpose, volume fluxes and sources, then the
  // cotangents of the trace nodes at the node (in trace-node order)
#pragma unroll 1
  for (int i = 0; i < ns; ++i) {
    const int n = p + P * i;
    if (n < Np) {
      float hb, hub, hvb;
      float Fb1 = 0, Fb2 = 0, Fb3 = 0, Gb1 = 0, Gb2 = 0, Gb3 = 0;
#pragma unroll
      for (int m = 0; m < Np; ++m) {
        const float2 ds = DS[m * Np + n];
        const float4 q = GF[m];
        const float dx = ds.x * q.x + ds.y * q.y;
        const float dy = ds.x * q.z + ds.y * q.w;
        const float4 wv = X[m];
        Fb1 -= dx * wv.x; Fb2 -= dx * wv.y; Fb3 -= dx * wv.z;
        Gb1 -= dy * wv.x; Gb2 -= dy * wv.y; Gb3 -= dy * wv.z;
      }
      const int v = v0 + n;
      const bool bathy = g.has_bathy != 0;
      const float4 w = X[n];
      volume_vjp_fast(g, bathy ? __ldg(g.Hx + l.fo + v) : 0.0f,
                      bathy ? __ldg(g.Hy + l.fo + v) : 0.0f, in.a[v],
                      in.b[v], in.c[v], Fb1, Fb2, Fb3, Gb1, Gb2, Gb3, w.y,
                      w.z, hb, hub, hvb);
      const float fn = (float)n;
      for (int j = 0; j < Ntr; ++j) {
        const float4 q = TT[j];
        if (q.w == fn) { hb += q.x; hub += q.y; hvb += q.z; }
      }
      if (l.active) out(v, hb, hub, hvb);
    }
  }
}

// A sum of `n` values src[0], src[stride], ... over the lanes of a warp:
// lane-strided, then a butterfly (every lane gets the same bits); the
// warp's lanes must all call it. global: src is in global memory, written
// by other blocks of the launch (read past L1), else in shared memory.
__device__ __forceinline__ float q_warp_sum(const float* src, int n,
                                            size_t stride, bool global) {
  const int lane = threadIdx.x & 31;
  float sum = 0.0f;
  for (int i = lane; i < n; i += 32)
    sum += global ? __ldcg(src + i * stride) : src[i * stride];
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, m);
  return sum;
}

struct StageBwdArgs {
  const float* fops;
  const int* iops;
  long long fstride, istride;
  int S, B, use_filter, sponge;
  const float *ch, *chu, *chv;  // (S, B, nV) stage input
  const float* rb;              // (S, B, n_recv, 3)
  const float *lh, *lhu, *lhv;  // (S, B, nV) cotangent of the output
  const float* lsb;             // (S, B, n_send, 3) cotangent of the send buffer
  float *obh, *obhu, *obhv;     // (S, B, nV) out: cotangent of the base
  float *och, *ochu, *ochv;     // (S, B, nV) out: cotangent of the input
  float* orb;                   // (S, B, n_recv, 3) out
  float* octl;                  // (S, B, n_ctrl) out, or null
  // with octl: (S, B, segments, n_ctrl) scratch, the blocks' sums of their
  // items' control shares, and (S, B) counters of the blocks done with each
  // shard and scenario (0 between launches)
  float* cpart;
  unsigned* done;
  float c_dt, t;
  // the peer mode (S = 1): the stage ring's table, the epoch read from the
  // reverse slots (0: none; else lsb is this rank's reverse slot set of
  // e_in's parity) and the epoch whose orb is sent to the ranks the
  // receive buffer came from (0: none)
  const long long* peer;
  flag_t e_in, e_out;
  flag_t e_skip;      // (0: none) the reverse epochs this rank will not read
  const float* lsb2;  // (1, B, n_send, 3) autograd's part of lsb, or null
};

// With out = sponge(base + c_dt R(cur)) and sb = gather(out):
//   lam  = lam_out + gather^T lam_sb        (the inverse send list)
//   base cotangent = sponge factor * lam    (h only where there is bathymetry)
//   cur cotangent, rb cotangent, control cotangent = VJP_R(cur)[c_dt * that].
// One pass: block b holds items b*ipb .. b*ipb + ipb - 1 (the launcher's
// grid covers every item).
//
// The peer mode (PEER, S = 1), the mirror image of the stage's over the
// stage ring's reverse slots, RGO and RIN; for the launch of reverse epoch
// e_out:
//   1. sr_fold_start: with e_skip, block 0 releases RGO = e_skip + 1 at
//      the ranks that send here (reverse epochs that no backward here will
//      read: a backward restricted by autograd to a part of the rollout
//      left them); thread k waits for RIN >= e_in of offset k (the
//      peers' adjoint launches of the stage that read this stage's send
//      buffer have stored lam_sb here; e_in = 0: lam_sb is given, the
//      stage whose send buffer carries the rollout's end) and thread
//      n_off + k for RGO >= e_out - 1 (the sending rank's reverse slot set
//      of e_out's parity is free);
//   2. lam_sb is read from this rank's reverse slots of e_in's parity
//      (their address passed as lsb by the launcher), plus lsb2 where a
//      cost also takes the send buffer (StageLam<true>: the sum forms in
//      registers, the stacked steps' sum of the two parts);
//   3. B8's items and qvjp (B8's bits); then, after a block barrier, each
//      block copies the receive-buffer cotangent orb of its items' cut
//      faces (each slot written by the lane of its one reading trace node,
//      in the block) into slot j of the reverse slots of e_out's parity of
//      the rank that chunk j / chunk came from, the unread slots' zeros
//      likewise (e_out = 0: orb stays here, the rollout's first stage,
//      whose receive buffer the standalone exchange gave);
//   4. sr_fold_end: the last block releases RGO = e_in + 1 at the ranks
//      that sent lam_sb and RIN = e_out at the ranks orb goes to.
// No wait cycle, as in the stage's peer mode: a launch waits only on flags
// that the peers' adjoint launches of the round before (the stage after
// it) release at their ends. The control-cotangent sums (cpart, done) are
// B8's.
// Whether a stage adjoint's launch sends orb over the ring (the peer mode
// with an epoch to send and ring offsets), and where slot j of scenario b
// goes: the reverse slots of e_out's parity of the rank that chunk
// j / chunk came from.
template <bool PEER>
__device__ __forceinline__ bool q_folds_reverse(const StageBwdArgs& a) {
  return PEER && a.e_out != 0 && a.peer[SR_NOFF] > 0;
}

__device__ __forceinline__ float* q_reverse_slot(const SwDesc& d,
                                                 const StageBwdArgs& a,
                                                 size_t ls, int b, int j) {
  const int n_off = (int)a.peer[SR_NOFF];
  return sr_peer_slot(a.peer + SR_HEAD + n_off, d.n_send / n_off,
                      sr_slots(a.peer, 0, 1, a.e_out), ls, b, j);
}

template <class Z, bool PEER>
__device__ __forceinline__ void stage_bwd_launch(const SwDesc& d,
                                                 const StageBwdArgs& a) {
  const Ops g = make_ops(d, a.fops, a.iops);
  if (PEER) sr_fold_start(a.peer, 1, a.e_in, a.e_out, a.e_skip);
  q_setup_adjoint_ops(g, smem, a.use_filter);
  __syncthreads();
  const size_t ls = (size_t)d.n_send * 3;  // floats of one slot list
  // receive slots that no trace node reads: zeros (each other slot is
  // written by the lane of its one reader)
  const int nr = d.n_recv;
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < a.S * a.B * nr;
       k += gridDim.x * blockDim.x) {
    const int sc = k / nr, j = k - sc * nr;
    const int* ptr = g.invP_ptr + (sc / a.B) * a.istride + g.nV + j;
    if (__ldg(ptr + 1) == __ldg(ptr)) {
      float* q = a.orb + sc * ls + 3 * j;
      q[0] = q[1] = q[2] = 0.0f;
      if (q_folds_reverse<PEER>(a)) {
        float* o = q_reverse_slot(d, a, ls, sc, j);
        o[0] = o[1] = o[2] = 0.0f;
      }
    }
  }
  const int ops_f = q_adj_ops_floats(g.Np, g.Ntr);
  const int vjp_f = q_vjp_item_floats(g.Np, g.Ntr, g.Nfaces);
  const int item_f = vjp_f + qround4(g.n_ctrl);  // the item's control share
  float* scr = q_item_slots(ops_f, item_f, Z::P);
  const int ipb = blockDim.x / Z::P, n_items = a.S * a.B * d.K;
  const int first = blockIdx.x * ipb;
  const int Np = Z::np(g), ns = Z::nslots(g), nc = Z::nc(g);
  const float h_bc = tidal_depth(g, a.t);
  if (first < n_items) {
    const QLane l = q_lane<Z>(first, n_items, a.B, d.K, a.fstride,
                              a.istride);
    const size_t off = (size_t)l.sc * g.nV;
    const StageLam<PEER> lam = {
        a.lh + off, a.lhu + off, a.lhv + off, a.lsb + l.sc * ls,
        g.send_ptr + l.io, g.send_idx + l.io,
        a.sponge ? g.SPNG + l.fo : nullptr, g.has_bathy != 0, a.c_dt,
        a.lsb2 == nullptr ? nullptr : a.lsb2 + l.sc * ls};
#pragma unroll
    for (int i = 0; i < ns; ++i) {  // the base cotangent
      const int n = l.p + Z::P * i, v = l.e * Np + n;
      if (n < Np && l.active) {
        const F3 r = lam(v);
        a.obh[off + v] = r.a; a.obhu[off + v] = r.b; a.obhv[off + v] = r.c;
      }
    }
    float *och = a.och + off, *ochu = a.ochu + off, *ochv = a.ochv + off;
    qvjp<Z>(g, smem, scr, l, at(a.ch, a.chu, a.chv, off), a.rb + l.sc * ls,
            lam, a.c_dt, h_bc, a.use_filter,
            [&](int v, float hb, float hub, float hvb) {
              och[v] = hb; ochu[v] = hub; ochv[v] = hvb;
            },
            a.orb + l.sc * ls, a.octl == nullptr ? nullptr : scr + vjp_f,
            false);
  }
  // the block's cut-face slots of orb to their senders (the table read
  // here, not held through qvjp)
  if (q_folds_reverse<PEER>(a)) {
    __syncthreads();
    const int Ntr = g.Ntr, n_in = max(0, min(ipb, n_items - first));
    for (int k = threadIdx.x; k < n_in * Ntr; k += blockDim.x) {
      const int it = first + k / Ntr, j = k - (k / Ntr) * Ntr;
      const int b = it / d.K, e = it - b * d.K;
      const int q = __ldg(g.vmapP + e * Ntr + j);
      if (q >= g.nV) {
        const float* src = a.orb + b * ls + 3 * (q - g.nV);
        float* dst = q_reverse_slot(d, a, ls, b, q - g.nV);
        dst[0] = src[0]; dst[1] = src[1]; dst[2] = src[2];
      }
    }
  }
  if (PEER) sr_fold_end(a.peer, 1, a.e_in, a.e_out);
  if (a.octl == nullptr) return;

  // the control cotangents, in a fixed order: the block's items' shares
  // summed per shard-scenario (segment sc, b - first block of sc), then the
  // block that completes a shard-scenario adds its segments
  __syncthreads();  // every item's share is in its slot
  const int K = d.K, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int n_in = min(ipb, n_items - first);
  const int sc_lo = first / K, n_sc = (first + n_in - 1) / K - sc_lo + 1;
  const int max_seg = (K + ipb - 1) / ipb + 1;
  auto seg0 = [&](int sc) { return sc * K / ipb; };  // first block of sc
  for (int pr = warp; pr < n_sc * nc; pr += nw) {
    const int sc = sc_lo + pr / nc, c = pr - (pr / nc) * nc;
    const int i0 = max(first, sc * K) - first;
    const int i1 = min(first + n_in, (sc + 1) * K) - first;
    const float sum = q_warp_sum(smem + ops_f + i0 * item_f + vjp_f + c,
                                 i1 - i0, item_f, false);
    if ((threadIdx.x & 31) == 0) {
      a.cpart[((size_t)sc * max_seg + blockIdx.x - seg0(sc)) * nc + c] = sum;
      __threadfence();
    }
  }
  __syncthreads();
  int* fin = reinterpret_cast<int*>(smem + ops_f);  // (the slots are free)
  for (int k = threadIdx.x; k < n_sc; k += blockDim.x) {
    const int sc = sc_lo + k, n_seg = ((sc + 1) * K - 1) / ipb - seg0(sc) + 1;
    fin[k] = atomicAdd(a.done + sc, 1u) == (unsigned)(n_seg - 1);
  }
  __syncthreads();
  for (int k = warp; k < n_sc; k += nw) {
    if (!fin[k]) continue;
    __threadfence();
    const int sc = sc_lo + k, n_seg = ((sc + 1) * K - 1) / ipb - seg0(sc) + 1;
    for (int c = 0; c < nc; ++c) {
      const float sum = q_warp_sum(a.cpart + (size_t)sc * max_seg * nc + c,
                                   n_seg, nc, true);
      if ((threadIdx.x & 31) == 0) a.octl[sc * nc + c] = sum;
    }
    if ((threadIdx.x & 31) == 0) a.done[sc] = 0;
  }
}

template <class Z>
__global__ void __launch_bounds__(QMAX_THREADS, Z::BWD_MIN_BLOCKS)
    sw2d_stage_bwd_kernel(SwDesc d, StageBwdArgs a) {
  stage_bwd_launch<Z, false>(d, a);
}

// The peer mode (S = 1), on B8's lanes for the shape (sixteen an element at
// N=3 at the sharded MPC's batch of one, where a rank's 512 elements are
// 8192 lanes, 256 blocks of one warp: S = 4 ranks' grids hold 1024 of the
// card's block slots, about half), so that a rank's bits are its shard's
// of B8 launched alone.
template <class Z>
__global__ void __launch_bounds__(QMAX_THREADS, Z::BWD_MIN_BLOCKS)
    sw2d_stage_bwd_peer_kernel(SwDesc d, StageBwdArgs a) {
  stage_bwd_launch<Z, true>(d, a);
}

struct BwdArgs {
  const float* fops;
  const int* iops;
  const float *th, *thu, *thv;     // (B, n_steps+1, nV) stored trajectory
  const float *tbh, *tbhu, *tbhv;  // its cotangents
  const float* ctrls;              // (B, n_cs, n_ctrl)
  float *xbh, *xbhu, *xbhv;        // (B, nV) out: initial-state cotangents
  float* cbar;                     // (B, n_cs, n_ctrl) out
  float *sh, *W, *A;  // scratch, (3, B, nV) each: s_half, W, a
  float* cpart;       // (B, n_cs, K, n_ctrl) scratch: items' shares
  float* tide;        // (n_steps, 2) scratch: tidal depth at t and t + dt/2
  int B, n_cs, spc, use_filter;
  double dt, t0;
};

template <class Z>
__global__ void __launch_bounds__(QMAX_THREADS, Z::BWD_MIN_BLOCKS)
    sw2d_blocked_rollout_bwd_kernel(SwDesc d, BwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  const Ops g = make_ops(d, a.fops, a.iops);
  q_setup_adjoint_ops(g, smem, a.use_filter);
  __syncthreads();
  const int Np = Z::np(g), ns = Z::nslots(g), nc = Z::nc(g);
  const int n_steps = a.n_cs * a.spc;
  const float dt = (float)a.dt;
  const size_t nV = (size_t)g.nV, fs = (size_t)a.B * nV;
  const size_t trow = (size_t)(n_steps + 1) * nV;
  const size_t n_part = (size_t)a.B * a.n_cs * d.K * nc;
  for (size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x; k < n_part;
       k += (size_t)gridDim.x * blockDim.x)
    a.cpart[k] = 0.0f;
  // the tidal depths of every stage time, as the forward rollout takes
  // them (q_stage_times, q_tide: computed once, a table)
  const bool tidal = g.has_tidal != 0;
  if (tidal)
    for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < 2 * n_steps;
         k += gridDim.x * blockDim.x) {
      float t1, t2;
      q_stage_times(a.t0, a.dt, k >> 1, t1, t2);
      a.tide[k] = q_tide(g, k & 1 ? t2 : t1);
    }
  grid.sync();
  auto tide = [&](int k) { return tidal ? __ldcg(a.tide + k) : 0.0f; };
  float* scr = q_item_slots(
      q_adj_ops_floats(g.Np, g.Ntr),
      max(q_item_floats(g.Np, g.Ntr),
          q_vjp_item_floats(g.Np, g.Ntr, g.Nfaces)), Z::P);
  const int ipb = blockDim.x / Z::P, n_items = a.B * d.K;
  const SendTo nosend = {nullptr, nullptr, 0};
  // the share of item (scenario b, element e) of control step j
  auto share = [&](const QLane& l, int j) {
    return a.cpart + (((size_t)l.sc * a.n_cs + j) * d.K + l.e) * nc;
  };

  for (int t = n_steps - 1; t >= -1; --t) {
    // ---- 1. lambda_{t+1}; W_t and s_half_t (t = -1: the initial-state
    // cotangent) ----
    for (int first = blockIdx.x * ipb; first < n_items;
         first += gridDim.x * ipb) {
      const QLane l = q_lane<Z>(first, n_items, a.B, d.K, 0, 0);
      const size_t off = (size_t)l.sc * nV;
      const size_t tb1 = l.sc * trow + (t + 1) * nV;
      // W_t at node v from lambda_{t+1} there, without the tbar of s_{t+1}
      auto finish = [&](int v, float l1, float l2, float l3) {
        l1 += a.tbh[tb1 + v]; l2 += a.tbhu[tb1 + v]; l3 += a.tbhv[tb1 + v];
        if (t < 0) {
          a.xbh[off + v] = l1; a.xbhu[off + v] = l2; a.xbhv[off + v] = l3;
          return;
        }
        if (g.has_sponge) {  // the stored s_{t+1} is the relaxed state
          const float fac = 1.0f / (1.0f + dt * __ldg(g.SPNG + v));
          if (g.has_bathy) l1 *= fac;
          l2 *= fac; l3 *= fac;
        }
        a.W[off + v] = l1; a.W[fs + off + v] = l2; a.W[2 * fs + off + v] = l3;
      };
      if (t < n_steps - 1) {  // lambda = W + a + VJP_R(s_{t+1})[dt/2 a]
        const int t1 = t + 1;
        const WFields asrc = {a.A + off, a.A + fs + off, a.A + 2 * fs + off};
        qvjp<Z>(g, smem, scr, l, at(a.th, a.thu, a.thv, l.sc * trow + t1 * nV),
                nullptr, asrc, 0.5f * dt, tide(2 * t1), a.use_filter,
                [&](int v, float b1, float b2, float b3) {
                  const size_t o = off + v;
                  finish(v, b1 + (a.W[o] + a.A[o]),
                         b2 + (a.W[fs + o] + a.A[fs + o]),
                         b3 + (a.W[2 * fs + o] + a.A[2 * fs + o]));
                },
                nullptr, share(l, t1 / a.spc), true);
      } else {
#pragma unroll
        for (int i = 0; i < ns; ++i) {
          const int n = l.p + Z::P * i;
          if (n < Np && l.active) finish(l.e * Np + n, 0.0f, 0.0f, 0.0f);
        }
      }
      if (t < 0) continue;
      // (the base read back from the trajectory at the update: held in
      // registers through the stage, it would push this loop into spills)
      const P3 st = at(a.th, a.thu, a.thv, l.sc * trow + t * nV);
      Own<Z> x, sh;
      load_own<Z>(g, l.e, l.p, st, x);
      qstage<Z, false>(g, smem, scr, l, st, x, x, st, sh,
                      atw(a.sh, a.sh + fs, a.sh + 2 * fs, off), nosend,
                      nullptr, 0.5f * dt, tide(2 * t), dt,
                      a.ctrls + ((size_t)l.sc * a.n_cs + t / a.spc) * nc,
                      a.use_filter, false, false);
    }
    grid.sync();
    if (t < 0) break;

    // ---- 2. a_t = VJP_R(s_half)[dt W_t] ----
    for (int first = blockIdx.x * ipb; first < n_items;
         first += gridDim.x * ipb) {
      const QLane l = q_lane<Z>(first, n_items, a.B, d.K, 0, 0);
      const size_t off = (size_t)l.sc * nV;
      const WFields wsrc = {a.W + off, a.W + fs + off, a.W + 2 * fs + off};
      float *A1 = a.A + off, *A2 = a.A + fs + off, *A3 = a.A + 2 * fs + off;
      qvjp<Z>(g, smem, scr, l, at(a.sh, a.sh + fs, a.sh + 2 * fs, off),
              nullptr, wsrc, dt, tide(2 * t + 1), a.use_filter,
              [&](int v, float b1, float b2, float b3) {
                A1[v] = b1; A2[v] = b2; A3[v] = b3;
              },
              nullptr, share(l, t / a.spc), true);
    }
    grid.sync();
  }

  // control cotangents: the items' shares (the last of them written before
  // the barrier that ended step 0), added in a fixed order in two rounds
  // around a grid barrier: each warp sums a chunk of an output's rows into
  // the W scratch (free now), then a warp an output sums the chunks
  const int wpb = (int)blockDim.x >> 5, n_warps = (int)gridDim.x * wpb;
  const int warp = (int)blockIdx.x * wpb + ((int)threadIdx.x >> 5);
  const int n_out = a.B * a.n_cs * nc, K = d.K;
  int n_ch = max(1, min(n_warps / n_out, K));
  n_ch = min(n_ch, (int)(3 * fs / n_out));
  const int rows = (K + n_ch - 1) / n_ch;
  for (int pr = warp; pr < n_out * n_ch; pr += n_warps) {
    const int o = pr % n_out, ch = pr / n_out, r0 = ch * rows;
    const float sum = q_warp_sum(
        a.cpart + (size_t)(o / nc) * K * nc + (o % nc) + (size_t)r0 * nc,
        max(0, min(rows, K - r0)), nc, true);
    if ((threadIdx.x & 31) == 0) a.W[(size_t)o * n_ch + ch] = sum;
  }
  grid.sync();
  for (int o = warp; o < n_out; o += n_warps) {
    const float sum = q_warp_sum(a.W + (size_t)o * n_ch, n_ch, 1, true);
    if ((threadIdx.x & 31) == 0) a.cbar[o] = sum;
  }
}

// ---------------------------------------------------------------------------
// C interface
// ---------------------------------------------------------------------------

typedef void (*StageKern)(SwDesc, StageArgs);
typedef void (*RdmaKern)(SwDesc, RdmaArgs);
typedef void (*StageBwdKern)(SwDesc, StageBwdArgs);
typedef void (*BwdKern)(SwDesc, BwdArgs);
typedef void (*FwdKern)(SwDesc, FwdArgs);

// The q kernels, as the launcher numbers them: the sharded stage (B7), the
// one-launch step (B9), the sharded stage's adjoint (B8), the blocked
// rollout's adjoint (B6), the blocked rollout (B5, and B4 with one step),
// the one-launch step's peer mode (B9 across ranks), the stage's and its
// adjoint's peer modes (B7 and B8 across ranks, the stage ring's exchange
// and its reverse folded in).
enum { Q_STAGE = 0, Q_STEP = 1, Q_STAGE_BWD = 2, Q_ROLLOUT_BWD = 3,
       Q_ROLLOUT = 4, Q_STEP_PEER = 5, Q_STAGE_PEER = 6,
       Q_STAGE_BWD_PEER = 7 };

// The instantiation of the q kernels for a set: N=3 with two controls
// (the MPC's), N=3 with others (a set built without injectors has one,
// which its rollouts never read), N=6 (the forward kernels' own),
// quadrilaterals at N=4 (every kernel's own), else the run-time sizes; -1
// past their room. The other quadrilateral orders take the run-time sizes
// in every q kernel.
static int q_kind(const SwDesc& d) {
  if (d.Np > QMAX_NP || d.Nfp > QMAX_NFP) return -1;
  if (d.Nfaces == QMAX_NFACES) return d.Np == 25 && d.Nfp == 5 ? 4 : 2;
  if (d.Nfaces != 3) return -1;
  if (d.Np == 10 && d.Nfp == 4) return d.n_ctrl == 2 ? 0 : 1;
  if (d.Np == 28 && d.Nfp == 7) return 3;
  return 2;
}

// (order6: null where the kernel takes the run-time sizes at N=6, as the
// adjoints do; quad4: null where the kernel takes no quadrilateral set at
// N=4 on those lanes)
template <class K>
static K q_pick(const SwDesc& d, K order3_ctrl, K order3, K any_order,
                K order6, K quad4) {
  switch (q_kind(d)) {
    case 0: return order3_ctrl;
    case 1: return order3;
    case 2: return any_order;
    case 3: return order6 != nullptr ? order6 : any_order;
    case 4: return quad4;
    default: return nullptr;
  }
}

static StageKern stage_kernel_of(const SwDesc& d) {
  return q_pick<StageKern>(d, sw2d_stage_kernel<QOrder3Ctrl>,
                           sw2d_stage_kernel<QOrder3>,
                           sw2d_stage_kernel<QAnyOrder>,
                           sw2d_stage_kernel<QOrder6>,
                           sw2d_stage_kernel<QOrder4Quad>);
}

static StageKern stage_peer_kernel_of(const SwDesc& d) {
  return q_pick<StageKern>(d, sw2d_stage_peer_kernel<QOrder3Ctrl>,
                           sw2d_stage_peer_kernel<QOrder3>,
                           sw2d_stage_peer_kernel<QAnyOrder>,
                           sw2d_stage_peer_kernel<QOrder6>,
                           sw2d_stage_peer_kernel<QOrder4Quad>);
}

static RdmaKern rdma_kernel_of(const SwDesc& d) {
  return q_pick<RdmaKern>(d, sw2d_step_rdma_kernel<QOrder3Ctrl>,
                          sw2d_step_rdma_kernel<QOrder3>,
                          sw2d_step_rdma_kernel<QAnyOrder>,
                          sw2d_step_rdma_kernel<QOrder6>,
                          sw2d_step_rdma_kernel<QOrder4Quad>);
}

static RdmaKern rdma_peer_kernel_of(const SwDesc& d) {
  return q_pick<RdmaKern>(d, sw2d_step_rdma_peer_kernel<QOrder3Ctrl>,
                          sw2d_step_rdma_peer_kernel<QOrder3>,
                          sw2d_step_rdma_peer_kernel<QAnyOrder>,
                          sw2d_step_rdma_peer_kernel<QOrder6>,
                          sw2d_step_rdma_peer_kernel<QOrder4Quad>);
}

static FwdKern rollout_kernel_of(const SwDesc& d) {
  return q_pick<FwdKern>(d, sw2d_blocked_rollout_kernel<QOrder3Ctrl>,
                         sw2d_blocked_rollout_kernel<QOrder3>,
                         sw2d_blocked_rollout_kernel<QAnyOrder>,
                         sw2d_blocked_rollout_kernel<QOrder6>,
                         sw2d_blocked_rollout_kernel<QOrder4Quad>);
}

// The N=1 set with two controls, which has a wide instantiation.
static bool q_order1_ctrl(const SwDesc& d) {
  return d.Nfaces == 3 && d.Np == 3 && d.Nfp == 2 && d.n_ctrl == 2;
}

// (lanes: 16 and 8 take the wide items at N=3 and at N=1; 8 also takes
// quadrilaterals at N=4, whose items are eight lanes wide at every batch)
static StageBwdKern stage_bwd_kernel_of(const SwDesc& d, int lanes) {
  if (lanes == 16)
    return q_pick<StageBwdKern>(d, sw2d_stage_bwd_kernel<QOrder3CtrlWide>,
                                sw2d_stage_bwd_kernel<QOrder3Wide>, nullptr,
                                nullptr, nullptr);
  if (lanes == 8)
    return q_order1_ctrl(d) ? sw2d_stage_bwd_kernel<QOrder1CtrlWide>
           : q_kind(d) == 4 ? sw2d_stage_bwd_kernel<QOrder4Quad>
                            : nullptr;
  return q_pick<StageBwdKern>(d, sw2d_stage_bwd_kernel<QOrder3Ctrl>,
                              sw2d_stage_bwd_kernel<QOrder3>,
                              sw2d_stage_bwd_kernel<QAnyOrder>, nullptr,
                              nullptr);
}

static StageBwdKern stage_bwd_peer_kernel_of(const SwDesc& d, int lanes) {
  if (lanes == 16)
    return q_pick<StageBwdKern>(d,
                                sw2d_stage_bwd_peer_kernel<QOrder3CtrlWide>,
                                sw2d_stage_bwd_peer_kernel<QOrder3Wide>,
                                nullptr, nullptr, nullptr);
  if (lanes == 8)
    return q_order1_ctrl(d) ? sw2d_stage_bwd_peer_kernel<QOrder1CtrlWide>
           : q_kind(d) == 4 ? sw2d_stage_bwd_peer_kernel<QOrder4Quad>
                            : nullptr;
  return q_pick<StageBwdKern>(d, sw2d_stage_bwd_peer_kernel<QOrder3Ctrl>,
                              sw2d_stage_bwd_peer_kernel<QOrder3>,
                              sw2d_stage_bwd_peer_kernel<QAnyOrder>, nullptr,
                              nullptr);
}

// (quadrilaterals at N=4: B5's items, so that the recompute of stage 1 is
// B5's bits, and qvjp's masked face mode)
static BwdKern rollout_bwd_kernel_of(const SwDesc& d) {
  return q_pick<BwdKern>(d, sw2d_blocked_rollout_bwd_kernel<QOrder3Ctrl>,
                         sw2d_blocked_rollout_bwd_kernel<QOrder3>,
                         sw2d_blocked_rollout_bwd_kernel<QAnyOrder>,
                         nullptr,
                         sw2d_blocked_rollout_bwd_kernel<QOrder4Quad>);
}

static const void* q_kernel(const SwDesc& d, int which, int lanes) {
  switch (which) {
    case Q_STAGE: return (const void*)stage_kernel_of(d);
    case Q_STEP: return (const void*)rdma_kernel_of(d);
    case Q_STAGE_BWD: return (const void*)stage_bwd_kernel_of(d, lanes);
    case Q_ROLLOUT_BWD: return (const void*)rollout_bwd_kernel_of(d);
    case Q_ROLLOUT: return (const void*)rollout_kernel_of(d);
    case Q_STEP_PEER: return (const void*)rdma_peer_kernel_of(d);
    case Q_STAGE_PEER: return (const void*)stage_peer_kernel_of(d);
    case Q_STAGE_BWD_PEER:
      return (const void*)stage_bwd_peer_kernel_of(d, lanes);
    default: return nullptr;
  }
}

// Lanes an item of kernel `which`: a face's nodes at N=3; QOrder6's at
// N=6 in the forward kernels; QOrder4Quad's on quadrilaterals at N=4 in
// every kernel (the one-launch step in both modes); one otherwise.
static bool q_stage_bwd(int which) {
  return which == Q_STAGE_BWD || which == Q_STAGE_BWD_PEER;
}

static int q_lanes(const SwDesc& d, int which) {
  const bool adjoint = q_stage_bwd(which) || which == Q_ROLLOUT_BWD;
  switch (q_kind(d)) {
    case 2: return 1;
    case 3: return adjoint ? 1 : QOrder6::P;
    case 4: return QOrder4Quad::P;
    default: return 4;
  }
}

// Shared memory of one block of `threads` threads of kernel `which`,
// `lanes` an item.
static size_t q_bytes(const SwDesc& d, int which, int threads, int lanes) {
  const int Ntr = d.Nfaces * d.Nfp, items = threads / lanes;
  int ops = q_ops_floats(d.Np, Ntr), item = q_item_floats(d.Np, Ntr);
  if (q_stage_bwd(which) || which == Q_ROLLOUT_BWD) {
    ops = q_adj_ops_floats(d.Np, Ntr);
    const int v = q_vjp_item_floats(d.Np, Ntr, d.Nfaces);
    // the stage adjoint's item also holds its control share
    item = q_stage_bwd(which) ? v + qround4(d.n_ctrl) : (v > item ? v : item);
  }
  return sizeof(float) * (ops + (size_t)items * item);
}

// Block size, grid and dynamic shared memory of q kernel `which` for S
// shards of B scenarios (S = 1 for the blocked rollout's adjoint), from
// the occupancy the device reports: the largest block of 256, 128, 64, 32
// threads that still gives every SM a block and whose shared memory fits
// the device's limit a block; the grid of an ordinary launch (the stage
// and its adjoint) covers every item, that of a cooperative one (the step,
// the blocked rollout and its adjoint) is what is co-resident (its blocks
// loop over the rest). The stage adjoint takes 16 lanes an element at N=3 (8 at N=1
// with two controls) where its narrow items would give the SMs less than a
// block of 256 threads each (both shapes of the sharded MPC's path: an
// element's chain, not the SMs' instruction rate, sets the time there).
// Sets the kernel's shared-memory limit. Run it once for a shape, before
// any launch of that shape (it is not a stream operation, and a launch
// does nothing else). fstride, istride: the packed buffers' row
// lengths. plan: threads, grid, bytes, lanes an item. Returns a CUDA error.
static int q_plan(const SwDesc& d, int S, int B, int which, int* plan,
                  long long fstride, long long istride) {
  cudaError_t e;
  int dev = 0, sms = 0, can = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int P = q_lanes(d, which);
  if (q_stage_bwd(which) &&
      (long long)S * B * d.K * P < (long long)sms * QMAX_THREADS) {
    if (P == 4) P = 16;
    else if (q_order1_ctrl(d)) P = 8;
  }
  // the lanes address their shard's rows with 32-bit offsets
  const void* kern = q_kernel(d, which, P);
  if (kern == nullptr || S * fstride > 0x7fffffffLL ||
      S * istride > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const bool coop = which == Q_STEP || which == Q_ROLLOUT_BWD ||
                    which == Q_ROLLOUT || which == Q_STEP_PEER;
  const long long lanes = (long long)S * B * d.K * P;
  int threads = 32, optin = 0;
  for (int t = QMAX_THREADS; t >= 32; t /= 2)
    if ((lanes + t - 1) / t >= sms) { threads = t; break; }
  // high orders: a smaller block, until its shared memory fits (N=6 takes
  // 128 threads on the H100 in the stage kernels)
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  while (threads > 32 && q_bytes(d, which, threads, P) > (size_t)optin)
    threads /= 2;
  const size_t bytes = q_bytes(d, which, threads, P);
  if (bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  const int pe = prepare(kern, bytes);
  if (pe != 0) return pe;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                    bytes);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  long long grid = (lanes + threads - 1) / threads;
  if (coop) {
    cudaDeviceGetAttribute(&can, cudaDevAttrCooperativeLaunch, dev);
    if (!can) return (int)cudaErrorNotSupported;
    if (grid > (long long)per_sm * sms) grid = (long long)per_sm * sms;
  }
  plan[0] = threads; plan[1] = (int)grid; plan[2] = (int)bytes; plan[3] = P;
  return 0;
}

// One launch of a planned shape (cooperative for the step and the
// rollout's adjoint: their blocks meet at grid barriers); nothing but the
// launch, so that it can be captured into a CUDA graph.
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

// n_steps SSP-RK2 steps of B scenarios in one cooperative launch (one
// step and one control row: the step). ctrls: (B, n_cs, n_ctrl) or null,
// step t taking row t / spc. With th/thu/thv (B, n_steps+1, nV) the
// step-start trajectory is stored and oh/ohu/ohv are not touched; without,
// the final state goes to oh/ohu/ohv. s1: 3*B*nV floats of scratch; plan:
// sw2d_shard_plan's for (1, B, 4).
int sw2d_blocked_rollout(const SwDesc* d, const float* fops, const int* iops,
                         const float* h, const float* hu, const float* hv,
                         const float* ctrls, float* oh, float* ohu,
                         float* ohv, float* th, float* thu, float* thv,
                         float* s1, int B, int n_steps, int n_cs, int spc,
                         double dt, double t0, int use_filter,
                         const int* plan, void* stream) {
  const size_t n = (size_t)B * d->K * d->Np;
  FwdArgs a = {fops, iops, h, hu, hv, ctrls, oh, ohu, ohv, s1, s1 + n,
               s1 + 2 * n, th, thu, thv, B, n_steps, n_cs, spc, use_filter,
               dt, t0};
  return q_launch(rollout_kernel_of(*d), *d, a, plan, true, stream);
}

// The reverse sweep of a blocked rollout of B scenarios: from the stored
// trajectory (B, n_steps+1, nV) and its cotangents to the cotangents of
// the initial state and of the controls (B, n_cs, n_ctrl). work: 9*B*nV +
// B*n_cs*K*n_ctrl + 2*n_cs*spc floats of scratch; plan: sw2d_shard_plan's
// for (1, B, 3).
int sw2d_blocked_rollout_bwd(const SwDesc* d, const float* fops,
                             const int* iops, const float* th,
                             const float* thu, const float* thv,
                             const float* tbh, const float* tbhu,
                             const float* tbhv, const float* ctrls,
                             float* xbh, float* xbhu, float* xbhv,
                             float* cbar, float* work, int B, int n_cs,
                             int spc, double dt, double t0, int use_filter,
                             const int* plan, void* stream) {
  const size_t n3 = (size_t)3 * B * d->K * d->Np;
  BwdArgs a;
  a.fops = fops; a.iops = iops;
  a.th = th; a.thu = thu; a.thv = thv;
  a.tbh = tbh; a.tbhu = tbhu; a.tbhv = tbhv;
  a.ctrls = ctrls;
  a.xbh = xbh; a.xbhu = xbhu; a.xbhv = xbhv; a.cbar = cbar;
  a.sh = work; a.W = work + n3; a.A = work + 2 * n3; a.cpart = work + 3 * n3;
  a.tide = a.cpart + (size_t)B * n_cs * d->K * d->n_ctrl;
  a.B = B; a.n_cs = n_cs; a.spc = spc; a.use_filter = use_filter;
  a.dt = dt; a.t0 = t0;
  return q_launch(rollout_bwd_kernel_of(*d), *d, a, plan, true, stream);
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

// The same step in its peer mode: this rank's one shard (S = 1) of a set
// spread over the ranks of a ring (parallel/peer.py), the stage-1 halo
// stored into the peers' stage-2 slots and stage 2's send slots into their
// step-boundary slots through the ring's table tab (peer_flags.cuh). rb:
// this rank's step-boundary slots, rb2 its stage-2 slots (both in its
// region); sb: this rank's send buffer as well; plan: sw2d_shard_plan's
// for (1, B, 5).
int sw2d_step_rdma_peer(const SwDesc* d, const float* fops, const int* iops,
                        long long fstride, long long istride, int B,
                        const float* h, const float* hu, const float* hv,
                        const float* rb, const float* ctrl,
                        const long long* tab, float* s1, float* rb2,
                        float* oh, float* ohu, float* ohv, float* sb,
                        float dt, float t1, float t2, int use_filter,
                        int sponge, const int* plan, void* stream) {
  const size_t n = (size_t)B * d->K * d->Np;
  RdmaArgs a = {fops, iops, fstride, istride, 1, B, use_filter, sponge,
                h, hu, hv, rb, ctrl, nullptr, s1, s1 + n, s1 + 2 * n, rb2,
                oh, ohu, ohv, sb, dt, t1, t2, tab};
  return q_launch(rdma_peer_kernel_of(*d), *d, a, plan, true, stream);
}

// Loads the peer mode's instance for a set into the current context now.
// CUDA's lazy loading would load it at its first launch, and a load waits
// for the context's running kernels: in a ring whose ranks share a process
// a rank's first launch would then wait for a peer's step that waits at a
// flag for it (a trap after the wait's bound). Returns a CUDA error.
int sw2d_step_rdma_peer_load(const SwDesc* d) {
  const RdmaKern k = rdma_peer_kernel_of(*d);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  return (int)cudaFuncGetAttributes(&attr, k);
}

// The adjoint of sw2d_stage: cotangents of (out, sb) to those of (base,
// cur, rb) and, with octl, the control cotangent per shard and scenario.
// With octl, cpart: S*B*(ceil(K/ipb) + 1)*n_ctrl floats of scratch (ipb:
// the plan's threads over its lanes an item) and done: S*B counters that
// are 0 (the launch leaves them at 0); plan: sw2d_shard_plan's for
// (S, B, 2).
int sw2d_stage_bwd(const SwDesc* d, const float* fops, const int* iops,
                   long long fstride, long long istride, int S, int B,
                   const float* ch, const float* chu, const float* chv,
                   const float* rb, const float* lh, const float* lhu,
                   const float* lhv, const float* lsb, float* obh,
                   float* obhu, float* obhv, float* och, float* ochu,
                   float* ochv, float* orb, float* octl, float* cpart,
                   unsigned* done, float c_dt, float t, int use_filter,
                   int sponge, const int* plan, void* stream) {
  StageBwdArgs a = {fops, iops, fstride, istride, S, B, use_filter, sponge,
                    ch, chu, chv, rb, lh, lhu, lhv, lsb, obh, obhu, obhv,
                    och, ochu, ochv, orb, octl, cpart, done, c_dt, t};
  return q_launch(stage_bwd_kernel_of(*d, plan[3]), *d, a, plan, false,
                  stream);
}

// The stage's peer mode: this rank's one shard (S = 1) of a set spread
// over the ranks of a stage ring (parallel/peer.py, StageRing; its table
// tab, peer_flags.cuh), the ring's exchange folded into the launch (see
// sw2d_stage_peer_kernel): its receive buffer rb, with e_in (not 0) its
// forward slots of epoch e_in's parity, copied into rbo, its send buffer
// sb stored into the receiving ranks' slots as epoch e_out; with e_skip
// (not 0) FGO released past it first (sr_fold_start). plan:
// sw2d_shard_plan's for (1, B, 6).
int sw2d_stage_peer(const SwDesc* d, const float* fops, const int* iops,
                    long long fstride, long long istride, int B,
                    const float* bh, const float* bhu, const float* bhv,
                    const float* ch, const float* chu, const float* chv,
                    const float* rb, const float* ctrl, float* oh,
                    float* ohu, float* ohv, float* sb, float* rbo,
                    const long long* tab, unsigned long long e_in,
                    unsigned long long e_out, unsigned long long e_skip,
                    float c_dt, float t, int use_filter, int sponge,
                    const int* plan, void* stream) {
  StageArgs a = {fops, iops, fstride, istride, 1, B, use_filter, sponge,
                 bh, bhu, bhv, ch, chu, chv, rb, ctrl, oh, ohu, ohv, sb,
                 c_dt, t, tab, rbo, (flag_t)e_in, (flag_t)e_out,
                 (flag_t)e_skip};
  return q_launch(stage_peer_kernel_of(*d), *d, a, plan, false, stream);
}

// The stage adjoint's peer mode (see sw2d_stage_bwd_peer_kernel): lsb,
// with e_in (not 0) this rank's reverse slots of epoch e_in's parity, plus
// lsb2 where not null (autograd's part of the send buffer's cotangent),
// orb also stored into the reverse slots of the ranks its chunks came from
// as epoch e_out (e_out = 0: not); with e_skip (not 0) RGO released past
// it first (sr_fold_start); the rest as sw2d_stage_bwd at S = 1. plan:
// sw2d_shard_plan's for (1, B, 7).
int sw2d_stage_bwd_peer(const SwDesc* d, const float* fops, const int* iops,
                        long long fstride, long long istride, int B,
                        const float* ch, const float* chu, const float* chv,
                        const float* rb, const float* lh, const float* lhu,
                        const float* lhv, const float* lsb,
                        const float* lsb2, float* obh, float* obhu,
                        float* obhv, float* och, float* ochu, float* ochv,
                        float* orb, float* octl, float* cpart,
                        unsigned* done, const long long* tab,
                        unsigned long long e_in, unsigned long long e_out,
                        unsigned long long e_skip, float c_dt, float t,
                        int use_filter, int sponge, const int* plan,
                        void* stream) {
  StageBwdArgs a = {fops, iops, fstride, istride, 1, B, use_filter, sponge,
                    ch, chu, chv, rb, lh, lhu, lhv, lsb, obh, obhu, obhv,
                    och, ochu, ochv, orb, octl, cpart, done, c_dt, t, tab,
                    (flag_t)e_in, (flag_t)e_out, (flag_t)e_skip, lsb2};
  return q_launch(stage_bwd_peer_kernel_of(*d, plan[3]), *d, a, plan, false,
                  stream);
}

// Loads the stage's and its adjoint's peer-mode instances for a set (the
// adjoint's on `lanes` lanes an element, its plan's) into the current
// context now, as sw2d_step_rdma_peer_load does the step's. Returns a
// CUDA error.
int sw2d_stage_peer_load(const SwDesc* d, int lanes) {
  const StageKern k = stage_peer_kernel_of(*d);
  const StageBwdKern kb = stage_bwd_peer_kernel_of(*d, lanes);
  if (k == nullptr || kb == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, k);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kb);
  return (int)e;
}

}  // extern "C"
