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
// (B, K*Np) per field.
//
// Work unit: (a chunk of E elements) x (a tile of Bs <= 4 scenarios), one
// thread per (element, scenario), the lanes of a block numbered element by
// element with the scenario innermost; a ragged last chunk or tile is
// masked. A thread runs its element's whole RHS as a scalar program: the
// nodal accumulator (N=3: 40 floats) lives in registers, and so does the
// nodal array that a product reads against run-time operator rows (the
// state in the forward volume term, the mass-inverse transposed cotangent
// in the adjoint's surface term); what else a thread keeps sits in its own
// slots in shared memory (thread innermost, a constant stride: no bank
// conflicts, offsets known at compile time). Operator values are read from
// shared memory at an address that is the same for the whole warp (a
// broadcast), so each one feeds an FMA a field. FMAs per shared-memory load
// instruction, as the loops below issue them at N=3 (float2 loads need an
// even Np):
//   cubature point  <- V row . nodal values (registers)         4
//   nodal value     <- Dr^T, Ds^T columns . weighted fluxes      4
//   nodal value     -= GI row^T . Gauss flux (float2 loads)      8
//   nodal value     <- mass inverse row, then filter row         4
//   Gauss trace     <- GI row . nodal values                     4
// and in the adjoint their transposes: filter and mass inverse 4; the
// Gauss values of the cotangent (in registers) 4; the lifts of the '-'
// cotangents 8 and of the gathered '+' ones 4.4 (a point's four values
// from its slots, five float2 loads, 40 FMAs); the volume term in tiles of
// four cubature points, a node's eight slot values (state and cotangent)
// and three float4s of V, Dr^T and Ds^T feeding 48 FMAs (4.4), then one
// float4 of V per 16 FMAs of the transposed interpolation. The reference
// operators sit in shared memory once a launch (V, Dr^T and Ds^T in tiles of
// four cubature points); the chunk's geometric factors (W rx .. W sy a
// cubature point; normal, weight, wall flag, '+' index and reader a Gauss
// point; the mass inverse) are copied to shared memory once a unit,
// element innermost, and serve all the unit's scenarios. When the grid
// holds every unit (both disks of the MPC), a block keeps one unit for the
// whole launch and reads the geometry once.
//
// Gauss traces. The '-' values of every Gauss point (four fields) are
// written once to a (nT, B) float4 buffer by the thread that owns the
// element, right after it writes the state they belong to; after the grid
// barrier that ends the stage, a Gauss point reads its own '-' value and
// its '+' value (mapP) from there, a face's loads in flight together. Both
// sides of a face see the same bits, as the adjoint's tie rules need, and
// no point re-interpolates its neighbour. The stage that computes a state
// writes its traces too, so a stage depends on the previous stage of the
// whole grid only: one barrier a stage, plus one before the first stage for
// the initial state's traces. The face maximum over a face's NG points is
// taken inside one thread.
//
// Adjoint (derived by hand; tensor-code twin and its test against autograd:
// ops/sw2d_curved_blocked.py). The own '-' cotangent of a Gauss point is
// lifted into the element's nodal cotangent at once; the '+' cotangent
// belongs to the neighbour, so it goes to a (nT, B) float4 buffer and is
// gathered after a grid barrier through the point's one reader (the inverse
// CSR map of mapP, cached a chunk). Three phases a step, a grid barrier
// after each:
//   1. finish the previous step's second product (gather T2), form W,
//      recompute s1 and its traces;
//   2. first half of the product at s1 (T1, volume part into A); the traces
//      of the next step's state s_{t-1};
//   3. gather T1 into A; first half of the product at s_t (T2, into Bv).
// Where the lanes are too few to fill the card (the small disk), two
// threads share each (element, scenario) in phases 2 and 3: they take
// alternate tiles of cubature points and split the Gauss points of the
// surface's second pass, and the second adds the first's sum to its own in
// a fixed order. The launcher takes two where the blocks of twice the
// threads are all resident at once, by the occupancy that the device
// reports for the kernel (sw2d_curved_bwd_parts). No float
// atomics: a rerun gives the same bits. Control cotangents are summed per
// (scenario, element) and reduced over the elements in a fixed order at the
// end. A cotangent trajectory may be a null pointer (nothing used that
// field): read as zero.
//
// Bound on the card: float32 operations (8 nV floats of traffic per step
// against some two thousand operations per node). The first design (one
// thread a (field, node) pair, six block barriers a stage, units of one
// scenario) issued about one shared-memory load per FMA, reloaded the
// geometry for every scenario and waited at the loads; this one issues four
// FMAs or more per shared-memory load in every product (the table above)
// and reads the geometry once a unit. What bounds it now: the parallelism
// the meshes give (32448 lanes at K=1014, B=32; 13824 at K=54, B=256), at
// most eight warps an SM at the registers the nodal arrays need (over 200
// a thread at N=3), so each thread's dependent
// chains (the pointwise formulas' divisions and roots, the per-point Gauss
// sums, the trace loads) show; and the instruction caches, which is why
// every loop over nodes, cubature or Gauss points runs at run time (a few
// unrolled twice) and only the loops inside one row are unrolled fully. ptxas spills nothing. PERF.md has
// the numbers. The kernels are instantiated for the sizes of N=3 (Sizes:
// the row loops unroll, slot offsets are immediates) beside one
// instantiation that reads the sizes at run time, for every other order up
// to MAX_NP nodes (its register arrays live in local memory).
//
// Plain C interface (extern "C" at the end), loaded with ctypes. Launches go
// to the stream that is passed in; nothing here synchronises or allocates.

#include "sw2d_common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

extern __shared__ __align__(16) float smem[];

#define NF 4  // h, hu, hv, hN
// Largest block the forward kernels are compiled for (THREADS of the
// wrappers; the adjoint's is up to twice that, two threads a lane), and the
// blocks per SM the register budget is cut to: up to 255 registers a
// thread, which the nodal arrays of N=3 need.
#define MAX_THREADS 128
#define BLOCKS_PER_SM 2
// Room of the run-time-size instantiation's arrays: nodes (N=6) and Gauss
// points a face.
#define MAX_NP 28
#define MAX_NG 14
// Thread stride of the threads' scratch slots in shared memory: a constant,
// so that a slot's offset is one (an immediate where the sizes are known);
// a block of more threads keeps its next threads' slots behind.
#define SLOT_STRIDE 128

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
// of the instantiation where the template gives them (loops unroll, the
// nodal arrays are registers), else read from the operator set.
template <int NP, int NCUB, int NGP>
struct Sizes {
  static constexpr int CAP = NP ? NP : MAX_NP;     // room of a nodal array
  static constexpr int GCAP = NGP ? NGP : MAX_NG;  // room of a face array
  // a row of Np values in shared memory read two at a time (float2): where
  // Np is even and known, each row starts 8-byte aligned
  static constexpr bool PAIRS = NP > 0 && NP % 2 == 0;
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

__device__ __forceinline__ P4 readonly(const W4& w) {
  P4 r;
  #pragma unroll
  for (int i = 0; i < NF; ++i) r.f[i] = w.f[i];
  return r;
}

// ---------------------------------------------------------------------------
// Shared memory: the reference operators, then the unit's chunk
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t al4(size_t n) { return (n + 3) & ~(size_t)3; }

// Tiles of four cubature points: the cubature operators' table holds, for
// tile t and node n, the float4s V, Dr^T and Ds^T of the tile's points
// (zeros past Ncub).
__host__ __device__ inline int cub_tiles(int Ncub) { return (Ncub + 3) / 4; }

__host__ __device__ inline size_t cop_floats(const COps& o) {
  return (size_t)12 * cub_tiles(o.Ncub) * o.Np + al4((size_t)o.NT * o.Np)
         + 2 * al4((size_t)o.Np * o.Np);
}

// Per element of a chunk: four weights a cubature point; four values, the
// '+' index and the index of the point that reads it a Gauss point; the
// mass inverse (or 1/J).
__host__ __device__ inline size_t chunk_floats(const COps& o, int E) {
  return (size_t)4 * o.Ncub * E + (size_t)4 * o.NT * E
         + 2 * al4((size_t)o.NT * E)
         + al4((size_t)(o.affine ? 1 : o.Np * o.Np) * E);
}

// Per thread: two nodal arrays of four fields (the products' outputs); in
// the adjoint, while a face is worked on, its '-' and '+' values and the
// speed at each of its Gauss points, and beside them the mass-inverse
// transposed cotangent from slot mb_slot on.
__host__ __device__ inline int mb_slot(int Np, int NG) {
  return 4 * Np > 9 * NG ? 4 * Np : 9 * NG;
}

__host__ __device__ inline size_t thread_floats(const COps& o) {
  const size_t a = (size_t)8 * o.Np, b = mb_slot(o.Np, o.NG) + 4 * o.Np;
  return al4(a > b ? a : b);
}

// parts > 1 (the adjoint's two threads an (element, scenario)): one
// nodal array a lane to add the two threads' sums.
__host__ __device__ inline size_t csmem_floats(const COps& o, int E,
                                               int threads, int parts = 1) {
  const size_t groups = (threads + SLOT_STRIDE - 1) / SLOT_STRIDE;
  return cop_floats(o) + chunk_floats(o, E)
         + thread_floats(o) * groups * SLOT_STRIDE
         + (parts > 1 ? (size_t)4 * o.Np * SLOT_STRIDE : 0);
}

// What a block keeps in shared memory: the reference operators (the
// cubature ones in tiles of four points, cub_tiles), then its chunk's data,
// element innermost: entry r of local element e at r * E + e, then each
// thread's own scratch, thread innermost: float r of this thread at
// slot[r * SLOT_STRIDE] (no bank conflicts, and no thread's slots overlap
// another's).
struct CBlock {
  const float4* ct;  // [(t Np + n) 3 + {0, 1, 2}]: V, Dr^T, Ds^T of tile t
  const float *GI, *filt, *VVT;
  float4* geo;  // [c]: W rx, W ry, W sx, W sy
  float4* gpt;  // [j]: nx, ny, W, wall
  int* mapP;    // [j]: the '+' Gauss point, a global index
  int* src;     // [j]: the one Gauss point that reads it as its '+' value,
                //      or -1: look the readers up in the inverse map
  float* minv;  // [n Np + m]: the mass inverse ('general') | [0]: 1/J
  float* slot;
  float* xch;   // [r * SLOT_STRIDE + l]: lane l's exchange slots
  int E;
};

// Copy the reference operators to shared memory and carve the chunk's part
// behind them.
__device__ CBlock setup_cblock(const COps& o, int E) {
  const int Np = o.Np, Ncub = o.Ncub, NT = o.NT, np2 = Np * Np;
  float* p = smem;
  float* sR = p; p += (size_t)12 * cub_tiles(Ncub) * Np;
  float* sG = p; p += al4((size_t)NT * Np);
  float* sF = p; p += al4((size_t)np2);
  float* sM = p; p += al4((size_t)np2);
  for (int i = threadIdx.x; i < 4 * cub_tiles(Ncub) * Np;
       i += blockDim.x) {
    const int c = i / Np, n = i - c * Np;
    float* r = sR + ((c >> 2) * Np + n) * 12 + (c & 3);
    const bool in = c < Ncub;
    r[0] = in ? o.V[i] : 0.0f;
    r[4] = in ? o.DrT[n * Ncub + c] : 0.0f;
    r[8] = in ? o.DsT[n * Ncub + c] : 0.0f;
  }
  for (int i = threadIdx.x; i < NT * Np; i += blockDim.x) sG[i] = o.GI[i];
  for (int i = threadIdx.x; i < np2; i += blockDim.x) {
    sF[i] = o.filt[i]; sM[i] = o.VVT[i];
  }
  CBlock ch;
  ch.ct = reinterpret_cast<const float4*>(sR); ch.GI = sG; ch.filt = sF; ch.VVT = sM;
  ch.E = E;
  ch.geo = reinterpret_cast<float4*>(p); p += (size_t)4 * Ncub * E;
  ch.gpt = reinterpret_cast<float4*>(p); p += (size_t)4 * NT * E;
  ch.mapP = reinterpret_cast<int*>(p); p += al4((size_t)NT * E);
  ch.src = reinterpret_cast<int*>(p); p += al4((size_t)NT * E);
  ch.minv = p; p += al4((size_t)(o.affine ? 1 : np2) * E);
  const int groups = (blockDim.x + SLOT_STRIDE - 1) / SLOT_STRIDE;
  const size_t T = thread_floats(o);
  ch.slot = p + (threadIdx.x / SLOT_STRIDE) * SLOT_STRIDE * T
            + threadIdx.x % SLOT_STRIDE;
  ch.xch = p + T * groups * SLOT_STRIDE;
  __syncthreads();
  return ch;
}

// Copy elements e0 .. e0+ne of the mesh into the chunk's part of shared
// memory (every thread of the block calls it).
__device__ void load_chunk(const COps& o, const CBlock& ch, int e0, int ne) {
  const int Np = o.Np, Ncub = o.Ncub, NT = o.NT, E = ch.E;
  const int tid = threadIdx.x, nth = blockDim.x;
  __syncthreads();  // the previous chunk may still be read
  for (int i = tid; i < Ncub * E; i += nth) {
    const int c = i / E, e = i - c * E;
    float4 w = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (e < ne) {
      const size_t q = (size_t)(e0 + e) * Ncub + c;
      w = make_float4(o.WRX[q], o.WRY[q], o.WSX[q], o.WSY[q]);
    }
    ch.geo[i] = w;
  }
  for (int i = tid; i < NT * E; i += nth) {
    const int j = i / E, e = i - j * E;
    float4 w = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    int mp = 0, src = -1;
    if (e < ne) {
      const int q = (e0 + e) * NT + j;
      w = make_float4(o.GNX[q], o.GNY[q], o.GW[q], o.WALL[q]);
      mp = o.mapP[q];
      if (o.invP_ptr[q + 1] - o.invP_ptr[q] == 1)
        src = o.invP_idx[o.invP_ptr[q]];
    }
    ch.gpt[i] = w;
    ch.mapP[i] = mp;
    ch.src[i] = src;
  }
  if (o.affine) {
    for (int e = tid; e < E; e += nth)
      ch.minv[e] = e < ne ? o.INVJ[e0 + e] : 0.0f;
  } else {
    const int np2 = Np * Np;
    for (int i = tid; i < np2 * E; i += nth) {
      const int r = i / E, e = i - r * E;
      ch.minv[i] = e < ne ? o.MINV[(size_t)(e0 + e) * np2 + r] : 0.0f;
    }
  }
  __syncthreads();
}

// The work units of a launch: unit u is chunk u % n_chunks of scenario tile
// u / n_chunks; lanes of a block: element (lane / Bs), scenario (lane % Bs).
struct Units {
  int E, Bs, B, K, n_chunks, n_units;
  __device__ Units(int E_, int Bs_, int B_, int K_)
      : E(E_), Bs(Bs_), B(B_), K(K_) {
    n_chunks = (K + E - 1) / E;
    n_units = n_chunks * ((B + Bs - 1) / Bs);
  }
};

// Runs body(k, b, e) for every (element, scenario) of the unit that exists,
// e the element's place in the chunk.
// With G threads a lane (the adjoint's parts): body(k, b, e, l, part), l the
// lane's place in the unit; a thread that runs several parts of a lane (a
// block smaller than the unit's lanes x G) runs them in the order 0 .. G-1.
template <class Body>
__device__ __forceinline__ void for_lane_parts(const Units& U, int u, int G,
                                               Body body) {
  const int c = u % U.n_chunks, e0 = c * U.E, b0 = (u / U.n_chunks) * U.Bs;
  for (int t = threadIdx.x; t < U.E * U.Bs * G; t += blockDim.x) {
    const int l = t / G, part = t - l * G, e = l / U.Bs;
    const int b = b0 + (l - e * U.Bs);
    if (e0 + e < U.K && b < U.B) body(e0 + e, b, e, l, part);
  }
}

template <class Body>
__device__ __forceinline__ void for_lanes(const Units& U, int u, Body body) {
  for_lane_parts(U, u, 1, [&](int k, int b, int e, int, int) { body(k, b, e); });
}

// Barrier of the two threads of a lane (adjacent in their warp).
__device__ __forceinline__ void pair_sync() {
  __syncwarp(3u << ((threadIdx.x & 31) & ~1u));
}

// Loads the chunk of unit u unless it is already there.
__device__ __forceinline__ void use_chunk(const COps& o, const CBlock& ch,
                                          const Units& U, int u, int& have) {
  const int c = u % U.n_chunks;
  if (c != have) {
    const int e0 = c * U.E;
    load_chunk(o, ch, e0, min(U.E, U.K - e0));
    have = c;
  }
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

// Cotangent of q from the cotangents of F(q) and G(q). (The adjoint's
// pointwise formulas divide with the fast reciprocal, 2 ulp: they decide no
// tie, and their inputs are rounded further than that already.)
__device__ __forceinline__ void fluxes4_vjp(float g, const float* q,
                                            const float* Fb, const float* Gb,
                                            float* qb) {
  const float inv = __fdividef(1.0f, q[0]);
  const float u = q[1] * inv, v = q[2] * inv, c = q[3] * inv;
  const float w23 = Fb[2] + Gb[1], t4 = u * Fb[3] + v * Gb[3];
  qb[1] = Fb[0] + 2.0f * u * Fb[1] + v * w23 + c * Fb[3];
  qb[2] = Gb[0] + 2.0f * v * Gb[2] + u * w23 + c * Gb[3];
  qb[0] = (g * q[0] - u * u) * Fb[1] + (g * q[0] - v * v) * Gb[2]
          - u * v * w23 - c * t4;
  qb[3] = t4;
}

__device__ __forceinline__ float speed4(float g, const float* q) {
  const float inv = 1.0f / q[0];
  return safe_norm(q[1] * inv, q[2] * inv) + sqrtf(g * q[0]);
}

// Adds the cotangent of |(u, v)| + sqrt(g h) to qb[0..2] (fast reciprocal
// and reciprocal square root, as in fluxes4_vjp; the speeds themselves,
// which decide the ties, come from speed4).
__device__ __forceinline__ void speed4_vjp(float g, const float* q,
                                           float sbar, float* qb) {
  const float inv = __fdividef(1.0f, q[0]), u = q[1] * inv, v = q[2] * inv;
  const float r2 = u * u + v * v, rn = r2 > 0.0f ? rsqrtf(r2) : 0.0f;
  const float gh = g * inv;  // g / h: sqrt(g / h) = gh * rsqrt(gh)
  qb[0] += sbar * (0.5f * gh * rsqrtf(gh) - r2 * rn * inv);
  if (r2 > 0.0f) {
    const float t = sbar * inv * rn;
    qb[1] += t * u;
    qb[2] += t * v;
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
// Per (element, scenario): the building blocks of both kernels
// ---------------------------------------------------------------------------
// Loops over nodes, cubature points and Gauss points run at run time (a few
// unrolled twice, for two independent chains); only the loops inside one
// row, point or node (over the Np nodes and the four fields) are unrolled
// fully, so that the nodal arrays they index stay in registers while the
// code stays small: with one or two warps a scheduler, a kernel whose code
// does not fit the instruction caches waits on its own instruction
// fetches. A product whose rows run at run time writes its result to the
// thread's slots in shared memory.

// The four nodal fields of element k from one scenario's state.
template <class Z>
__device__ __forceinline__ void load_nodal(const COps& o, const P4& in, int k,
                                           float (&S)[NF][Z::CAP]) {
  const int Np = Z::Np(o), v0 = k * Np;
  #pragma unroll
  for (int n = 0; n < Np; ++n) {
    #pragma unroll
    for (int f = 0; f < NF; ++f) S[f][n] = in.f[f][v0 + n];
  }
}

// The four nodal fields from this thread's slots r0 .. r0 + 4 Np.
template <class Z>
__device__ __forceinline__ void load_slots(const COps& o, const CBlock& ch,
                                           int r0, float (&S)[NF][Z::CAP]) {
  const int Np = Z::Np(o);
  #pragma unroll
  for (int n = 0; n < Np; ++n) {
    #pragma unroll
    for (int f = 0; f < NF; ++f) S[f][n] = ch.slot[(r0 + f * Np + n) * SLOT_STRIDE];
  }
}

// Interpolates element k's nodal fields Y to its Gauss points and stores
// them as its '-' traces, scenario b of the trace buffer TM (nT, B).
template <class Z>
__device__ __forceinline__ void store_traces(const COps& o, const CBlock& ch,
                                             int k, int b, int B,
                                             const float (&Y)[NF][Z::CAP],
                                             float4* TM) {
  const int Np = Z::Np(o), NT = 3 * Z::NG(o);
  #pragma unroll 1
  for (int j = 0; j < NT; ++j) {
    const float* gi = ch.GI + j * Np;
    float m[NF] = {0.0f, 0.0f, 0.0f, 0.0f};
    #pragma unroll
    for (int n = 0; n < Np; ++n) {
      const float w = gi[n];
      #pragma unroll
      for (int f = 0; f < NF; ++f) m[f] += w * Y[f][n];
    }
    TM[(size_t)(k * NT + j) * B + b] = make_float4(m[0], m[1], m[2], m[3]);
  }
}

// ... of a stored state; copy: where to store the element's part of it as
// well, or null pointers.
template <class Z>
__device__ void traces_of(const COps& o, const CBlock& ch, const P4& in,
                          int k, int b, int B, float4* TM, const W4& copy) {
  float S[NF][Z::CAP];
  load_nodal<Z>(o, in, k, S);
  if (copy.f[0] != nullptr) {
    const int Np = Z::Np(o);
    #pragma unroll
    for (int n = 0; n < Np; ++n) {
      #pragma unroll
      for (int f = 0; f < NF; ++f) copy.f[f][k * Np + n] = S[f][n];
    }
  }
  store_traces<Z>(o, ch, k, b, B, S, TM);
}

// Cubature point c's column of the tiled operator table: V[c][n] at
// [12 n], Dr^T[n][c] at [12 n + 4], Ds^T[n][c] at [12 n + 8].
__device__ __forceinline__ const float* cub_col(const CBlock& ch, int Np,
                                                int c) {
  return reinterpret_cast<const float*>(ch.ct) + (c >> 2) * 12 * Np + (c & 3);
}

// Four values in this thread's slots 4 r .. 4 r + 3.
__device__ __forceinline__ void put4(const CBlock& ch, int r, float4 v) {
  float* p = ch.slot + 4 * r * SLOT_STRIDE;
  p[0] = v.x; p[SLOT_STRIDE] = v.y; p[2 * SLOT_STRIDE] = v.z;
  p[3 * SLOT_STRIDE] = v.w;
}

__device__ __forceinline__ void get4(const CBlock& ch, int r, float* q) {
  const float* p = ch.slot + 4 * r * SLOT_STRIDE;
  q[0] = p[0]; q[1] = p[SLOT_STRIDE]; q[2] = p[2 * SLOT_STRIDE];
  q[3] = p[3 * SLOT_STRIDE];
}

// Reads the '-' and '+' values of face fc's NG Gauss points from the trace
// buffer TM, the loads of four points in flight together, and leaves them in
// this thread's slots as four-value groups 2 jj ('-') and 2 jj + 1 ('+', the
// wall reflection applied).
template <class Z>
__device__ __forceinline__ void stage_face(const COps& o, const CBlock& ch,
                                           int e, int k, int fc, int b, int B,
                                           const float4* TM) {
  const int NG = Z::NG(o), NT = 3 * NG, E = ch.E;
  #pragma unroll 1
  for (int j0 = 0; j0 < NG; j0 += 4) {
    #pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int jj = j0 + q;
      if (jj < NG) {
        const int j = fc * NG + jj;
        const float4 gp = ch.gpt[j * E + e];
        const float4 m = TM[(size_t)(k * NT + j) * B + b];
        float4 p = TM[(size_t)ch.mapP[j * E + e] * B + b];
        if (gp.w != 0.0f) {  // reflect the normal momentum
          const float un2 = 2.0f * (m.y * gp.x + m.z * gp.y);
          p.y = m.y - un2 * gp.x;
          p.z = m.z - un2 * gp.y;
        }
        put4(ch, 2 * jj, m);
        put4(ch, 2 * jj + 1, p);
      }
    }
  }
}

// The four fields of a nodal array X (registers) at a Gauss point:
// a[f] = gi . X[f], gi the point's row of GI; each row value a broadcast
// that feeds four FMAs.
template <class Z>
__device__ __forceinline__ void gauss_value(const COps& o, const float* gi,
                                            const float (&X)[NF][Z::CAP],
                                            float* a) {
  const int Np = Z::Np(o);
  #pragma unroll
  for (int f = 0; f < NF; ++f) a[f] = 0.0f;
  #pragma unroll
  for (int n = 0; n < Np; ++n) {
    const float w = gi[n];
    #pragma unroll
    for (int f = 0; f < NF; ++f) a[f] += w * X[f][n];
  }
}

// acc[f][n] += gi[n] t[f] over the row gi of GI (shared memory): a lift of
// the four values t.
template <class Z>
__device__ __forceinline__ void lift_row(const COps& o, const float* gi,
                                         const float* t,
                                         float (&acc)[NF][Z::CAP]) {
  const int Np = Z::Np(o);
  if (Z::PAIRS) {
    #pragma unroll
    for (int n = 0; n < Np; n += 2) {
      const float2 w = *reinterpret_cast<const float2*>(gi + n);
      #pragma unroll
      for (int f = 0; f < NF; ++f) {
        acc[f][n] += w.x * t[f];
        acc[f][n + 1] += w.y * t[f];
      }
    }
  } else {
    #pragma unroll
    for (int n = 0; n < Np; ++n) {
      const float w = gi[n];
      #pragma unroll
      for (int f = 0; f < NF; ++f) acc[f][n] += w * t[f];
    }
  }
}

// Adds GI^T (the '+' cotangents that other Gauss points sent to element k's
// Gauss points, T (nT, B)) to the nodal cotangent acc, in the fixed order of
// the inverse map of mapP; a face's loads are issued together.
template <class Z>
__device__ __forceinline__ void lift_gathered(const COps& o, const CBlock& ch,
                                              int e, int k, int b, int B,
                                              const float4* T,
                                              float (&acc)[NF][Z::CAP]) {
  const int Np = Z::Np(o), NG = Z::NG(o), NT = 3 * NG;
  #pragma unroll 1
  for (int fc = 0; fc < 3; ++fc) {
    #pragma unroll
    for (int jj = 0; jj < NG; ++jj) {
      const int q = ch.src[(fc * NG + jj) * ch.E + e];
      put4(ch, jj, q >= 0 ? T[(size_t)q * B + b]
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f));
    }
    // a point that not exactly one point reads (none on a conforming mesh):
    // the inverse map's list
    #pragma unroll 1
    for (int jj = 0; jj < NG; ++jj) {
      const int j = fc * NG + jj;
      if (ch.src[j * ch.E + e] >= 0) continue;
      const int i = k * NT + j;
      float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int r = o.invP_ptr[i]; r < o.invP_ptr[i + 1]; ++r) {
        const float4 p = T[(size_t)o.invP_idx[r] * B + b];
        s.x += p.x; s.y += p.y; s.z += p.z; s.w += p.w;
      }
      put4(ch, jj, s);
    }
    #pragma unroll 1
    for (int jj = 0; jj < NG; ++jj) {
      float t[NF];
      get4(ch, jj, t);
      lift_row<Z>(o, ch.GI + (fc * NG + jj) * Np, t, acc);
    }
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// One RK stage of element k (local element e of the loaded chunk), scenario
// b:   out = base + coef * R(in) at the element's nodes.
// in, base, out: the scenario's fields (base and out may be one buffer);
// TMin: the traces of `in` (all elements); TMout: where to store the traces
// of `out`, or null.
template <class Z>
__device__ void cstage(const COps& o, const CBlock& ch, int e, int k, int b,
                       int B, const P4& in, const P4& base, const W4& out,
                       float coef, const float* ctrl, int use_filter,
                       const float4* TMin, float4* TMout) {
  const int Np = Z::Np(o), Ncub = Z::Ncub(o), NG = Z::NG(o);
  const int E = ch.E, v0 = k * Np, nth = SLOT_STRIDE;
  const float g = o.g;
  float acc[NF][Z::CAP];

  // volume: interpolate to each cubature point, weighted fluxes, and their
  // weak divergence at once; the state and the accumulator in registers,
  // each operator value a broadcast that feeds four FMAs (one a field)
  {
    float S[NF][Z::CAP];
    load_nodal<Z>(o, in, k, S);
    #pragma unroll
    for (int n = 0; n < Np; ++n) {
      #pragma unroll
      for (int f = 0; f < NF; ++f) acc[f][n] = 0.0f;
    }
    #pragma unroll 2
    for (int c = 0; c < Ncub; ++c) {
      const float* op = cub_col(ch, Np, c);
      // two partial sums a field: half the dependent chain
      float q[NF] = {0.0f, 0.0f, 0.0f, 0.0f}, q2[NF] = {0.0f, 0.0f, 0.0f, 0.0f};
      float F[NF], G[NF];
      #pragma unroll
      for (int n = 0; n + 1 < Np; n += 2) {
        const float w = op[12 * n], w2 = op[12 * (n + 1)];
        #pragma unroll
        for (int f = 0; f < NF; ++f) {
          q[f] += w * S[f][n];
          q2[f] += w2 * S[f][n + 1];
        }
      }
      if (Np & 1) {
        const float w = op[12 * (Np - 1)];
        #pragma unroll
        for (int f = 0; f < NF; ++f) q[f] += w * S[f][Np - 1];
      }
      #pragma unroll
      for (int f = 0; f < NF; ++f) q[f] += q2[f];
      fluxes4(g, q, F, G);
      const float4 w = ch.geo[c * E + e];
      float tr[NF], ts[NF];
      #pragma unroll
      for (int f = 0; f < NF; ++f) {
        tr[f] = w.x * F[f] + w.y * G[f];
        ts[f] = w.z * F[f] + w.w * G[f];
      }
      #pragma unroll
      for (int n = 0; n < Np; ++n) {
        const float dr = op[12 * n + 4], ds = op[12 * n + 8];
        #pragma unroll
        for (int f = 0; f < NF; ++f) acc[f][n] += dr * tr[f] + ds * ts[f];
      }
    }
  }

  // surface, face by face: the face's maximum speed, then central +
  // Lax-Friedrichs flux at each point, lifted
  #pragma unroll 1
  for (int fc = 0; fc < 3; ++fc) {
    stage_face<Z>(o, ch, e, k, fc, b, B, TMin);
    float lam = 0.0f;
    #pragma unroll 2
    for (int jj = 0; jj < NG; ++jj) {
      float M[NF], P[NF];
      get4(ch, 2 * jj, M);
      get4(ch, 2 * jj + 1, P);
      const float sp = fmaxf(speed4(g, M), speed4(g, P));
      lam = jj == 0 ? sp : fmaxf(lam, sp);
    }
    const float hl = 0.5f * lam;
    #pragma unroll 2
    for (int jj = 0; jj < NG; ++jj) {
      const int j = fc * NG + jj;
      float M[NF], P[NF], FM[NF], GM[NF], FP[NF], GP[NF], fl[NF];
      get4(ch, 2 * jj, M);
      get4(ch, 2 * jj + 1, P);
      const float4 gp = ch.gpt[j * E + e];
      fluxes4(g, M, FM, GM);
      fluxes4(g, P, FP, GP);
      #pragma unroll
      for (int f = 0; f < NF; ++f) {
        const float pre = 0.5f * ((FM[f] + FP[f]) * gp.x
                                  + (GM[f] + GP[f]) * gp.y);
        fl[f] = gp.z * (pre + hl * (M[f] - P[f]));
      }
      #pragma unroll
      for (int f = 0; f < NF; ++f) fl[f] = -fl[f];
      lift_row<Z>(o, ch.GI + j * Np, fl, acc);
    }
  }

  // per-element mass inverse, nodal sources (into slots 0 .. 4 Np)
  const bool src = o.cd != 0.0f || o.fcor != 0.0f || o.has_bed;
  #pragma unroll 1
  for (int n = 0; n < Np; ++n) {
    float a[NF] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (o.affine) {
      #pragma unroll
      for (int m = 0; m < Np; ++m) {
        const float w = ch.VVT[n * Np + m];
        #pragma unroll
        for (int f = 0; f < NF; ++f) a[f] += w * acc[f][m];
      }
      #pragma unroll
      for (int f = 0; f < NF; ++f) a[f] *= ch.minv[e];
    } else {
      #pragma unroll
      for (int m = 0; m < Np; ++m) {
        const float w = ch.minv[(n * Np + m) * E + e];
        #pragma unroll
        for (int f = 0; f < NF; ++f) a[f] += w * acc[f][m];
      }
    }
    if (src) {
      const int v = v0 + n;
      const float h = in.f[0][v], hu = in.f[1][v], hv = in.f[2][v];
      a[1] += source4(o, 1, v, h, hu, hv);
      a[2] += source4(o, 2, v, h, hu, hv);
    }
    #pragma unroll
    for (int f = 0; f < NF; ++f) ch.slot[(f * Np + n) * nth] = a[f];
  }

  // modal filter (into slots 4 Np .. 8 Np)
  float R[NF][Z::CAP];
  if (use_filter) {
    load_slots<Z>(o, ch, 0, R);
    #pragma unroll 1
    for (int n = 0; n < Np; ++n) {
      float a[NF] = {0.0f, 0.0f, 0.0f, 0.0f};
      #pragma unroll
      for (int m = 0; m < Np; ++m) {
        const float w = ch.filt[n * Np + m];
        #pragma unroll
        for (int f = 0; f < NF; ++f) a[f] += w * R[f][m];
      }
      #pragma unroll
      for (int f = 0; f < NF; ++f) ch.slot[((NF + f) * Np + n) * nth] = a[f];
    }
  }
  // control forcing and stage update; the global loads issued together
  float fu[Z::CAP], fv[Z::CAP];
  #pragma unroll
  for (int n = 0; n < Np; ++n) fu[n] = fv[n] = 0.0f;
  if (ctrl != nullptr) {
    for (int c = 0; c < o.n_ctrl; ++c) {
      const float cc = ctrl[c];
      #pragma unroll
      for (int n = 0; n < Np; ++n) {
        fu[n] += cc * o.BU[(size_t)c * o.nV + v0 + n];
        fv[n] += cc * o.BV[(size_t)c * o.nV + v0 + n];
      }
    }
  }
  load_nodal<Z>(o, base, k, R);
  const int r0 = use_filter ? NF * Np : 0;
  #pragma unroll
  for (int n = 0; n < Np; ++n) {
    #pragma unroll
    for (int f = 0; f < NF; ++f) {
      float a = ch.slot[(r0 + f * Np + n) * nth];
      if (f == 1) a += fu[n];
      if (f == 2) a += fv[n];
      R[f][n] += coef * a;
      out.f[f][v0 + n] = R[f][n];
    }
  }
  if (TMout != nullptr) store_traces<Z>(o, ch, k, b, B, R, TMout);
}

struct CFwdArgs {
  const float* s0[NF];  // (B, nV) initial fields
  const float* ctrls;   // (B, n_cs, n_ctrl) or null
  float* o[NF];         // (B, nV) final fields, the resident state buffer
  float* s1[NF];        // (B, nV) stage scratch
  float* t[NF];         // (B, n_steps+1, nV) trajectories or null
  float4 *TMa, *TMb;    // (nT, B) traces: of the step-start state, of s1
  int B, n_steps, n_cs, spc, E, Bs, use_filter;
  float dt;
};

// n_steps SSP-RK2 steps: u1 = u + dt/2 R(u); u <- u + dt R(u1), with a grid
// barrier after the initial traces and after each stage but the last.
template <class Z>
__device__ void cforward_body(const COps& og, const CFwdArgs& a) {
  cg::grid_group grid = cg::this_grid();
  const COps& o = og;
  const CBlock ch = setup_cblock(o, a.E);
  const Units U(a.E, a.Bs, a.B, o.K);
  const size_t nV = (size_t)o.nV, trow = (size_t)(a.n_steps + 1) * nV;
  const bool traj = a.t[0] != nullptr;
  const int B = a.B;
  W4 none;
  #pragma unroll
  for (int f = 0; f < NF; ++f) none.f[f] = nullptr;

  // the initial state's traces (and, stored, row 0 of the trajectory)
  for (int u = blockIdx.x; u < U.n_units; u += gridDim.x)
    for_lanes(U, u, [&](int k, int b, int) {
      traces_of<Z>(o, ch, at4(a.s0, b * nV), k, b, B, a.TMa,
                   traj ? atw4(a.t, b * trow) : none);
    });
  grid.sync();

  int have = -1;
  for (int t = 0; t < a.n_steps; ++t) {
    for (int phase = 0; phase < 2; ++phase) {
      const bool last = t == a.n_steps - 1 && phase == 1;
      for (int u = blockIdx.x; u < U.n_units; u += gridDim.x) {
        use_chunk(o, ch, U, u, have);
        for_lanes(U, u, [&](int k, int b, int e) {
          P4 cur;  // the step-start state
          if (t == 0) cur = at4(a.s0, b * nV);
          else if (traj) cur = at4(a.t, b * trow + t * nV);
          else cur = at4(a.o, b * nV);
          const W4 s1 = atw4(a.s1, b * nV);
          const float* ctrl = a.ctrls == nullptr ? nullptr
              : a.ctrls + ((size_t)b * a.n_cs + t / a.spc) * o.n_ctrl;
          // stage 1: s1 = u + dt/2 R(u); stage 2: u' = u + dt R(s1)
          const W4 out = phase == 0 ? s1
              : traj ? atw4(a.t, b * trow + (t + 1) * nV) : atw4(a.o, b * nV);
          cstage<Z>(o, ch, e, k, b, B, phase == 0 ? cur : readonly(s1), cur,
                    out, (phase == 0 ? 0.5f : 1.0f) * a.dt, ctrl,
                    a.use_filter, phase == 0 ? a.TMa : a.TMb,
                    phase == 0 ? a.TMb : (last ? nullptr : a.TMa));
        });
      }
      if (!last) grid.sync();
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

// First half of the vector-Jacobian product of the filtered, control-forced
// RHS at state S for element k (local element e), scenario b, against the
// cotangent scale * acc (acc: the element's nodal cotangent, in registers;
// overwritten). It
//   adds  d/d ctrl_c  to cp[c],
//   writes the volume, source and own-trace part of J_R(S)^T (scale acc) to
//   Avol at the element's nodes,
//   writes the cotangent of each of its Gauss points' '+' value to
//   T[i, b] (nT, B).
// The product is complete once every element has added GI^T of what the
// Gauss points that read its traces wrote to T (lift_gathered), after a grid
// barrier. TM: the traces of S.
template <class Z>
__device__ void cvjp(const COps& o, const CBlock& ch, int e, int k, int b,
                     int B, int l, int part, int G, const P4& S,
                     float (&acc)[NF][Z::CAP], float scale, int use_filter,
                     const float4* TM, float4* T, const W4& Avol, float* cp) {
  const int Np = Z::Np(o), Ncub = Z::Ncub(o), NG = Z::NG(o), NT = 3 * NG;
  const int E = ch.E, v0 = k * Np, i0 = k * NT, nth = SLOT_STRIDE;
  const float g = o.g;
  // the mass inverse transposed cotangent, in this thread's slots
  const float* mb = ch.slot + mb_slot(Np, NG) * nth;

  #pragma unroll
  for (int n = 0; n < Np; ++n) {
    #pragma unroll
    for (int f = 0; f < NF; ++f) acc[f][n] *= scale;
  }
  // the control enters after the filter: its cotangent is the product of
  // the incoming momentum cotangents with the (folded) injectors
  for (int c = 0; c < o.n_ctrl; ++c) {
    float part_c = 0.0f;
    #pragma unroll
    for (int n = 0; n < Np; ++n)
      part_c += o.BU[(size_t)c * o.nV + v0 + n] * acc[1][n]
                + o.BV[(size_t)c * o.nV + v0 + n] * acc[2][n];
    if (part == 0) cp[c] += part_c;
  }
  // filter transpose (into slots 0 .. 4 Np), mass inverse transpose (into
  // slots 4 Np .. 8 Np)
  #pragma unroll 1
  for (int m = 0; m < Np; ++m) {
    float a[NF];
    if (use_filter) {
      #pragma unroll
      for (int f = 0; f < NF; ++f) a[f] = 0.0f;
      #pragma unroll
      for (int n = 0; n < Np; ++n) {
        const float w = ch.filt[n * Np + m];
        #pragma unroll
        for (int f = 0; f < NF; ++f) a[f] += w * acc[f][n];
      }
    } else {
      // (acc at a run-time node: through the slots)
      #pragma unroll
      for (int n = 0; n < Np; ++n) {
        if (n == m) {
          #pragma unroll
          for (int f = 0; f < NF; ++f) a[f] = acc[f][n];
        }
      }
    }
    #pragma unroll
    for (int f = 0; f < NF; ++f) ch.slot[(f * Np + m) * nth] = a[f];
  }
  float bn[NF][Z::CAP];
  load_slots<Z>(o, ch, 0, bn);
  #pragma unroll 1
  for (int m = 0; m < Np; ++m) {
    float a[NF] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (o.affine) {
      #pragma unroll
      for (int n = 0; n < Np; ++n) {
        const float w = ch.VVT[n * Np + m];
        #pragma unroll
        for (int f = 0; f < NF; ++f) a[f] += w * bn[f][n];
      }
      #pragma unroll
      for (int f = 0; f < NF; ++f) a[f] *= ch.minv[e];
    } else {
      #pragma unroll
      for (int n = 0; n < Np; ++n) {
        const float w = ch.minv[(n * Np + m) * E + e];
        #pragma unroll
        for (int f = 0; f < NF; ++f) a[f] += w * bn[f][n];
      }
    }
    #pragma unroll
    for (int f = 0; f < NF; ++f) ch.slot[(mb_slot(Np, NG) + f * Np + m) * nth]
        = a[f];
  }
  // the output accumulator starts with the sources' part (slots 0 .. 3 Np;
  // part 0's sum only)
  if (part == 0 && (o.cd != 0.0f || o.fcor != 0.0f || o.has_bed)) {
    #pragma unroll 1
    for (int n = 0; n < Np; ++n) {
      const int v = v0 + n;
      const float h = S.f[0][v], hu = S.f[1][v], hv = S.f[2][v];
      const float w2 = ch.slot[(Np + n) * nth], w3 = ch.slot[(2 * Np + n) * nth];
      #pragma unroll
      for (int f = 0; f < 3; ++f)
        ch.slot[(f * Np + n) * nth] = source4_vjp(o, f, v, h, hu, hv, w2, w3);
    }
    #pragma unroll
    for (int n = 0; n < Np; ++n) {
      #pragma unroll
      for (int f = 0; f < 3; ++f) acc[f][n] = ch.slot[(f * Np + n) * nth];
      acc[3][n] = 0.0f;
    }
  } else {
    #pragma unroll
    for (int n = 0; n < Np; ++n) {
      #pragma unroll
      for (int f = 0; f < NF; ++f) acc[f][n] = 0.0f;
    }
  }

  // surface, face by face: speeds and the speed's cotangent, then the whole
  // chain rule of the face flux. The face's values sit in slots 0 .. 8 NG
  // (stage_face), the speeds in slots 8 NG .. 9 NG; the mass-inverse
  // transposed cotangent in registers.
  float* sp = ch.slot + 8 * NG * nth;
  float mbr[NF][Z::CAP];
  load_slots<Z>(o, ch, mb_slot(Np, NG), mbr);
  #pragma unroll 1
  for (int fc = 0; fc < 3; ++fc) {
    stage_face<Z>(o, ch, e, k, fc, b, B, TM);
    float lam = 0.0f, lsum = 0.0f;
    #pragma unroll 2
    for (int jj = 0; jj < NG; ++jj) {
      const int j = fc * NG + jj;
      float M[NF], P[NF];
      get4(ch, 2 * jj, M);
      get4(ch, 2 * jj + 1, P);
      const float sM = speed4(g, M), sP = speed4(g, P);
      const float s = fmaxf(sM, sP);
      sp[jj * nth] = s;
      const float* gi = ch.GI + j * Np;
      const float hw = 0.5f * ch.gpt[j * E + e].z;
      float lb = 0.0f;
      float a[NF];
      gauss_value<Z>(o, gi, mbr, a);
      #pragma unroll
      for (int f = 0; f < NF; ++f) lb += -hw * a[f] * (M[f] - P[f]);
      lam = jj == 0 ? s : fmaxf(lam, s);
      lsum = jj == 0 ? lb : lsum + lb;
    }
    // the face maximum's cotangent, split evenly over the points that
    // attain it (compared with the stored speeds)
    int cnt = 0;
    #pragma unroll 1
    for (int jj = 0; jj < NG; ++jj) cnt += sp[jj * nth] == lam ? 1 : 0;
    const float share = lsum / (float)cnt;
    #pragma unroll 2
    for (int jj = part; jj < NG; jj += G) {
      const int j = fc * NG + jj;
      float M[NF], P[NF], e4[NF], Fe[NF], Ge[NF], Mb[NF], Pb[NF];
      get4(ch, 2 * jj, M);
      get4(ch, 2 * jj + 1, P);
      const float4 gp = ch.gpt[j * E + e];
      const float* gi = ch.GI + j * Np;
      const float hw = 0.5f * gp.z;
      gauss_value<Z>(o, gi, mbr, e4);
      #pragma unroll
      for (int f = 0; f < NF; ++f) {
        e4[f] *= -hw;
        Fe[f] = e4[f] * gp.x; Ge[f] = e4[f] * gp.y;
      }
      fluxes4_vjp(g, M, Fe, Ge, Mb);
      fluxes4_vjp(g, P, Fe, Ge, Pb);
      #pragma unroll
      for (int f = 0; f < NF; ++f) {
        const float le = lam * e4[f];
        Mb[f] += le; Pb[f] -= le;
      }
      // (the tie weight of max(sM, sP): the same formulas on the same values
      // as in the first pass)
      const float sM = speed4(g, M), sP = speed4(g, P);
      const float sb = sp[jj * nth] == lam ? share : 0.0f;
      const float sMb = sb * (sM > sP ? 1.0f : (sM == sP ? 0.5f : 0.0f));
      speed4_vjp(g, M, sMb, Mb);
      speed4_vjp(g, P, sb - sMb, Pb);
      if (gp.w != 0.0f) {  // reflection: '+' momentum is a map of '-'
        const float unb = -2.0f * (gp.x * Pb[1] + gp.y * Pb[2]);
        Mb[1] += Pb[1] + gp.x * unb;
        Mb[2] += Pb[2] + gp.y * unb;
        Pb[1] = 0.0f; Pb[2] = 0.0f;
      }
      lift_row<Z>(o, gi, Mb, acc);
      T[(size_t)(i0 + j) * B + b] = make_float4(Pb[0], Pb[1], Pb[2], Pb[3]);
    }
  }

  // volume: cotangents of the cubature values, interpolation transposed, a
  // tile of four cubature points at a time (the parts take alternate
  // tiles). The state in slots 0 .. 4 Np, the mass-inverse transposed
  // cotangent in its slots: a node's eight values, loaded once, and its
  // three float4s of operators feed the tile's 48 FMAs.
  {
    {
      float Sn[NF][Z::CAP];
      load_nodal<Z>(o, S, k, Sn);
      #pragma unroll
      for (int n = 0; n < Np; ++n) {
        #pragma unroll
        for (int f = 0; f < NF; ++f) ch.slot[(f * Np + n) * nth] = Sn[f][n];
      }
    }
    const int ntile = cub_tiles(Ncub);
    #pragma unroll 1
    for (int t = part; t < ntile; t += G) {
      const float4* op = ch.ct + t * 3 * Np;
      float q[4][NF], trb[4][NF], tsb[4][NF];
      #pragma unroll
      for (int i = 0; i < 4; ++i) {
        #pragma unroll
        for (int f = 0; f < NF; ++f) q[i][f] = trb[i][f] = tsb[i][f] = 0.0f;
      }
      #pragma unroll 2
      for (int n = 0; n < Np; ++n) {
        const float4 v4 = op[3 * n], r4 = op[3 * n + 1], s4 = op[3 * n + 2];
        const float v[4] = {v4.x, v4.y, v4.z, v4.w};
        const float dr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float ds[4] = {s4.x, s4.y, s4.z, s4.w};
        float y[NF], x[NF];
        #pragma unroll
        for (int f = 0; f < NF; ++f) {
          y[f] = ch.slot[(f * Np + n) * nth];
          x[f] = mb[(f * Np + n) * nth];
        }
        #pragma unroll
        for (int i = 0; i < 4; ++i) {
          #pragma unroll
          for (int f = 0; f < NF; ++f) {
            q[i][f] += v[i] * y[f];
            trb[i][f] += dr[i] * x[f];
            tsb[i][f] += ds[i] * x[f];
          }
        }
      }
      float qb[4][NF];
      #pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 4 * t + i;
        if (c < Ncub) {
          const float4 w = ch.geo[c * E + e];
          float Fb[NF], Gb[NF];
          #pragma unroll
          for (int f = 0; f < NF; ++f) {
            Fb[f] = w.x * trb[i][f] + w.z * tsb[i][f];
            Gb[f] = w.y * trb[i][f] + w.w * tsb[i][f];
          }
          fluxes4_vjp(g, q[i], Fb, Gb, qb[i]);
        } else {
          #pragma unroll
          for (int f = 0; f < NF; ++f) qb[i][f] = 0.0f;
        }
      }
      #pragma unroll
      for (int n = 0; n < Np; ++n) {
        const float4 v4 = op[3 * n];
        #pragma unroll
        for (int f = 0; f < NF; ++f) {
          acc[f][n] += v4.x * qb[0][f];
          acc[f][n] += v4.y * qb[1][f];
          acc[f][n] += v4.z * qb[2][f];
          acc[f][n] += v4.w * qb[3][f];
        }
      }
    }
  }
  if (G > 1) {  // the two parts' sums, added in a fixed order by part 1
    float* x = ch.xch + l;
    if (part == 0) {
      #pragma unroll
      for (int n = 0; n < Np; ++n) {
        #pragma unroll
        for (int f = 0; f < NF; ++f) x[(f * Np + n) * SLOT_STRIDE] = acc[f][n];
      }
    }
    pair_sync();
    if (part == 1) {
      #pragma unroll
      for (int n = 0; n < Np; ++n) {
        #pragma unroll
        for (int f = 0; f < NF; ++f)
          acc[f][n] = x[(f * Np + n) * SLOT_STRIDE] + acc[f][n];
      }
    }
    pair_sync();  // the exchange slots are free again
    if (part == 0) return;
  }
  #pragma unroll
  for (int n = 0; n < Np; ++n) {
    #pragma unroll
    for (int f = 0; f < NF; ++f) Avol.f[f][v0 + n] = acc[f][n];
  }
}

struct CBwdArgs {
  const float* t[NF];   // (B, n_steps+1, nV) stored trajectories
  const float* tb[NF];  // their cotangents; null: zero
  const float* ctrls;   // (B, n_cs, n_ctrl)
  float* xb[NF];        // (B, nV) out: initial-state cotangents
  float* cbar;          // (B, n_cs, n_ctrl) out
  // scratch, each (B, nV) per field: stage state, cotangent W of the step's
  // output, g1 = VJP_R(s1)[dt W], the first half of VJP_R(s_t)[dt/2 g1]
  float *s1, *W, *A, *Bv;
  float4 *TMs, *TM0, *TM1;  // (nT, B) traces of s1 and of s_t (alternating)
  float4 *T1, *T2;          // (nT, B) '+' cotangents of the two products
  float* cpart;             // (B, K, n_cs, n_ctrl) control partial sums
  int B, n_cs, spc, E, Bs, use_filter;
  int parts;                // threads a (scenario, element): 1 or 2
  float dt;
};

// Reverse sweep. For each step t (T-1 .. 0), with s_t the stored step-start
// state and lambda the adjoint of s_{t+1}:
//   W      = lambda + tbar_{t+1}
//   s1     = s_t + dt/2 R(s_t)                   (recomputed)
//   g1     = VJP_R(s1)[dt W]
//   lambda = W + g1 + VJP_R(s_t)[dt/2 g1].
// Three phases per step, a grid barrier after each (header of this file);
// phases 2 and 3 share one call of cvjp (one copy of its code).
template <class Z>
__global__ void __launch_bounds__(2 * MAX_THREADS, 1)
sw2d_curved_rollout_bwd_kernel(COps og, CBwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  const COps& o = og;
  const int Np = Z::Np(o), G = a.parts;
  const CBlock ch = setup_cblock(o, a.E);
  const Units U(a.E, a.Bs, a.B, o.K);
  const int B = a.B, n_steps = a.n_cs * a.spc, n_cc = a.n_cs * o.n_ctrl;
  const size_t nV = (size_t)o.nV;
  const size_t fs = (size_t)B * nV;  // floats per field of a scratch
  const size_t trow = (size_t)(n_steps + 1) * nV;
  W4 none;
  #pragma unroll
  for (int f = 0; f < NF; ++f) none.f[f] = nullptr;
  // this (scenario, element)'s control partial sums at control step j
  auto cp = [&](int b, int k, int j) {
    return a.cpart + (((size_t)b * o.K + k) * a.n_cs + j) * o.n_ctrl;
  };

  for (int u = blockIdx.x; u < U.n_units; u += gridDim.x)
    for_lane_parts(U, u, G, [&](int k, int b, int, int, int part) {
      if (part != 0) return;
      for (int r = 0; r < n_cc; ++r) cp(b, k, 0)[r] = 0.0f;
      traces_of<Z>(o, ch, at4(a.t, b * trow + (n_steps - 1) * nV), k, b, B,
                   a.TM0, none);
    });
  grid.sync();

  int have = -1;
  for (int t = n_steps - 1; t >= -1; --t) {
    float4* TMt = ((n_steps - 1 - t) & 1) ? a.TM1 : a.TM0;  // traces of s_t
    float4* TMn = ((n_steps - 1 - t) & 1) ? a.TM0 : a.TM1;  // of s_{t-1}
    // ---- phase 1 (for t = -1: only the initial-state cotangent) ----
    for (int u = blockIdx.x; u < U.n_units; u += gridDim.x) {
      use_chunk(o, ch, U, u, have);
      for_lane_parts(U, u, G, [&](int k, int b, int e, int, int part) {
        if (part != 0) return;
        const int v0 = k * Np;
        const size_t sb = (size_t)b * nV;
        float lam[NF][Z::CAP];
        #pragma unroll
        for (int n = 0; n < Np; ++n) {
          #pragma unroll
          for (int f = 0; f < NF; ++f) {
            const size_t at = f * fs + sb + v0 + n;
            lam[f][n] = t < n_steps - 1 ? a.Bv[at] + a.W[at] + a.A[at] : 0.0f;
          }
        }
        if (t < n_steps - 1) lift_gathered<Z>(o, ch, e, k, b, B, a.T2, lam);
        const P4 tb = at4(a.tb, b * trow + (t + 1) * nV);
        #pragma unroll
        for (int f = 0; f < NF; ++f) {
          if (tb.f[f] != nullptr) {
            #pragma unroll
            for (int n = 0; n < Np; ++n) lam[f][n] += tb.f[f][v0 + n];
          }
        }
        #pragma unroll
        for (int n = 0; n < Np; ++n) {
          #pragma unroll
          for (int f = 0; f < NF; ++f) {
            if (t < 0) a.xb[f][sb + v0 + n] = lam[f][n];
            else a.W[f * fs + sb + v0 + n] = lam[f][n];
          }
        }
        if (t < 0) return;
        const P4 st = at4(a.t, b * trow + t * nV);
        const float* ctrl =
            a.ctrls + ((size_t)b * a.n_cs + t / a.spc) * o.n_ctrl;
        cstage<Z>(o, ch, e, k, b, B, st, st, fields_of(a.s1, fs, sb),
                  0.5f * a.dt, ctrl, a.use_filter, TMt, a.TMs);
      });
    }
    if (t < 0) break;
    grid.sync();

    const int j = t / a.spc;
    // ---- phase 2: g1 = VJP_R(s1)[dt W], first half; traces of s_{t-1}.
    // ---- phase 3: complete g1; VJP_R(s_t)[dt/2 g1], first half.
    for (int half = 0; half < 2; ++half) {
      for (int u = blockIdx.x; u < U.n_units; u += gridDim.x) {
        use_chunk(o, ch, U, u, have);
        for_lane_parts(U, u, G, [&](int k, int b, int e, int l, int part) {
          const int v0 = k * Np;
          const size_t sb = (size_t)b * nV;
          const W4 A = fields_of(a.A, fs, sb);
          float w[NF][Z::CAP];
          if (half == 0) {
            load_nodal<Z>(o, readonly(fields_of(a.W, fs, sb)), k, w);
          } else {
            // part 0 completes g1 and stores it; part 1 reads it back
            if (part == 0) {
              load_nodal<Z>(o, readonly(A), k, w);
              lift_gathered<Z>(o, ch, e, k, b, B, a.T1, w);
              #pragma unroll
              for (int n = 0; n < Np; ++n) {
                #pragma unroll
                for (int f = 0; f < NF; ++f) A.f[f][v0 + n] = w[f][n];
              }
            }
            if (G > 1) {
              pair_sync();
              if (part != 0) load_nodal<Z>(o, readonly(A), k, w);
            }
          }
          cvjp<Z>(o, ch, e, k, b, B, l, part, G,
                  half == 0 ? readonly(fields_of(a.s1, fs, sb))
                            : at4(a.t, b * trow + t * nV),
                  w, (half == 0 ? 1.0f : 0.5f) * a.dt, a.use_filter,
                  half == 0 ? a.TMs : TMt, half == 0 ? a.T1 : a.T2,
                  half == 0 ? A : fields_of(a.Bv, fs, sb), cp(b, k, j));
          if (half == 0 && t > 0 && part == 0)
            traces_of<Z>(o, ch, at4(a.t, b * trow + (t - 1) * nV), k, b, B,
                         TMn, none);
        });
      }
      grid.sync();
    }
  }

  // control cotangents: the elements' partial sums, added in a fixed order.
  // The last of them were written before the barrier that ended step 0.
  const int nth = blockDim.x;
  for (int i = blockIdx.x * nth + threadIdx.x; i < B * n_cc;
       i += gridDim.x * nth) {
    const int b = i / n_cc, r = i - b * n_cc;
    float tot = 0.0f;
    for (int k = 0; k < o.K; ++k)
      tot += a.cpart[((size_t)b * o.K + k) * n_cc + r];
    a.cbar[i] = tot;
  }
}

// ---------------------------------------------------------------------------
// C interface
// ---------------------------------------------------------------------------

extern "C" {

// Bytes of dynamic shared memory one block of `threads` needs with chunks of
// E elements and `parts` threads a lane (the adjoint: 1 or 2).
long long sw2d_curved_smem_bytes(const CurvedDesc* d, int E, int parts,
                                 int threads) {
  COps o = make_cops(*d, nullptr, nullptr);
  return (long long)(csmem_floats(o, E, threads, parts) * sizeof(float));
}

// Blocks of the last launch (for reporting).
int sw2d_curved_last_grid() { return g_last_grid; }

static int g_last_parts = 0;

// Threads a (scenario, element) of the last adjoint launch (for reporting).
int sw2d_curved_last_parts() { return g_last_parts; }

static int check_sizes(const CurvedDesc* d, int E, int Bs, int threads,
                       int parts = 1) {
  if (threads > MAX_THREADS * parts || E < 1 || Bs < 1)
    return (int)cudaErrorInvalidValue;
  if (!is_order3(*d) && (d->Np > MAX_NP || d->NG > MAX_NG))
    return (int)cudaErrorInvalidValue;
  return 0;
}

static int n_units_of(const CurvedDesc* d, int B, int E, int Bs) {
  return ((d->K + E - 1) / E) * ((B + Bs - 1) / Bs);
}

// Floats of scratch that sw2d_curved_step / sw2d_curved_rollout need in
// `work`: the stage state (4 B nV), two trace buffers (2 x 4 B nT).
long long sw2d_curved_fwd_work_floats(const CurvedDesc* d, int B) {
  const long long nV = (long long)d->K * d->Np;
  const long long nT = (long long)d->K * 3 * d->NG;
  return 4 * B * nV + 8 * B * nT;
}

static int launch_cforward(const void* kern, const CurvedDesc* d,
                           const float* fops, const int* iops, CFwdArgs a,
                           int threads, void* stream) {
  const int bad = check_sizes(d, a.E, a.Bs, threads);
  if (bad) return bad;
  COps o = make_cops(*d, fops, iops);
  const size_t bytes = csmem_floats(o, a.E, threads) * sizeof(float);
  void* args[] = {&o, &a};
  return coop_launch(kern, args, n_units_of(d, a.B, a.E, a.Bs), threads,
                     bytes, stream);
}

static void fwd_work(CFwdArgs& a, const CurvedDesc* d, float* work, int B) {
  const size_t n = (size_t)B * d->K * d->Np;
  const size_t t4 = (size_t)4 * B * d->K * 3 * d->NG;
  for (int f = 0; f < NF; ++f) a.s1[f] = work + f * n;
  a.TMa = reinterpret_cast<float4*>(work + 4 * n);
  a.TMb = reinterpret_cast<float4*>(work + 4 * n + t4);
}

// ctrl: (B, n_ctrl) or null. work: sw2d_curved_fwd_work_floats floats.
int sw2d_curved_step(const CurvedDesc* d, const float* fops, const int* iops,
                     const float* h, const float* hu, const float* hv,
                     const float* hN, const float* ctrl, float* oh,
                     float* ohu, float* ohv, float* ohN, float* work, int B,
                     float dt, int use_filter, int E, int Bs, int threads,
                     void* stream) {
  CFwdArgs a = {{h, hu, hv, hN}, ctrl, {oh, ohu, ohv, ohN},
                {nullptr, nullptr, nullptr, nullptr},
                {nullptr, nullptr, nullptr, nullptr}, nullptr, nullptr,
                B, 1, 1, 1, E, Bs, use_filter, dt};
  fwd_work(a, d, work, B);
  const void* kern = is_order3(*d)
      ? (const void*)sw2d_curved_step_kernel<Order3>
      : (const void*)sw2d_curved_step_kernel<AnyOrder>;
  return launch_cforward(kern, d, fops, iops, a, threads, stream);
}

// ctrls: (B, n_cs, n_ctrl) or null. With th..thN (B, n_steps+1, nV) the
// trajectories are stored and oh..ohN are not touched; without, the final
// fields go to oh..ohN. work: sw2d_curved_fwd_work_floats floats.
int sw2d_curved_rollout(const CurvedDesc* d, const float* fops,
                        const int* iops, const float* h, const float* hu,
                        const float* hv, const float* hN, const float* ctrls,
                        float* oh, float* ohu, float* ohv, float* ohN,
                        float* th, float* thu, float* thv, float* thN,
                        float* work, int B, int n_steps, int n_cs, int spc,
                        float dt, int use_filter, int E, int Bs, int threads,
                        void* stream) {
  CFwdArgs a = {{h, hu, hv, hN}, ctrls, {oh, ohu, ohv, ohN},
                {nullptr, nullptr, nullptr, nullptr}, {th, thu, thv, thN},
                nullptr, nullptr, B, n_steps, n_cs, spc, E, Bs, use_filter,
                dt};
  fwd_work(a, d, work, B);
  const void* kern = is_order3(*d)
      ? (const void*)sw2d_curved_rollout_kernel<Order3>
      : (const void*)sw2d_curved_rollout_kernel<AnyOrder>;
  return launch_cforward(kern, d, fops, iops, a, threads, stream);
}

// Floats of scratch that sw2d_curved_rollout_bwd needs in `work`: four
// (B, nV) states (x 4 fields), five (nT, B) float4 buffers, the control
// partial sums.
long long sw2d_curved_bwd_work_floats(const CurvedDesc* d, int B, int n_cs) {
  const long long nV = (long long)d->K * d->Np;
  const long long nT = (long long)d->K * 3 * d->NG;
  return 16 * B * nV + 20 * B * nT + (long long)B * d->K * n_cs * d->n_ctrl;
}

static int round32(int n) { return (n + 31) & ~31; }

static const void* bwd_kernel(const CurvedDesc* d) {
  return is_order3(*d)
      ? (const void*)sw2d_curved_rollout_bwd_kernel<Order3>
      : (const void*)sw2d_curved_rollout_bwd_kernel<AnyOrder>;
}

// Threads a (scenario, element) that the adjoint takes for B scenarios in
// units of E elements x Bs scenarios: 2 where the blocks of twice the
// threads fit shared memory and are all resident at once, by the occupancy
// the device reports for the kernel (the lanes are too few to fill the
// card: the small disk), else 1; a CUDA error as a negative number.
int sw2d_curved_bwd_parts(const CurvedDesc* d, int B, int E, int Bs) {
  const int threads = round32(E * Bs * 2);
  if (threads > 2 * MAX_THREADS || check_sizes(d, E, Bs, threads, 2)) return 1;
  const COps o = make_cops(*d, nullptr, nullptr);
  const size_t bytes = csmem_floats(o, E, threads, 2) * sizeof(float);
  int dev = 0, room = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return -(int)e;
  cudaDeviceGetAttribute(&room, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (bytes > (size_t)room) return 1;
  const void* kern = bwd_kernel(d);
  const int pe = prepare(kern, bytes);
  if (pe != 0) return -pe;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                    bytes);
  if (e != cudaSuccess) return -(int)e;
  return n_units_of(d, B, E, Bs) <= per_sm * sms ? 2 : 1;
}

// tbh..tbhN: cotangent trajectories; a null pointer stands for zeros.
// parts: threads a (scenario, element), 1 or 2, or 0 for the choice of
// sw2d_curved_bwd_parts; the block has 32 (E Bs parts / 32) threads.
int sw2d_curved_rollout_bwd(const CurvedDesc* d, const float* fops,
                            const int* iops, const float* th,
                            const float* thu, const float* thv,
                            const float* thN, const float* tbh,
                            const float* tbhu, const float* tbhv,
                            const float* tbhN, const float* ctrls, float* xbh,
                            float* xbhu, float* xbhv, float* xbhN,
                            float* cbar, float* work, int B, int n_cs,
                            int spc, float dt, int use_filter, int E, int Bs,
                            int parts, void* stream) {
  if (parts == 0) parts = sw2d_curved_bwd_parts(d, B, E, Bs);
  if (parts < 0) return -parts;
  if (parts != 1 && parts != 2) return (int)cudaErrorInvalidValue;
  const int threads = round32(E * Bs * parts);
  const int bad = check_sizes(d, E, Bs, threads, parts);
  if (bad) return bad;
  COps o = make_cops(*d, fops, iops);
  const size_t n4 = (size_t)NF * B * o.nV, t4 = (size_t)4 * B * o.nT;
  CBwdArgs a;
  a.t[0] = th; a.t[1] = thu; a.t[2] = thv; a.t[3] = thN;
  a.tb[0] = tbh; a.tb[1] = tbhu; a.tb[2] = tbhv; a.tb[3] = tbhN;
  a.ctrls = ctrls;
  a.xb[0] = xbh; a.xb[1] = xbhu; a.xb[2] = xbhv; a.xb[3] = xbhN;
  a.cbar = cbar;
  a.s1 = work; a.W = work + n4; a.A = work + 2 * n4; a.Bv = work + 3 * n4;
  float* tw = work + 4 * n4;
  a.TMs = reinterpret_cast<float4*>(tw);
  a.TM0 = reinterpret_cast<float4*>(tw + t4);
  a.TM1 = reinterpret_cast<float4*>(tw + 2 * t4);
  a.T1 = reinterpret_cast<float4*>(tw + 3 * t4);
  a.T2 = reinterpret_cast<float4*>(tw + 4 * t4);
  a.cpart = tw + 5 * t4;
  a.B = B; a.n_cs = n_cs; a.spc = spc; a.E = E; a.Bs = Bs;
  a.use_filter = use_filter; a.dt = dt; a.parts = parts;
  const size_t bytes = csmem_floats(o, E, threads, parts) * sizeof(float);
  void* args[] = {&o, &a};
  g_last_parts = parts;
  return coop_launch(bwd_kernel(d), args, n_units_of(d, B, E, Bs), threads,
                     bytes, stream);
}

}  // extern "C"
