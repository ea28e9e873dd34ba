// Device memory that other processes map, and the exchanges and sums
// between ranks over it, sm_90a.
//
//   peer_alloc / peer_free      one zeroed cudaMalloc region of this rank
//   peer_export / peer_open /   its CUDA IPC handle, and a peer's region
//   peer_close                  mapped into this process (on one card, or a
//                               peer card's memory over NVLink)
//   peer_ring_exchange_kernel   the step-boundary exchange of a ring's
//                               initial send buffer (the one-launch step)
//   peer_stage_exchange_kernel  the stage ring's exchange of a stage's send
//                               buffer, and its reverse (the backward); the
//                               halo ring's exchange of face rows, and its
//                               reverse
//   peer_rank_reduce_kernel     a ring's sum or maximum of a small float or
//                               double vector over the ranks, the same bits
//                               on every rank
//
// Regions come from cudaMalloc, not from the torch caching allocator: that
// allocator sub-allocates (a handle names its whole segment), and its
// expandable segments are cuMemCreate memory, which cudaIpcGetMemHandle
// refuses.
//
// Both exchange kernels send a buffer's chunks the same way (send_chunk),
// as 4-byte words, whatever the type: one block a ring offset i waits until
// the receiving rank's slots of chunk i are free (a GO flag in this rank's
// memory, released by the receiver; for the stage and halo rings, whose
// slots are two sets by the epoch's parity, the set of the epoch's parity:
// the read of the epoch before the last), stores chunk i of every scenario
// into them and sets the chunk's ARRIVED flag in the receiver's memory
// after block_fence. The slot set (where the slots lie in a region, which
// flags guard them, which way the ring sends) is the kernel's.
//
// The order (block_fence): a block barrier, then thread 0 alone makes one
// fence at system scope and stores the flag as a relaxed store at system
// scope (flag_store). The barrier orders every thread's stores into the
// peer's slots (or loads from this rank's) before thread 0's fence; the
// fence followed by the strong store is a release pattern (PTX memory
// model), which the peer's acquire load of the flag synchronizes with, and
// the causality order is transitive through the barrier: the peer's reads
// after its wait see every thread's stores, and its stores after its wait
// come after every thread's loads. So one system fence on a block's path:
// each system fence in series costs a launch about 0.002 ms on the H100
// (PERF.md; sw2d_blocked.cu's sr_fold_end orders the folded launches' end
// the same way).
//
// peer_ring_exchange_kernel replaces the XLA ppermute of the carried send
// buffer that precedes the TPU one-launch step in
// blitzdg_tpu/parallel/blocked_shard.py (make_sharded_blocked_step_rdma);
// it replaces no TPU kernel. A ring runs it once, before its first step:
// every later step's exchange is the step launch's own (its stage 2 stores
// each send slot into the receiving rank's step-boundary slots and
// releases INB there; sw2d_blocked.cu, rdma_step), so a step is one
// launch. Its slot set: the step-boundary slots, GOB and INB; the epoch is
// read from this rank's region, where the step launch keeps it; the
// receiving rank's first step launch waits for INB.
//
// peer_stage_exchange_kernel replaces the XLA ppermute between the RK
// stages of the differentiable sharded step (blitzdg_tpu/parallel/
// blocked_shard.py, make_sharded_blocked_step_diff, its exchange) and, with
// `rev`, its transpose in the backward sweep; and the lax.ppermute a ring
// offset of the element-sharded plain-tensor path's face rows
// (blitzdg_tpu/parallel/halo.py, halo_face_rows) with its transpose, every
// offset in one launch; no TPU kernel. The chunk's size (words a ring
// offset) and a row's (words a scenario) are the launch's, so one kernel
// takes the stage's (B, L, 3) floats and the halo's face rows of any
// width and type (float32, float64, bfloat16 padded to whole words). In
// the slots chunk i lies at i x slot_cw, slot_cw the same for every call
// of a ring (its chunk size for a stage ring, the slot set's words over
// the ring offsets for a halo ring): a call whose chunks are smaller than
// the last call's never stores into another chunk's slots, which only
// that chunk's GO flag frees. Epoch e takes the slot set of e's parity
// (peer_flags.cuh), so the standalone exchange and the folded stage
// launches of sw2d_blocked.cu (the stage ring's exchange and its reverse
// inside B7's and B8's launches) share one sequence a use. The stage ring
// launches it for a rollout's first exchange only, the constant start's
// send buffer (and the reverse for a send buffer that needs its
// cotangent); every later exchange is a folded launch's own. A launch has
// 2 n_off blocks of two kinds, each with one system fence on its path:
// block i < n_off sends chunk i (send_chunk: forward to rank + d over FGO /
// FIN, reverse to rank - d over RGO / RIN); block n_off + i waits for its
// own ARRIVED flag of chunk i, copies the chunk from its slots into `out`
// (memory torch owns, so that autograd may keep it) and sets the sender's
// GO flag after block_fence. So the send and the receive of a chunk
// overlap. The sends take the low block indices: where a launch's blocks
// run one after another (the host build of the tests), a receive never
// waits for a send of its own launch. Bound on the card: bytes (some KB at
// the sharded paths' shapes); what it waits for is the launch and the
// flags.
//
// peer_rank_reduce_kernel<T, OP> (OP 0: sum, 1: maximum; T float or
// double) replaces the XLA psum of the sharded MPC's cost
// (examples/mpc_sharded.py), the sum over chips of the shared control's
// cotangent that JAX's transpose of the replicated controls makes, the
// psums of the Krylov loops' dots (blitzdg_tpu/solvers/krylov.py,
// _reducers) and the lax.pmax of the element-sharded time step
// (blitzdg_tpu/parallel/halo.py, halo_sw2d_timestep); no TPU kernel. One
// block: this rank's n values into slot `rank` of every rank's reduction
// slots, then, once every rank's part has arrived in this rank's slots,
// the parts combined in rank order 0, 1, ..., S-1 in T: every rank
// combines the same values in the same order, so every rank holds the
// same bits. The maximum carries a NaN of any rank to every rank (the
// first in rank order), as pmax does. One system fence a launch: the
// arrivals (SIN) after a block barrier and thread 0's fence, as relaxed
// stores (block_fence's order); the slots' release (SGO) of the epoch
// before at the launch's start, as relaxed stores with no fence: the
// launch before on this rank's stream read those slots and has ended, its
// loads with it, so no store that a peer makes after seeing the release
// can reach a load of it. Bound: bytes.
//
// Plain C interface (extern "C" at the end), loaded with ctypes. The
// kernels launch on the stream passed in; nothing here synchronises
// except set-up (alloc, open, close, free).

#include <cuda_runtime.h>
#include <string.h>

#include "peer_flags.cuh"

// Where chunk i of B rows lies: a row every `row` words, chunk i at
// i x `stride` words in it.
struct ChunkLayout {
  int row, stride;
};

// Chunk i (cw words a row) of each of B rows of src (layout sl) into dst
// (layout dl); the block's threads share the work.
__device__ __forceinline__ void chunk_copy(unsigned* dst, ChunkLayout dl,
                                           const unsigned* src,
                                           ChunkLayout sl, int i, int cw,
                                           int B) {
  for (int k = threadIdx.x; k < B * cw; k += blockDim.x) {
    const int b = k / cw, j = k - b * cw;
    dst[(size_t)b * dl.row + (size_t)i * dl.stride + j] =
        __ldcg(src + (size_t)b * sl.row + (size_t)i * sl.stride + j);
  }
}

// The end of a block's part of an exchange or a reduction: a block barrier,
// then one fence at system scope by thread 0. True on thread 0 alone,
// whose relaxed flag stores after it (flag_store) are then release
// patterns (the order: the file's header); a release pattern is a fence
// and a strong store of one thread, so no other thread may store a flag.
__device__ __forceinline__ bool block_fence() {
  __syncthreads();
  if (threadIdx.x != 0) return false;
  __threadfence_system();
  return true;
}

// Chunk i of src (layout sl) into the receiving rank's slots `dst` (layout
// dl) once its GO flag `go` (this rank's memory) reads `free_at`; then the
// receiver's ARRIVED flag `arrived` set to e after block_fence. Thread 0
// waits; the whole block stores.
__device__ __forceinline__ void send_chunk(flag_t* go, flag_t free_at,
                                           flag_t* arrived, flag_t e,
                                           long long timeout_ns,
                                           unsigned* dst, ChunkLayout dl,
                                           const unsigned* src,
                                           ChunkLayout sl, int i, int cw,
                                           int B) {
  if (threadIdx.x == 0) flag_wait(go, free_at, timeout_ns);
  __syncthreads();
  chunk_copy(dst, dl, src, sl, i, cw, B);
  if (block_fence()) flag_store(arrived, e);
}

__global__ void peer_ring_exchange_kernel(const long long* tab,
                                          const float* sbuf, int B, int L) {
  const int i = blockIdx.x, cw = 3 * (int)tab[PT_CHUNK];
  const flag_t e = *peer_epoch(tab) + 1;
  const ChunkLayout lay = {3 * L, cw};
  send_chunk(peer_flag(tab, tab[PT_OWN], i, PEER_GOB), e,
             peer_flag(tab, peer_to(tab, i), i, PEER_INB), e,
             tab[PT_TIMEOUT],
             reinterpret_cast<unsigned*>(peer_to(tab, i) + tab[PT_RBB]), lay,
             reinterpret_cast<const unsigned*>(sbuf), lay, i, cw, B);
}

__global__ void peer_stage_exchange_kernel(const long long* tab, int rev,
                                           const unsigned* src, unsigned* out,
                                           int B, int row, int cw,
                                           int slot_cw, flag_t e) {
  const int n_off = (int)tab[SR_NOFF];
  const bool send = (int)blockIdx.x < n_off;
  const int i = send ? (int)blockIdx.x : (int)blockIdx.x - n_off;
  const long long own = tab[SR_OWN], timeout = tab[SR_TIMEOUT];
  const int go = rev ? SR_RGO : SR_FGO, in = rev ? SR_RIN : SR_FIN;
  // the buffers' rows and chunks; the slots' chunk i always at the same
  // place of the epoch's slot set, whatever the call's chunk (guarded by
  // the flags of chunk i)
  const ChunkLayout buf = {row, cw};
  const ChunkLayout sl = {n_off * slot_cw, slot_cw};
  if (send) {
    const long long to = rev ? sr_from(tab, i) : sr_to(tab, i);
    // (the slot set of e's parity is free once epoch e - 2 is read)
    send_chunk(sr_flag(tab, own, i, go), e - 1, sr_flag(tab, to, i, in), e,
               timeout, reinterpret_cast<unsigned*>(sr_slots(tab, to, rev, e)),
               sl, src, buf, i, cw, B);
    return;
  }
  const long long from = rev ? sr_to(tab, i) : sr_from(tab, i);
  if (threadIdx.x == 0) flag_wait(sr_flag(tab, own, i, in), e, timeout);
  __syncthreads();
  chunk_copy(out, buf,
             reinterpret_cast<const unsigned*>(sr_slots(tab, own, rev, e)),
             sl, i, cw, B);
  if (block_fence()) flag_store(sr_flag(tab, from, i, go), e + 1);
}

// The combination of two parts: their sum, or their maximum with a NaN
// kept (the first operand's if both are NaN).
template <class T, int OP>
__device__ __forceinline__ T rank_combine(T acc, T x) {
  if (OP == 0) return acc + x;
  if (acc != acc) return acc;
  return (x != x || x > acc) ? x : acc;
}

template <class T, int OP>
__global__ void peer_rank_reduce_kernel(const long long* tab, const T* x,
                                        T* out, int n, flag_t e) {
  const int S = (int)tab[SR_S], r = (int)tab[SR_RANK];
  const int len = (int)(tab[SR_SUMBYTES] / (long long)sizeof(T));
  const long long own = tab[SR_OWN], timeout = tab[SR_TIMEOUT];
  // epoch e - 1's parts read here (this rank's launch before has ended):
  // slot p of this rank free for p's part of epoch e; then this rank's part
  // into slot r of every rank, once each such slot is free
  for (int p = threadIdx.x; p < S; p += blockDim.x) {
    flag_store(sr_sum_flag(tab, sr_rank(tab, p), r, SR_SGO), e);
    flag_wait(sr_sum_flag(tab, own, p, SR_SGO), e, timeout);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < S * n; k += blockDim.x) {
    const int p = k / n, j = k - p * n;
    reinterpret_cast<T*>(sr_rank(tab, p) + tab[SR_SUM])[r * len + j] = x[j];
  }
  if (block_fence())
    for (int p = 0; p < S; ++p)
      flag_store(sr_sum_flag(tab, sr_rank(tab, p), r, SR_SIN), e);
  for (int p = threadIdx.x; p < S; p += blockDim.x)
    flag_wait(sr_sum_flag(tab, own, p, SR_SIN), e, timeout);
  __syncthreads();
  // every part here: combined in rank order
  const T* slot = reinterpret_cast<const T*>(own + tab[SR_SUM]);
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    T acc = __ldcg(slot + j);
    for (int p = 1; p < S; ++p)
      acc = rank_combine<T, OP>(acc, __ldcg(slot + p * len + j));
    out[j] = acc;
  }
}

template <class T, int OP>
static int launch_reduce(const long long* tab, const void* x, void* out,
                         int n, flag_t e, int threads, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(threads);
  cfg.stream = (cudaStream_t)stream;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, peer_rank_reduce_kernel<T, OP>, tab, static_cast<const T*>(x),
      static_cast<T*>(out), n, e);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" {

int peer_handle_bytes() { return (int)sizeof(cudaIpcMemHandle_t); }

// Loads the kernels of this file into the current context now, as
// sw2d_step_rdma_peer_load does the step's (CUDA's lazy loading would at
// a kernel's first launch, waiting for the context's running kernels).
int peer_load() {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, peer_ring_exchange_kernel);
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&attr, peer_stage_exchange_kernel);
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&attr, peer_rank_reduce_kernel<float, 0>);
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&attr, peer_rank_reduce_kernel<float, 1>);
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&attr, peer_rank_reduce_kernel<double, 0>);
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&attr, peer_rank_reduce_kernel<double, 1>);
  return (int)e;
}

const char* peer_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// One region of `bytes` on device `dev`, zeroed before it returns.
int peer_alloc(int dev, size_t bytes, void** out) {
  cudaError_t e;
  if ((e = cudaSetDevice(dev)) != cudaSuccess) return (int)e;
  if ((e = cudaMalloc(out, bytes)) != cudaSuccess) return (int)e;
  if ((e = cudaMemset(*out, 0, bytes)) != cudaSuccess) return (int)e;
  return (int)cudaDeviceSynchronize();
}

int peer_free(void* ptr) { return (int)cudaFree(ptr); }

// The IPC handle of a region (peer_handle_bytes() bytes into `handle`).
int peer_export(void* ptr, void* handle) {
  cudaIpcMemHandle_t h;
  const cudaError_t e = cudaIpcGetMemHandle(&h, ptr);
  if (e == cudaSuccess) memcpy(handle, &h, sizeof h);
  return (int)e;
}

// Another process's region in this one (a handle may be opened once a
// process; a process cannot open its own).
int peer_open(int dev, const void* handle, void** out) {
  cudaError_t e;
  if ((e = cudaSetDevice(dev)) != cudaSuccess) return (int)e;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof h);
  return (int)cudaIpcOpenMemHandle(out, h, cudaIpcMemLazyEnablePeerAccess);
}

int peer_close(void* ptr) { return (int)cudaIpcCloseMemHandle(ptr); }

// The step-boundary exchange of this rank's send buffer sbuf (B, L, 3) over
// the ring's table (n_off ring offsets).
int peer_ring_exchange(const long long* tab, const float* sbuf, int n_off,
                       int B, int L, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_off);
  cfg.blockDim = dim3(256);
  cfg.stream = (cudaStream_t)stream;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, peer_ring_exchange_kernel, tab, sbuf, B, L);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// A ring's exchange of src into out over its table (n_off ring offsets),
// forward or (rev) reverse, epoch e of that use: chunk i (cw words) of each
// of B rows of `row` words, at i x cw in a row; in the slots at i x
// slot_cw in rows of n_off x slot_cw words. (threads: a block's, a
// multiple of 32.)
int peer_stage_exchange(const long long* tab, int rev, const void* src,
                        void* out, int n_off, int B, int row, int cw,
                        int slot_cw, unsigned long long e, int threads,
                        void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * n_off);  // a send and a receive block an offset
  cfg.blockDim = dim3(threads);
  cfg.stream = (cudaStream_t)stream;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, peer_stage_exchange_kernel, tab, rev,
      static_cast<const unsigned*>(src), static_cast<unsigned*>(out), B, row,
      cw, slot_cw, (flag_t)e);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// A ring's sum (op 0) or maximum (op 1) over its ranks of x (n values of
// type `dtype`, 0 float or 1 double, at most the table's SR_SUMBYTES) into
// out, epoch e of the reductions.
int peer_rank_reduce(const long long* tab, int op, int dtype, const void* x,
                     void* out, int n, unsigned long long e, int threads,
                     void* stream) {
  const flag_t f = (flag_t)e;
  if (dtype == 0)
    return op == 0 ? launch_reduce<float, 0>(tab, x, out, n, f, threads, stream)
                   : launch_reduce<float, 1>(tab, x, out, n, f, threads, stream);
  if (dtype == 1)
    return op == 0
               ? launch_reduce<double, 0>(tab, x, out, n, f, threads, stream)
               : launch_reduce<double, 1>(tab, x, out, n, f, threads, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
