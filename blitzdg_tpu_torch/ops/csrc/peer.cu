// Device memory that other processes map, and the step-boundary exchange
// of the one-launch sharded step over it, sm_90a.
//
//   peer_alloc / peer_free      one zeroed cudaMalloc region of this rank
//   peer_export / peer_open /   its CUDA IPC handle, and a peer's region
//   peer_close                  mapped into this process (on one card, or a
//                               peer card's memory over NVLink)
//   peer_ring_exchange_kernel   the step-boundary exchange of a ring's
//                               initial send buffer
//
// Regions come from cudaMalloc, not from the torch caching allocator: that
// allocator sub-allocates (a handle names its whole segment), and its
// expandable segments are cuMemCreate memory, which cudaIpcGetMemHandle
// refuses.
//
// peer_ring_exchange_kernel replaces the XLA ppermute of the carried send
// buffer that precedes the TPU one-launch step in
// blitzdg_tpu/parallel/blocked_shard.py (make_sharded_blocked_step_rdma);
// it replaces no TPU kernel. A ring runs it once, before its first step:
// every later step's exchange is the step launch's own (its stage 2 stores
// each send slot into the receiving rank's step-boundary slots and
// releases INB there; sw2d_blocked.cu, rdma_step), so a step is one
// launch. One block a ring offset i: it waits until the receiving rank's
// step-boundary slots of chunk i are free (GOB; the ring starts with them
// free), stores chunk i of every scenario into them, fences at system
// scope and releases INB there, which the receiving rank's first step
// launch waits for. The epoch is read from this rank's region, where the
// step launch keeps it. Bound on the card: bytes (B x chunk x 3 floats an
// offset read here and written into the peer, some KB at the sharded
// path's shapes); what it waits for is the launch and the flags.
//
// Plain C interface (extern "C" at the end), loaded with ctypes. The
// exchange launches on the stream passed in; nothing here synchronises
// except set-up (alloc, open, close, free).

#include <cuda_runtime.h>
#include <string.h>

#include "peer_flags.cuh"

__global__ void peer_ring_exchange_kernel(const long long* tab,
                                          const float* sbuf, int B, int L) {
  const int i = blockIdx.x, cw = 3 * (int)tab[PT_CHUNK];
  flag_t e = 0;
  if (threadIdx.x == 0) {
    e = *peer_epoch(tab) + 1;
    flag_wait(peer_flag(tab, tab[PT_OWN], i, PEER_GOB), e, tab[PT_TIMEOUT]);
  }
  __syncthreads();
  float* dst = reinterpret_cast<float*>(peer_to(tab, i) + tab[PT_RBB]);
  for (int k = threadIdx.x; k < B * cw; k += blockDim.x) {
    const int b = k / cw;
    const size_t o = (size_t)b * L * 3 + (size_t)i * cw + (k - b * cw);
    dst[o] = sbuf[o];
  }
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0)
    flag_release(peer_flag(tab, peer_to(tab, i), i, PEER_INB), e);
}

extern "C" {

int peer_handle_bytes() { return (int)sizeof(cudaIpcMemHandle_t); }

// Loads the exchange kernel into the current context now, as
// sw2d_step_rdma_peer_load does the step's (CUDA's lazy loading would at
// its first launch, waiting for the context's running kernels).
int peer_load() {
  cudaFuncAttributes attr;
  return (int)cudaFuncGetAttributes(&attr, peer_ring_exchange_kernel);
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

}  // extern "C"
