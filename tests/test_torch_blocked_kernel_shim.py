"""The blocked and sharded kernels' CUDA source (``ops/csrc/sw2d_blocked.cu``:
the stage kernel ``sw2d_stage_kernel``, the one-launch step
``sw2d_step_rdma_kernel``, the blocked rollout ``sw2d_blocked_rollout_kernel``
(the step's kernel too) and both adjoints), compiled for the CPU with
``g++ -std=c++20 -pthread`` behind a shim header, against their plain
versions (``ops/sw2d_blocked.py``).

The kernels run several lanes an element that meet in shuffles and warp
barriers, and the step's blocks meet at a grid barrier. So every CUDA
thread of a launch is a host thread: ``threadIdx`` and ``blockIdx`` are
thread-local, ``__syncthreads`` is a ``std::barrier`` of the block,
``__syncwarp`` one of the warp, ``__shfl_xor_sync`` an exchange through a
per-warp buffer between two warp barriers, ``grid.sync()`` a
``std::barrier`` over every thread of the launch, and shared memory is a
buffer of the block. A cooperative launch runs all its blocks at once; an
ordinary one runs them in turn. The shim's device reports ``shim_sms``
multiprocessors and ``shim_per_sm`` resident blocks (set from the test
through ``ctypes``): few, so that the step's blocks loop over the items, or
enough for one pass (the step then keeps its lanes' nodes in registers
across the grid barrier). The launches go through the module's own launch
helpers (``_run_stage``, ``RdmaLaunch._launch``, ``_run_rollout``,
``_run_stage_bwd``, ``_run_rollout_bwd``), so the argument lists and the
launch plans are exercised too.

Cases, on ``box_triangles(8, 8)`` partitioned: coastal physics (bathymetry
with the well-balanced star fluxes, drag, Coriolis, tidal depth on the open
east side from t = 1, sponge toward it) with two controls, at N=3 (the
compile-time instance, four lanes an element) and N=1 (the run-time sizes,
one lane), at S=4 (ring offsets and flipped cut faces) and S=1, at B=3 and
B=1; N=3 without controls (its own instance); at N=1, B=3 the last block is
ragged; the stage and the step also at N=6 (their compile-time instance,
eight lanes an element). The stage kernel also on a wet/dry beach (the
limiter). The kernels run in float32; the reference is the plain version
in float64 on the same float32 inputs, with ``chip_smoke.py``'s tolerance:
5e-5 absolute on states near 10 (float32 rounding of two RHS evaluations),
1e-4 at N=6. Besides: the same bits on a rerun, and the step bit-equal to
two stage launches with the ring exchange between (both run the same stage
code, on quadrilaterals at N=4 in one instance, eight lanes an element:
the shim, compiled without contraction of products into FMAs, cannot see
an expression that the card's compiler contracts differently in two
kernels, which only ``chip_smoke.py``'s gates can). The blocked rollout
and the adjoints: their own sections below.
"""
import ctypes
import dataclasses
import shutil
import subprocess
import threading
import time

import numpy as np
import pytest
import torch

from blitzdg_tpu_torch.context import BC_OUT
from blitzdg_tpu_torch.mesh import box_quads, box_triangles
from blitzdg_tpu_torch.mpc.coastal_box import cfl_dt, retag_east_open
from blitzdg_tpu_torch.mpc.sharded_box import injectors
from blitzdg_tpu_torch.ops import _build
from blitzdg_tpu_torch.ops import sw2d_blocked as TB
from blitzdg_tpu_torch.ops.sw2d import SWPhysics
from blitzdg_tpu_torch.parallel import blocked_shard as BS
from blitzdg_tpu_torch.parallel import partition_mesh
from blitzdg_tpu_torch.parallel import peer as PR
from blitzdg_tpu_torch.parallel.halo import RingExchange
from blitzdg_tpu_torch.specgrid.quad import build_quad_context
from blitzdg_tpu_torch.specgrid.triangle import build_triangle_context
from blitzdg_tpu_torch.utils import build_sponge_coefficient

F32, F64 = torch.float32, torch.float64
FWD_ATOL = 5e-5
FWD_ATOL_N6 = 1e-4  # chip_smoke.py's at N=6

SHIM = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <chrono>
#include <cmath>
#include <cstddef>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <tuple>
#include <vector>
using std::max;
using std::min;
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
#define __shared__
// (internal linkage throughout: another shim library loaded into the same
// process must not share these)
// (thread-local, as the grid barrier is: each launch has its own, and the
// ranks of the peer cases launch at once)
struct shim_dim { unsigned x, y, z; };
static thread_local shim_dim threadIdx = {0, 0, 0}, blockIdx = {0, 0, 0};
static thread_local shim_dim blockDim = {1, 1, 1}, gridDim = {1, 1, 1};
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
static inline float4 make_float4(float x, float y, float z, float w) {
  float4 r = {x, y, z, w};
  return r;
}
// one block of a launch: its barrier, its warps' barriers, the exchange
// buffer of the shuffles, its shared memory
struct ShimBlock {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp;
  std::vector<float> xch;
  std::vector<float4> mem;
  unsigned orders = 0;  // its threads' system fences and release stores
};
static thread_local ShimBlock* shim_blk = nullptr;
static thread_local std::barrier<>* shim_grid = nullptr;
#define smem (reinterpret_cast<float*>(shim_blk->mem.data()))
static inline void __syncthreads() { shim_blk->bar->arrive_and_wait(); }
static inline void __syncwarp(unsigned = 0xffffffffu) {
  shim_blk->warp[threadIdx.x / 32]->arrive_and_wait();
}
// (a width that is not a power of two up to 32 is not valid on the card:
// the shim aborts rather than compute something)
static inline float __shfl_xor_sync(unsigned, float v, int m, int w = 32) {
  if (w < 1 || w > 32 || (w & (w - 1)) != 0) {
    std::fprintf(stderr, "__shfl_xor_sync: invalid width %d\n", w);
    std::abort();
  }
  const unsigned t = threadIdx.x, l = t & 31;
  shim_blk->xch[t] = v;
  __syncwarp();
  const unsigned src = (t & ~31u) | ((l & ~(unsigned)(w - 1))
                                     | ((l ^ (unsigned)m) & (w - 1)));
  const float r = shim_blk->xch[src];
  __syncwarp();
  return r;
}
static inline float __shfl_down_sync(unsigned, float, int) { return 0.0f; }
static inline float __fdividef(float a, float b) { return a / b; }
template <class T>
static inline T __ldg(const T* p) { return *p; }
template <class T>
static inline T __ldcg(const T* p) { return *p; }
static inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
// the peer mode's flags: a system fence a seq_cst fence, the trap an
// exception that ends the thread's part of its launch, the global timer
// the steady clock. A thread counts its system fences and its release
// stores at system scope (``shim_orders``): the ordering points on its
// path, which a launch logs by block where ``shim_log_orders`` is set
static thread_local unsigned shim_orders = 0;
static inline void __threadfence_system() {
  ++shim_orders;
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
struct ShimTrap {};
[[noreturn]] static inline void __trap() { throw ShimTrap{}; }
static inline void __nanosleep(unsigned ns) {
  std::this_thread::sleep_for(std::chrono::nanoseconds(ns));
}
static inline unsigned long long shim_clock_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}
static inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
static inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
static inline float cospif(float x) {
  return (float)std::cos(3.14159265358979323846 * (double)x);
}
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fmaf_rn(float a, float b, float c) {
  return std::fma(a, b, c);
}
static inline double __dadd_rn(double a, double b) { return a + b; }
static inline double __dmul_rn(double a, double b) { return a * b; }
static inline float __double2float_rn(double a) { return (float)a; }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorLaunchOutOfResources = 701, cudaErrorLaunchFailure = 719,
       cudaErrorCooperativeLaunchTooLarge = 720,
       cudaErrorNotSupported = 801 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrCooperativeLaunch = 95,
                      cudaDevAttrMultiProcessorCount = 16,
                      cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
// the device that the launcher asks about: its multiprocessors and the
// blocks of a kernel that one holds (set from the test), and the shared
// memory a block may have (the H100's 227 KB)
extern "C" { int shim_sms = 1, shim_per_sm = 1, shim_smem_optin = 232448; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
enum { cudaLaunchAttributeCooperative = 2 };
struct cudaLaunchAttribute {
  int id;
  struct { int cooperative; } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <class K>
static inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return 0;
}
// (loading a kernel: the host build has nothing to load)
struct cudaFuncAttributes { int maxThreadsPerBlock; };
template <class K>
static inline cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, K) {
  a->maxThreadsPerBlock = 1024;
  return 0;
}
static inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
static inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr a,
                                                 int) {
  *v = a == cudaDevAttrMultiProcessorCount            ? shim_sms
       : a == cudaDevAttrMaxSharedMemoryPerBlockOptin ? shim_smem_optin
                                                      : 1;
  return 0;
}
template <class K>
static inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, K, int, size_t) {
  *n = shim_per_sm;
  return 0;
}
template <class K>
static inline cudaError_t cudaLaunchCooperativeKernel(K, dim3, dim3, void**,
                                                      size_t, cudaStream_t) {
  return cudaErrorNotSupported;  // the kernels of the blocked rollouts
}
static inline cudaError_t cudaGetLastError() { return 0; }
// the log of the launches' ordering points: with shim_log_orders set, each
// block of each launch appends (blocks of its launch, its index, the
// system fences and release stores of its threads); shim_orders_read
// copies up to cap triples out and returns the log's triples,
// shim_orders_clear empties it
#include <mutex>
static std::mutex shim_log_mutex;
static std::vector<unsigned> shim_log;
extern "C" {
int shim_log_orders = 0;
int shim_orders_read(unsigned* out, int cap) {
  std::lock_guard<std::mutex> g(shim_log_mutex);
  const int n = (int)shim_log.size() / 3;
  std::copy(shim_log.begin(), shim_log.begin() + 3 * std::min(n, cap), out);
  return n;
}
void shim_orders_clear() {
  std::lock_guard<std::mutex> g(shim_log_mutex);
  shim_log.clear();
}
}
// the transport's set-up (peer.cu): host memory; no IPC on the host
struct cudaIpcMemHandle_t { char reserved[64]; };
enum { cudaIpcMemLazyEnablePeerAccess = 1 };
static inline const char* cudaGetErrorString(cudaError_t) { return "shim"; }
static inline cudaError_t cudaSetDevice(int) { return 0; }
static inline cudaError_t cudaDeviceSynchronize() { return 0; }
static inline cudaError_t cudaMalloc(void** p, size_t n) {
  *p = std::calloc(n, 1);
  return *p ? cudaSuccess : cudaErrorInvalidValue;
}
static inline cudaError_t cudaMemset(void* p, int v, size_t n) {
  std::memset(p, v, n);
  return 0;
}
static inline cudaError_t cudaFree(void* p) { std::free(p); return 0; }
static inline cudaError_t cudaIpcGetMemHandle(cudaIpcMemHandle_t*, void*) {
  return cudaErrorNotSupported;
}
static inline cudaError_t cudaIpcOpenMemHandle(void**, cudaIpcMemHandle_t,
                                               unsigned) {
  return cudaErrorNotSupported;
}
static inline cudaError_t cudaIpcCloseMemHandle(void*) {
  return cudaErrorNotSupported;
}
// a launch: each CUDA thread a host thread; a cooperative launch runs all
// its blocks at once (they meet at grid barriers), an ordinary one runs
// them in turn. A thread that traps leaves every barrier it belongs to,
// the others run on, and the launch fails.
template <class... P, class... A>
static inline cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                                             void (*f)(P...), A&&... args) {
  const std::tuple<P...> params(std::forward<A>(args)...);
  std::atomic<bool> trapped(false);
  bool coop = false;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    coop = coop || (cfg->attrs[i].id == cudaLaunchAttributeCooperative
                    && cfg->attrs[i].val.cooperative);
  const unsigned G = cfg->gridDim.x, T = cfg->blockDim.x;
  if (T % 32 != 0) return cudaErrorInvalidValue;
  if (coop && (int)G > shim_sms * shim_per_sm)
    return cudaErrorCooperativeLaunchTooLarge;
  auto run = [&](unsigned b0, unsigned b1) {
    std::vector<ShimBlock> blocks(b1 - b0);
    for (auto& b : blocks) {
      b.bar = std::make_unique<std::barrier<>>(T);
      for (unsigned w = 0; w < T / 32; ++w)
        b.warp.push_back(std::make_unique<std::barrier<>>(32));
      b.xch.assign(T, 0.0f);
      b.mem.assign(cfg->dynamicSmemBytes / sizeof(float4) + 1,
                   float4{0, 0, 0, 0});
    }
    std::barrier<> grid((b1 - b0) * T);
    std::vector<std::thread> ts;
    for (unsigned blk = b0; blk < b1; ++blk)
      for (unsigned i = 0; i < T; ++i)
        ts.emplace_back([f, &params, &blocks, &grid, &trapped, blk, b0, i,
                         T, G] {
          threadIdx = {i, 0, 0};
          blockIdx = {blk, 0, 0};
          blockDim = {T, 1, 1};
          gridDim = {G, 1, 1};
          shim_blk = &blocks[blk - b0];
          shim_grid = &grid;
          shim_orders = 0;
          try {
            std::apply(f, params);
          } catch (const ShimTrap&) {
            trapped = true;
            shim_blk->bar->arrive_and_drop();
            shim_blk->warp[i / 32]->arrive_and_drop();
            grid.arrive_and_drop();
          }
          __atomic_fetch_add(&shim_blk->orders, shim_orders,
                             __ATOMIC_SEQ_CST);
        });
    for (auto& t : ts) t.join();
    if (shim_log_orders) {
      std::lock_guard<std::mutex> g(shim_log_mutex);
      for (unsigned blk = b0; blk < b1; ++blk)
        shim_log.insert(shim_log.end(), {G, blk, blocks[blk - b0].orders});
    }
  };
  if (coop) run(0, G);
  else
    for (unsigned b = 0; b < G; ++b) run(b, b + 1);
  return trapped ? cudaErrorLaunchFailure : cudaSuccess;
}
"""

COOPERATIVE_GROUPS = r"""
#pragma once
#include "shim.h"
namespace cooperative_groups {
struct grid_group {
  void sync() const { shim_grid->arrive_and_wait(); }
};
static inline grid_group this_grid() { return grid_group{}; }
}  // namespace cooperative_groups
"""


# libcu++'s atomic_ref as the standard library's
CUDA_ATOMIC = r"""
#pragma once
#include <atomic>
namespace cuda {
enum thread_scope { thread_scope_system, thread_scope_device,
                    thread_scope_block, thread_scope_thread };
namespace std {
using ::std::memory_order_acquire;
using ::std::memory_order_relaxed;
using ::std::memory_order_release;
}  // namespace std
// (a release store at system scope counts as an ordering point of its
// thread: the shim's shim_orders)
template <class T, thread_scope S = thread_scope_system>
struct atomic_ref : ::std::atomic_ref<T> {
  explicit atomic_ref(T& t) : ::std::atomic_ref<T>(t) {}
  void store(T v, ::std::memory_order o) const noexcept {
    if (S == thread_scope_system && o == ::std::memory_order_release)
      ++shim_orders;
    ::std::atomic_ref<T>::store(v, o);
  }
};
}  // namespace cuda
"""


def _shim_source(src: str) -> str:
    """The kernels' source with shared memory a buffer of the block."""
    decl = "extern __shared__ float smem[];"
    assert src.count(decl) == 1
    return src.replace(decl, "")


def _shim_flags(src: str) -> str:
    """The flags' header with the steady clock for the global timer."""
    timer = 'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));'
    assert src.count(timer) == 1
    return src.replace(timer, "t = shim_clock_ns();")


@pytest.fixture(scope="module")
def shim_lib(tmp_path_factory):
    return build_shim_lib(tmp_path_factory)


def build_shim_lib(tmp_path_factory):
    """``sw2d_blocked.cu`` and ``peer.cu`` compiled with g++ behind the
    shim header into one library, loaded."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the kernel source cannot be "
                    "compiled for the CPU")
    d = tmp_path_factory.mktemp("blocked_shim")
    (d / "shim.h").write_text(SHIM)
    (d / "cuda_runtime.h").write_text('#pragma once\n#include "shim.h"\n')
    (d / "cooperative_groups.h").write_text(COOPERATIVE_GROUPS)
    (d / "cuda").mkdir()
    (d / "cuda" / "atomic").write_text(CUDA_ATOMIC)
    src = (_build.CSRC / "sw2d_blocked.cu").read_text()
    (d / "sw2d_blocked_shim.cu").write_text(_shim_source(src))
    # the transport's source in the same library (one translation unit:
    # the shim's device is defined once), and the flags' header that both
    # include (found first in this directory)
    (d / "peer.cu").write_text((_build.CSRC / "peer.cu").read_text())
    (d / "peer_flags.cuh").write_text(
        _shim_flags((_build.CSRC / "peer_flags.cuh").read_text()))
    (d / "both.cu").write_text('#include "sw2d_blocked_shim.cu"\n'
                               '#include "peer.cu"\n')
    lib = d / "libsw2d_blocked_shim.so"
    cmd = [gxx, "-std=c++20", "-pthread", "-O1", "-fno-strict-aliasing",
           "-shared", "-fPIC", "-w", "-include", str(d / "shim.h"), "-I",
           str(d), "-I", str(_build.CSRC), "-x", "c++", str(d / "both.cu"),
           "-o", str(lib)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-4000:]
    return ctypes.CDLL(str(lib))


SHUFFLE_PROBE = r"""
#include "shim.h"
// one thread of one warp: __shfl_xor_sync of lane 1's value at width argv[1]
int main(int argc, char** argv) {
  ShimBlock b;
  b.warp.push_back(std::make_unique<std::barrier<>>(1));
  b.xch.assign(32, 2.0f);
  shim_blk = &b;
  const int w = std::atoi(argv[1]);
  const float v = __shfl_xor_sync(0xffffffffu, 1.0f, 1, w);
  return v == (w == 1 ? 1.0f : 2.0f) ? 0 : 1;  // (width 1: its own)
}
"""


@pytest.fixture(scope="module")
def shuffle_probe(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the shim cannot be compiled")
    d = tmp_path_factory.mktemp("shuffle_probe")
    (d / "shim.h").write_text(SHIM)
    (d / "probe.cc").write_text(SHUFFLE_PROBE)
    exe = d / "probe"
    res = subprocess.run([gxx, "-std=c++20", "-pthread", "-O1", "-w", "-I",
                          str(d), str(d / "probe.cc"), "-o", str(exe)],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-4000:]
    return exe


@pytest.mark.parametrize("width, valid", [(1, True), (2, True), (8, True),
                                          (32, True), (0, False),
                                          (3, False), (5, False),
                                          (12, False), (64, False)])
def test_shim_shuffle_aborts_on_an_invalid_width(shuffle_probe, width, valid):
    """The shim's ``__shfl_xor_sync`` takes the card's widths (a power of
    two up to a warp) and aborts on any other, so that a kernel asking for
    one (a face of five nodes shuffled at width five) fails here instead
    of computing with a width the card does not take."""
    res = subprocess.run([str(shuffle_probe), str(width)],
                         capture_output=True, text=True)
    if valid:
        assert res.returncode == 0
    else:
        assert res.returncode != 0 and "invalid width" in res.stderr


@pytest.fixture
def device(shim_lib, monkeypatch):
    """The module's launch helpers on the shim library; set the shim
    device's multiprocessors and resident blocks through the returned
    function (the launch plans are made anew for each setting)."""
    monkeypatch.setattr(_build, "load", lambda name: shim_lib)
    monkeypatch.setattr(TB, "_plans", {})
    sms = ctypes.c_int.in_dll(shim_lib, "shim_sms")
    per_sm = ctypes.c_int.in_dll(shim_lib, "shim_per_sm")

    def set_device(n_sms, n_per_sm):
        sms.value, per_sm.value = n_sms, n_per_sm
        TB._plans.clear()

    yield set_device
    set_device(1, 1)


def _context(n_order, wetdry=False, n_shards=1, cells=(8, 8), quads=False):
    """The coastal box (its east side open) or the beach of the wet/dry
    cases, of triangles or (``quads``) quadrilaterals, partitioned into
    ``n_shards`` where more than one."""
    box = box_quads if quads else box_triangles
    if wetdry:
        mesh = box(*cells, xlim=(0.0, 1.0), ylim=(0.0, 1.0))
    else:
        mesh = box(*cells)
        retag_east_open(mesh)
    if n_shards > 1:
        mesh = partition_mesh(mesh, n_shards)[0]
    build = build_quad_context if quads else build_triangle_context
    return build(n_order, mesh, dtype=F64, device="cpu",
                 filter_cutoff=0.9 * n_order, filter_order=4)


def _physics(ctx, wetdry, n_ctrl, rng, spread_injectors=False):
    """Coastal physics (bathymetry with the well-balanced star fluxes, drag,
    Coriolis, tidal depth on the open east side from t = 1, sponge toward
    it; injectors of ``n_ctrl`` = 2 controls, or none) or the wet/dry
    beach's: (phys, the operator sets' keywords, H, dt, start time)."""
    kw = {}
    if wetdry:
        H = 1.0 - 1.5 * ctx.x
        phys = SWPhysics(g=9.81, cd=1e-3, H=H, Hx=-1.5 * torch.ones_like(H),
                         Hy=torch.zeros_like(H), well_balanced=False)
        kw.update(wetdry=True, h_floor=1e-3)
        return phys, kw, H, cfl_dt(ctx, 9.81, 1.1), 0.0
    H = 10.0 + 2.0 * ctx.x + torch.sin(2.0 * ctx.y)
    open_nodes = (ctx.bc_table[:, :, None].expand(-1, -1, ctx.n_fp)
                  .reshape(ctx.k_elem, -1) == BC_OUT).numpy()
    phys = SWPhysics(g=9.81, cd=2.5e-3, f_cor=1e-4, H=H,
                     Hx=2.0 * torch.ones_like(H),
                     Hy=2.0 * torch.cos(2.0 * ctx.y),
                     sponge=build_sponge_coefficient(
                         ctx, open_nodes, width=0.3, strength=0.5))
    kw["tidal"] = (12.0, 0.5, 2.0, 10.0)
    if n_ctrl:
        bu, bv = injectors(ctx)
        if spread_injectors:  # every element forced
            bu, bv = (rng.uniform(0.5, 1.0, a.shape) for a in (bu, bv))
        kw.update(forcing_bu=bu, forcing_bv=bv)
    return phys, kw, H, cfl_dt(ctx, 9.81, 13.5), 1.0


def _scenarios(ctx, H, batch, wetdry, rng):
    """``batch`` perturbed (h, hu, hv) rows (numpy): on the box a bump of
    random height and place, a random current and node-wise noise; on the
    beach a wave of random height, dry beyond x = 2/3."""
    x = ctx.x.reshape(1, -1).numpy()
    y = ctx.y.reshape(1, -1).numpy()
    Hn = H.reshape(1, -1).numpy()
    col = lambda lo, hi: rng.uniform(lo, hi, (batch, 1))
    if wetdry:
        wave = 0.05 * np.exp(-30.0 * ((x - 0.45) ** 2 + (y - 0.5) ** 2))
        h = np.maximum(Hn + col(1.0, 1.4) * wave, 1e-3)
        wet = (h > 5e-3).astype(float)
        hu = wet * h * (0.3 + 0.05 * rng.standard_normal(h.shape))
        hv = wet * h * 0.1 * rng.standard_normal(h.shape)
        assert (h <= 1e-3).any() and (h > 0.5).any()
        return h, hu, hv
    bump = np.exp(-10.0 * ((x - col(-0.5, 0.5)) ** 2
                           + (y - col(-0.5, 0.5)) ** 2))
    noise = lambda: 0.01 * rng.standard_normal((batch, x.shape[1]))
    h = Hn + col(0.05, 0.3) * bump + noise()
    hu = col(-0.1, 0.1) * h + noise()
    hv = col(-0.1, 0.1) * h + noise()
    return h, hu, hv


class Case:
    """The coastal box (or the wet/dry beach) partitioned into ``n_shards``
    at one order, as float32 (the kernels' operator set) and float64 (the
    reference's) sharded sets, a perturbed float32 state of ``batch``
    scenarios and a control vector."""

    def __init__(self, n_order, n_shards, batch, n_ctrl=2, wetdry=False,
                 seed=0, cells=(8, 8), spread_injectors=False, quads=False):
        rng = np.random.default_rng(seed)
        self.ctx = ctx = _context(n_order, wetdry, n_shards, cells, quads)
        phys, kw, H, self.dt, self.t = _physics(ctx, wetdry, n_ctrl, rng,
                                                spread_injectors)
        self.sets = {dt: BS.build_sharded_blocked(ctx, phys, n_shards,
                                                  dtype=dt, device="cpu",
                                                  **kw)
                     for dt in (F32, F64)}
        sb = self.sets[F32]
        m = sb.meta
        # without injectors a set carries one zero injector
        assert m.n_ctrl == (n_ctrl if n_ctrl and not wetdry else 1)
        if n_shards > 1:
            # ring offsets; on triangles flipped cut faces too (the box's
            # quadrilaterals have none; S=2 has the one offset 1, and the
            # box cut in two no flipped cut face)
            plan = sb.plan
            assert len(plan.offs) >= min(2, n_shards - 1) and (
                quads or n_shards == 2 or bool(
                    (plan.pflip.astype(bool)
                     & (plan.psrc >= plan.psrc.shape[1])).any()))
        self.state = tuple(BS.split_shards(torch.as_tensor(f, dtype=F32),
                                           n_shards)
                           for f in _scenarios(ctx, H, batch, wetdry, rng))
        self.ctrl = (torch.as_tensor(0.3 * rng.standard_normal(m.n_ctrl),
                                     dtype=F32)
                     if n_ctrl and not wetdry else None)
        self.ex = {dt: RingExchange(self.sets[dt].plan, m.n_fp, device="cpu")
                   for dt in (F32, F64)}
        self.rb = self.ex[F32](BS.initial_send_buffer(sb, self.state))

    def ref(self, fn, *args, **kw):
        """The plain version in float64 on the float32 inputs, as float32."""
        sb = self.sets[F64]
        out = fn(sb.ops, sb.meta, *(_up(a) for a in args), **kw)
        return tuple(None if t is None else t.to(F32) for t in out)

    def stage(self, base, cur, rb, c_dt, t, sponge):
        sb = self.sets[F32]
        return TB._run_stage(sb.ops, sb.meta, base, cur, rb, c_dt, t,
                             self.ctrl, True, sponge)


def _up(a):
    """Tensors (in tuples too) to float64."""
    return (a.to(F64) if torch.is_tensor(a) else
            tuple(_up(b) for b in a) if isinstance(a, tuple) else a)


def _max_abs(xs, ys):
    return max(float((a - b).abs().max()) for a, b in zip(xs, ys))


def _same(xs, ys):
    return all(torch.equal(a, b) for a, b in zip(xs, ys))


# (N, shards, batch, controls, shim device (SMs, blocks an SM))
CASES = {
    "N3_S4_B3": (3, 4, 3, 2, (2, 1)),    # the step's blocks loop
    "N3_S4_B1": (3, 4, 1, 2, (4, 1)),    # one pass: nodes kept in registers
    "N3_S1_B1_noctrl": (3, 1, 1, 0, (2, 1)),
    "N1_S4_B3": (1, 4, 3, 2, (2, 1)),    # ragged last block
    "N1_S1_B1": (1, 1, 1, 2, (1, 1)),
    "N1_S4_B3_noctrl": (1, 4, 3, 0, (2, 1)),  # the run-time sizes in B8
}


@pytest.mark.parametrize("name", list(CASES))
def test_stage_kernel_matches_plain(device, name):
    n, S, B, nc, dev = CASES[name]
    device(*dev)
    c = Case(n, S, B, nc)
    st, dt, t = c.state, c.dt, c.t
    got1 = c.stage(st, st, c.rb, 0.5 * dt, t, False)
    ref1 = c.ref(TB.sw2d_stage_blocked_plain, st, st, c.rb, 0.5 * dt, t,
                 c.ctrl, True, False)
    assert _max_abs(got1, ref1) <= FWD_ATOL
    cur, rb2 = tuple(got1[:3]), c.ex[F32](got1[3])
    got2 = c.stage(st, cur, rb2, dt, t + 0.5 * dt, True)
    ref2 = c.ref(TB.sw2d_stage_blocked_plain, st, cur, rb2, dt, t + 0.5 * dt,
                 c.ctrl, True, True)
    assert all(torch.isfinite(f).all() for f in got2)
    assert _max_abs(got2, ref2) <= FWD_ATOL
    assert _same(got2, c.stage(st, cur, rb2, dt, t + 0.5 * dt, True))


@pytest.mark.parametrize("name", list(CASES))
def test_step_kernel_matches_plain_and_two_stages(device, name):
    n, S, B, nc, dev = CASES[name]
    device(*dev)
    c = Case(n, S, B, nc, seed=1)
    sb = c.sets[F32]
    launch = TB.RdmaLaunch(sb.ops, sb.meta, c.ex[F32])
    got = launch._launch(c.state, c.rb, c.dt, c.t, c.ctrl, True)
    plan = TB.shard_plan(sb.ops, sb.meta, B, step=True)
    assert plan["lanes_per_element"] == (4 if n == 3 else 1)
    ref = c.ref(TB.sw2d_step_rdma_blocked_plain, c.state, c.rb, c.dt,
                c.ex[F64], c.t, c.ctrl)
    assert all(torch.isfinite(f).all() for f in got)
    assert _max_abs(got, ref) <= FWD_ATOL
    assert _same(got, launch._launch(c.state, c.rb, c.dt, c.t, c.ctrl, True))
    # two stage launches, the ring exchange between: the same bits
    *s1, sb1 = c.stage(c.state, c.state, c.rb, 0.5 * c.dt, c.t, False)
    two = c.stage(c.state, tuple(s1), c.ex[F32](sb1), c.dt, c.t + 0.5 * c.dt,
                  True)
    assert _same(got, two)


def test_stage_kernel_limits_wetdry(device):
    """The positivity limiter across an element's four lanes (N=3) and in
    one lane (N=1) on a beach that is dry beyond x = 2/3."""
    device(2, 1)
    for n in (3, 1):
        c = Case(n, 4, 3, wetdry=True)
        st, dt = c.state, c.dt
        got = c.stage(st, st, c.rb, 0.5 * dt, 0.0, False)
        ref = c.ref(TB.sw2d_stage_blocked_plain, st, st, c.rb, 0.5 * dt, 0.0,
                    None, True, False)
        assert all(torch.isfinite(f).all() for f in got)
        assert _max_abs(got, ref) <= FWD_ATOL


def test_plan_follows_the_occupancy(device, shim_lib):
    """The launcher's block at the sharded rollout's shapes (512 elements a
    shard, N=3) on a device of 132 SMs: the largest block that still gives
    every SM one; the step's grid is what is co-resident."""
    c = Case(3, 4, 1)
    lib = TB._lib()
    desc = TB._desc(c.sets[F32].meta._replace(k_elem=512, n_v=5120,
                                              n_t=6144),
                    blocked=True, n_recv=192, n_send=192)
    plan = (ctypes.c_int * 4)()

    def threads_grid(S, B, which, per_sm):
        device(132, per_sm)
        assert lib.sw2d_shard_plan(ctypes.byref(desc), S, B, which, 1 << 20,
                                   1 << 20, plan) == 0
        return plan[0], plan[1]

    # S=4, B=8: 65536 lanes, 256 blocks of 256 threads, two an SM resident
    assert threads_grid(4, 8, TB._RDMA, 2) == (256, 256)
    assert threads_grid(4, 8, TB._RDMA, 1) == (256, 132)  # the blocks loop
    assert threads_grid(4, 8, TB._STAGE, 1) == (256, 256)
    # B=1: 8192 lanes in 256 blocks of one warp
    assert threads_grid(4, 1, TB._RDMA, 8) == (32, 256)
    assert plan[2] == 4 * (420 + 8 * 100) and plan[3] == 4


def test_plan_fits_shared_memory_at_high_order(device, shim_lib):
    """At N=6 (28 nodes, 7 a face) the forward kernels take their
    compile-time instance, eight lanes an element, whose block of 256
    threads fits the 227 KB a block may have; the adjoints take the
    run-time sizes, one lane an element, whose block of 256 items would
    not: the launcher halves the block until it fits, and on a device with
    less shared memory it halves the forward kernels' block too. Past N=6
    the kernels have no room, and the wrapper says so."""
    c = Case(1, 4, 1)
    lib = TB._lib()
    meta = c.sets[F32].meta

    def desc_at(n_p, n_fp, n_halo=192):
        return TB._desc(meta._replace(k_elem=2048, n_p=n_p, n_fp=n_fp,
                                      n_v=2048 * n_p, n_t=2048 * 3 * n_fp),
                        blocked=True, n_recv=n_halo, n_send=n_halo)

    desc = desc_at(28, 7)
    plan = (ctypes.c_int * 4)()
    optin = ctypes.c_int.in_dll(shim_lib, "shim_smem_optin").value

    def plan_of(d, S, which, per_sm):
        device(132, per_sm)
        assert lib.sw2d_shard_plan(ctypes.byref(d), S, 8, which, 1 << 20,
                                   1 << 20, plan) == 0
        return plan[0], plan[1], plan[3]

    # S=4 x B=8 x 2048 elements: 65536 items
    forward = 4 * (2940 + 32 * 224)
    assert plan_of(desc, 4, TB._STAGE, 1) == (256, 2048, 8)
    assert plan[2] == forward <= optin
    assert plan_of(desc, 4, TB._RDMA, 1) == (256, 132, 8)
    # the blocked rollout at B=8, K=2048 (16384 items, 512 blocks): two
    # blocks an SM resident, so the blocks loop
    assert plan_of(desc_at(28, 7, 0), 1, TB._ROLLOUT, 2) == (256, 264, 8)
    assert plan[2] == forward
    for which, grid in ((TB._STAGE_BWD, 1024), (TB._ROLLOUT_BWD, 132)):
        assert plan_of(desc, 4, which, 1) == (64, grid, 1)
        assert plan[2] <= optin < 4 * (3528 + 128 * 644)
    # a device with less shared memory a block: smaller blocks still
    ctypes.c_int.in_dll(shim_lib, "shim_smem_optin").value = 32 * 1024
    try:
        assert plan_of(desc, 4, TB._STAGE, 1)[0] == 128
        assert plan[2] <= 32 * 1024
    finally:
        ctypes.c_int.in_dll(shim_lib, "shim_smem_optin").value = optin
    # N=7 (36 nodes): refused by the launcher and, with its reason, by the
    # wrapper
    assert lib.sw2d_shard_plan(ctypes.byref(desc_at(36, 8)), 4, 8,
                               TB._STAGE, 1 << 20, 1 << 20, plan) != 0
    with pytest.raises(ValueError, match="N <= 6"):
        TB._shard_plan(lib, desc_at(36, 8), c.sets[F32].ops, 8, TB._STAGE)


def test_stage_and_step_kernels_at_order_six(device):
    """B7 and B9 at N=6 on their compile-time instance (eight lanes an
    element, the eighth holding no trace node): stage 1 and the step
    against their plain versions at chip_smoke.py's N=6 tolerance, the
    step bit-equal to two stage launches with the ring exchange between,
    eight lanes in both plans."""
    device(2, 1)
    c = Case(6, 4, 1, seed=5)
    sb = c.sets[F32]
    st, dt, t = c.state, c.dt, c.t
    *s1, sb1 = c.stage(st, st, c.rb, 0.5 * dt, t, False)
    ref1 = c.ref(TB.sw2d_stage_blocked_plain, st, st, c.rb, 0.5 * dt, t,
                 c.ctrl, True, False)
    assert _max_abs((*s1, sb1), ref1) <= FWD_ATOL_N6
    launch = TB.RdmaLaunch(sb.ops, sb.meta, c.ex[F32])
    got = launch._launch(st, c.rb, dt, t, c.ctrl, True)
    ref = c.ref(TB.sw2d_step_rdma_blocked_plain, st, c.rb, dt, c.ex[F64], t,
                c.ctrl)
    assert all(torch.isfinite(f).all() for f in got)
    assert _max_abs(got, ref) <= FWD_ATOL_N6
    two = c.stage(st, tuple(s1), c.ex[F32](sb1), dt, t + 0.5 * dt, True)
    assert _same(got, two)
    for step in (False, True):
        assert TB.shard_plan(sb.ops, sb.meta, 1,
                             step=step)["lanes_per_element"] == 8


# ---------------------------------------------------------------------------
# The one-launch step across ranks: its peer mode and the step-boundary
# exchange (ops/csrc/peer.cu) over the flags of ops/csrc/peer_flags.cuh
# ---------------------------------------------------------------------------
#
# S ranks in one process: S zeroed regions of host memory laid out as
# ``parallel.peer.region_layout`` says, each rank's ``PeerRing`` over plain
# pointers into the others (``PeerRing.over_regions``), each rank a host
# thread that launches its exchange and its step in turn (the launches on
# the shim device run their CUDA threads as host threads, each launch with
# its own grid barrier). The ranks' launches run at once and meet only
# through the flags: READY and ARRIVED a ring offset, the system-scope
# acquire and release as the standard library's atomic_ref, the trap an
# exception that fails the launch.

PEER_STEPS = 3
# (N, shards, batch, cells, shim device (SMs, blocks an SM), quadrilaterals)
PEER_CASES = {
    # one ring offset, rank + 1 and rank - 1 the same peer; the blocks loop
    "N3_S2_B3": (3, 2, 3, (8, 8), (1, 1), False),
    "N1_S3_B1": (1, 3, 1, (6, 6), (2, 1), False),  # run-time sizes
    "N3_S4_B1": (3, 4, 1, (8, 8), (2, 1), False),  # three offsets
    # quadrilaterals at N=4 (QOrder4Quad, eight lanes an element, lanes 5-7
    # masked on the faces): three offsets, cut faces on x = 0 and y = 0, a
    # rank's 16 items in two blocks of 64 threads, one pass
    "quads_N4_S4_B1": (4, 4, 1, (8, 8), (2, 1), True),
    # one offset; a rank's 96 items (768 lanes) in one block of 256
    # threads: its blocks loop, three passes
    "quads_N4_S2_B3_blocks_loop": (4, 2, 3, (8, 8), (1, 1), True),
}


def _rank_ops(ops, r):
    """Shard r's operator set, with its shard axis (one rank's set)."""
    return dataclasses.replace(ops, **{
        f.name: getattr(ops, f.name)[r:r + 1]
        for f in dataclasses.fields(ops)})


class PeerCase:
    """One case's sharded set, its stacked one-launch rollout (the
    reference) and its ranks' rollouts over peer rings."""

    def __init__(self, name):
        n, S, B, cells, self.dev, quads = PEER_CASES[name]
        self.c = Case(n, S, B, cells=cells, seed=7, quads=quads)
        self.S, self.B = S, B
        sb = self.c.sets[F32]
        self.sbuf0 = BS.initial_send_buffer(sb, self.c.state)

    def stacked(self, n_steps, trace=None):
        """The stacked rollout's end; ``trace``, a list, takes each step's
        (h, hu, hv, sb, stage-2 receive buffer)."""
        c, sb = self.c, self.c.sets[F32]
        launch = TB.RdmaLaunch(sb.ops, sb.meta, c.ex[F32])
        st, sbuf, t = c.state, self.sbuf0, c.t
        for _ in range(n_steps):
            *st, sbuf = launch._launch(tuple(st), c.ex[F32](sbuf), c.dt, t,
                                       c.ctrl, True)
            if trace is not None:
                trace.append((*st, sbuf, launch._scratch[1].clone()))
            t += c.dt
        return (*st, sbuf)

    def ranks(self, n_steps, delay=None, missing=(), timeout_s=30.0,
              join_s=240.0, trace=None):
        """Each rank's (h, hu, hv, sb) after ``n_steps`` steps (None where it
        failed or never ran), its error, its flags. ``delay``: (rank, every,
        seconds) slept before every ``every``-th step; ``missing``: ranks
        that never launch; ``trace``, a list a rank, takes each step's
        (h, hu, hv, sb, stage-2 receive slots) of the rank (the slots read
        by its thread between its step and its next, when no peer may store
        into them)."""
        c, sb = self.c, self.c.sets[F32]
        plan, n_fp = sb.plan, sb.meta.n_fp
        lay = PR.region_layout(self.B, sb.ops.send.shape[1], len(plan.offs))
        regions = [torch.zeros(lay["bytes"], dtype=torch.uint8)
                   for _ in range(self.S)]
        bases = {r: g.data_ptr() for r, g in enumerate(regions)}
        rings = [PR.PeerRing.over_regions(plan, n_fp, self.B, r, bases,
                                          "cpu", timeout_s)
                 for r in range(self.S)]
        out, errors = [None] * self.S, [None] * self.S

        def rank(r):
            try:
                launch = TB.RdmaLaunch(_rank_ops(sb.ops, r), sb.meta,
                                       rings[r])
                st = tuple(f[r:r + 1].clone() for f in c.state)
                sbuf, t = self.sbuf0[r:r + 1].clone(), c.t
                for k in range(n_steps):
                    if delay and r == delay[0] and k % delay[1] == 0:
                        time.sleep(delay[2])
                    # the initial send buffer through the exchange kernel
                    # (PR.peer_ring_exchange's first call launches it, on
                    # the card only); after that the step delivers its own
                    # and the ring takes back what the step returned
                    if k == 0:
                        rings[r]._deliver(sbuf)
                    rb = PR.peer_ring_exchange(rings[r], sbuf)
                    *st, sbuf = launch._launch(tuple(st), rb, c.dt, t,
                                               c.ctrl, True)
                    if trace is not None:
                        trace[r].append((*st, sbuf, rings[r].rb2.clone()))
                    t += c.dt
                out[r] = (*st, sbuf)
            except RuntimeError as e:
                errors[r] = e

        threads = [threading.Thread(target=rank, args=(r,), daemon=True)
                   for r in range(self.S) if r not in missing]
        t0 = time.monotonic()
        for th in threads:
            th.start()
        for th in threads:
            th.join(max(join_s - (time.monotonic() - t0), 0.0))
        assert not any(th.is_alive() for th in threads), \
            "a rank is still waiting: a wait that does not end"
        flags = [ring.flags.clone() for ring in rings]
        self.rings = rings
        self.rbb = [ring.rbb.clone() for ring in rings]
        return out, errors, flags


@pytest.mark.parametrize("name", list(PEER_CASES))
def test_peer_step_matches_the_stacked_step(device, name):
    """Each rank's state and send buffer after PEER_STEPS steps of the
    peer-mode step (the first after the exchange of the initial send
    buffer; each later one's step-boundary halo stored by its peers' steps),
    the ranks' launches at once: bit-equal to its shard of the stacked
    one-launch rollout, and the same bits on a rerun over fresh regions.
    Every flag reads the last epoch (GOB and INB one ahead: the next step's
    step-boundary slots, freed and filled), so no wait was skipped or
    doubled.

    Mutation checks of the quad cases' eight-lane items (made on a copy of
    the source): letting a lane past its element's 25 nodes (lanes 1-7 at
    their fourth node slot) store its values into the send slots of the
    last node, the stage-1 halo into the peers' stage-2 slots among them,
    fails both quad cases here (and three of
    ``test_stage_and_step_kernels_on_quads_match_plain``). Letting such a
    lane copy slots in ``q_send_to_peers`` (the last node's, or with the
    guard dropped the next element's) fails no test: the copy takes slot j
    of the rank's own send buffer into slot j of the receiver's, so a
    second copy carries the same bits, and only a read before the slot's
    own lane stored it could differ, a race that the shim's threads do not
    make happen. The guard keeps one writer a slot, as the design has
    it."""
    pc = PeerCase(name)
    device(*pc.dev)
    want = pc.stacked(PEER_STEPS)
    got, errors, flags = pc.ranks(PEER_STEPS)
    assert errors == [None] * pc.S
    for r in range(pc.S):
        assert _same(got[r], [f[r:r + 1] for f in want]), f"rank {r}"
    # each rank's step-boundary slots, filled by its peers' last steps: the
    # stacked gather of the last send buffers
    last_rb = pc.c.ex[F32](want[3])
    for r in range(pc.S):
        assert torch.equal(pc.rbb[r], last_rb[r:r + 1]), f"rank {r}"
    again = pc.ranks(PEER_STEPS)[0]
    for r in range(pc.S):
        assert _same(again[r], got[r])
    n_off = len(pc.c.sets[F32].plan.offs)
    for f in flags:
        want_flags = [PEER_STEPS] + [PEER_STEPS, PEER_STEPS,
                                     PEER_STEPS + 1, PEER_STEPS + 1] * n_off
        assert f.tolist() == want_flags


def test_peer_step_holds_with_a_delayed_rank(device):
    """S=4, rank 2 sleeping before every second step: the others wait at
    its flags, and after every step each rank's state, send buffer and
    stage-2 receive slots (the peers' stage-1 halo, guarded by IN2) are
    still its shard's bits of the stacked step's, as ``chip_smoke.py``'s
    long in-process run holds them on the card."""
    pc = PeerCase("N3_S4_B1")
    device(*pc.dev)
    want, got = [], [[] for _ in range(pc.S)]
    pc.stacked(PEER_STEPS, trace=want)
    _, errors, _ = pc.ranks(PEER_STEPS, delay=(2, 2, 0.3), trace=got)
    assert errors == [None] * pc.S
    for r in range(pc.S):
        assert len(got[r]) == PEER_STEPS
        for k in range(PEER_STEPS):
            assert _same(got[r][k], [f[r:r + 1] for f in want[k]]), (r, k)


def test_peer_step_traps_when_a_rank_never_launches(device):
    """S=2 with rank 1 absent: rank 0's exchange finds its first slots free
    (GOB starts at 1), its step waits for rank 1's chunk and traps after
    the ring's bound (0.3 s), which fails the launch: an error, not a
    hang (the test's own bound: 60 s)."""
    pc = PeerCase("N3_S2_B3")
    device(*pc.dev)
    t0 = time.monotonic()
    got, errors, flags = pc.ranks(1, missing=(1,), timeout_s=0.3, join_s=60.0)
    assert got == [None, None] and errors[1] is None
    assert isinstance(errors[0], RuntimeError)
    assert "sw2d_step_rdma_blocked" in str(errors[0])
    assert time.monotonic() - t0 < 60.0
    # rank 0's exchange stored its chunk and released rank 1's INB
    assert int(flags[1][4]) == 1 and int(flags[0][4]) == 0


def test_peer_ring_takes_only_the_last_steps_send_buffer(device):
    """After a ring's first step the step itself has stored its send buffer
    into the peers' step-boundary slots: ``ring(sbuf)`` then launches
    nothing and returns the slots for the send buffer that step returned,
    and refuses any other (a copy of it, the initial one), which it could
    not deliver."""
    pc = PeerCase("N3_S2_B3")
    device(*pc.dev)
    got, errors, _ = pc.ranks(2)
    assert errors == [None] * pc.S
    n0 = PR.peer_ring_exchange.launches
    for r, ring in enumerate(pc.rings):
        last = got[r][3]
        assert ring.carried is last
        assert ring(last).data_ptr() == ring.rbb.data_ptr()
        for other in (last.clone(), pc.sbuf0[r:r + 1].clone()):
            with pytest.raises(ValueError, match="last step returned"):
                ring(other)
    assert PR.peer_ring_exchange.launches == n0


@pytest.mark.parametrize("name", list(PEER_CASES))
def test_peer_plan_takes_the_stacked_steps_lanes(device, name):
    """The peer mode's plan for one rank's shard: the stacked step's lanes
    an element (four at N=3, one at N=1, eight on quadrilaterals at N=4),
    so that a rank's bits are its shard's of the stacked step, on small
    shards too (N3_S4_B1: 32 elements, 128 lanes on the shim device's 2
    SMs, where the stage adjoint would take sixteen); a cooperative grid of
    what is co-resident, one pass or blocks that loop as the case says."""
    pc = PeerCase(name)
    device(*pc.dev)
    sb = pc.c.sets[F32]
    plan = TB.shard_plan(_rank_ops(sb.ops, 0), sb.meta, pc.B, step=True,
                         peer=True)
    n, quads = PEER_CASES[name][0], PEER_CASES[name][5]
    P = {(3, False): 4, (1, False): 1, (4, True): 8}[n, quads]
    assert plan["lanes_per_element"] == P
    assert TB.shard_plan(sb.ops, sb.meta, pc.B,
                         step=True)["lanes_per_element"] == P
    items = pc.B * sb.meta.k_elem
    assert plan["grid"] == min(pc.dev[0] * pc.dev[1],
                               -(-items * P // plan["threads"]))
    if quads:  # (the quad cases say whether their blocks loop)
        assert (plan["grid"] * plan["threads"] >= items * P) == (
            "blocks_loop" not in name)


# ---------------------------------------------------------------------------
# The adjoints on qvjp: the sharded stage's (B8) and the blocked rollout's
# (B6)
# ---------------------------------------------------------------------------

# chip_smoke.py's adjoint tolerances: every entry of every cotangent
# relative to the largest entry of its reference, 99 % within the bulk
# bound, all within the kink bound (a near-tie of two speeds may be decided
# either way by float32 rounding)
BWD_RTOL_BULK, BWD_RTOL_MAX = 1e-5, 1e-3


def _check_adjoint(got, ref):
    assert all(torch.isfinite(f).all() for f in got)
    per = torch.cat([((x - y).abs() / (y.abs().max() + 1e-30)).reshape(-1)
                     for x, y in zip(got, ref)])
    assert float(torch.quantile(per, 0.99)) <= BWD_RTOL_BULK
    assert float(per.max()) <= BWD_RTOL_MAX


@pytest.mark.parametrize("name", list(CASES))
def test_stage_bwd_kernel_matches_plain(device, name):
    """B8 on stage 2's inputs (the stage-1 output and its exchanged send
    buffer) with the sponge, under random cotangents of the output and the
    send buffer: every cotangent, the control's per shard and scenario
    included, against the plain version; the same bits on a rerun; the
    launcher's plan (an ordinary launch over every item)."""
    n, S, B, nc, dev = CASES[name]
    device(*dev)
    c = Case(n, S, B, nc, seed=2)
    sb = c.sets[F32]
    m = sb.meta
    *s1, sb1 = c.stage(c.state, c.state, c.rb, 0.5 * c.dt, c.t, False)
    cur, rb2 = tuple(s1), c.ex[F32](sb1)
    L = sb.ops.send.shape[1]
    rng = np.random.default_rng(5)
    g = lambda *shape: torch.as_tensor(rng.standard_normal(shape), dtype=F32)
    lam, lsb = tuple(g(S, B, m.n_v) for _ in range(3)), g(S, B, L, 3)
    args = (cur, rb2, lam, lsb, c.dt, c.t + 0.5 * c.dt, c.ctrl, True, True)
    got = TB._run_stage_bwd(sb.ops, m, *args)
    ref = c.ref(TB.sw2d_stage_bwd_blocked_v2_plain, *args)
    assert (got[7] is None) == (c.ctrl is None)
    if c.ctrl is None:
        got, ref = got[:7], ref[:7]
    _check_adjoint(got, ref)
    again = TB._run_stage_bwd(sb.ops, m, *args)
    assert _same(got, again)
    # where the narrow items would not give each SM a block of 256 threads
    # (N3_S4_B1 on its device of 4 SMs, N1_S1_B1 on its one SM), 16 lanes
    # an element at N=3 and 8 at N=1 (with its two controls), else 4 at
    # N=3 and 1 at N=1
    plan = TB.shard_plan(sb.ops, m, B, adjoint=True)
    narrow = 4 if n == 3 else 1
    small = S * B * m.k_elem * narrow < dev[0] * 256
    wide = 16 if n == 3 else 8 if nc == 2 else narrow
    P = wide if small else narrow
    assert plan["lanes_per_element"] == P
    assert plan["grid"] == -(-S * B * m.k_elem * P // plan["threads"])


def test_stage_bwd_kernel_without_controls(device):
    """B8 on a set with injectors, asked for no control cotangent: the
    other cotangents are the same bits as when it is asked for."""
    device(2, 1)
    c = Case(3, 4, 3, seed=3)
    sb = c.sets[F32]
    m = sb.meta
    rng = np.random.default_rng(6)
    g = lambda *shape: torch.as_tensor(rng.standard_normal(shape), dtype=F32)
    lam = tuple(g(4, 3, m.n_v) for _ in range(3))
    lsb = g(4, 3, sb.ops.send.shape[1], 3)
    args = (c.state, c.rb, lam, lsb, 0.5 * c.dt, c.t)
    with_c = TB._run_stage_bwd(sb.ops, m, *args, c.ctrl, True, False)
    without = TB._run_stage_bwd(sb.ops, m, *args, None, True, False)
    assert without[7] is None
    assert _same(with_c[:7], without[:7])
    _check_adjoint(without[:7], c.ref(TB.sw2d_stage_bwd_blocked_v2_plain,
                                      *args, None, True, False)[:7])


@pytest.mark.parametrize("dev, lanes, grid", [((1, 1), 4, 3),
                                              ((3, 1), 16, 9)],
                         ids=["four_lanes", "sixteen_lanes"])
def test_stage_bwd_control_sum_across_blocks(device, dev, lanes, grid):
    """The control cotangent's two rounds when blocks and scenarios do not
    line up: 72 elements a scenario in blocks of 64 items (four lanes an
    element) or 16 (sixteen), so a block holds parts of two scenarios and a
    scenario spans several blocks (the block that completes a scenario adds
    its blocks' sums)."""
    device(*dev)
    c = Case(3, 1, 2, seed=4, cells=(6, 6), spread_injectors=True)
    sb = c.sets[F32]
    m = sb.meta
    assert m.k_elem == 72
    plan = TB.shard_plan(sb.ops, m, 2, adjoint=True)
    assert (plan["lanes_per_element"], plan["threads"],
            plan["grid"]) == (lanes, 256, grid)
    rng = np.random.default_rng(7)
    g = lambda *shape: torch.as_tensor(rng.standard_normal(shape), dtype=F32)
    lam = tuple(g(1, 2, m.n_v) for _ in range(3))
    lsb = g(1, 2, sb.ops.send.shape[1], 3)
    args = (c.state, c.rb, lam, lsb, c.dt, c.t, c.ctrl, True, True)
    got = TB._run_stage_bwd(sb.ops, m, *args)
    _check_adjoint(got, c.ref(TB.sw2d_stage_bwd_blocked_v2_plain, *args))
    assert _same(got, TB._run_stage_bwd(sb.ops, m, *args))
    # each launch leaves its counters of finished blocks at 0
    assert all(int(done.abs().sum()) == 0
               for _, done in TB._stage_bwd_scratch.values())


def test_stage_bwd_kernel_from_two_threads_at_once(device):
    """Two ranks of a ring in one process launch B8 on sets of the same
    shape at once (threads on the host build, streams on the card): each
    launch needs its own control sums' scratch and counters of finished
    blocks, and each thread's cotangents are the bits of the same launch
    made alone. With one scratch for both (keyed by the shape alone) the
    counters of one launch count the other's blocks, and the control
    cotangents come out wrong."""
    device(1, 1)
    c = Case(3, 4, 3, seed=8)
    sb = c.sets[F32]
    m = sb.meta
    rng = np.random.default_rng(9)
    g = lambda *shape: torch.as_tensor(rng.standard_normal(shape), dtype=F32)
    ranks = [_rank_ops(sb.ops, r) for r in range(2)]
    args = [((tuple(f[r:r + 1] for f in c.state), c.rb[r:r + 1],
              tuple(g(1, 3, m.n_v) for _ in range(3)),
              g(1, 3, sb.ops.send.shape[1], 3), c.dt, c.t, c.ctrl, True,
              True)) for r in range(2)]
    alone = [TB._run_stage_bwd(ranks[r], m, *args[r]) for r in range(2)]
    out = [[], []]

    def rank(r):
        for _ in range(3):
            out[r].append(TB._run_stage_bwd(ranks[r], m, *args[r]))

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for r in range(2):
        assert len(out[r]) == 3
        assert all(_same(got, alone[r]) for got in out[r])


class ForwardCase:
    """The coastal box (with ``n_ctrl`` = 2: two controls) or the wet/dry
    beach, unsharded at one order, as float32 and float64 blocked operator
    sets; ``batch`` perturbed float32 scenarios; with controls, ``n_cs``
    control steps of ``spc`` steps each, else ``n_cs * spc`` steps."""

    def __init__(self, n_order, batch, n_ctrl=2, wetdry=False, n_cs=2,
                 spc=2, seed=0, quads=False, cells=(8, 8)):
        rng = np.random.default_rng(seed)
        self.ctx = ctx = _context(n_order, wetdry, cells=cells, quads=quads)
        phys, kw, H, self.dt, self.t0 = _physics(ctx, wetdry, n_ctrl, rng)
        self.sets = {dt: TB.build_blocked_step_ops(ctx, phys, dtype=dt,
                                                   device="cpu", **kw)
                     for dt in (F32, F64)}
        ops, m = self.sets[F32]
        assert m.has_sponge != wetdry and m.wetdry == wetdry
        self.spc, self.n_steps = spc, n_cs * spc
        self.state = tuple(torch.as_tensor(f, dtype=F32)
                           for f in _scenarios(ctx, H, batch, wetdry, rng))
        self.ctrls = (torch.as_tensor(0.3 * rng.standard_normal(
            (batch, n_cs, m.n_ctrl)), dtype=F32)
            if n_ctrl and not wetdry else None)
        self.rng = rng  # (a subclass draws more from the same stream)

    def kernel(self, store_traj=True):
        """The rollout kernel through its launch helper: (trajectory triple,
        final triple), the one not asked for as Nones."""
        ops, m = self.sets[F32]
        n_cs = 0 if self.ctrls is None else self.ctrls.shape[1]
        return TB._run_rollout(ops, m, self.state, self.ctrls, n_cs, self.dt,
                               self.spc, self.n_steps, self.t0, True,
                               store_traj)

    def steps(self):
        """The step kernel launched for each step in turn (through the
        rollout's launch helper, as ``sw2d_step_blocked`` launches it): the
        states after each step."""
        ops, m = self.sets[F32]
        st, out = self.state, []
        for t in range(self.n_steps):
            c = (None if self.ctrls is None
                 else self.ctrls[:, t // self.spc].contiguous())
            st = TB._run_rollout(ops, m, st, c, 1, self.dt, 1, 1,
                                 self.t0 + t * self.dt, True, False)[1]
            out.append(st)
        return out

    def ref(self):
        """The plain rollout in float64 on the float32 inputs, as float32:
        the trajectory triple."""
        ops, m = self.sets[F64]
        out = TB.sw2d_rollout_blocked_plain(
            ops, m, *_up(self.state), _up(self.ctrls), self.dt, self.spc,
            self.n_steps, self.t0, True, store_traj=True)
        return tuple(t.to(F32) for t in out[:3])


class RolloutCase(ForwardCase):
    """The coastal box (bathymetry with the well-balanced star fluxes, drag,
    Coriolis, tidal depth on the open east side, sponge toward it, two
    controls, or with ``n_ctrl`` = 0 the set's one zero injector) unsharded
    at one order, as float32 and float64 blocked operator sets; ``batch``
    perturbed float32 scenarios (with ``east_tie``, a state whose nodes on
    the open east side all hold the same values: each east face's nodes
    then tie at the face maximum, against the tidal depth's jump, while
    inside the state varies along y, so that the stages after it have no
    ties), controls of ``n_cs`` steps, the plain float32 rollout's
    trajectory from t0 = 1 and random cotangents of it."""

    def __init__(self, n_order, batch, n_cs=2, spc=2, seed=0, quads=False,
                 cells=(8, 8), n_ctrl=2, east_tie=False):
        super().__init__(n_order, batch, n_ctrl=n_ctrl, n_cs=n_cs, spc=spc,
                         seed=seed, quads=quads, cells=cells)
        ops, m = self.sets[F32]
        assert m.wb and m.has_sponge and m.tidal is not None
        assert m.n_ctrl == (n_ctrl or 1)
        if not n_ctrl:  # controls of the zero injector: no effect
            self.ctrls = torch.as_tensor(0.3 * self.rng.standard_normal(
                (batch, n_cs, 1)), dtype=F32)
        if east_tie:
            x = self.ctx.x.reshape(1, -1)
            y = self.ctx.y.reshape(1, -1)
            h = (11.0 + 0.5 * (x.max() - x)
                 * (1.0 + 0.5 * torch.sin(3.0 * y + 0.4))).to(F32)
            self.state = tuple(f.expand(batch, -1).contiguous()
                               for f in (h, 0.5 * h, -0.3 * h))
        self.traj = TB.sw2d_rollout_blocked_plain(
            ops, m, *self.state, self.ctrls, self.dt, spc, t0=self.t0,
            store_traj=True)[:3]
        self.tb = tuple(torch.as_tensor(self.rng.standard_normal(
            tuple(self.traj[0].shape)), dtype=F32) for _ in range(3))

    def args(self):
        return (self.traj, self.tb, self.ctrls, self.dt, self.spc, self.t0,
                True)

    def kernel(self):
        ops, m = self.sets[F32]
        return TB._run_rollout_bwd(ops, m, *self.args())

    def ref(self):
        ops, m = self.sets[F64]
        out = TB.sw2d_rollout_bwd_blocked_plain(
            ops, m, *_up(self.traj), *_up(self.tb), _up(self.ctrls), self.dt,
            self.spc, self.t0, True)
        return tuple(t.to(F32) for t in out)


# (N, scenarios, shim device (SMs, blocks an SM)): at N=3 the compile-time
# instance (four lanes an element), at N=2 the run-time sizes (one lane);
# the grid covers the items in one pass (the lanes keep their nodes in
# registers across the grid barriers) or the blocks loop over them
ROLLOUT_BWD_CASES = {
    "N3_B2_one_pass": (3, 2, (8, 1)),
    "N3_B1_blocks_loop": (3, 1, (2, 1)),
    "N2_B2_one_pass": (2, 2, (8, 1)),
    "N2_B3_blocks_loop": (2, 3, (1, 1)),
}


@pytest.mark.parametrize("name", list(ROLLOUT_BWD_CASES))
def test_rollout_bwd_kernel_matches_plain(device, name):
    """B6 over 2 control steps x 2 steps of the coastal box with the sponge
    and controls: the initial-state and control cotangents against the
    plain version; the same bits on a rerun; the launcher's plan (a
    cooperative launch: what is co-resident)."""
    n, B, dev = ROLLOUT_BWD_CASES[name]
    device(*dev)
    c = RolloutCase(n, B, seed=n + B)
    got, ref = c.kernel(), c.ref()
    _check_adjoint(got, ref)
    assert _same(got, c.kernel())
    ops, m = c.sets[F32]
    plan = TB.rollout_bwd_plan(ops, m, B)
    P = 4 if n == 3 else 1
    assert plan["lanes_per_element"] == P
    items_per_block = plan["threads"] // P
    assert plan["grid"] == min(dev[0] * dev[1],
                               -(-B * m.k_elem // items_per_block))


def test_rollout_bwd_refuses_high_order_and_wetdry(device):
    """Past N=6 the launcher has no room and the wrapper says so; a wet/dry
    set has no adjoint (C10)."""
    c = Case(1, 4, 1)
    lib = TB._lib()
    meta = c.sets[F32].meta._replace(k_elem=128, n_p=36, n_fp=8,
                                     n_v=128 * 36, n_t=128 * 24)
    desc = TB._desc(meta, blocked=True)
    ops, _ = RolloutCase(2, 1).sets[F32]
    with pytest.raises(ValueError, match="N <= 6"):
        TB._shard_plan(lib, desc, ops, 8, TB._ROLLOUT_BWD)
    with pytest.raises(NotImplementedError, match="wet/dry"):
        TB.sw2d_rollout_bwd_blocked(ops, meta._replace(wetdry=True),
                                    *([None] * 6), None, 0.1, 1)


# ---------------------------------------------------------------------------
# The blocked forward rollout (B5) and step (B4), on qstage
# ---------------------------------------------------------------------------

# (N, scenarios, controls, wet/dry, shim device (SMs, blocks an SM)): at N=3
# and N=6 the compile-time instances (four and eight lanes an element), at
# N=2 the run-time sizes (one lane); the grid covers the items in one pass
# or the blocks loop over them
FORWARD_CASES = {
    "coastal_N3_B2_one_pass": (3, 2, 2, False, (4, 1)),
    "coastal_N3_B2_blocks_loop": (3, 2, 2, False, (2, 1)),
    "coastal_N3_B2_noctrl_one_pass": (3, 2, 0, False, (4, 1)),
    "coastal_N2_B2_one_pass": (2, 2, 2, False, (8, 1)),
    "coastal_N2_B3_blocks_loop": (2, 3, 2, False, (1, 1)),
    "coastal_N6_B1_one_pass": (6, 1, 2, False, (4, 1)),
    "coastal_N6_B1_blocks_loop": (6, 1, 2, False, (1, 1)),
    "wetdry_N3_B2_one_pass": (3, 2, 0, True, (4, 1)),
    "wetdry_N2_B3_blocks_loop": (2, 3, 0, True, (1, 1)),
}


@pytest.mark.parametrize("name", list(FORWARD_CASES))
def test_rollout_kernel_matches_plain(device, name):
    """B5 over 2 control steps x 2 steps (4 steps without controls) from
    t0 = 1 on the coastal box (from 0 on the wet/dry beach, which runs the
    limiter) with the trajectory stored, against the plain version in
    float64; without the trajectory, its last row bit for bit; the same bits
    on a rerun; B4 launched for each step in turn bit-equal to the
    trajectory's rows; the launcher's plan (a cooperative launch: what is
    co-resident)."""
    n, B, nc, wetdry, dev = FORWARD_CASES[name]
    device(*dev)
    c = ForwardCase(n, B, nc, wetdry, seed=n + B)
    traj = c.kernel()[0]
    assert all(torch.isfinite(f).all() for f in traj)
    assert _max_abs(traj, c.ref()) <= (FWD_ATOL_N6 if n == 6 else FWD_ATOL)
    assert _same(traj, c.kernel()[0])
    assert _same(c.kernel(store_traj=False)[1],
                 tuple(f[:, -1] for f in traj))
    for t, st in enumerate(c.steps()):
        assert _same(st, tuple(f[:, t + 1] for f in traj))
    ops, m = c.sets[F32]
    plan = TB.rollout_plan(ops, m, B)
    P = {2: 1, 3: 4, 6: 8}[n]
    assert plan["lanes_per_element"] == P
    items_per_block = plan["threads"] // P
    assert plan["grid"] == min(dev[0] * dev[1],
                               -(-B * m.k_elem // items_per_block))
    assert (plan["grid"] * items_per_block >= B * m.k_elem) == (
        "one_pass" in name)


# ---------------------------------------------------------------------------
# B5 and B4 on quadrilaterals: four faces; at N=4 the compile-time instance
# (eight lanes an element), at N=2 the run-time sizes (one lane)
# ---------------------------------------------------------------------------

# (N, scenarios, controls, wet/dry, shim device (SMs, blocks an SM), cells)
# on box_quads: N=2 (Nfp 3: the even split of a face maximum tied over three
# nodes could show; it does not at these states) and N=4 (Np 25, Nfp 5:
# QOrder4Quad, lanes 5-7 masked on the faces); one pass, or blocks that loop
# (more items than the co-resident blocks hold)
QUAD_CASES = {
    "quads_coastal_N2_B2_one_pass": (2, 2, 2, False, (4, 1), (6, 6)),
    "quads_coastal_N4_B5_blocks_loop": (4, 5, 2, False, (1, 1), (8, 8)),
    "quads_coastal_N4_B1_noctrl_one_pass": (4, 1, 0, False, (4, 3), (6, 6)),
    "quads_wetdry_N2_B5_blocks_loop": (2, 5, 0, True, (1, 1), (8, 8)),
    "quads_coastal_N4_B1_one_pass": (4, 1, 2, False, (4, 3), (6, 6)),
    "quads_coastal_N4_B5_noctrl_blocks_loop": (4, 5, 0, False, (2, 1),
                                               (6, 6)),
    "quads_wetdry_N4_B2_one_pass": (4, 2, 0, True, (4, 3), (6, 6)),
}


@pytest.mark.parametrize("name", list(QUAD_CASES))
def test_rollout_kernel_on_quads_matches_plain(device, name):
    """B5 on a quadrilateral set over 2 control steps x 2 steps (4 steps
    without controls) from t0 = 1 on the coastal box (0 on the wet/dry
    beach) with the trajectory stored, against the plain version in float64
    at 5e-5; without the trajectory its last row bit for bit; the same bits
    on a rerun; B4 launched for each step in turn bit-equal to the
    trajectory's rows; the plan: eight lanes an element at N=4 (the
    compile-time instance), one at N=2, what is co-resident."""
    n, B, nc, wetdry, dev, cells = QUAD_CASES[name]
    device(*dev)
    c = ForwardCase(n, B, nc, wetdry, seed=10 + n + B, quads=True,
                    cells=cells)
    ops, m = c.sets[F32]
    assert m.n_faces == 4 and m.n_fp == n + 1
    assert m.k_elem == cells[0] * cells[1]
    traj = c.kernel()[0]
    assert all(torch.isfinite(f).all() for f in traj)
    assert _max_abs(traj, c.ref()) <= FWD_ATOL
    assert _same(traj, c.kernel()[0])
    assert _same(c.kernel(store_traj=False)[1],
                 tuple(f[:, -1] for f in traj))
    for t, st in enumerate(c.steps()):
        assert _same(st, tuple(f[:, t + 1] for f in traj))
    plan = TB.rollout_plan(ops, m, B)
    P = {2: 1, 4: 8}[n]
    assert plan["lanes_per_element"] == P
    items_per_block = plan["threads"] // P
    assert plan["grid"] == min(dev[0] * dev[1],
                               -(-B * m.k_elem // items_per_block))
    assert (plan["grid"] * items_per_block >= B * m.k_elem) == (
        "one_pass" in name)


def test_quads_refused_above_order_four(device):
    """A quadrilateral set at N=5 (Np 36, past the run-time sizes' room):
    every q kernel raises in the launcher's guard, naming itself, and the C
    dispatch refuses it too."""
    lib = TB._lib()
    o5, m5 = ForwardCase(5, 1, quads=True, cells=(2, 2)).sets[F32]
    desc = TB._desc(m5, blocked=True)
    for which, name in ((TB._ROLLOUT, "B5"), (TB._ROLLOUT_BWD, "B6"),
                        (TB._STAGE, "B7"), (TB._STAGE_BWD, "B8"),
                        (TB._RDMA, "B9")):
        with pytest.raises(ValueError, match=f"{name}.*N <= 4"):
            TB._shard_plan(lib, desc, o5, 1, which)
        plan = (ctypes.c_int * 4)()
        assert lib.sw2d_shard_plan(ctypes.byref(desc), 1, 1, which,
                                   o5.fbuf.shape[0], o5.ibuf.shape[0],
                                   plan) != 0
    with pytest.raises(ValueError, match="N <= 4"):
        TB.rollout_plan(o5, m5, 1)


# ---------------------------------------------------------------------------
# B7, B8 and B9 on quadrilaterals: four faces; at N=4 the compile-time
# instance (eight lanes an element), at N=2 the run-time sizes (one lane)
# ---------------------------------------------------------------------------

# (N, shards, batch, controls, shim device (SMs, blocks an SM)) on
# box_quads(8, 8) partitioned (16 elements a shard at S=4), coastal physics,
# two controls or none (the set's one zero injector): N=2 (Nfp 3) and N=4
# (Np 25, Nfp 5); S=4 (ring offsets, cut faces) and S=1. B7 and B8 are
# ordinary launches whose grid covers every item; B9's cooperative grid
# covers its items in one pass (N=4: 192 items of eight lanes in 12 blocks
# of 128 threads), or its blocks loop (blocks_loop: 320 items of eight
# lanes, 2560 lanes, in one block of 256 threads)
QUAD_SHARD_CASES = {
    "quads_N2_S4_B3": (2, 4, 3, 2, (2, 1)),
    "quads_N4_S4_B3": (4, 4, 3, 2, (12, 1)),
    "quads_N4_S1_B3_one_pass": (4, 1, 3, 2, (12, 1)),
    "quads_N4_S4_B5_blocks_loop": (4, 4, 5, 2, (1, 1)),
    "quads_N4_S4_B3_noctrl": (4, 4, 3, 0, (12, 1)),
}


def _check_quad_plans(sb, n, B):
    """The plans of B7, B8 and B9 on a quad case: eight lanes an element at
    N=4 in all three, one at N=2; B7's and B8's grids cover every item
    (threads // lanes items a block). Returns the step's plan."""
    m = sb.meta
    n_items = sb.ops.send.shape[0] * B * m.k_elem
    P = {2: 1, 4: 8}[n]
    for adjoint in (False, True):
        plan = TB.shard_plan(sb.ops, m, B, adjoint=adjoint)
        assert plan["lanes_per_element"] == P
        assert plan["grid"] == -(-n_items // (plan["threads"] // P))
    step = TB.shard_plan(sb.ops, m, B, step=True)
    assert step["lanes_per_element"] == P
    return step, n_items


@pytest.mark.parametrize("name", list(QUAD_SHARD_CASES))
def test_stage_and_step_kernels_on_quads_match_plain(device, name):
    """B7 (both stages of a step, the second with the sponge) and B9 on a
    partitioned quadrilateral set against their plain versions in float64;
    the same bits on a rerun; B9 bit-equal to two B7 launches with the ring
    exchange between; the plans' lanes (eight an element at N=4), B7's
    grid over every item, B9's lanes covering its items in one pass or
    its blocks looping."""
    n, S, B, nc, dev = QUAD_SHARD_CASES[name]
    device(*dev)
    c = Case(n, S, B, n_ctrl=nc, seed=20 + n + S, quads=True)
    sb = c.sets[F32]
    assert sb.meta.n_faces == 4 and sb.meta.n_fp == n + 1
    assert (c.ctrl is None) == (nc == 0)
    if S > 1:
        assert len(sb.plan.offs) >= 2
    st, dt, t = c.state, c.dt, c.t
    *s1, sb1 = c.stage(st, st, c.rb, 0.5 * dt, t, False)
    ref1 = c.ref(TB.sw2d_stage_blocked_plain, st, st, c.rb, 0.5 * dt, t,
                 c.ctrl, True, False)
    assert _max_abs((*s1, sb1), ref1) <= FWD_ATOL
    cur, rb2 = tuple(s1), c.ex[F32](sb1)
    two = c.stage(st, cur, rb2, dt, t + 0.5 * dt, True)
    ref2 = c.ref(TB.sw2d_stage_blocked_plain, st, cur, rb2, dt, t + 0.5 * dt,
                 c.ctrl, True, True)
    assert all(torch.isfinite(f).all() for f in two)
    assert _max_abs(two, ref2) <= FWD_ATOL
    assert _same(two, c.stage(st, cur, rb2, dt, t + 0.5 * dt, True))
    launch = TB.RdmaLaunch(sb.ops, sb.meta, c.ex[F32])
    got = launch._launch(st, c.rb, dt, t, c.ctrl, True)
    ref = c.ref(TB.sw2d_step_rdma_blocked_plain, st, c.rb, dt, c.ex[F64], t,
                c.ctrl)
    assert _max_abs(got, ref) <= FWD_ATOL
    assert _same(got, launch._launch(st, c.rb, dt, t, c.ctrl, True))
    assert _same(got, two)
    step, n_items = _check_quad_plans(sb, n, B)
    assert (step["grid"] * step["threads"]
            >= n_items * step["lanes_per_element"]) == (
        "blocks_loop" not in name)


@pytest.mark.parametrize("name", list(QUAD_SHARD_CASES))
def test_stage_bwd_kernel_on_quads_matches_plain(device, name):
    """B8 on stage 2's inputs of a partitioned quadrilateral set, with the
    sponge and the control cotangent (none without controls), under random
    cotangents of the output and the send buffer, against the plain version
    in float64; the same bits on a rerun; eight lanes an element at N=4,
    one at N=2, an ordinary launch over every item."""
    n, S, B, nc, dev = QUAD_SHARD_CASES[name]
    device(*dev)
    c = Case(n, S, B, n_ctrl=nc, seed=30 + n + S, quads=True)
    sb = c.sets[F32]
    m = sb.meta
    *s1, sb1 = c.stage(c.state, c.state, c.rb, 0.5 * c.dt, c.t, False)
    cur, rb2 = tuple(s1), c.ex[F32](sb1)
    rng = np.random.default_rng(8)
    g = lambda *shape: torch.as_tensor(rng.standard_normal(shape), dtype=F32)
    lam = tuple(g(S, B, m.n_v) for _ in range(3))
    lsb = g(S, B, sb.ops.send.shape[1], 3)
    args = (cur, rb2, lam, lsb, c.dt, c.t + 0.5 * c.dt, c.ctrl, True, True)
    got = TB._run_stage_bwd(sb.ops, m, *args)
    ref = c.ref(TB.sw2d_stage_bwd_blocked_v2_plain, *args)
    assert (got[7] is None) == (nc == 0)
    if not nc:
        got, ref = got[:7], ref[:7]
    _check_adjoint(got, ref)
    assert _same(got, TB._run_stage_bwd(sb.ops, m, *args))
    _check_quad_plans(sb, n, B)


def test_stage_bwd_kernel_on_quads_splits_face_ties(device):
    """B8 at N=4 on quadrilaterals in four shards (cut faces on x = 0 and
    y = 0) from a state that is the same at every node of the line x = 0
    and of the open east side x = 1: on each face along x = 0, cut faces
    included, all five nodes of both sides share the face maximum, and so
    do the five nodes of each east face, against the jump to the tidal
    depth; so the speed cotangent there is split five ways, and at the cut
    faces into the receive slots' cotangents. Held to the plain version
    (the even split over the face's real nodes, C6/C12).

    Mutation checks (made on a copy of the source): counting the masked
    lanes (5-7, which redo the face's last node) among the nodes at the
    maximum splits it eight ways and fails this test. Letting them write
    the cut faces' receive slots cannot fail it, nor any test of values: a
    masked lane redoes the last node with the same inputs and would store
    that node's bits into that node's slot. The guard keeps one writer a
    slot, as the launch's design has it."""
    device(2, 1)
    c = Case(4, 4, 1, seed=37, quads=True)
    sb = c.sets[F32]
    m = sb.meta
    x, y = c.ctx.x.reshape(1, -1), c.ctx.y.reshape(1, -1)
    h = (11.0 + 2.0 * x ** 2 * (1.0 - x)
         * (1.0 + 0.5 * torch.sin(3.0 * y + 0.4))).to(F32)
    state = tuple(BS.split_shards(f.contiguous(), 4)
                  for f in (h, 0.5 * h, -0.3 * h))
    # the faces' nodes along each line: of the eight elements on each side
    # of x = 0, of the eight east elements
    for line, n_nodes in ((x == 0.0, 16 * 5), (x == 1.0, 8 * 5)):
        nodes = line.flatten().nonzero().flatten()
        assert len(nodes) == n_nodes
        for f in (h, 0.5 * h, -0.3 * h):
            assert float(f[0, nodes].max() - f[0, nodes].min()) == 0.0
    # the cut faces along x = 0: four a shard, each side's
    xs = BS.split_shards(x.to(F32), 4)[:, 0]
    cut = sb.ops.vmapP.reshape(4, -1) >= m.n_v
    vm = sb.ops.vmapM.reshape(4, -1)
    on_line = torch.stack([xs[s][vm[s]] == 0.0 for s in range(4)]) & cut
    faces = on_line.reshape(4, m.k_elem, 4, 5).all(-1)
    assert int(faces.sum()) == 4 * 4
    rb = c.ex[F32](BS.initial_send_buffer(sb, state))
    rng = np.random.default_rng(9)
    g = lambda *shape: torch.as_tensor(rng.standard_normal(shape), dtype=F32)
    lam = tuple(g(4, 1, m.n_v) for _ in range(3))
    lsb = g(4, 1, sb.ops.send.shape[1], 3)
    args = (state, rb, lam, lsb, 0.5 * c.dt, c.t, c.ctrl, True, False)
    got = TB._run_stage_bwd(sb.ops, m, *args)
    _check_adjoint(got, c.ref(TB.sw2d_stage_bwd_blocked_v2_plain, *args))
    assert _same(got, TB._run_stage_bwd(sb.ops, m, *args))
    assert TB.shard_plan(sb.ops, m, 1, adjoint=True)["lanes_per_element"] == 8


# (N, scenarios, controls, shim device, cells) of B6 on box_quads: N=2 (the
# run-time sizes, one lane an element) and N=4 (QOrder4Quad: eight lanes an
# element, qvjp's faces masked to five of eight lanes); one pass, or blocks
# that loop; with two controls, or the set's one zero injector
QUAD_ROLLOUT_BWD_CASES = {
    "quads_N2_B3_blocks_loop": (2, 3, 2, (1, 1), (8, 8)),
    "quads_N4_B3_one_pass": (4, 3, 2, (8, 2), (6, 6)),
    "quads_N4_B1_one_pass": (4, 1, 2, (4, 2), (6, 6)),
    "quads_N4_B3_blocks_loop": (4, 3, 2, (1, 1), (6, 6)),
    "quads_N4_B1_noctrl_one_pass": (4, 1, 0, (4, 2), (6, 6)),
    "quads_N4_B3_noctrl_blocks_loop": (4, 3, 0, (2, 1), (6, 6)),
}


def _check_rollout_bwd_on_quads(c, n, B, dev, one_pass):
    """B6 on a quad case against the plain version, the same bits on a
    rerun, and its plan: eight lanes an element at N=4, one at N=2, what
    is co-resident."""
    ops, m = c.sets[F32]
    assert m.n_faces == 4 and m.n_fp == n + 1
    got = c.kernel()
    _check_adjoint(got, c.ref())
    assert _same(got, c.kernel())
    plan = TB.rollout_bwd_plan(ops, m, B)
    P = {2: 1, 4: 8}[n]
    assert plan["lanes_per_element"] == P
    items_per_block = plan["threads"] // P
    assert plan["grid"] == min(dev[0] * dev[1],
                               -(-B * m.k_elem // items_per_block))
    assert (plan["grid"] * items_per_block >= B * m.k_elem) == one_pass
    return got


@pytest.mark.parametrize("name", list(QUAD_ROLLOUT_BWD_CASES))
def test_rollout_bwd_kernel_on_quads_matches_plain(device, name):
    """B6 over 2 control steps x 2 steps of the coastal quadrilateral box
    with the sponge, the tidal boundary and two controls (or the zero
    injector): the initial-state and control cotangents against the plain
    version in float64; the same bits on a rerun; the plan's lanes, what is
    co-resident."""
    n, B, nc, dev, cells = QUAD_ROLLOUT_BWD_CASES[name]
    device(*dev)
    c = RolloutCase(n, B, seed=40 + n + B, quads=True, cells=cells,
                    n_ctrl=nc)
    got = _check_rollout_bwd_on_quads(c, n, B, dev, "one_pass" in name)
    if not nc:  # the zero injector's control cotangent
        assert float(got[3].abs().max()) == 0.0


def test_rollout_bwd_kernel_on_quads_splits_face_ties(device):
    """B6 at N=4 on quadrilaterals from a state that is the same at every
    node of the open east side: on each east face all five nodes share the
    face maximum at the initial state, against the jump to the tidal depth,
    so the speed cotangent there is split five ways; held to the plain
    version (the even split over the face's real nodes, C6/C12). A masked
    lane (they redo the face's last node) counted among the nodes at the
    maximum would split it eight ways."""
    device(4, 2)
    c = RolloutCase(4, 1, seed=47, quads=True, cells=(6, 6), east_tie=True)
    x = c.ctx.x.reshape(-1)
    east = (x == x.max()).nonzero().flatten()
    assert len(east) == 6 * 5  # the east faces' nodes
    for f in c.state:
        assert float(f[0, east].max() - f[0, east].min()) == 0.0
    _check_rollout_bwd_on_quads(c, 4, 1, (4, 2), True)
