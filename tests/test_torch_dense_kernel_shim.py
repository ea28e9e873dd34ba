"""The dense kernels' CUDA source (``ops/csrc/sw2d_dense.cu``), compiled for
the CPU with ``g++ -std=c++20 -pthread`` behind a shim header, against their
plain versions (``ops/sw2d_fused.py``).

The kernels keep each thread's element in registers across block barriers,
so one thread cannot run a block in order (as the curved kernels' shim
does). Here every CUDA thread of a block is a host thread: ``threadIdx`` is
thread-local, ``__syncthreads`` is one ``std::barrier`` of the block's
threads, shared memory is a static array, and ``cudaLaunchKernel`` runs the
grid's blocks one after another. The launches go through the module's own
launch helpers (``_run_step``, ``_run_rollout``, ``_run_rollout_bwd``), so
the argument lists and the launcher's choice of tile are exercised too; the
shim's device reports ``shim_sms`` multiprocessors and ``shim_per_sm``
resident blocks, set from the test through ``ctypes``.

Cases: the headline mesh (``box_triangles(4, 5)``, K=40, coastal: shelf
bathymetry, well-balancing, drag, Coriolis, tidal open boundary) at N=1 (the
compile-time instance) with B=7 (a full tile of four scenarios and a ragged
one of three), from a perturbed state at t0=1 (the tide moves) and from the
exact rest state with zero controls (ties on every face); and K=18 at N=2
(the run-time-size instance), B=7 (one ragged tile of eight); and the
N=1 mesh flat, without filter, one step a control. The kernel
runs in float32; the reference is the plain version in float64 on the same
float32 inputs, with ``chip_smoke.py``'s tolerances: forward 2e-5 absolute (1e-4 for the N=2
rollout); adjoint per scenario relative to the largest entry of each
cotangent, 99 % within 1e-5 and all within 1e-3 (1e-4 for every scenario at
the rest start); the same bits on a rerun.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from blitzdg_tpu_torch.mpc import coastal_box as cbx
from blitzdg_tpu_torch.ops import _build
from blitzdg_tpu_torch.ops import sw2d_fused as F
from blitzdg_tpu_torch.ops.sw2d import SWPhysics

F32, F64 = torch.float32, torch.float64
FWD_ATOL, FWD_ATOL_N2_ROLLOUT = 2e-5, 1e-4
BWD_BULK, BWD_MAX, BWD_REST = 1e-5, 1e-3, 1e-4

SHIM = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <thread>
#include <vector>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
#define __shared__
struct shim_dim { unsigned x, y, z; };
inline thread_local shim_dim threadIdx = {0, 0, 0};
inline shim_dim blockIdx = {0, 0, 0}, blockDim = {1, 1, 1},
                gridDim = {1, 1, 1};
inline std::barrier<>* shim_bar = nullptr;
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct int4 { int x, y, z, w; };
static inline float4 make_float4(float x, float y, float z, float w) {
  float4 r = {x, y, z, w};
  return r;
}
static inline void __syncthreads() { shim_bar->arrive_and_wait(); }
static inline void __syncwarp(unsigned) {}
static inline float __fdividef(float a, float b) { return a / b; }
static inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
static inline float __shfl_down_sync(unsigned, float, int) { return 0.0f; }
static inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, 4);
  return f;
}
static inline int __float_as_int(float f) {
  int i;
  std::memcpy(&i, &f, 4);
  return i;
}
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorLaunchOutOfResources = 701, cudaErrorNotSupported = 801 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrCooperativeLaunch = 95,
                      cudaDevAttrMultiProcessorCount = 16,
                      cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
// the device that the launcher asks about: its multiprocessors and the
// blocks of a kernel that one holds (set from the test)
extern "C" { int shim_sms = 1, shim_per_sm = 1; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
template <class K>
static inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return 0;
}
static inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
static inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr a,
                                                 int) {
  *v = a == cudaDevAttrMultiProcessorCount ? shim_sms
       : a == cudaDevAttrMaxSharedMemoryPerBlockOptin ? 232448 : 1;
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
  return 1;
}
static inline cudaError_t cudaGetLastError() { return 0; }
// a launch: the blocks in turn, each block's threads as host threads
template <class O, class A>
static inline cudaError_t cudaLaunchKernel(void (*f)(O, A), dim3 g, dim3 b,
                                           void** args, size_t,
                                           cudaStream_t) {
  const O o = *(O*)args[0];
  const A a = *(A*)args[1];
  blockDim = {b.x, 1, 1};
  gridDim = {g.x, 1, 1};
  for (unsigned blk = 0; blk < g.x; ++blk) {
    blockIdx = {blk, 0, 0};
    std::barrier<> bar(b.x);
    shim_bar = &bar;
    std::vector<std::thread> ts;
    for (unsigned i = 0; i < b.x; ++i)
      ts.emplace_back([f, &o, &a, i] {
        threadIdx = {i, 0, 0};
        f(o, a);
      });
    for (auto& t : ts) t.join();
  }
  return 0;
}
"""


def _shim_source(src: str) -> str:
    """The kernels' source with shared memory a static array."""
    decl = "extern __shared__ __align__(16) float smem[];"
    assert src.count(decl) == 1
    return src.replace(decl, "alignas(16) static float smem[1 << 20];")


@pytest.fixture(scope="module")
def shim_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the kernel source cannot be "
                    "compiled for the CPU")
    d = tmp_path_factory.mktemp("dense_shim")
    (d / "shim.h").write_text(SHIM)
    (d / "cuda_runtime.h").write_text('#pragma once\n#include "shim.h"\n')
    src = (_build.CSRC / "sw2d_dense.cu").read_text()
    (d / "sw2d_dense_shim.cu").write_text(_shim_source(src))
    lib = d / "libsw2d_dense_shim.so"
    cmd = [gxx, "-std=c++20", "-pthread", "-O1", "-fno-strict-aliasing",
           "-shared", "-fPIC", "-w", "-include", str(d / "shim.h"), "-I",
           str(d), "-I", str(_build.CSRC), "-x", "c++",
           str(d / "sw2d_dense_shim.cu"), "-o", str(lib)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-4000:]
    return ctypes.CDLL(str(lib))


@pytest.fixture
def device(shim_lib, monkeypatch):
    """The module's launch helpers on the shim library, whose device holds
    four blocks an SM on 132 SMs (an H100 at the N=1 kernels' registers)."""
    monkeypatch.setattr(_build, "load", lambda name: shim_lib)
    sms = ctypes.c_int.in_dll(shim_lib, "shim_sms")
    per_sm = ctypes.c_int.in_dll(shim_lib, "shim_per_sm")
    sms.value, per_sm.value = 132, 4
    yield sms, per_sm
    sms.value, per_sm.value = 1, 1


class Case:
    """The coastal box at one order in float32 (the kernel's operator set)
    and float64 (the reference's), perturbed or at rest; with ``flat`` the
    same mesh with a flat bottom and no coastal term (its open boundary
    then reads its own traces as '+'), no filter and one step a control."""

    def __init__(self, n_order, cells, batch, rest=False, flat=False,
                 seed=0):
        cb = cbx.coastal_box_problem(batch=batch, n_order=n_order,
                                     cells=cells, dtype=F64, device="cpu")
        phys, tidal = cb.prob.phys, cb.tidal
        if flat:
            phys, tidal = SWPhysics(g=9.81), None
        self.sets = {dt: F.build_fused_step_ops(
            cb.prob.ctx, phys, cb.forcing_bu, cb.forcing_bv, dtype=dt,
            tidal=tidal, device="cpu") for dt in (F32, F64)}
        # two control intervals of two steps, or four of one step
        self.n_cs, self.spc = (4, 1) if flat else (2, 2)
        self.use_filter = not flat
        self.meta = self.sets[F32][1]
        self.dt = cb.prob.dt
        rng = np.random.default_rng(seed)
        n_v = self.meta.n_v
        H = cb.H_rest.reshape(1, -1).numpy()
        if flat:
            H = np.full_like(H, 10.0)
        if rest:
            h = np.repeat(H, batch, axis=0)
            hu = hv = np.zeros_like(h)
            ctrls = np.zeros((batch, self.n_cs, 2))
            self.t0 = 0.0
        else:
            x = cb.prob.ctx.x.reshape(1, -1).numpy()
            y = cb.prob.ctx.y.reshape(1, -1).numpy()
            col = lambda lo, hi: rng.uniform(lo, hi, (batch, 1))
            bump = np.exp(-10.0 * ((x - col(-0.5, 0.5)) ** 2
                                   + (y - col(-0.5, 0.5)) ** 2))
            noise = lambda: 0.01 * rng.standard_normal((batch, n_v))
            h = H + col(0.05, 0.3) * bump + noise()
            hu = col(-0.1, 0.1) * h + noise()
            hv = col(-0.1, 0.1) * h + noise()
            ctrls = 0.3 * rng.standard_normal((batch, self.n_cs, 2))
            self.t0 = 1.0
        to = lambda a: torch.as_tensor(a, dtype=F32).contiguous()
        self.S = (to(h), to(hu), to(hv))
        self.ctrls = to(ctrls)
        self.rng = rng

    def ref(self, fn, *args, **kw):
        """The plain version in float64 on the float32 inputs, as float32."""
        o, m = self.sets[F64]
        up = lambda a: a.to(F64) if torch.is_tensor(a) else a
        out = fn(o, m, *(up(a) for a in args), **kw)
        return tuple(t.to(F32) for t in out)


def _max_abs(xs, ys):
    return max(float((a - b).abs().max()) for a, b in zip(xs, ys))


def _scenario_rel(xs, ys):
    """Per scenario: the largest error over all cotangents, each relative to
    the largest entry of its reference over the batch (chip_smoke.py's)."""
    B = xs[0].shape[0]
    return torch.stack([
        (x - y).abs().reshape(B, -1).amax(dim=1) / (y.abs().max() + 1e-30)
        for x, y in zip(xs, ys)]).amax(dim=0)


CASES = {
    "headline_N1": dict(n_order=1, cells=(4, 5), batch=7),
    "headline_rest_N1": dict(n_order=1, cells=(4, 5), batch=7, rest=True),
    "coastal_K18_N2": dict(n_order=2, cells=(3, 3), batch=7),
    "flat_N1": dict(n_order=1, cells=(4, 5), batch=7, flat=True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_forward_kernels_match_plain(device, name):
    c = Case(**CASES[name])
    o, m = c.sets[F32]
    c0 = c.ctrls[:, 0].contiguous()
    run = (c.dt, c.spc, c.use_filter, c.t0)
    got = F._run_step(o, m, *c.S, c0, c.dt, c.use_filter, c.t0)
    ref = c.ref(F.sw2d_step_plain, *c.S, c0, c.dt, c.use_filter, c.t0)
    assert _max_abs(got, ref) <= FWD_ATOL
    got = F._run_rollout(o, m, *c.S, c.ctrls, *run)
    # the fewest idle lanes: 2 x 160 threads for 7 x 40 elements at N=1,
    # one block of 8 x 18 (160 threads) for 7 x 18 at N=2
    assert F.last_tile() == (4 if m.n_p == 3 else 8)
    ref = c.ref(F.sw2d_rollout_plain, *c.S, c.ctrls, *run)
    assert all(torch.isfinite(t).all() for t in got)
    atol = FWD_ATOL if m.n_p == 3 else FWD_ATOL_N2_ROLLOUT
    assert _max_abs(got, ref) <= atol
    again = F._run_rollout(o, m, *c.S, c.ctrls, *run)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("name", list(CASES))
def test_adjoint_kernel_matches_plain(device, name):
    c = Case(**CASES[name], seed=1)
    o, m = c.sets[F32]
    run = (c.dt, c.spc, c.use_filter, c.t0)
    traj = F._run_rollout(o, m, *c.S, c.ctrls, *run)
    tb = tuple(torch.as_tensor(c.rng.standard_normal(tuple(traj[0].shape)),
                               dtype=F32) for _ in range(3))
    got = F._run_rollout_bwd(o, m, traj, tb, c.ctrls, *run)
    again = F._run_rollout_bwd(o, m, traj, tb, c.ctrls, *run)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = c.ref(F.sw2d_rollout_bwd_plain, *traj, *tb, c.ctrls, *run)
    assert all(torch.isfinite(g).all() for g in got)
    per = _scenario_rel(got, ref)
    if CASES[name].get("rest"):
        assert float(per.max()) <= BWD_REST
    else:
        assert float(torch.quantile(per, 0.99)) <= BWD_BULK
        assert float(per.max()) <= BWD_MAX


def test_tile_follows_the_occupancy(device):
    """The launcher's tile at the headline (K=40, B=2048): four scenarios
    (160 threads) where four blocks an SM are resident, so that the 512
    blocks make one wave on 132 SMs; eight where only two are (256 blocks
    of 320 threads, one wave again)."""
    sms, per_sm = device
    c = Case(n_order=1, cells=(4, 5), batch=2)
    o, m = c.sets[F32]
    lib, desc = F._check_kernel_inputs(o, m, torch.empty(2048, dtype=F32),
                                       F._ROLLOUT)
    for which in (F._STEP, F._ROLLOUT, F._BWD):
        assert lib.sw2d_dense_tile(ctypes.byref(desc), 2048, which) == 4
    per_sm.value = 2
    assert lib.sw2d_dense_tile(ctypes.byref(desc), 2048, F._BWD) == 8
    # why the card takes 8 in the adjoint: its lambda slots make four of its
    # 4-scenario blocks too large for an SM's 228 KB (1 KB reserved a
    # block), two 8-scenario blocks fit, and four forward blocks fit
    sm = lambda which, bs: lib.sw2d_smem_bytes(ctypes.byref(desc), which, bs)
    room = 233472
    assert 4 * (sm(F._BWD, 4) + 1024) > room
    assert 2 * (sm(F._BWD, 8) + 1024) <= room
    assert 4 * (sm(F._ROLLOUT, 4) + 1024) <= room
    # a handful of scenarios: the smallest tile that wastes no lane
    assert lib.sw2d_dense_tile(ctypes.byref(desc), 4, F._BWD) == 4
