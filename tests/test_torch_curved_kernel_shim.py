"""The curved kernels' CUDA source (``ops/csrc/sw2d_curved.cu``), compiled
for the CPU with ``g++ -x c++`` behind a small shim header, against their
plain versions (``ops/sw2d_curved_blocked.py``).

The shim makes one thread of one block run each kernel: ``threadIdx`` 0,
``blockDim`` and ``gridDim`` 1, block and grid barriers no-ops, shared
memory a static array, the cooperative launch a direct call. The kernels'
loops are strided by the block and the grid, so that thread runs every work
unit and every (element, scenario) of it in order, phase after phase. It
finds wrong arithmetic and indexing, not races. The launches go through the
module's own launch helpers (``_run_step``, ``_run_rollout``,
``_run_rollout_bwd``), so the argument lists and the scratch sizes are
checked too.

Cases: the small disk (``disk_triangles(3)``, K=54, Gordon-Hall, 'general'
mass mode) at B=5 (one full tile of four scenarios and a ragged one), at
N=3 (the instantiation for N=3's sizes) and at N=2 (the run-time-size one),
with drag, Coriolis and a bed slope so that every term runs; the straight
box (K=128, 'affine' mass mode) at N=3. The kernel runs in float32; the
reference is the plain version in float64 on the same float32 inputs.

Tolerances, with their reasons:
 - forward (step, rollout with and without stored trajectories, with and
   without controls): 1e-5 absolute on states near 1, float32 rounding of
   a few hundred operations per node over up to 4 steps, as on the card
   (``CRV_FWD_ATOL`` of ``chip_smoke.py``);
 - adjoint: every entry within 1e-3 of the largest entry of its field (and
   of the control cotangent), 99 % within 1e-5: the float32 rounding of two
   VJPs and a recomputed stage per step, as on the card;
 - the same bits on a rerun (no atomics, fixed summation orders).
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from blitzdg_tpu_torch.mesh import box_triangles
from blitzdg_tpu_torch.mpc.coastal_box import cfl_dt
from blitzdg_tpu_torch.mpc.curved_disk import curved_disk_contexts
from blitzdg_tpu_torch.ops import _build
from blitzdg_tpu_torch.ops import sw2d_curved_blocked as TC
from blitzdg_tpu_torch.ops.sw2d import SWPhysics
from blitzdg_tpu_torch.specgrid.cubature import (build_cubature_context,
                                                 build_gauss_face_context)
from blitzdg_tpu_torch.specgrid.triangle import build_triangle_context

F32, F64 = torch.float32, torch.float64
B = 5  # one full scenario tile and a ragged one
FWD_ATOL = 1e-5
BWD_BULK, BWD_MAX = 1e-5, 1e-3

SHIM = r"""
#pragma once
#include <algorithm>
#include <cmath>
#include <cstddef>
using std::max;
using std::min;
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
#define __shared__
struct shim_dim { unsigned x, y, z; };
static shim_dim threadIdx = {0, 0, 0}, blockIdx = {0, 0, 0};
static shim_dim blockDim = {1, 1, 1}, gridDim = {1, 1, 1};
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
static inline float4 make_float4(float x, float y, float z, float w) {
  float4 r = {x, y, z, w};
  return r;
}
static inline void __syncthreads() {}
static inline void __syncwarp(unsigned) {}
static inline float __fdividef(float a, float b) { return a / b; }
static inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
static inline float __shfl_down_sync(unsigned, float, int) { return 0.0f; }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorLaunchOutOfResources = 701, cudaErrorNotSupported = 801 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrCooperativeLaunch = 95,
                      cudaDevAttrMultiProcessorCount = 16,
                      cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
// the device that the launchers ask about: its multiprocessors and the
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
  return 0;
}
static inline cudaError_t cudaGetLastError() { return 0; }
namespace cooperative_groups {
struct grid_group { void sync() {} };
inline grid_group this_grid() { return grid_group(); }
}
// the cooperative launch as a direct call of the kernel: one block, one
// thread
template <class O, class A>
static int shim_launch(const void* kern, void** args, int, int, size_t,
                       void*) {
  typedef void (*Kern)(O, A);
  reinterpret_cast<Kern>(const_cast<void*>(kern))(*(O*)args[0],
                                                  *(A*)args[1]);
  return 0;
}
"""


def _shim_source(src: str) -> str:
    """The kernels' source with shared memory a static array and the two
    cooperative launches direct calls."""
    decl = "extern __shared__ __align__(16) float smem[];"
    assert src.count(decl) == 1
    src = src.replace(decl, "alignas(16) static float smem[1 << 18];")
    fwd = src.index("static int launch_cforward(")
    bwd = src.index("int sw2d_curved_rollout_bwd(")
    call = "return coop_launch("
    i_f, i_b = src.index(call, fwd), src.index(call, bwd)
    assert fwd < i_f < bwd < i_b
    return (src[:i_f] + "return shim_launch<COps, CFwdArgs>("
            + src[i_f + len(call):i_b]
            + "return shim_launch<COps, CBwdArgs>("
            + src[i_b + len(call):])


@pytest.fixture(scope="module")
def shim_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the kernel source cannot be "
                    "compiled for the CPU")
    d = tmp_path_factory.mktemp("curved_shim")
    (d / "shim.h").write_text(SHIM)
    for header in ("cuda_runtime.h", "cooperative_groups.h"):
        (d / header).write_text('#pragma once\n#include "shim.h"\n')
    src = (_build.CSRC / "sw2d_curved.cu").read_text()
    (d / "sw2d_curved_shim.cu").write_text(_shim_source(src))
    lib = d / "libsw2d_curved_shim.so"
    cmd = [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-w", "-include",
           str(d / "shim.h"), "-I", str(d), "-I", str(_build.CSRC), "-x",
           "c++", str(d / "sw2d_curved_shim.cu"), "-o", str(lib)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-4000:]
    return ctypes.CDLL(str(lib))


@pytest.fixture
def kernels(shim_lib, monkeypatch):
    """The module's launch helpers, on the shim library."""
    monkeypatch.setattr(_build, "load", lambda name: shim_lib)
    return TC


def _disk(n_order):
    (_, _, _), (ctx, cub, gauss) = curved_disk_contexts(3, 0.3, n_order,
                                                        device="cpu")
    return ctx, cub, gauss, SWPhysics(g=9.81, cd=2e-3, f_cor=1e-2), True


def _box(n_order):
    mesh = box_triangles(8, 8)
    kw = dict(filter_cutoff=0.9 * n_order, filter_order=4)
    ctx = build_triangle_context(n_order, mesh, dtype=F64, device="cpu",
                                 **kw)
    xs, ys, V = ctx.x.numpy(), ctx.y.numpy(), ctx.V.numpy()
    cub = build_cubature_context(n_order, mesh, xs, ys, V, device="cpu")
    gauss = build_gauss_face_context(n_order, mesh, xs, ys, V, device="cpu")
    return ctx, cub, gauss, SWPhysics(g=9.81), False


class Case:
    """One discretization in float32 (the kernel's) and float64 (the
    reference's), with states near rest and random controls."""

    def __init__(self, geom, n_order, seed=0):
        ctx, cub, gauss, phys, bed = (_disk if geom == "disk" else _box)(
            n_order)
        xs, ys = ctx.x.numpy(), ctx.y.numpy()
        bump = np.exp(-8.0 * (xs ** 2 + ys ** 2))
        kw = dict(zx=0.1 * np.cos(xs), zy=0.05 * np.sin(2.0 * ys)) if bed \
            else {}
        self.sets = {
            dt: TC.build_curved_blocked_ops(
                ctx, cub, gauss, phys, np.stack([bump, 0 * bump]),
                np.stack([0 * bump, bump]), dtype=dt, device="cpu", **kw)
            for dt in (F32, F64)}
        self.meta = self.sets[F32][1]
        rng = np.random.default_rng(seed)
        n_v = self.meta.n_v
        x, y = xs.reshape(1, -1), ys.reshape(1, -1)
        col = lambda lo, hi: rng.uniform(lo, hi, (B, 1))
        bmp = np.exp(-10.0 * ((x - col(-0.4, 0.4)) ** 2
                              + (y - col(-0.4, 0.4)) ** 2))
        noise = lambda: 1e-3 * rng.standard_normal((B, n_v))
        h = 1.0 + col(0.01, 0.05) * bmp + noise()
        self.S = tuple(torch.as_tensor(a, dtype=F32).contiguous() for a in (
            h, col(-0.05, 0.05) * h + noise(), col(-0.05, 0.05) * h + noise(),
            0.5 + 0.3 * bmp + noise()))
        self.ctrls = torch.as_tensor(0.3 * rng.standard_normal((B, 2, 2)),
                                     dtype=F32)
        self.dt = cfl_dt(ctx, 9.81, 1.1, cfl=0.5)
        self.rng = rng

    def ref(self, fn, *args, **kw):
        """The plain version in float64 on the float32 inputs, as float32."""
        o, m = self.sets[F64]
        up = lambda a: (tuple(up(x) for x in a)
                        if isinstance(a, (tuple, list))
                        else a.to(F64) if torch.is_tensor(a) else a)
        out = fn(o, m, *up(args), **kw)
        return tuple(t.to(F32) for t in out)


def _max_abs(xs, ys):
    return max(float((a - b).abs().max()) for a, b in zip(xs, ys))


CASES = [("disk", 3), ("disk", 2), ("box", 3)]


@pytest.mark.parametrize("geom,n_order", CASES)
def test_forward_kernels_match_plain(kernels, geom, n_order):
    c = Case(geom, n_order)
    o, m = c.sets[F32]
    spc = 2
    c0 = c.ctrls[:, 0].contiguous()
    got = kernels._run_step(o, m, c.S, c0, c.dt, True)
    ref = c.ref(TC.sw2d_curved_step_blocked_plain, *c.S, c0, c.dt)
    assert _max_abs(got, ref) <= FWD_ATOL
    for ctrls, traj in ((c.ctrls, True), (c.ctrls, False), (None, False)):
        n_steps = 4
        got = kernels._run_rollout(o, m, c.S, ctrls, c.dt, spc, n_steps, True,
                                   traj)
        ref = c.ref(TC.sw2d_curved_rollout_blocked_plain, *c.S, ctrls, c.dt,
                    spc=spc, n_steps=n_steps, store_traj=traj)
        assert len(got) == len(ref)
        assert all(torch.isfinite(t).all() for t in got)
        assert _max_abs(got, ref) <= FWD_ATOL, (ctrls is None, traj)


@pytest.mark.parametrize("geom,n_order", CASES)
def test_adjoint_kernel_matches_plain(kernels, geom, n_order):
    c = Case(geom, n_order, seed=1)
    o, m = c.sets[F32]
    spc = 2
    traj = kernels._run_rollout(o, m, c.S, c.ctrls, c.dt, spc, 4, True,
                                True)[:4]
    traj = tuple(t.contiguous() for t in traj)
    tb = [torch.as_tensor(c.rng.standard_normal(tuple(traj[0].shape)),
                          dtype=F32) for _ in range(4)]
    for cot, parts in ((tb, 1), (tb, 2), ([tb[0], None, None, None], 2)):
        got = kernels._run_rollout_bwd(o, m, traj, cot, c.ctrls, c.dt, spc,
                                       True, parts)
        again = kernels._run_rollout_bwd(o, m, traj, cot, c.ctrls, c.dt, spc,
                                         True, parts)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        ref = c.ref(TC.sw2d_curved_rollout_bwd_blocked_plain, traj, cot,
                    c.ctrls, c.dt, spc)
        for a, r in zip(got, ref):
            assert torch.isfinite(a).all()
            scale = float(r.abs().max())
            if scale == 0.0:  # a field that no cotangent reaches
                assert not a.any()
                continue
            rel = (a - r).abs() / scale
            assert float(rel.max()) <= BWD_MAX
            assert float(torch.quantile(rel.reshape(-1), 0.99)) <= BWD_BULK


def test_shim_smem_size_is_the_wrappers(kernels):
    """The kernels' shared-memory size and the wrapper's mirror of it."""
    for geom, n_order in CASES:
        o, m = Case(geom, n_order).sets[F32]
        lib, desc = kernels._check_kernel_inputs(o, m, o.fbuf)
        for e, parts, threads in ((1, 1, 32), (7, 1, 32), (32, 1, 128),
                                  (27, 2, 224)):
            assert lib.sw2d_curved_smem_bytes(ctypes.byref(desc), e, parts,
                                              threads) \
                == TC.smem_bytes(m, e, threads, parts)


def test_adjoint_takes_two_threads_where_the_lanes_are_few(shim_lib):
    """The adjoint's launcher takes two threads a (element, scenario) where
    the blocks of twice the threads are all resident at once, by the
    occupancy that the device reports for the kernel: with one such block
    an SM on 132 SMs (an H100 at the adjoint's register count), the small
    disk's 128 units at B=256 take two, the large disk's 256 at B=32 one;
    with two blocks an SM the large disk takes two as well."""
    sms = ctypes.c_int.in_dll(shim_lib, "shim_sms")
    per_sm = ctypes.c_int.in_dll(shim_lib, "shim_per_sm")
    shim_lib.sw2d_curved_bwd_parts.restype = ctypes.c_int

    def parts(k_elem, batch, n_sm, blocks):
        sms.value, per_sm.value = n_sm, blocks
        meta = TC.CurvedBlockedMeta(  # N=3: Np 10, Ncub 34, NG 8
            k_elem=k_elem, n_p=10, n_cub=34, n_gauss=8, n_faces=3,
            n_v=10 * k_elem, n_t=24 * k_elem, n_ctrl=2, g=9.81, cd=0.0,
            f_cor=0.0, has_bed=False, mass_mode="general",
            filter_folded=True)
        u = TC.unit_shape(meta, batch)
        return shim_lib.sw2d_curved_bwd_parts(
            ctypes.byref(TC._desc(meta)), batch, u.elems, u.scens)

    try:
        assert parts(54, 256, 132, 1) == 2
        assert parts(1014, 32, 132, 1) == 1
        assert parts(1014, 32, 132, 2) == 2
        assert parts(54, 256, 64, 1) == 1
    finally:
        sms.value, per_sm.value = 1, 1
