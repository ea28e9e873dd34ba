"""The port stands on torch and numpy alone: importing every module of
``blitzdg_tpu_torch`` pulls in nothing of JAX and nothing of the JAX
package; ``chip_smoke.py`` imports none of them either; and an entry point
called without ``device=`` raises on a machine without CUDA instead of
running on the CPU."""
import ast
import inspect
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "blitzdg_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "blitzdg_tpu")


def port_modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_package_has_the_slice_modules():
    want = {"context", "timestepping", "convert", "mesh.connectivity",
            "mesh.gmsh", "mesh.generators", "specgrid.jacobi",
            "specgrid.vandermonde", "specgrid.triangle", "ops.sw2d",
            "ops.sw2d_dense", "ops.sw2d_fused", "ops._build", "mpc.problem",
            "mpc.solver", "mpc.fused",
            # the blocked (large-mesh) path
            "utils", "parallel", "parallel.partition", "ops.limiters",
            "ops.sw2d_wetdry", "ops.sw2d_blocked", "mpc.blocked",
            "mpc.blocked_box"}
    have = {m.removeprefix("blitzdg_tpu_torch.") for m in port_modules()}
    assert want <= have
    for name in ("sw2d_dense.cu", "sw2d_blocked.cu", "sw2d_common.cuh"):
        assert (PKG / "ops" / "csrc" / name).exists()


def test_importing_every_module_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"mods = {port_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def _imported_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path", [ROOT / "chip_smoke.py", *sorted(PKG.rglob("*.py"))],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax(path):
    assert not (_imported_roots(path) & set(FORBIDDEN))


def test_default_device_is_cuda_and_does_not_fall_back():
    """On a machine without CUDA the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from blitzdg_tpu_torch.mesh import box_triangles
    from blitzdg_tpu_torch.mpc import MPCProblem, build_fused_mpc
    from blitzdg_tpu_torch.mpc.coastal_box import coastal_box_problem
    from blitzdg_tpu_torch.ops.sw2d import SWPhysics
    from blitzdg_tpu_torch.specgrid.triangle import build_triangle_context

    mesh = box_triangles(2, 2)
    with pytest.raises((RuntimeError, AssertionError)):
        build_triangle_context(1, mesh)
    with pytest.raises((RuntimeError, AssertionError)):
        coastal_box_problem(batch=2)
    ctx = build_triangle_context(1, mesh, dtype=torch.float32, device="cpu")
    prob = MPCProblem(ctx=ctx, phys=SWPhysics(), dt=1e-3, horizon=2)
    bump = np.ones((1, ctx.k_elem, ctx.n_p))
    with pytest.raises((RuntimeError, AssertionError)):
        build_fused_mpc(prob, bump, bump)
    fm = build_fused_mpc(prob, bump, bump, device="cpu")
    assert fm.ops.fbuf.device.type == "cpu"


def test_blocked_entry_points_default_to_cuda():
    """The blocked path's entry points: no ``device=`` means the card, and
    without a card that raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from blitzdg_tpu_torch import convert
    from blitzdg_tpu_torch.mesh import box_triangles
    from blitzdg_tpu_torch.mpc import MPCProblem, build_blocked_mpc
    from blitzdg_tpu_torch.mpc.blocked_box import (blocked_box_problem,
                                                   blocked_rollout_problem)
    from blitzdg_tpu_torch.ops import build_blocked_step_ops
    from blitzdg_tpu_torch.ops.sw2d import SWPhysics
    from blitzdg_tpu_torch.specgrid.triangle import build_triangle_context

    ctx = build_triangle_context(1, box_triangles(2, 2), dtype=torch.float32,
                                 device="cpu")
    prob = MPCProblem(ctx=ctx, phys=SWPhysics(), dt=1e-3, horizon=2)
    bump = np.ones((1, ctx.k_elem, ctx.n_p))
    cuda_or_nothing = pytest.raises((RuntimeError, AssertionError))
    with cuda_or_nothing:
        build_blocked_step_ops(ctx, SWPhysics())
    with cuda_or_nothing:
        build_blocked_mpc(prob, bump, bump)
    with cuda_or_nothing:
        blocked_box_problem(batch=2, cells=(2, 2), n_order=1)
    with cuda_or_nothing:
        blocked_rollout_problem(batch=2, cells=(2, 2), n_order=1, n_steps=2)
    sig = inspect.signature(convert.blocked_step_ops_from_numpy)
    assert sig.parameters["device"].default == "cuda"
    bm = build_blocked_mpc(prob, bump, bump, device="cpu")
    assert bm.ops.fbuf.device.type == "cpu" and bm.wj.device.type == "cpu"


def test_matmul_precision_is_full_float32():
    assert torch.backends.cuda.matmul.allow_tf32 is False
