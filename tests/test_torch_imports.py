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
            "mpc.blocked_box",
            # the curved weak-form path
            "mesh.curved", "mesh.periodic", "specgrid.cubature",
            "ops.sw2d_curved", "ops.sw2d_curved_blocked",
            "mpc.curved_blocked", "mpc.curved_disk",
            # the element-sharded path
            "parallel.halo", "parallel.distributed", "parallel.blocked_shard",
            "mpc.sharded_box",
            # the elliptic solvers and the 1D context they need
            "solvers", "solvers.krylov", "solvers.precon", "ops.poisson",
            "ops.sem", "specgrid.nodes1d"}
    have = {m.removeprefix("blitzdg_tpu_torch.") for m in port_modules()}
    assert want <= have
    for name in ("sw2d_dense.cu", "sw2d_blocked.cu", "sw2d_curved.cu",
                 "sw2d_common.cuh"):
        assert (PKG / "ops" / "csrc" / name).exists()


def test_cubature_tables_are_the_jax_packages_byte_for_byte():
    """The port opens its own copy of the compact cubature rules."""
    name = "_cubature_tables.npz"
    own = (PKG / "specgrid" / name).read_bytes()
    assert own == (ROOT / "blitzdg_tpu" / "specgrid" / name).read_bytes()
    src = (PKG / "specgrid" / "cubature.py").read_text()
    assert f'os.path.join(os.path.dirname(__file__), "{name}")' in src


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


def test_curved_entry_points_default_to_cuda():
    """The curved path's entry points: no ``device=`` means the card, and
    without a card that raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from blitzdg_tpu_torch import convert
    from blitzdg_tpu_torch.mesh import box_triangles
    from blitzdg_tpu_torch.mpc import MPCProblem, build_curved_blocked_mpc
    from blitzdg_tpu_torch.mpc.curved_disk import (curved_disk_contexts,
                                                   curved_disk_problem)
    from blitzdg_tpu_torch.ops import build_curved_blocked_ops
    from blitzdg_tpu_torch.ops.sw2d import SWPhysics
    from blitzdg_tpu_torch.specgrid.cubature import (
        build_cubature_context, build_gauss_face_context)
    from blitzdg_tpu_torch.specgrid.triangle import build_triangle_context

    mesh = box_triangles(2, 2)
    ctx = build_triangle_context(1, mesh, dtype=torch.float64, device="cpu")
    geom = (1, mesh, ctx.x.numpy(), ctx.y.numpy(), ctx.V.numpy())
    cuda_or_nothing = pytest.raises((RuntimeError, AssertionError))
    with cuda_or_nothing:
        build_cubature_context(*geom)
    with cuda_or_nothing:
        build_gauss_face_context(*geom)
    cub = build_cubature_context(*geom, device="cpu")
    gauss = build_gauss_face_context(*geom, device="cpu")
    prob = MPCProblem(ctx=ctx, phys=SWPhysics(), dt=1e-3, horizon=2)
    bump = np.ones((1, ctx.k_elem, ctx.n_p))
    with cuda_or_nothing:
        build_curved_blocked_ops(ctx, cub, gauss, SWPhysics())
    with cuda_or_nothing:
        build_curved_blocked_mpc(prob, cub, gauss, bump, bump)
    with cuda_or_nothing:
        curved_disk_contexts(1, 0.3, n_order=1)
    with cuda_or_nothing:
        curved_disk_problem(rings=1, snap_tol=0.3, batch=2, n_order=1)
    for fn in (convert.cubature_from_numpy, convert.gauss_from_numpy,
               convert.curved_blocked_ops_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    bm = build_curved_blocked_mpc(prob, cub, gauss, bump, bump, device="cpu")
    assert bm.ops.fbuf.device.type == "cpu" and bm.wj.device.type == "cpu"
    assert bm.meta.mass_mode == "affine"


def test_sharded_entry_points_default_to_cuda():
    """The sharded path's entry points: no ``device=`` means the card, and
    without a card that raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from blitzdg_tpu_torch import convert
    from blitzdg_tpu_torch.mesh import box_triangles
    from blitzdg_tpu_torch.mpc import sharded_box as sbx
    from blitzdg_tpu_torch.ops.sw2d import SWPhysics
    from blitzdg_tpu_torch.ops.sw2d_blocked import (RdmaLaunch,
                                                    sw2d_step_rdma_blocked)
    from blitzdg_tpu_torch.parallel import (RingExchange,
                                            build_sharded_blocked,
                                            make_sharded_blocked_step_rdma,
                                            partition_mesh)
    from blitzdg_tpu_torch.specgrid.triangle import build_triangle_context

    mesh = partition_mesh(box_triangles(2, 2), 2)[0]
    ctx = build_triangle_context(1, mesh, dtype=torch.float32, device="cpu")
    cuda_or_nothing = pytest.raises((RuntimeError, AssertionError))
    with cuda_or_nothing:
        build_sharded_blocked(ctx, SWPhysics(), 2)
    with cuda_or_nothing:
        sbx.sharded_rollout_problem(2, 1, n_steps=1, n_order=1, cells=(2, 2))
    with cuda_or_nothing:
        sbx.sharded_mpc_problem(dict(sbx.EXAMPLE, cells=(2, 2), n_shards=2))
    sb = build_sharded_blocked(ctx, SWPhysics(), 2, device="cpu")
    assert sb.ops.fbuf.device.type == "cpu" and sb.ops.fbuf.shape[0] == 2
    with cuda_or_nothing:
        RingExchange(sb.plan, sb.meta.n_fp)
    # the one-launch step: its ring exchange defaults to the card; on a CPU
    # set the step runs its plain version and launches nothing
    with cuda_or_nothing:
        RdmaLaunch(sb.ops, sb.meta, RingExchange(sb.plan, sb.meta.n_fp))
    before = sw2d_step_rdma_blocked.launches
    r = sbx.sharded_rollout_problem(2, 1, n_steps=1, n_order=1, cells=(2, 2),
                                    device="cpu")
    end = sbx.sharded_rollout(r, 1, make_sharded_blocked_step_rdma)
    assert end[0].device.type == "cpu" and bool(torch.isfinite(end[0]).all())
    assert sw2d_step_rdma_blocked.launches == before
    for fn in (convert.sharded_blocked_from_numpy,
               sbx.sharded_rollout_problem):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_elliptic_and_solver_entry_points_default_to_cuda():
    """The elliptic path's set-up (1D context, block inverses, two-level
    preconditioner): no ``device=`` means the card, and without a card that
    raises; the solvers follow their inputs' device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from blitzdg_tpu_torch import convert
    from blitzdg_tpu_torch.context import DGContext1D
    from blitzdg_tpu_torch.mesh import box_triangles
    from blitzdg_tpu_torch.ops.poisson import assemble_poisson2d
    from blitzdg_tpu_torch.solvers import (block_jacobi_from_assembled, cg,
                                           invert_blocks,
                                           two_level_from_assembled)
    from blitzdg_tpu_torch.specgrid import build_nodes1d
    from blitzdg_tpu_torch.specgrid.triangle import build_triangle_context

    cuda_or_nothing = pytest.raises((RuntimeError, AssertionError))
    with cuda_or_nothing:
        build_nodes1d(2, 4, 0.0, 1.0)
    ctx1 = build_nodes1d(2, 4, 0.0, 1.0, device="cpu")
    assert isinstance(ctx1, DGContext1D) and ctx1.x.device.type == "cpu"
    ctx = build_triangle_context(1, box_triangles(2, 2), dtype=torch.float64,
                                 device="cpu")
    OP, _ = assemble_poisson2d(ctx)
    with cuda_or_nothing:
        invert_blocks(np.eye(3)[None])
    with cuda_or_nothing:
        block_jacobi_from_assembled(OP, ctx.k_elem, ctx.n_p)
    with cuda_or_nothing:
        two_level_from_assembled(ctx, OP)
    for fn in (convert.context1d_from_numpy, block_jacobi_from_assembled,
               two_level_from_assembled, build_nodes1d):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    pre = block_jacobi_from_assembled(OP, ctx.k_elem, ctx.n_p, device="cpu")
    b = torch.ones(ctx.k_elem * ctx.n_p, dtype=torch.float32)
    res = cg(lambda v: v, b, precon=pre)
    assert res.x.device.type == "cpu"
