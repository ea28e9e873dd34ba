"""The port's Krylov solvers against the JAX package's on the same inputs
(CPU, float64 unless a case says otherwise): the cases of
``tests/test_poisson.py::TestKrylov`` and ``TestGMRESFlags`` through both
``solvers.krylov`` modules. Each case must give the same flag and the same
iteration count, and x within 1e-10 relative, except where x is set by
roundoff (said at the case).

Batching: three right-hand sides, one of which converges early, through
the port's batched solve against the JAX solve under ``vmap``: the same
per-RHS iteration counts and flags, x within 1e-10, and the early
right-hand side's iterate frozen once it converged (equal to its own
unbatched solve).

Process groups: two gloo processes each hold half of a diagonal SPD system
and solve it with ``group=``; each half equals the single-process solve.
"""
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blitzdg_tpu.solvers import krylov as jk
from blitzdg_tpu_torch.solvers import krylov as tk


def both(name, A, b, dtype=np.float64, offset=None, x0=None, **kw):
    """The same solve through both packages: (jax result, port result)."""
    A = np.asarray(A, dtype=dtype)
    b = np.asarray(b, dtype=dtype)
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    cj = 0.0 if offset is None else jnp.asarray(offset, dtype=dtype)
    ct = 0.0 if offset is None else torch.as_tensor(offset.astype(dtype))
    j0 = None if x0 is None else jnp.asarray(x0, dtype=dtype)
    t0 = None if x0 is None else torch.as_tensor(np.asarray(x0, dtype=dtype))
    rj = getattr(jk, name)(lambda v: Aj @ v + cj, jnp.asarray(b), j0, **kw)
    rt = getattr(tk, name)(lambda v: v @ At.T + ct, torch.as_tensor(b), t0,
                           **kw)
    return rj, rt


def assert_same(rj, rt, x_rtol=1e-10):
    """Same flag and iteration count; x within ``x_rtol`` of the largest
    entry and relres to 1e-6 (relres below 1e-13 is roundoff), unless
    ``x_rtol`` is None (x and relres are roundoff)."""
    assert int(rt.flag) == int(rj.flag)
    assert int(rt.iters) == int(rj.iters)
    if x_rtol is None:
        return
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=0,
                               atol=x_rtol * np.abs(xj).max())
    np.testing.assert_allclose(float(rt.relres), float(rj.relres), rtol=1e-6,
                               atol=1e-13)


def spd(n, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n))
    return A @ A.T + n * np.eye(n), rng.normal(size=n)


def test_cg_dense_spd():
    A, b = spd(40, 0)
    rj, rt = both("cg", A, b, tol=1e-10)
    assert int(rt.flag) == tk.CONV_SUCCESS
    assert_same(rj, rt)
    np.testing.assert_allclose(rt.x.numpy(), np.linalg.solve(A, b), atol=1e-8)


def test_gmres_dense_nonsymmetric():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(50, 50)) + 10 * np.eye(50)
    b = rng.normal(size=50)
    rj, rt = both("gmres", A, b, tol=1e-10, restart=25)
    assert int(rt.flag) == tk.CONV_SUCCESS
    assert_same(rj, rt)
    np.testing.assert_allclose(rt.x.numpy(), np.linalg.solve(A, b), atol=1e-7)


def test_cg_breakdown_does_not_diverge():
    """A singular PSD system with a right-hand side in the nullspace: the
    guard stops on breakdown and returns a finite iterate."""
    A = np.zeros((12, 12))
    A[:8, :8] = np.diag(np.arange(1.0, 9.0))
    rj, rt = both("cg", A, np.ones(12), tol=1e-14, maxiter=200)
    assert int(rt.flag) == tk.CONV_BREAKDOWN
    assert_same(rj, rt)
    assert 0.1 < float(rt.relres) < 10.0


def test_cg_on_an_affine_operator():
    """A matvec with a constant offset (not linear): the recurrence cannot
    reach tol; both packages use up maxiter the same way."""
    rng = np.random.default_rng(11)
    Q = np.linalg.qr(rng.normal(size=(30, 30)))[0]
    A = Q @ np.diag(np.linspace(1.0, 4.0, 30)) @ Q.T
    rj, rt = both("cg", A, rng.normal(size=30), tol=1e-9, maxiter=200,
                  offset=1e-6 * np.random.default_rng(12).normal(size=30))
    assert int(rt.flag) == tk.CONV_MAXITS
    assert_same(rj, rt)


def test_cg_singular_consistent_converges():
    A = np.zeros((12, 12))
    A[:8, :8] = np.diag(np.arange(1.0, 9.0))
    b = np.zeros(12)
    b[:8] = 1.0
    rj, rt = both("cg", A, b, tol=1e-12, maxiter=100)
    assert int(rt.flag) == tk.CONV_SUCCESS
    assert_same(rj, rt)
    np.testing.assert_allclose(rt.x.numpy()[:8], 1.0 / np.arange(1.0, 9.0),
                               atol=1e-10)


def test_gmres_singular_flags_no_convergence():
    """Singular, inconsistent: maxits are used up and the last cycle's
    recurrence claims convergence (true-rnrm). The Hessenberg matrix is
    singular to roundoff here, so x and relres are roundoff and are not
    compared."""
    A = np.zeros((10, 10))
    A[:9, :9] = np.eye(9)
    rj, rt = both("gmres", A, np.ones(10), tol=1e-12, maxiter=3)
    assert int(rt.flag) != tk.CONV_SUCCESS
    assert_same(rj, rt, x_rtol=None)


def test_gmres_stagnation_flag():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(20, 20)) + 10 * np.eye(20)
    rj, rt = both("gmres", A, rng.normal(size=20), tol=1e-30, restart=2,
                  maxiter=50, stg_tol=1e30)
    assert int(rt.flag) == tk.CONV_STAGNATION
    assert_same(rj, rt)


def test_gmres_diverged_flag():
    rng = np.random.default_rng(4)
    Q = np.linalg.qr(rng.normal(size=(16, 16)))[0]
    A = Q @ np.diag(np.linspace(1e-6, 1.0, 16)) @ Q.T
    rj, rt = both("gmres", A, rng.normal(size=16), tol=1e-30, restart=1,
                  maxiter=100, div_tol=1e-12)
    assert int(rt.flag) == tk.CONV_DIVERGED
    assert_same(rj, rt)


def test_gmres_true_residual_flag():
    """The cycle's recurrence converges while the true residual b - A x
    misses tol: an affine matvec (a constant offset of 1e-6) makes the
    difference exact in float64, so the flag does not rest on roundoff."""
    rng = np.random.default_rng(11)
    Q = np.linalg.qr(rng.normal(size=(30, 30)))[0]
    A = Q @ np.diag(np.linspace(1.0, 4.0, 30)) @ Q.T
    rj, rt = both("gmres", A, rng.normal(size=30), tol=1e-9, restart=30,
                  maxiter=1,
                  offset=1e-6 * np.random.default_rng(12).normal(size=30))
    assert int(rt.flag) == tk.CONV_TRUE_RNRM
    assert float(rt.relres) > 1e-7
    assert_same(rj, rt)


def test_cg_true_residual_flag_float32():
    """The JAX package's case: an ill-conditioned SPD system in float32,
    where the CG recurrence clears tol and the true residual stalls at the
    roundoff floor. Both flag true-rnrm and report the verified true
    residual. Here x and the iteration count are set by float32 roundoff
    (the two packages sum in different orders), so the counts are held to
    1 % and x is not compared."""
    rng = np.random.default_rng(7)
    n = 64
    Q = np.linalg.qr(rng.normal(size=(n, n)))[0]
    A = Q @ np.diag(np.logspace(-5, 0, n)) @ Q.T
    b = rng.normal(size=n)
    rj, rt = both("cg", A, b, dtype=np.float32, tol=1e-6, maxiter=2000)
    assert int(rt.flag) == int(rj.flag) == tk.CONV_TRUE_RNRM
    assert abs(int(rt.iters) - int(rj.iters)) <= 0.01 * int(rj.iters)
    x = rt.x.numpy().astype(np.float64)
    A32, b32 = A.astype(np.float32), b.astype(np.float32)
    true_rel = (np.linalg.norm(b32 - A32.astype(np.float64) @ x)
                / np.linalg.norm(b32))
    np.testing.assert_allclose(float(rt.relres), true_rel, rtol=1e-2)
    assert true_rel > 1e-6


def test_gmres_defaults_still_converge():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(24, 24)) + 8 * np.eye(24)
    b = rng.normal(size=24)
    rj, rt = both("gmres", A, b, tol=1e-10)
    assert int(rt.flag) == tk.CONV_SUCCESS
    assert_same(rj, rt)
    np.testing.assert_allclose(rt.x.numpy(), np.linalg.solve(A, b), atol=1e-7)


def test_flag_values_match():
    for name in ("CONV_SUCCESS", "CONV_MAXITS", "CONV_BREAKDOWN",
                 "CONV_INF_OR_NAN", "CONV_DIVERGED", "CONV_STAGNATION",
                 "CONV_TRUE_RNRM"):
        assert getattr(tk, name) == getattr(jk, name)


def _batched(name, A, B, **kw):
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    rj = jax.vmap(lambda b: getattr(jk, name)(lambda v: Aj @ v, b, **kw))(
        jnp.asarray(B))
    rt = getattr(tk, name)(lambda v: v @ At.T, torch.as_tensor(B), **kw)
    single = getattr(tk, name)(lambda v: v @ At.T, torch.as_tensor(B[1]), **kw)
    return rj, rt, single


@pytest.mark.parametrize("name", ["cg", "gmres"])
def test_batched_rhs_match_vmap_and_freeze(name):
    """Three right-hand sides; the middle one converges at once (an
    eigenvector for GMRES, two eigenvectors for CG). Per-RHS iterations,
    flags, relres and x equal the JAX solve under vmap; the early one's
    iterate stops moving when it converges (its own unbatched solve gives
    it, with the same iteration count)."""
    rng = np.random.default_rng(2)
    n = 30
    if name == "cg":
        Q = np.linalg.qr(rng.normal(size=(n, n)))[0]
        A = Q @ np.diag(np.linspace(1.0, 30.0, n)) @ Q.T
        B = rng.normal(size=(3, n))
        B[1] = Q[:, 0] + Q[:, 1]
        kw = dict(tol=1e-10)
    else:
        A = rng.normal(size=(n, n)) + 8 * np.eye(n)
        A[:, 0] = 0.0
        A[0, 0] = 5.0  # e0 is an eigenvector
        B = rng.normal(size=(3, n))
        B[1] = np.eye(n)[0]
        kw = dict(tol=1e-10, restart=5)
    rj, rt, single = _batched(name, A, B, **kw)
    iters = rt.iters.numpy()
    np.testing.assert_array_equal(iters, np.asarray(rj.iters))
    np.testing.assert_array_equal(rt.flag.numpy(), np.asarray(rj.flag))
    assert iters[1] < min(iters[0], iters[2])
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=0,
                               atol=1e-10 * np.abs(xj).max())
    np.testing.assert_allclose(rt.relres.numpy(), np.asarray(rj.relres),
                               rtol=1e-6, atol=1e-13)
    assert int(single.iters) == iters[1]
    np.testing.assert_allclose(rt.x[1].numpy(), single.x.numpy(), rtol=0,
                               atol=1e-14)
    np.testing.assert_allclose(rt.x.numpy(), np.linalg.solve(A, B.T).T,
                               atol=1e-8)


_WORKER = r'''
import sys
port, rank, repo, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, repo)
import numpy as np, torch
import torch.distributed as dist
from blitzdg_tpu_torch.parallel import distributed_init
from blitzdg_tpu_torch.solvers import cg, gmres

distributed_init(f"tcp://localhost:{port}", 2, rank, backend="gloo")
d = torch.linspace(1.0, 10.0, 40, dtype=torch.float64)
b = torch.as_tensor(np.random.default_rng(0).normal(size=40))
sl = slice(20 * rank, 20 * (rank + 1))
mv = lambda v: d[sl] * v
res = {}
for name, fn, kw in (("cg", cg, dict(tol=1e-12)),
                     ("gmres", gmres, dict(tol=1e-12, restart=6))):
    r = fn(mv, b[sl], group=dist.group.WORLD, **kw)
    res.update({name + "_x": r.x.numpy(), name + "_iters": r.iters.numpy(),
                name + "_flag": r.flag.numpy(),
                name + "_relres": r.relres.numpy()})
np.savez(out, **res)
dist.destroy_process_group()
print(f"RANK_OK {rank}")
'''


def test_two_gloo_ranks_match_the_single_process_solve(tmp_path):
    """``_reducers`` with a process group: a diagonal SPD system split over
    two gloo ranks (20 entries each) gives, on each rank, its half of the
    single-process CG and GMRES solution, with the same iteration count,
    flag and relres."""
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outs = [tmp_path / f"rank{r}.npz" for r in range(2)]
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(port), str(r), repo, str(outs[r])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"RANK_OK {r}" in log, log

    d = torch.linspace(1.0, 10.0, 40, dtype=torch.float64)
    b = torch.as_tensor(np.random.default_rng(0).normal(size=40))
    refs = {"cg": tk.cg(lambda v: d * v, b, tol=1e-12),
            "gmres": tk.gmres(lambda v: d * v, b, tol=1e-12, restart=6)}
    for r in range(2):
        got = np.load(outs[r])
        for name, ref in refs.items():
            np.testing.assert_allclose(got[name + "_x"],
                                       ref.x[20 * r:20 * (r + 1)].numpy(),
                                       rtol=1e-12, atol=0)
            assert int(got[name + "_iters"]) == int(ref.iters)
            assert int(got[name + "_flag"]) == int(ref.flag) == 0
            np.testing.assert_allclose(float(got[name + "_relres"]),
                                       float(ref.relres), rtol=1e-6,
                                       atol=1e-13)
