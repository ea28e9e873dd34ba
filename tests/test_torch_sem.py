"""The port's SEM (continuous-Galerkin) Poisson path against the JAX
package's, the cases of ``tests/test_sem.py`` (CPU, float64,
``box_triangles(5, 5)`` at N=3, each package building its own context):
scatter/gather, the matrix-free operator and load vector (to 1e-12, also on
a batch of vectors), the manufactured CG solve (same flag, iterations and
solution as the JAX solve), the assembled oracle against the matrix-free
operator, and the direct solve."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

from blitzdg_tpu.mesh import box_triangles as j_box
from blitzdg_tpu.ops import sem as JS
from blitzdg_tpu.solvers import krylov as jk
from blitzdg_tpu.specgrid.triangle import build_triangle_context as j_build

from blitzdg_tpu_torch.mesh import box_triangles as t_box
from blitzdg_tpu_torch.ops import sem as TS
from blitzdg_tpu_torch.solvers import krylov as tk
from blitzdg_tpu_torch.specgrid.triangle import build_triangle_context as t_build


@pytest.fixture(scope="module")
def pair():
    jc = j_build(3, j_box(5, 5))
    tc = t_build(3, t_box(5, 5), dtype=torch.float64, device="cpu")
    n = TS.sem_num_nodes(tc)
    assert n == JS.sem_num_nodes(jc)
    bnodes = TS.sem_boundary_nodes(tc)
    np.testing.assert_array_equal(bnodes, JS.sem_boundary_nodes(jc))
    mask = np.zeros(n, dtype=bool)
    mask[bnodes] = True
    return jc, tc, mask


def close(got, want, tol=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max())


def test_scatter_gather_consistency(pair):
    jc, tc, _ = pair
    x, y = tc.x.numpy().reshape(-1), tc.y.numpy().reshape(-1)
    gi = tc.gather_ids.numpy()
    np.testing.assert_array_equal(gi, np.asarray(jc.gather_ids))
    u_sem = np.sin(x[gi]) * np.cos(y[gi])
    u_dg = TS.sem_scatter(tc, torch.as_tensor(u_sem))
    np.testing.assert_allclose(u_dg.numpy().reshape(-1),
                               np.sin(x) * np.cos(y), atol=1e-12)
    f = np.random.default_rng(1).standard_normal((2, tc.k_elem, tc.n_p))
    close(TS.sem_gather_add(tc, torch.as_tensor(f)).numpy(),
          jax.vmap(lambda v: JS.sem_gather_add(jc, v))(jnp.asarray(f)))


def test_operator_and_load_vector_match_jax(pair):
    jc, tc, mask = pair
    n = mask.size
    v = np.random.default_rng(3).standard_normal((3, n))
    mj, mt = jnp.asarray(mask), torch.as_tensor(mask)
    want = jax.vmap(lambda u: JS.sem_poisson_op(jc, u, mj))(jnp.asarray(v))
    close(TS.sem_poisson_op(tc, torch.as_tensor(v), mt).numpy(), want)
    f = np.random.default_rng(4).standard_normal((tc.k_elem, tc.n_p))
    close(TS.sem_load_vector(tc, torch.as_tensor(f), mt).numpy(),
          JS.sem_load_vector(jc, jnp.asarray(f), mj))


def test_sem_solve_manufactured_cg_matches_jax(pair):
    """-Lap u = 2 pi^2 sin(pi x) sin(pi y), u = 0 on the boundary."""
    jc, tc, mask = pair
    mj, mt = jnp.asarray(mask), torch.as_tensor(mask)
    fj = 2.0 * np.pi ** 2 * jnp.sin(np.pi * jc.x) * jnp.sin(np.pi * jc.y)
    ft = 2.0 * np.pi ** 2 * torch.sin(np.pi * tc.x) * torch.sin(np.pi * tc.y)
    rj = jk.cg(lambda v: JS.sem_poisson_op(jc, v, mj),
               JS.sem_load_vector(jc, fj, mj), tol=1e-10, maxiter=2000)
    rt = tk.cg(lambda v: TS.sem_poisson_op(tc, v, mt),
               TS.sem_load_vector(tc, ft, mt), tol=1e-10, maxiter=2000)
    assert int(rt.flag) == int(rj.flag) == tk.CONV_SUCCESS
    assert int(rt.iters) == int(rj.iters)
    close(rt.x.numpy(), rj.x, 1e-10)
    x, y = tc.x.numpy().reshape(-1), tc.y.numpy().reshape(-1)
    gi = tc.gather_ids.numpy()
    uex = np.sin(np.pi * x[gi]) * np.sin(np.pi * y[gi])
    assert np.max(np.abs(rt.x.numpy() - uex)) < 6e-3


def test_sem_oracle_matches_jax_and_matrix_free(pair):
    jc, tc, mask = pair
    A, Msem = TS.assemble_sem_poisson(tc)
    Aj, Mj = JS.assemble_sem_poisson(jc)
    close(A.toarray(), Aj.toarray())
    close(Msem.toarray(), Mj.toarray())
    v = np.random.default_rng(3).normal(size=mask.size)
    v[mask] = 0.0
    mf = TS.sem_poisson_op(tc, torch.as_tensor(v), torch.as_tensor(mask))
    free = ~mask
    np.testing.assert_allclose(mf.numpy()[free], (A @ v)[free], atol=1e-9)


def test_sem_direct_solve(pair):
    _, tc, mask = pair
    A, Msem = TS.assemble_sem_poisson(tc)
    free = np.flatnonzero(~mask)
    x, y = tc.x.numpy().reshape(-1), tc.y.numpy().reshape(-1)
    gi = tc.gather_ids.numpy()
    uex = np.sin(np.pi * x[gi]) * np.sin(np.pi * y[gi])
    b = Msem @ (2.0 * np.pi ** 2 * uex)
    u = np.zeros(mask.size)
    u[free] = spla.spsolve(A[np.ix_(free, free)].tocsc(), b[free])
    assert np.max(np.abs(u - uex)) < 6e-3
