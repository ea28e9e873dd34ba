"""Matrix-free Krylov solvers: CG and restarted GMRES.

Counterpart of the JAX package's ``blitzdg_tpu/solvers/krylov.py`` (the
seven convergence flags, ``SolveResult``, ``_reducers``, ``cg``,
``gmres``), with the same exit taxonomy in the same order. The recurrence
claiming success while the true residual misses ``tol`` (CONV_TRUE_RNRM)
is tested before a CG breakdown, so it masks CONV_BREAKDOWN, as in the
reference.

Batching is native. ``b`` is ``(n,)`` or ``(..., n)``; every dot product
reduces over the last axis only, so each right-hand side has its own
scalars, ``iters``, ``relres`` and ``flag``. The loops run while any
right-hand side is still active and freeze the finished ones (their
iterate, residual and counters stop moving), which is what the JAX
package's ``while_loop`` does under ``vmap``: the per-RHS results are
those of the unbatched solve. ``matvec`` and ``precon`` receive the
batched vectors, ``(..., n)``, frozen rows included.

Each loop condition is read on the host (one device-to-host copy an
iteration, or an Arnoldi step). GMRES keeps its Krylov basis on the device
and orthogonalizes by modified Gram-Schmidt there (two launches a basis
vector); the small Hessenberg column, its Givens rotations and the
back-substitution are host work in the vectors' own dtype, one
device-to-host copy of the new column an Arnoldi step.

``group``: a ``torch.distributed`` process group over which the vectors are
split (each rank holds its slice of ``n``); every dot product and norm then
sums its local partial with one ``all_reduce``, and the stagnation test
counts violations across the ranks (the counterpart of ``axis_name`` under
``shard_map``). That serves CPU tensors. On the card, one slice a rank,
``ring``: this rank's ``parallel.HaloRing``, whose sum kernel
(``peer_rank_sum``) adds the ranks' partials in rank order in the vectors'
dtype, so that every rank holds the same bits and takes the same loop
decisions; the violation counts are summed in float64, which is exact.
Vectors on the card with a ``group`` and no ``ring`` raise.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

# Convergence flags (same values as the JAX package)
CONV_SUCCESS = 0
CONV_MAXITS = 1
CONV_BREAKDOWN = 2
CONV_INF_OR_NAN = 3
CONV_DIVERGED = 4  # residual grew past div_tol * ||r0||
CONV_STAGNATION = 5  # |dx_i| <= stg_tol*|x_i| for all i
# recurrence claimed convergence but the true residual b - A x misses tol
CONV_TRUE_RNRM = 6


class SolveResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor  # iterations (CG) or outer restarts (GMRES)
    relres: torch.Tensor
    flag: torch.Tensor


def _reducers(group=None, ring=None, like=None):
    """(dot, norm, all) reductions over the last axis: local, or summed over
    the ranks of ``ring`` (its sum kernel) or of ``group`` (``all_reduce``;
    refused for ``like``, the right-hand side, on the card)."""
    def local_dot(a, b):
        return torch.sum(a * b, dim=-1)

    if ring is not None:
        from ..parallel.peer import peer_rank_sum

        def ring_dot(a, b):
            return peer_rank_sum(ring, local_dot(a, b).contiguous())

        def ring_all(pred):
            bad = torch.sum(~pred, dim=-1).to(torch.float64)
            return peer_rank_sum(ring, bad) == 0

        return ring_dot, lambda a: torch.sqrt(ring_dot(a, a)), ring_all

    if group is not None and like is not None and like.is_cuda:
        raise ValueError(
            "across ranks on the card the solver's sums take this rank's "
            "ring (ring=: a parallel.HaloRing); the process group's "
            "all_reduce serves CPU tensors")
    if group is None:
        return (local_dot, lambda a: torch.sqrt(local_dot(a, a)),
                lambda pred: torch.all(pred, dim=-1))

    import torch.distributed as dist

    def dot(a, b):
        s = local_dot(a, b)
        dist.all_reduce(s, group=group)
        return s

    def norm(a):
        return torch.sqrt(dot(a, a))

    def all_(pred):
        # all-true iff no rank saw a violation
        bad = torch.sum(~pred, dim=-1)
        dist.all_reduce(bad, group=group)
        return bad == 0

    return dot, norm, all_


def _keep(active: torch.Tensor, new: torch.Tensor, old: torch.Tensor):
    """``new`` where the right-hand side is active, else ``old``; scalars
    have the batch shape, vectors one more axis."""
    if new.dim() > active.dim():
        active = active[..., None]
    return torch.where(active, new, old)


def _exit_flag(relres, tol, cases):
    """The exit flag: SUCCESS, INF_OR_NAN, then ``cases`` (condition, flag)
    in order of precedence, MAXITS last."""
    flag = torch.full(relres.shape, CONV_MAXITS, dtype=torch.int64,
                      device=relres.device)
    for cond, code in reversed(cases):
        flag = torch.where(cond, torch.full_like(flag, code), flag)
    flag = torch.where(~torch.isfinite(relres),
                       torch.full_like(flag, CONV_INF_OR_NAN), flag)
    return torch.where(relres <= tol, torch.full_like(flag, CONV_SUCCESS),
                       flag)


def cg(
    matvec: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    tol: float = 1e-6,
    maxiter: int = 1000,
    precon: Callable | None = None,
    group=None,
    ring=None,
) -> SolveResult:
    """Preconditioned conjugate gradients for SPD operators.

    Breakdown and divergence guards as in the JAX package: stop on a
    non-positive or non-finite pAp, or when the residual norm has grown
    past 1e4 times its best, returning the best iterate seen. The exit
    reports the true relative residual ||b - A x|| / ||b|| (one more
    matvec). ``group`` / ``ring``: the vectors split over ranks (see the
    module)."""
    dot, norm, _ = _reducers(group, ring, b)
    if x0 is None:
        x0 = torch.zeros_like(b)
    if precon is None:
        precon = lambda v: v
    lead = b.shape[:-1]

    bnorm = norm(b)
    bnorm = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))

    x = x0
    r = b - matvec(x0)
    p = precon(r)
    rz = dot(r, p)
    rmin = norm(r)
    xbest = x0
    it = torch.zeros(lead, dtype=torch.int64, device=b.device)
    broke = torch.zeros(lead, dtype=torch.bool, device=b.device)

    while True:
        active = (~broke) & (norm(r) / bnorm > tol) & (it < maxiter)
        if not bool(active.any()):
            break
        Ap = matvec(p)
        pAp = dot(p, Ap)
        ok = torch.isfinite(pAp) & (pAp > 0)
        alpha = torch.where(ok, rz / torch.where(ok, pAp, torch.ones_like(pAp)),
                            torch.zeros_like(pAp))
        x_n = x + alpha[..., None] * p
        r_n = r - alpha[..., None] * Ap
        rn = norm(r_n)
        improved = rn < rmin
        xbest_n = _keep(improved, x_n, xbest)
        rmin_n = torch.minimum(rn, rmin)
        diverging = ~torch.isfinite(rn) | (rn > 1e4 * rmin_n)
        z_n = precon(r_n)
        rz_new = dot(r_n, z_n)
        beta = torch.where(ok, rz_new / rz, torch.zeros_like(rz))
        p_n = z_n + beta[..., None] * p
        rz_n = torch.where(ok, rz_new, rz)

        x, r, p = _keep(active, x_n, x), _keep(active, r_n, r), _keep(active, p_n, p)
        rz, rmin = _keep(active, rz_n, rz), _keep(active, rmin_n, rmin)
        xbest = _keep(active, xbest_n, xbest)
        broke = _keep(active, ~ok | diverging, broke)
        it = it + active.to(it.dtype)

    rn = norm(r)
    use_best = ~torch.isfinite(rn) | (rmin < rn)
    x = _keep(use_best, xbest, x)
    relres_rec = torch.where(use_best, rmin, rn) / bnorm
    # the true residual: the recurrence r drifts from b - A x under roundoff
    relres = norm(b - matvec(x)) / bnorm
    flag = _exit_flag(relres, tol, [(relres_rec <= tol, CONV_TRUE_RNRM),
                                    (broke, CONV_BREAKDOWN)])
    return SolveResult(x=x, iters=it, relres=relres, flag=flag)


def _numpy_dtype(t: torch.Tensor):
    return np.float32 if t.dtype == torch.float32 else np.float64


def gmres(
    matvec: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    tol: float = 1e-6,
    restart: int = 30,
    maxiter: int = 100,
    precon: Callable | None = None,
    div_tol: float = 1e5,
    stg_tol: float = 1e-12,
    group=None,
    ring=None,
) -> SolveResult:
    """Right-preconditioned restarted GMRES(m).

    Arnoldi with modified Gram-Schmidt and progressive Givens rotations:
    after step j the rotated right-hand side |g[j+1]| is the cycle's
    residual norm, so a cycle ends as soon as it clears ``tol``. The
    triangular least-squares problem is solved at the end of each cycle,
    and the true residual b - A x is formed there (it seeds the next
    cycle). ``maxiter`` counts restart cycles. Exit flags: success,
    inf/nan, diverged (||r|| >= div_tol ||r0||), stagnation (no component
    with x_j != 0 moved by more than stg_tol |x_j| in a cycle), true-rnrm
    (the last cycle's recurrence claimed convergence, the true residual
    disagrees), maxits. ``group`` / ``ring``: the vectors split over ranks
    (see the module).
    """
    dot, norm, all_ = _reducers(group, ring, b)
    if x0 is None:
        x0 = torch.zeros_like(b)
    if precon is None:
        precon = lambda v: v

    lead = b.shape[:-1]
    nb = int(np.prod(lead)) if lead else 1
    m = restart
    npt = _numpy_dtype(b)

    bnorm = norm(b)
    bnorm = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
    tol_b = (tol * bnorm).reshape(nb).cpu().numpy().astype(npt)

    def host(t):
        return t.reshape(nb, *t.shape[len(lead):]).cpu().numpy()

    def arnoldi_cycle(x, r, outer):
        beta = norm(r)
        zero_row = torch.zeros_like(r)
        V = [r / torch.where(beta > 0, beta, torch.ones_like(beta))[..., None]]
        R = np.zeros((nb, m + 1, m), dtype=npt)  # Givens-triangularized H
        cs = np.zeros((nb, m), dtype=npt)
        sn = np.zeros((nb, m), dtype=npt)
        g = np.zeros((nb, m + 1), dtype=npt)
        g[:, 0] = host(beta)
        done = np.zeros(nb, dtype=bool)
        j_used = np.zeros(nb, dtype=np.int64)
        live = host(outer).copy()

        for j in range(m):
            step = live & ~done
            if not step.any():
                break
            w = matvec(precon(V[j]))
            hs = []
            for i in range(j + 1):  # modified Gram-Schmidt
                hij = dot(V[i], w)
                w = w - hij[..., None] * V[i]
                hs.append(hij)
            hnext = norm(w)
            row = w / torch.where(hnext > 1e-30, hnext,
                                  torch.ones_like(hnext))[..., None]
            step_dev = torch.as_tensor(step.reshape(lead), device=b.device)
            V.append(torch.where(step_dev[..., None], row, zero_row))

            col = host(torch.stack(hs + [hnext], dim=-1))  # (nb, j+2)
            h = np.zeros((nb, m + 1), dtype=npt)
            h[:, :j + 2] = col
            # the accumulated rotations, then the one zeroing h[j+1]
            for i in range(j):
                hi = cs[:, i] * h[:, i] + sn[:, i] * h[:, i + 1]
                hip = -sn[:, i] * h[:, i] + cs[:, i] * h[:, i + 1]
                h[:, i], h[:, i + 1] = hi, hip
            denom = np.sqrt(h[:, j] ** 2 + h[:, j + 1] ** 2)
            pos = denom > 0
            safe = np.where(pos, denom, npt(1.0))
            c_new = np.where(pos, h[:, j] / safe, npt(1.0)).astype(npt)
            s_new = np.where(pos, h[:, j + 1] / safe, npt(0.0)).astype(npt)
            h[:, j] = c_new * h[:, j] + s_new * h[:, j + 1]
            h[:, j + 1] = 0.0
            g_next = -s_new * g[:, j]
            g_j = c_new * g[:, j]
            res_est = np.abs(g_next)
            now_done = (res_est <= tol_b) | (col[:, j + 1] <= 1e-30)

            a = step
            cs[a, j], sn[a, j] = c_new[a], s_new[a]
            R[a, :, j] = h[a]
            g[a, j + 1], g[a, j] = g_next[a], g_j[a]
            done[a] = now_done[a]
            j_used[a] = j + 1

        # back-substitute R[:j, :j] y = g[:j] per right-hand side; columns
        # past j_used get a unit diagonal and a zero right-hand side, so
        # their y is exactly 0
        live_c = np.arange(m)[None, :] < j_used[:, None]  # (nb, m)
        Rsq = np.where(live_c[:, :, None] & live_c[:, None, :], R[:, :m, :],
                       np.eye(m, dtype=npt)[None])
        y = _solve_upper(Rsq, np.where(live_c, g[:, :m], npt(0.0)),
                         int(j_used.max()))
        # an active right-hand side took a step, so V has a row past V[0]
        n_rows = min(len(V) - 1, m)
        ydev = torch.as_tensor(y[:, :n_rows], dtype=b.dtype,
                               device=b.device).reshape(*lead, n_rows)
        Vm = torch.stack(V[:n_rows], dim=-2)  # (..., rows, n)
        dx = precon(torch.einsum("...k,...kn->...n", ydev, Vm))
        x_new = x + dx
        r_new = b - matvec(x_new)
        res = norm(r_new)
        stag = all_((x_new == 0) | (torch.abs(dx) <= stg_tol * torch.abs(x_new)))
        g_end = g[np.arange(nb), j_used]
        rec_ok = torch.as_tensor((np.abs(g_end) <= tol_b).reshape(lead),
                                 device=b.device)
        return x_new, r_new, res, stag, rec_ok

    x, r = x0, b - matvec(x0)
    res0 = norm(r)
    res = res0
    false = torch.zeros(lead, dtype=torch.bool, device=b.device)
    it = torch.zeros(lead, dtype=torch.int64, device=b.device)
    stag, div, rec_ok = false, false, false

    while True:
        active = ((res / bnorm > tol) & (it < maxiter) & torch.isfinite(res)
                  & ~stag & ~div)
        if not bool(active.any()):
            break
        x_n, r_n, res_n, stag_n, rec_n = arnoldi_cycle(x, r, active)
        div_n = res_n >= div_tol * res0
        x, r = _keep(active, x_n, x), _keep(active, r_n, r)
        res = _keep(active, res_n, res)
        stag, div = _keep(active, stag_n, stag), _keep(active, div_n, div)
        rec_ok = _keep(active, rec_n, rec_ok)
        it = it + active.to(it.dtype)

    relres = res / bnorm
    flag = _exit_flag(relres, tol, [(div, CONV_DIVERGED),
                                    (stag, CONV_STAGNATION),
                                    (rec_ok, CONV_TRUE_RNRM)])
    return SolveResult(x=x, iters=it, relres=relres, flag=flag)


def _solve_upper(R: np.ndarray, g: np.ndarray, n: int) -> np.ndarray:
    """Back substitution of the upper-triangular systems R[b] y[b] = g[b],
    all right-hand sides at once; rows from ``n`` on are identity rows with
    a zero right-hand side. A zero on the diagonal gives inf or nan, not an
    error (the solve's exit flags then report it)."""
    y = np.zeros_like(g)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for i in range(n - 1, -1, -1):
            acc = g[:, i] - np.einsum("bk,bk->b", R[:, i, i + 1:n],
                                      y[:, i + 1:n])
            y[:, i] = acc / R[:, i, i]
    return y
