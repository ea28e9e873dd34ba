"""The reference's optimizers: fixed-iteration Adam and Gauss-Newton with
Levenberg-Marquardt damping over per-scenario costs.

Frozen copies of ``blitzdg_tpu_torch/mpc/solver.py`` (``adam_update``,
``adam_minimize``) and ``blitzdg_tpu_torch/mpc/blocked.py`` (``_adam_solve``,
``_gn_lm_fd``) at commit dfe7828, the algorithms the benchmark's cells
state: Adam with b1 = 0.9, b2 = 0.999, eps = 1e-8 and bias correction;
Gauss-Newton whose Jv is a forward difference and whose J^T u is a
gradient. Each returns what the measured solvers return, so that one
comparison reads both.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Solution(NamedTuple):
    controls: torch.Tensor  # (B, horizon, n_ctrl)
    cost: torch.Tensor  # (B,) at the controls
    cost_history: torch.Tensor  # (iters, B)
    grad_norm: torch.Tensor | None = None  # (B,) at the controls


def adam_minimize(total: Callable, init: torch.Tensor, iters: int,
                  learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8):
    """Adam over ``total(c) -> (B,)``; the sum is differentiated. Returns
    (controls, cost history (iters, B))."""
    c = init.detach().clone()
    mu, nu = torch.zeros_like(c), torch.zeros_like(c)
    history = []
    for count in range(1, iters + 1):
        c.requires_grad_(True)
        costs = total(c)
        (grad,) = torch.autograd.grad(costs.sum(), c)
        history.append(costs.detach())
        c = c.detach()
        mu = b1 * mu + (1.0 - b1) * grad
        nu = b2 * nu + (1.0 - b2) * grad * grad
        mu_hat = mu / (1.0 - b1 ** count)
        nu_hat = nu / (1.0 - b2 ** count)
        c = c - learning_rate * mu_hat / (torch.sqrt(nu_hat) + eps)
    return c, torch.stack(history, dim=0)


def adam_final_cost(total: Callable, init, iters: int, lr: float) -> Solution:
    """Adam, then the cost at the returned controls (no gradient)."""
    c, history = adam_minimize(total, init, iters, lr)
    with torch.no_grad():
        final = total(c)
    return Solution(c, final, history)


def cost_and_grad_norm(total: Callable, c: torch.Tensor):
    """(cost (B,), |d cost / d c| (B,)) at ``c``."""
    c = c.detach().requires_grad_(True)
    costs = total(c)
    (g,) = torch.autograd.grad(costs.sum(), c)
    return costs.detach(), torch.sqrt(torch.sum(g * g, dim=(-2, -1)))


def _bdot(a, b):
    return torch.sum(a * b, dim=tuple(range(1, a.dim())))


def gauss_newton(R: Callable, c0: torch.Tensor, *, gn_iters: int,
                 cg_iters: int, lm_lambda0: float, fd_eps: float) -> Solution:
    """Batched Gauss-Newton/Levenberg-Marquardt on residuals R(c)
    (B, n_res): per outer iteration the linearization, g = J^T R, the
    damping from the curvature along g, ``cg_iters`` steps of CG on
    (J^T J + lam I) d = -g with Jv by a forward difference of step
    fd_eps (|c| + 1) / |v|, then c + d kept where it lowers the cost
    (lam x 0.4) or refused (lam x 4). Returns the cost, the history of
    accepted costs and 2 |J^T R| at the final controls."""
    one = torch.ones_like

    def linearize(c):
        c = c.detach().requires_grad_(True)
        r = R(c)

        def pullback(u):
            (g,) = torch.autograd.grad(r, c, u, retain_graph=True)
            return g

        return r.detach(), pullback

    def R_nograd(c):
        with torch.no_grad():
            return R(c)

    c = c0.detach().clone()
    lam = torch.full((c.shape[0],), lm_lambda0, dtype=c.dtype, device=c.device)
    history = []
    for _ in range(gn_iters):
        r, pullback = linearize(c)
        cost = _bdot(r, r)
        g = pullback(r)

        def jv_fd(v):
            vn = torch.sqrt(_bdot(v, v))[:, None, None]
            cn = torch.sqrt(_bdot(c, c))[:, None, None]
            eps = fd_eps * (cn + 1.0) / torch.where(vn > 0, vn, one(vn))
            return (R_nograd(c + eps * v) - r) / eps[:, :, 0]

        gn2 = _bdot(g, g)
        Jg = jv_fd(g)
        curv = _bdot(Jg, Jg) / torch.where(gn2 > 0, gn2, one(gn2))
        lam_eff = (lam * torch.where(curv > 0, curv, one(curv)))[:, None, None]

        def jtjv(v):
            return pullback(jv_fd(v)) + lam_eff * v

        x = torch.zeros_like(g)
        rr = -g
        p = rr
        rs = _bdot(rr, rr)
        for _ in range(cg_iters):
            Ap = jtjv(p)
            denom = _bdot(p, Ap)
            ok = denom > 0
            zero = torch.zeros_like(rs)
            alpha = torch.where(ok, rs / torch.where(ok, denom, one(denom)),
                                zero)[:, None, None]
            x = x + alpha * p
            rr = rr - alpha * Ap
            rs_new = _bdot(rr, rr)
            beta = torch.where(ok, rs_new / torch.where(rs > 0, rs, one(rs)),
                               zero)[:, None, None]
            p = rr + beta * p
            rs = rs_new

        r_new = R_nograd(c + x)
        new_cost = _bdot(r_new, r_new)
        accept = new_cost < cost
        c = torch.where(accept[:, None, None], c + x, c)
        lam = torch.where(accept, lam * 0.4, lam * 4.0)
        history.append(torch.where(accept, new_cost, cost))

    r_fin, pb_fin = linearize(c)
    gfin = pb_fin(r_fin)
    return Solution(c, _bdot(r_fin, r_fin), torch.stack(history, dim=0),
                    2.0 * torch.sqrt(_bdot(gfin, gfin)))
