"""What a request returns, on either side of the check."""
from __future__ import annotations

from typing import NamedTuple

import torch


class Response(NamedTuple):
    controls: torch.Tensor  # (B, horizon, n_ctrl)
    cost: torch.Tensor  # (B,) at the controls
    history: torch.Tensor  # (iterations, B): Adam's costs or GN's accepted
    grad_norm: torch.Tensor | None  # (B,) at the controls, where reported
    plant: tuple  # (B, K, Np) per field after one control interval

    def rows(self, idx: torch.Tensor) -> "Response":
        """The answers of the scenarios ``idx`` alone."""
        pick = lambda t: t.index_select(0, idx)
        return Response(
            pick(self.controls), pick(self.cost),
            self.history.index_select(1, idx),
            None if self.grad_norm is None else pick(self.grad_norm),
            tuple(pick(f) for f in self.plant))


def cat(parts: list) -> Response:
    """Kept answers of several requests as one batch."""
    g = [p.grad_norm for p in parts]
    return Response(
        torch.cat([p.controls for p in parts]),
        torch.cat([p.cost for p in parts]),
        torch.cat([p.history for p in parts], dim=1),
        None if g[0] is None else torch.cat(g),
        tuple(torch.cat(f) for f in zip(*(p.plant for p in parts))))
