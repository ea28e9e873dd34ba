"""The adjoint rollout kernel's share of its roofline (B3, B12)."""
from portbench.metrics_common import roofline_pct


def read(rec: dict):
    return roofline_pct(rec, "bwd_rollout")
