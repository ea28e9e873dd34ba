"""The forward rollout kernel's share of its roofline (B2, B11)."""
from portbench.metrics_common import roofline_pct


def read(rec: dict):
    return roofline_pct(rec, "fwd_rollout")
