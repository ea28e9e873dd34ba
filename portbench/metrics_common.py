"""Readings that several per-layer metrics share."""


def roofline_pct(rec: dict, role: str):
    """The least time of one launch of the cell's ``role`` kernel (from
    ``counts/``) over its mean device time per launch in the trace, in per
    cent; None where the trace holds no such launch."""
    tr = rec.get("trace")
    if not tr or role not in tr["roles"]:
        return None
    name = tr["roles"][role]
    times = [s for k, s in tr["kernels"] if k == name]
    if not times:
        return None
    mean_ms = 1e3 * sum(times) / len(times)
    return 100.0 * tr["bound_ms"][role] / mean_ms
