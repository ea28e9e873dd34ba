"""Each cell's load cut to a size a CPU test holds (the sizes of the
solve, not the configuration, are cut)."""

SMALL = {
    "coastal.adam_b8192": {
        "batch": 4, "pool": 2,
        "solver": {"kind": "adam", "iters": 3, "lr": 0.05},
        "warm_solver": {"kind": "adam", "iters": 1, "lr": 0.05}},
    "curved.adam_b32": {
        "batch": 2, "pool": 2,
        "solver": {"kind": "adam", "iters": 2, "lr": 0.05},
        "warm_solver": {"kind": "adam", "iters": 1, "lr": 0.05}},
    "curved.gn_b32": {
        "batch": 2, "pool": 2,
        "solver": {"kind": "gn", "gn_iters": 2, "cg_iters": 2,
                   "lm_lambda0": 0.01, "fd_eps": 0.01},
        "warm_solver": {"kind": "gn", "gn_iters": 1, "cg_iters": 1,
                        "lm_lambda0": 0.01, "fd_eps": 0.01}},
}


def small(cell: str) -> dict:
    """The cut load, every answer kept and checked."""
    load = SMALL[cell]
    return {**load, "sample": {"per_request": load["batch"],
                               "checked": 2 * load["batch"]}}
