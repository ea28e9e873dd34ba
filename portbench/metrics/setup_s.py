"""Seconds from the process's start to the window's: imports, the card,
the kernels' build or load, the problem's set-up, the pool, the warm-up;
not the reference's own mesh, which serves the pool and the check."""


def read(rec: dict):
    return rec["setup_s"]
