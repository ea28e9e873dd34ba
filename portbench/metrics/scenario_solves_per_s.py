"""Scenarios solved over the window's seconds: every request's batch that
completed, over the time from the window's start to the last completion."""


def read(rec: dict):
    return rec["scenarios"] / rec["window_s"] if rec["window_s"] > 0 else None
