"""Frozen copies of the measured package's host builders and plain
right-hand sides, the reference's own (each file names its origin)."""
