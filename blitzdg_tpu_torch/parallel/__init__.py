"""Mesh partitioning and ordering (see ``partition.py``)."""
from .partition import rcm_order

__all__ = ["rcm_order"]
