"""Host-side output and restart: CSV fields, VTK unstructured grids,
checkpoints. Counterpart of the JAX package's ``blitzdg_tpu/io``."""
from . import csv, vtk
from .checkpoint import restore_checkpoint, save_checkpoint
from .csv import csvread, read_depth_data
from .vtk import write_fields_to_files, write_vtu

__all__ = [
    "csv",
    "vtk",
    "csvread",
    "read_depth_data",
    "write_vtu",
    "write_fields_to_files",
    "save_checkpoint",
    "restore_checkpoint",
]
