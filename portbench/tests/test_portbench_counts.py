"""The frozen counts give the bound column of PERF.md's kernel table (the
port's kernels alone on the H100) at that table's shapes."""
import pytest

from portbench import spec
from portbench.counts.peaks import bound_ms
from portbench.counts.shapes import shape_of
from portbench.counts.sw2d import COUNTS
from portbench.reference.models import build_model

# The table's curved shapes: the disk of 13 rings (K=1014) at N=3, whose
# cubature (order 12) and Gauss faces (8 points) follow from N.
DISK_K1014_N3 = {"rings": 13, "K": 1014, "N": 3, "cubature_order": 12,
                 "cubature_points": 34, "gauss_per_face": 8}

# (kernel, configuration, its mesh as the table has it, count, B, control
#  steps, steps a control, bound ms as the table gives it, to four figures)
TABLE = [
    ("B2", "coastal_box_k40_n1", {}, "dense_rollout", 2048, 8, 4, 0.0889),
    ("B3", "coastal_box_k40_n1", {}, "dense_rollout_bwd", 2048, 8, 4,
     0.1898),
    ("B11", "curved_disk_k864_n4", DISK_K1014_N3, "curved_rollout", 32, 4, 2,
     0.1335),
    ("B12", "curved_disk_k864_n4", DISK_K1014_N3, "curved_rollout_bwd", 32, 4,
     2, 0.2529),
]


@pytest.mark.parametrize("row", TABLE, ids=lambda r: r[0])
def test_bound_ms_of_the_kernel_table(row):
    _, name, mesh, count, B, n_cs, spc, want = row
    cfg = spec.config(name)
    cfg = {**cfg, "mesh": {**cfg["mesh"], **mesh}}
    ms, by = bound_ms(*COUNTS[count](shape_of(build_model(cfg), cfg), B,
                                     n_cs, spc))
    assert by == "operations"
    assert ms == pytest.approx(want, abs=0.00005)
