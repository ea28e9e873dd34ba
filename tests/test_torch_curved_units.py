"""The curved kernels' work units (``ops/sw2d_curved_blocked.py``:
``unit_shape``, ``n_units``, ``smem_bytes``), pure Python on the CPU.

A unit is a chunk of ``elems`` elements times a tile of up to ``SCEN_TILE``
scenarios, one thread per (element, scenario). Checked: the block fits the
shared memory a block can have at N=1-4, for ragged and round batches and
meshes; the units, walked as the kernels walk them (unit u: chunk
u % n_chunks of scenario tile u // n_chunks; lane l: element l // scens,
scenario l % scens), cover every (scenario, element) exactly once; the
chunks shrink for high orders, where an element's data grows; the two
disks' units; and the module's copies of the kernel source's size limits.
(``smem_bytes`` against the source's own ``csmem_floats``, and the
adjoint's threads a lane, which its launcher chooses:
``test_torch_curved_kernel_shim.py``.)
"""
import re
from pathlib import Path

import pytest

from blitzdg_tpu_torch.ops import sw2d_curved_blocked as TC
from blitzdg_tpu_torch.ops.sw2d_fused import MAX_SMEM_BYTES
from blitzdg_tpu_torch.specgrid.cubature import triangle_cubature

def _meta(n_order: int, k_elem: int, mass_mode: str = "general"):
    """The sizes of a curved operator set at order N, as the disk and box
    configurations build it: cubature of order 3 (N+1), 2 (N+1) Gauss points
    a face."""
    n_p = (n_order + 1) * (n_order + 2) // 2
    n_cub = len(triangle_cubature(3 * (n_order + 1))[2])
    n_gauss = 2 * (n_order + 1)
    return TC.CurvedBlockedMeta(
        k_elem=k_elem, n_p=n_p, n_cub=n_cub, n_gauss=n_gauss, n_faces=3,
        n_v=k_elem * n_p, n_t=k_elem * 3 * n_gauss, n_ctrl=2, g=9.81, cd=0.0,
        f_cor=0.0, has_bed=False, mass_mode=mass_mode, filter_folded=True)


def _walk(meta, batch, u):
    """(scenario, element) pairs in the order the kernels' lanes take them."""
    n_chunks = -(-meta.k_elem // u.elems)
    seen = []
    for unit in range(TC.n_units(meta, batch)):
        c, tile = unit % n_chunks, unit // n_chunks
        for lane in range(u.elems * u.scens):
            e, b = lane // u.scens, tile * u.scens + lane % u.scens
            k = c * u.elems + e
            if k < meta.k_elem and b < batch:
                seen.append((b, k))
    return seen


@pytest.mark.parametrize("n_order", [1, 2, 3, 4])
@pytest.mark.parametrize("mass_mode", ["general", "affine"])
def test_units_fit_shared_memory(n_order, mass_mode):
    for k_elem in (54, 1014):
        meta = _meta(n_order, k_elem, mass_mode)
        for batch in (1, 5, 32, 256):
            u = TC.unit_shape(meta, batch)
            assert u.threads % 32 == 0
            assert u.elems * u.scens <= u.threads <= TC.THREADS
            assert TC.smem_bytes(meta, u.elems, u.threads) <= MAX_SMEM_BYTES


@pytest.mark.parametrize("k_elem,batch", [
    (54, 5), (54, 256), (1014, 32), (97, 3), (128, 1), (7, 13)])
def test_units_cover_every_scenario_and_element_once(k_elem, batch):
    meta = _meta(3, k_elem)
    u = TC.unit_shape(meta, batch)
    seen = _walk(meta, batch, u)
    assert len(seen) == len(set(seen)) == k_elem * batch
    # the chunks are evened out: the last is not mostly empty
    n_chunks = -(-k_elem // u.elems)
    assert k_elem - (n_chunks - 1) * u.elems > u.elems // 2 or n_chunks == 1


def test_chunks_shrink_for_high_orders():
    """Per element the chunk holds 4 Ncub + 5 NT (+ Np^2) floats and per
    thread the scratch grows with Np and NG: at high orders fewer elements
    fit a block, as the wrappers' sizing finds; beyond that they refuse."""
    low, high = _meta(3, 1014), _meta(6, 1014)  # Np 10 and 28
    e_low = TC.unit_shape(low, 1).elems
    e_high = TC.unit_shape(high, 1).elems
    assert e_high < e_low
    assert TC.smem_bytes(high, e_high, 32 * -(-e_high // 32)) \
        <= MAX_SMEM_BYTES
    with pytest.raises(ValueError):  # the run-time-size arrays' room
        TC.unit_shape(_meta(3, 54)._replace(n_p=TC.MAX_NP + 8), 4)


def test_the_disks_units():
    small, large = _meta(3, 54), _meta(3, 1014)
    assert TC.unit_shape(large, 32) == (32, 4, 128)
    assert TC.unit_shape(small, 256) == (27, 4, 128)
    assert TC.n_units(small, 256) == 128 and TC.n_units(large, 32) == 256
    assert TC.unit_shape(small, 5) == (27, 4, 128)
    assert TC.n_units(small, 5) == 4


def test_size_limits_are_the_kernel_sources():
    """THREADS, SLOT_STRIDE, MAX_NP and MAX_NG of the module are the
    ``#define``s of the kernels' source."""
    src = (Path(TC.__file__).parent / "csrc" / "sw2d_curved.cu").read_text()
    defs = dict(re.findall(r"^#define (\w+) (\d+)", src, re.M))
    assert {k: int(defs[k]) for k in (
        "MAX_THREADS", "SLOT_STRIDE", "MAX_NP", "MAX_NG")} == {
        "MAX_THREADS": TC.THREADS, "SLOT_STRIDE": TC.SLOT_STRIDE,
        "MAX_NP": TC.MAX_NP, "MAX_NG": TC.MAX_NG}
