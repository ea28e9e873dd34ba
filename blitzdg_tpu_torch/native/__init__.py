"""Native (C++) mesh-setup helpers with ctypes bindings.

Counterpart of the JAX package's ``blitzdg_tpu/native/__init__.py``. The
port keeps its own copy of the source (``dgmesh.cpp`` here, the same code
as the JAX package's) and builds it at first use with ``g++ -O2 -shared``
into ``blitzdg_tpu_torch/_build/``, under a name that carries a hash of the
source (an edited source is rebuilt, a stale library never loaded). Every
entry point has a numpy fallback, so the package works without a
toolchain; ``available()`` reports whether the native library loaded. This
is host set-up, not the device path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "dgmesh.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lib = None
_tried = False
# what the last build printed (empty when the library was already built)
last_build_log = ""


def library_path() -> Path:
    """Where the library of the current source lives."""
    h = hashlib.sha1(" ".join(GXX_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libdgmesh-{h.hexdigest()[:12]}.so"


def _build(target: Path) -> bool:
    """Compile the source into ``target``: into a temporary file beside it,
    then renamed, so that processes building at once never load a partial
    library."""
    global last_build_log
    gxx = shutil.which("g++")
    if gxx is None:
        last_build_log = "g++ not found"
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", tmp],
                             capture_output=True, text=True, timeout=120)
        last_build_log = res.stdout + res.stderr
        if res.returncode != 0:
            return False
        os.replace(tmp, target)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        last_build_log = str(e)
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    target = library_path()
    if not target.exists() and not _build(target):
        return None
    try:
        lib = ctypes.CDLL(str(target))
    except OSError:
        return None

    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")

    lib.dg_build_connectivity.argtypes = [i32p, ctypes.c_int32,
                                          ctypes.c_int32, i32p, i32p]
    lib.dg_build_connectivity.restype = ctypes.c_int

    lib.dg_build_maps.argtypes = [
        f64p, f64p, ctypes.c_int32, ctypes.c_int32,
        i32p, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, f64p, i32p, ctypes.c_double,
        i32p, i32p, i32p,
    ]
    lib.dg_build_maps.restype = ctypes.c_int

    lib.dg_parse_gmsh_elements.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.dg_parse_gmsh_elements.restype = ctypes.c_int

    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def build_connectivity(etov: np.ndarray):
    """Native EToE/EToF; falls back to the numpy implementation."""
    lib = _load()
    if lib is None:
        from ..mesh.connectivity import build_connectivity as np_impl

        return np_impl(etov)
    etov = np.ascontiguousarray(etov, dtype=np.int32)
    K, nf = etov.shape
    etoe = np.empty_like(etov)
    etof = np.empty_like(etov)
    rc = lib.dg_build_connectivity(etov, K, nf, etoe, etof)
    assert rc == 0
    return etoe, etof


def build_maps(x, y, fmask, etoe, etof, verts, etov, node_tol=1e-5):
    """Native vmapM/vmapP/mapP; same contract as ``triangle._build_maps``.
    Returns None without the native library (the caller falls back)."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float64).reshape(-1)
    y = np.ascontiguousarray(y, dtype=np.float64).reshape(-1)
    fmask = np.ascontiguousarray(fmask, dtype=np.int32)
    etoe = np.ascontiguousarray(etoe, dtype=np.int32)
    etof = np.ascontiguousarray(etof, dtype=np.int32)
    verts = np.ascontiguousarray(verts[:, :2], dtype=np.float64)
    etov = np.ascontiguousarray(etov, dtype=np.int32)
    K, nfaces = etoe.shape
    nfp = fmask.shape[1]
    np_ = x.size // K
    ntr = nfaces * nfp
    vmapM = np.empty((K, ntr), dtype=np.int32)
    vmapP = np.empty((K, ntr), dtype=np.int32)
    mapP = np.empty((K, ntr), dtype=np.int32)
    rc = lib.dg_build_maps(
        x, y, K, np_, fmask, nfaces, nfp, etoe, etof, verts, etov,
        node_tol, vmapM, vmapP, mapP,
    )
    assert rc == 0
    return vmapM, vmapP, mapP


def parse_gmsh_elements(text: str):
    """Native $Elements scan. Returns (tris, quads, lines, line_tags) or
    None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    raw = text.encode()
    nt = ctypes.c_int32()
    nq = ctypes.c_int32()
    nl = ctypes.c_int32()
    rc = lib.dg_parse_gmsh_elements(raw, len(raw), ctypes.byref(nt),
                                    ctypes.byref(nq), ctypes.byref(nl),
                                    None, None, None, None)
    if rc != 0:
        return None
    tris = np.empty((nt.value, 3), dtype=np.int32)
    quads = np.empty((nq.value, 4), dtype=np.int32)
    lines = np.empty((nl.value, 2), dtype=np.int32)
    tags = np.empty((nl.value,), dtype=np.int32)
    rc = lib.dg_parse_gmsh_elements(
        raw, len(raw), ctypes.byref(nt), ctypes.byref(nq), ctypes.byref(nl),
        tris.ctypes.data_as(ctypes.c_void_p),
        quads.ctypes.data_as(ctypes.c_void_p),
        lines.ctypes.data_as(ctypes.c_void_p),
        tags.ctypes.data_as(ctypes.c_void_p),
    )
    assert rc == 0
    return tris, quads, lines, tags
