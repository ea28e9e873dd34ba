"""Builds and loads the CUDA kernels of ``ops/csrc``.

Each ``csrc/<name>.cu`` is compiled at first use, by ``nvcc`` directly, into
a shared library with a plain C interface and loaded with ``ctypes``. The
sources include no PyTorch header, so a build takes seconds. All sources are
compiled together, one ``nvcc`` process each, all started at once. Libraries
go to ``blitzdg_tpu_torch/_build/`` under a name that carries a hash of the
source and of every file under ``csrc/`` that a source can include (``*.cu``,
``*.cuh``, ``*.h``), so an edited source or shared header is rebuilt and a
stale library is never loaded.

Nothing here runs when the module is imported: a machine without ``nvcc``
can import the package; it cannot launch a kernel, and asking for one raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_libs: dict[str, ctypes.CDLL] = {}
# what nvcc printed when it built each source's current library (ptxas -v
# included); kept beside the library, so a library built by an earlier run
# has its log too
last_build_log: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest(csrc: Path = CSRC) -> str:
    """Hash of the compiler flags and of every source and header under
    ``csrc``, names included: a change to any of them changes every
    library's name."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for pattern in ("*.cu", "*.cuh", "*.h"):
        for f in sorted(csrc.glob(pattern)):
            h.update(f.name.encode() + b"\0" + f.read_bytes() + b"\0")
    return h.hexdigest()[:12]


def _target(src: Path) -> Path:
    return BUILD_DIR / f"lib{src.stem}-{_digest(src.parent)}.so"


def _log_path(target: Path) -> Path:
    return target.with_suffix(".log")


def build_all(verbose: bool = False) -> dict[str, Path]:
    """Compile every source that has no current library; returns the
    library path of each source by name. Raises if any compile fails."""
    sources = sorted(CSRC.glob("*.cu"))
    targets = {s.stem: _target(s) for s in sources}
    todo = [s for s in sources if not targets[s.stem].exists()]
    for s in sources:
        log = _log_path(targets[s.stem])
        if s not in todo and log.exists():
            last_build_log[s.stem] = log.read_text()
    if not todo:
        return targets
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for s in todo:
        tmp = targets[s.stem].with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(s.parent), "-Xptxas", "-v",
               "-o", str(tmp), str(s)]
        procs.append((s, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for s, tmp, p in procs:
        out, _ = p.communicate()
        last_build_log[s.stem] = out
        if verbose:
            print(out)
        if p.returncode != 0:
            failed.append(f"{s.name}:\n{out}")
        else:
            _log_path(targets[s.stem]).write_text(out)
            os.replace(tmp, targets[s.stem])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu`` (built if need be)."""
    if name not in _libs:
        targets = build_all()
        if name not in targets:
            raise KeyError(f"no kernel source csrc/{name}.cu")
        _libs[name] = ctypes.CDLL(str(targets[name]))
    return _libs[name]
