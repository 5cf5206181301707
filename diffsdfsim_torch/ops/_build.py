"""Build and load the hand-written CUDA kernels (``ops/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``. A library is built at
first use into ``diffsdfsim_torch/_build/`` (git-ignored), under a name
keyed by a hash of its source, of every header in ``csrc/`` (``*.cuh``, which
any source may include) and of the flags, so a changed source or header
rebuilds and an unchanged one is reused. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# every kernel source in csrc/ (K1, K3, K2, K4, K5)
KERNELS = ("pdipm_fwd", "fw_search", "kkt_bwd", "igr_mlp", "grid_interp")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return path


def lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def start_build(name: str):
    """Start nvcc for one source into a temporary file; returns (Popen or
    None if already built, temporary path, target)."""
    target = lib_path(name)
    if target.exists():
        return None, None, target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def finish_build(proc, tmp, target: Path) -> str:
    """Wait for a build started by start_build and move it into place
    (atomically, so a concurrent loader never sees half a library);
    returns nvcc's log."""
    if proc is None:
        return f"{target.name}: already built"
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {target.name}:\n{log}")
    os.replace(tmp, target)
    return log


def build_all(names) -> dict[str, str]:
    """Build several kernels with one nvcc each, all started together."""
    started = {n: start_build(n) for n in names}
    return {n: finish_build(*started[n]) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it if needed."""
    if name not in _loaded:
        proc, tmp, target = start_build(name)
        finish_build(proc, tmp, target)
        _loaded[name] = ctypes.CDLL(str(target))
    return _loaded[name]
