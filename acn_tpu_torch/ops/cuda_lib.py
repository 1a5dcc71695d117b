"""Build and load the port's CUDA kernel library.

``csrc/segscan.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). The library is built at first use into
``acn_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash of its
source and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is. ptxas's report (registers, shared memory, spills) is kept
beside the library as ``<lib>.log``. ``defines`` (``-D`` macros: the
source's tile extents) builds a variant beside the default library; only
``scripts/bench_segscan.py`` asks for one, to choose the tile by measurement.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional, Sequence

PKG = Path(__file__).resolve().parent.parent
SOURCE = PKG / "csrc" / "segscan.cu"
BUILD_DIR = PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LOADED: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _flags(defines: Sequence[str]) -> list:
    return NVCC_FLAGS + [f"-D{d}" for d in defines]


def library_path(defines: Sequence[str] = ()) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(_flags(defines)).encode())
    return BUILD_DIR / f"libsegscan-{digest.hexdigest()[:12]}.so"


def build(defines: Sequence[str] = ()) -> float:
    """Compile the library unless it is built already. Returns the build's
    wall seconds (0.0 when it was built); raises with nvcc's output if the
    build fails."""
    out = library_path(defines)
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *_flags(defines), "-o", str(tmp), str(SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    seconds = time.perf_counter() - t0
    Path(f"{out}.log").write_text(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc exit {proc.returncode}:\n{proc.stdout}")
    os.replace(tmp, out)
    return seconds


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _LOADED
    if _LOADED is None:
        build()
        _LOADED = ctypes.CDLL(str(library_path()))
    return _LOADED


def load_variant(defines: Sequence[str]) -> ctypes.CDLL:
    """A variant of the library built with ``defines``, loaded beside the
    default one (which ``load`` returns and the port uses)."""
    build(defines)
    return ctypes.CDLL(str(library_path(defines)))


def build_log(defines: Sequence[str] = ()) -> str:
    """ptxas's report from the library's build."""
    p = Path(f"{library_path(defines)}.log")
    return p.read_text() if p.exists() else ""
