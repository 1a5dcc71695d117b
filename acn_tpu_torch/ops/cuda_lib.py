"""Build and load the port's CUDA kernel libraries.

Each library of ``SOURCES`` is compiled by ``nvcc`` for ``sm_90a`` from its
sources in ``csrc/`` into a shared object with a plain C interface and loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds): ``segscan``
(the scan), ``composite`` (the packed composite, forward and backward),
``hashgrid`` and ``ngp_net``, one source each, so that an edit to one
source rebuilds its library alone. A
library is built at first use into ``acn_tpu_torch/_build/`` (listed in
``.gitignore``), named by the library and a hash of its sources and flags,
so an edited source is rebuilt and an unchanged one is loaded as it is. ptxas's report (registers, shared
memory, spills) is kept beside the library as ``<lib>.log``. ``defines``
(``-D`` macros: the scan's tile extents) builds a variant beside the default
library; only ``scripts/bench_segscan.py`` asks for one, to choose the tile
by measurement. ``build_all`` starts one ``nvcc`` per library at once and
waits for all; ``start_all`` starts them and returns, and each library's
``finish`` (or its first ``load``) waits for its own.

What a launch needs beyond its scalars lives on the card: ``to_device``
copies a small host table there from pinned memory on the current stream
(no host wait), and ``device_table`` keeps such tables of pointers, keyed
by their values, so that a launch whose pointers repeat (a model's weights
in serving) copies nothing.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import atexit
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Sequence

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
SOURCES = {"segscan": (CSRC / "segscan.cu",), "composite": (CSRC / "composite.cu",),
           "hashgrid": (CSRC / "hashgrid.cu",), "ngp_net": (CSRC / "ngp_net.cu",)}
BUILD_DIR = PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LOADED: Dict[str, ctypes.CDLL] = {}
_PENDING: Dict[str, object] = {}  # source → a build start_all started, not yet waited for


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _flags(defines: Sequence[str]) -> list:
    return NVCC_FLAGS + [f"-D{d}" for d in defines]


def library_path(defines: Sequence[str] = (), source: str = "segscan") -> Path:
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in SOURCES[source])
                            + " ".join(_flags(defines)).encode())
    return BUILD_DIR / f"lib{source}-{digest.hexdigest()[:12]}.so"


def _start(defines: Sequence[str], source: str):
    """Start nvcc for the library unless it is built already: (the process,
    its temporary output, the library, the start time), or None."""
    out = library_path(defines, source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    proc = subprocess.Popen(
        [_nvcc(), *_flags(defines), "-o", str(tmp), *map(str, SOURCES[source])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(started) -> float:
    """Wait for a started build; keep its report, raise with nvcc's output
    if it failed. Returns its wall seconds."""
    if started is None:
        return 0.0
    proc, tmp, out, t0 = started
    stdout, _ = proc.communicate()
    seconds = time.perf_counter() - t0
    Path(f"{out}.log").write_text(stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc exit {proc.returncode} on {out.name}:\n{stdout}")
    os.replace(tmp, out)
    return seconds


def build(defines: Sequence[str] = (), source: str = "segscan") -> float:
    """Compile the library unless it is built already (waiting for the build
    ``start_all`` started, if any). Returns the build's wall seconds (0.0
    when it was built); raises with nvcc's output if the build fails."""
    if not defines and source in _PENDING:
        return finish(source)
    return _finish(_start(defines, source))


def start_all() -> None:
    """Start one nvcc for every source's default library not built yet, all
    together, and return at once: ``finish``, ``build`` or ``load`` waits
    for a library's own build, so work that needs only the libraries
    finished first runs while the others build."""
    if not _PENDING:
        atexit.register(_cancel_pending)
    for name in SOURCES:
        if name not in _PENDING:
            _PENDING[name] = _start((), name)


def _cancel_pending() -> None:
    """At exit: end the builds nobody waited for (a run that failed early)."""
    for started in _PENDING.values():
        if started is not None and started[0].poll() is None:
            started[0].kill()
            started[0].wait()
            Path(started[1]).unlink(missing_ok=True)
    _PENDING.clear()


def finish(source: str) -> float:
    """Wait for ``source``'s build that ``start_all`` started: its wall
    seconds (0.0 if none was started); raises if it failed."""
    return _finish(_PENDING.pop(source, None))


def build_all() -> Dict[str, float]:
    """Build every source's default library, one nvcc each, all started
    together. Returns each build's wall seconds (0.0 where it was built);
    raises if any build fails, after all have ended."""
    start_all()
    seconds, failed = {}, []
    for name in SOURCES:
        try:
            seconds[name] = finish(name)
        except RuntimeError as e:
            failed.append(str(e))
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def load(source: str = "segscan") -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    if source not in _LOADED:
        build(source=source)
        _LOADED[source] = ctypes.CDLL(str(library_path(source=source)))
    return _LOADED[source]


def load_variant(defines: Sequence[str]) -> ctypes.CDLL:
    """A variant of the scan's library built with ``defines``, loaded beside
    the default one (which ``load`` returns and the port uses)."""
    build(defines)
    return ctypes.CDLL(str(library_path(defines)))


def build_log(defines: Sequence[str] = (), source: str = "segscan") -> str:
    """ptxas's report from the library's build."""
    p = Path(f"{library_path(defines, source)}.log")
    return p.read_text() if p.exists() else ""


def to_device(values: Sequence, dtype: torch.dtype, device) -> torch.Tensor:
    """``values`` as a 1-D tensor of ``dtype`` on ``device``: staged in
    pinned host memory and copied on the current stream without a host
    wait (PyTorch's host allocator keeps the staging block until the copy
    has run)."""
    return torch.tensor(list(values), dtype=dtype).pin_memory().to(device, non_blocking=True)


TABLES_KEPT = 256
_TABLES: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()


def device_table(ptrs: Sequence[int], device) -> torch.Tensor:
    """The pointers ``ptrs`` as an int64 table on ``device``: the kept one
    with these values, or a new one (``to_device``). A table is a function
    of its values alone, so a freed and reused pointer cannot make a kept
    table wrong; the least recently used beyond ``TABLES_KEPT`` are dropped.
    Used from a stream other than the one that made it, the table is marked
    as in use there (``record_stream``), so that dropping it cannot free it
    under a launch."""
    key = (str(device), tuple(ptrs))
    t = _TABLES.get(key)
    if t is None:
        t = to_device(ptrs, torch.int64, device)
        _TABLES[key] = t
        if len(_TABLES) > TABLES_KEPT:
            _TABLES.popitem(last=False)
    else:
        _TABLES.move_to_end(key)
        t.record_stream(torch.cuda.current_stream(t.device))
    return t
