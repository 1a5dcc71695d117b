"""Segmented exclusive prefix sum over packed samples, forward and reverse:
CUDA kernel + plain versions.

Port of ``acn_tpu/ops/segscan.py``. ``composite_packed``
(``nerfs/render.py``) needs, for every packed sample, the sum of the
log-transmittance of the earlier samples of its own ray:

    excl_i = Σ_{j<i, same segment} x_j,  a segment starting where seg_start

and its gradient is the same sum taken from the other end,

    grad_j = Σ_{i>j, same segment} g_i,

the reverse mode (``seg_excl_rsum``).

The TPU kernel it replaces is ``_seg_excl_sum_pallas`` / ``_seg_scan_kernel``
(``acn_tpu/ops/segscan.py:90-190``, ``pallas_call`` at :180; backward
``_bwd`` at :251). Here it is a hand-written CUDA kernel for ``sm_90a``
(``csrc/segscan.cu``), built by ``ops/cuda_lib.py`` and called through
``ctypes``.

Bound: the op moves at least 9 bytes per element (4 B read of x, 1 B read of
the flag, 4 B write) for one add, so it is bound by memory: at the serving
shape B = 983,040 that is 8.8 MB, 2.64 µs at the H100's 3.35 TB/s.

Design (the source has the detail): one launch per scan, a single pass of
chained tiles with decoupled look-back. Each block takes a tile of
``TILE`` elements by an atomic ticket (never by ``blockIdx.x``: a block may
only wait for blocks that are already running), scans it in registers,
publishes the tile's state as one 64-bit word — f32 value in the low half,
``(epoch << 3) | (has_boundary << 2) | status`` in the high half, status
invalid / aggregate / prefix — looks back over its predecessors' words for
its carry, and writes ``inclusive − x`` from the registers it holds: x and
the flags are read once. The look-back ends at the nearest tile that holds a
boundary, which among a serving chunk's rays (at most 256 samples, tiles of
4,096) is the tile before; only the chunk's tail of pad slots, one segment
of many tiles, walks further. The reverse mode is the same kernel by a template
flag, walking tiles and elements from the end with a boundary after element
i where ``seg_start[i + 1]`` is set; it reads the cotangent and the flags as
they lie, so the backward is one launch and no copies.

Scratch and reset: a 16-byte header (one 64-bit word ``epoch << 32 | next
ticket``, and a count used once in 2^29 launches) and the state words live
in one buffer per (device, stream), allocated and zeroed here once and kept;
a launch allocates only its output. No reset is launched between scans: a
state of another epoch reads as invalid, and the block that draws a launch's
last ticket stores ``(epoch + 1, ticket 0)`` for the next launch. The epoch
lives on the device, so a failed launch changes nothing and a launch
replayed from a CUDA graph finds the right epoch. Scans on two streams use
two buffers.

Dispatch is by device and by nothing else: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises. ``seg_excl_sum`` is
differentiable in x to any order: its backward is ``SegExclRSum`` (the
reverse kernel), whose backward is ``SegExclSum`` again (the forward
kernel).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from acn_tpu_torch.ops import cuda_lib

# Extents of the built kernel (``csrc/segscan.cu``'s defaults, checked when
# the library is loaded): elements per tile, per warp and per thread. Tests
# and checks place boundaries on these edges.
ITEMS = 8
WARP = 32 * ITEMS
TILE = 512 * ITEMS
EPOCH_MAX = 2**29 - 1  # the launch epoch kept in the scratch wraps after it


def seg_excl_sum_plain(x: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a log-depth segmented Hillis–Steele scan.

    Step d combines every element with the one d places before it,
    (va, fa) • (vb, fb) = (fb ? vb : va + vb, fa ∨ fb), for d = 1, 2, 4, …
    Partial sums never cross a boundary, so the error stays at the scale of
    one segment's sum wherever the segment lies in the buffer (a global
    cumsum minus a per-segment base would not). Returns inclusive − x, as
    ``acn_tpu``'s ``_seg_excl_sum_xla`` does, in float32 (float64 stays
    float64, for the CPU's gradient checks)."""
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    v, f = x, seg_start.to(torch.bool)
    n = x.shape[0]
    d = 1
    while d < n:
        v = torch.cat([v[:d], torch.where(f[d:], v[d:], v[:-d] + v[d:])])
        f = torch.cat([f[:d], f[d:] | f[:-d]])
        d *= 2
    return v - x


def seg_excl_rsum_plain(g: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """Plain version of the reverse mode, rsum_j = Σ_{i>j, same segment} g_i:
    the plain scan on the reversed buffer with boundaries moved to segment
    ends, as ``acn_tpu``'s ``_bwd`` writes it
    (``acn_tpu/ops/segscan.py:257-260``)."""
    end = torch.cat([seg_start[1:], seg_start.new_ones(1)])
    return seg_excl_sum_plain(g.flip(0), end.flip(0)).flip(0)


_LIB = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures on a loaded library: pointers and the stream as
    ``c_void_p`` (a bare int would be cut to 32 bits)."""
    lib.seg_excl_scan_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.seg_excl_scan_f32.restype = ctypes.c_int
    for name in ("seg_excl_sum_tile", "seg_excl_sum_items",
                 "seg_excl_sum_header_bytes"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.seg_excl_sum_epoch_max.argtypes = []
    lib.seg_excl_sum_epoch_max.restype = ctypes.c_uint
    return lib


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = bind(cuda_lib.load())
        if (lib.seg_excl_sum_tile(), lib.seg_excl_sum_items(),
                lib.seg_excl_sum_header_bytes(), lib.seg_excl_sum_epoch_max()
                ) != (TILE, ITEMS, 8 * _HEADER, EPOCH_MAX):
            raise RuntimeError("csrc/segscan.cu and ops/segscan.py disagree on "
                               "the tile's extents, the scratch header or the epoch")
        _LIB = lib
    return _LIB


# scratch per (device index, stream handle): int64 words, the header first
_HEADER = 2
_MIN_STATES = 4096  # 32 KB: tiles of a 16 M element buffer
_SCRATCH: dict = {}


def scan_scratch(device: torch.device, tiles: int = 0) -> torch.Tensor:
    """The scratch buffer of ``device``'s current stream, with room for
    ``tiles`` states: zeroed when first made (or made larger), then kept,
    because the kernel leaves it ready for the next launch. int64 words;
    word 0 is ``epoch << 32 | next ticket``."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() - _HEADER < tiles:
        buf = torch.zeros(_HEADER + max(_MIN_STATES, 2 * tiles),
                          dtype=torch.int64, device=device)
        _SCRATCH[key] = buf
    return buf


def launch(x: torch.Tensor, seg_start: torch.Tensor, reverse: bool,
           lib: Optional[ctypes.CDLL] = None) -> torch.Tensor:
    """Check the inputs and launch the scan once on the current stream (the
    port's library unless ``lib`` gives a variant). x: float32 (B,)
    contiguous on a CUDA device; seg_start: bool (B,) contiguous on the same
    device, True at index 0. Buffers that are not 16-byte aligned (a view at
    an offset) are taken, on the kernel's scalar path."""
    if x.dtype != torch.float32 or seg_start.dtype != torch.bool:
        raise TypeError(f"the scan kernel takes float32 x and bool "
                        f"seg_start, got {x.dtype} / {seg_start.dtype}")
    if x.ndim != 1 or seg_start.shape != x.shape:
        raise ValueError(f"the scan kernel takes matching 1-D inputs, got "
                         f"{tuple(x.shape)} / {tuple(seg_start.shape)}")
    if not (x.is_contiguous() and seg_start.is_contiguous()):
        raise ValueError("the scan kernel takes contiguous inputs")
    if x.device.type != "cuda" or seg_start.device != x.device:
        raise ValueError(f"the scan kernel needs x and seg_start on one "
                         f"CUDA device, got {x.device} / {seg_start.device}")
    lib = lib or _library()
    n = x.shape[0]
    tiles = -(-n // lib.seg_excl_sum_tile())
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        scratch = scan_scratch(x.device, tiles)
        err = lib.seg_excl_scan_f32(
            x.data_ptr(), seg_start.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), scratch.numel() - _HEADER, n, int(reverse),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"seg_excl_scan kernel launch failed: CUDA error {err}")
    return out


def seg_excl_sum_kernel(x: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel (see ``launch`` for what it takes). Adds one
    to ``seg_excl_sum_kernel.launches`` per launch."""
    out = launch(x, seg_start, reverse=False)
    if x.numel():  # an empty buffer launches nothing
        seg_excl_sum_kernel.launches += 1
    return out


def seg_excl_rsum_kernel(g: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """Launch the reverse kernel: rsum_j = Σ_{i>j, same segment} g_i, with
    ``seg_start`` as the forward scan takes it. Adds one to
    ``seg_excl_rsum_kernel.launches`` per launch."""
    out = launch(g, seg_start, reverse=True)
    if g.numel():
        seg_excl_rsum_kernel.launches += 1
    return out


seg_excl_sum_kernel.launches = 0
seg_excl_rsum_kernel.launches = 0


class SegExclSum(torch.autograd.Function):
    """Gradient: grad_j = Σ_{i>j, same segment} g_i — the segment-exclusive
    REVERSE sum (``acn_tpu/ops/segscan.py:251-261``): one launch of the
    reverse kernel on the cotangent as it lies, through ``SegExclRSum`` so
    that the backward is itself differentiable (second-order MAML
    differentiates through it)."""

    @staticmethod
    def forward(ctx, x, seg_start):
        ctx.save_for_backward(seg_start)
        if x.device.type == "cpu":
            return seg_excl_sum_plain(x, seg_start)
        return seg_excl_sum_kernel(x, seg_start)

    @staticmethod
    def backward(ctx, g):
        (seg_start,) = ctx.saved_tensors
        return SegExclRSum.apply(g, seg_start), None


class SegExclRSum(torch.autograd.Function):
    """The reverse sum, rsum_j = Σ_{i>j, same segment} g_i, as a function
    with a gradient: it is linear and its transpose is the forward sum, so
    its backward is ``SegExclSum`` on the cotangent. The second derivative
    of ``seg_excl_sum`` is therefore forward scan → reverse scan → forward
    scan, as JAX's ``_bwd`` calling ``seg_excl_sum`` makes it; on the card
    each of the three is a launch of the kernel."""

    @staticmethod
    def forward(ctx, g, seg_start):
        ctx.save_for_backward(seg_start)
        if g.device.type == "cpu":
            return seg_excl_rsum_plain(g, seg_start)
        return seg_excl_rsum_kernel(g.contiguous(), seg_start)

    @staticmethod
    def backward(ctx, h):
        (seg_start,) = ctx.saved_tensors
        return SegExclSum.apply(h.contiguous(), seg_start), None


def seg_excl_sum(x: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """excl_i = Σ_{j<i, same segment} x_j (resets where seg_start).

    ``seg_start`` must be True at index 0. Differentiable in ``x``, to any
    order. CPU tensors take the plain version; CUDA tensors the kernel."""
    return SegExclSum.apply(x, seg_start)


def seg_excl_rsum(g: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """rsum_j = Σ_{i>j, same segment} g_i, the transpose of ``seg_excl_sum``,
    differentiable in ``g``. CPU tensors take the plain version; CUDA
    tensors the reverse kernel."""
    return SegExclRSum.apply(g, seg_start)
