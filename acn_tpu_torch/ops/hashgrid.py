"""Cell-layout hash-grid encode, forward and table cotangent: CUDA kernels
and plain versions.

For every point p (x01 in [0, 1]³) and level l the cell layout keeps one row
of 8·F values per hashed cell, the cell's eight corners in packing order
(corner c = 4·dx + 2·dy + dz). The encode gathers the row h(p, l) of the
cell that holds the point and blends it with the trilinear corner weights
w_c of the intra-cell fraction:

    out[p, l·F + f] = Σ_c w_c(p, l) · T_l[h(p, l), c·F + f]

and its table cotangent scatters the output cotangent back into the rows:

    G_l[h(p, l), c·F + f] += w_c(p, l) · g[p, l·F + f]

The JAX package wrote no TPU kernel for these (a per-lane table gather
does not lower to Mosaic); they are ``_cell_saved_fwd_impl`` and the table
half of the hand-written VJP ``_saved_bwd``
(``acn_tpu/models/encodings.py:314-501``), plain XLA there. Here they are
hand-written CUDA kernels for ``sm_90a`` (``csrc/hashgrid.cu``), built by
``ops/cuda_lib.py`` and called through ``ctypes``; the source has the
design: a group of lanes per (point, level), each lane one 16-byte piece of
the row, so a warp reads and adds whole rows, and the cotangent sums the
lanes that share a row before one of them adds (F = 1, 2, 4, 8, 16; any
other F takes a general kernel of each direction). The forward at F = 1
has a kernel of its own (a thread a point and run of levels, every row in
registers), and the general forward copies each warp's rows into shared
memory with all the copies in flight. Both recompute the cell and
the weights from x01, so nothing but x01 is kept between the forward and
the backward. The x cotangent, asked for only when x01 needs a gradient
(never in training), stays PyTorch: ``hash_cell_bwd_x``.

Bound: memory, each distinct byte once. The forward reads x01 and the
distinct rows its points fall in and writes the output; at the serving
chunk of the smoke's model (983,040 points, 8 levels, F = 4) that is
0.0726 ms in float32 and 0.0359 ms in bfloat16 at the H100's 3.35 TB/s.
The cotangent reads x01 and g and writes the tables once.

Bits: the kernels round every step where PyTorch's eager ops round it, so
the cell, the row and the weights are the plain version's bits, in float32
and in bfloat16; only the order of the sums (the eight corners, and the
atomic adds of the backward) is free.

They take every F ≥ 1 and every level count: the per-level constants live
on the card, uploaded once per (config, x01 type, card), and the forward's
table pointers are a small device table cached by value
(``cuda_lib.device_table``), copied from pinned memory on the stream
without a host wait; the cotangent's tables are row blocks of one
allocation, passed as its base and each level's offset. Only
``log2_hashmap_size`` is bounded (1 to 31): a level of 2³² rows of 8·F
values could not fit on a card at any F.

Dispatch is by device and by nothing else: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises. ``HashCellBwdTables``
makes the table cotangent differentiable in the output cotangent (and in
x01): its backward is the forward kernel on the cotangent's cotangent, so
second-order MAML runs forward kernel → backward kernel → forward kernel.
"""

from __future__ import annotations

import ctypes
import functools
import types
from typing import Optional, Sequence

import torch
from torch.autograd.function import once_differentiable

from acn_tpu_torch.ops import cuda_lib

# Instant-NGP 3D spatial hash primes.
HASH_PRIMES = (1, 2654435761, 805459861)
INTERPOLATIONS = ("Linear", "Smoothstep", "Nearest")
# F with a templated kernel of their own: the forward's at 2 to 16 (F = 1 has
# a forward of its own), the cotangent's at all five; any other F takes the
# general kernel of each direction
FEATURES = (1, 2, 4, 8, 16)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# corner sign per axis in packing order (dz fastest): +1 where the corner
# takes the fraction f, −1 where it takes 1 − f
_CORNER_SIGNS = tuple((1.0 if dx else -1.0, 1.0 if dy else -1.0,
                       1.0 if dz else -1.0)
                      for dx in (0, 1) for dy in (0, 1) for dz in (0, 1))

# ================================================================ plain math


def _spatial_hash(ixyz: torch.Tensor, log2_size: int) -> torch.Tensor:
    """3-prime XOR hash of non-negative integer coords → [0, 2^log2_size).

    ``acn_tpu`` computes it in uint32 with wraparound; here it runs in int64
    and is masked. Multiplication mod 2^32 and XOR keep the low 32 bits
    identical, and cell coordinates (< 2^13) times the primes (< 2^32) stay
    far below 2^63, so the indices are the same."""
    ixyz = ixyz.to(torch.int64)
    h = (ixyz[..., 0] * HASH_PRIMES[0]) ^ (ixyz[..., 1] * HASH_PRIMES[1]) \
        ^ (ixyz[..., 2] * HASH_PRIMES[2])
    return h & (2**log2_size - 1)


def _interp_frac(frac: torch.Tensor, interpolation: str) -> torch.Tensor:
    if interpolation == "Smoothstep":
        return frac * frac * (3 - 2 * frac)
    if interpolation == "Nearest":
        return torch.round(frac)
    return frac


def _corner_weights(frac: torch.Tensor) -> torch.Tensor:
    """(..., 8) trilinear corner weights in packing order (dz fastest):
    w[4·dx + 2·dy + dz] = (A_x[dx] · A_y[dy]) · A_z[dz] with A = (1 − f, f).
    The products are ``acn_tpu``'s, in its order, so the values are the same
    bits; they are taken as two broadcast products instead of one chain per
    corner (5 kernels per call, where the chain per corner made about 30)."""
    a = torch.stack([1.0 - frac, frac], dim=-1)  # (..., 3, 2)
    xy = a[..., 0, :, None] * a[..., 1, None, :]  # (..., 2, 2)
    return (xy[..., None] * a[..., 2, None, None, :]).flatten(-3)


@functools.lru_cache(maxsize=None)
def _res_as(res_l: int, dtype: torch.dtype) -> float:
    """The level's resolution rounded to ``dtype``, as a host number:
    ``acn_tpu`` multiplies by ``jnp.asarray(res, x01.dtype)``, so under bf16
    the factor is the rounded one (4095 becomes 4096)."""
    return float(torch.tensor(float(res_l), dtype=dtype))


def _is_dense(cfg, l: int) -> bool:
    res_l = int(cfg.level_resolutions()[l])
    return bool(cfg.dense_levels and res_l**3 <= cfg.level_rows(l))


def _cell_index(x01: torch.Tensor, cfg, l: int):
    """Per-level (h (...,), frac_raw (..., 3)): the row of the cell that
    holds each point and the raw intra-cell fraction."""
    res_l = int(cfg.level_resolutions()[l])
    scaled = x01 * _res_as(res_l, x01.dtype)
    cell = torch.floor(scaled)
    frac = scaled - cell
    cell_i = cell.to(torch.int64)
    if _is_dense(cfg, l):
        # dense level: collision-free linear index of the clipped cell
        ci = torch.clamp(cell_i, 0, res_l - 1)
        h = (ci[..., 0] * res_l + ci[..., 1]) * res_l + ci[..., 2]
    else:
        h = _spatial_hash(cell_i, cfg.log2_hashmap_size)
    return h, frac


def _cell_level_lookup(tables, x01: torch.Tensor, cfg, l: int):
    """Per-level (rows (..., 8F), h (...,), frac_raw (..., 3))."""
    h, frac = _cell_index(x01, cfg, l)
    return tables[l][h], h, frac


def hash_cell_fwd_plain(tables, x01: torch.Tensor, cfg,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the forward: one gathered row per (point, level)
    holding the cell's 8 corner features, blended trilinearly. (..., 3) in
    [0, 1] → (..., L·F) in the tables' type, written into ``out`` when
    given."""
    F = cfg.features_per_level
    feats = []
    for l in range(cfg.levels):
        rows, _, frac = _cell_level_lookup(tables, x01, cfg, l)
        w = _corner_weights(_interp_frac(frac, cfg.interpolation))
        blended = rows.reshape(*rows.shape[:-1], 8, F) * w.to(rows.dtype)[..., None]
        feats.append(blended.sum(dim=-2))  # (..., F)
    if out is not None:
        return torch.cat(feats, dim=-1, out=out)
    return torch.cat(feats, dim=-1)


def hash_cell_bwd_tables_plain(x01: torch.Tensor, g: torch.Tensor, cfg,
                               nrows: Sequence[int],
                               dtypes: Sequence[torch.dtype]) -> list:
    """Plain version of the table cotangent, per level ``index_add_`` of
    w ⊗ g at h into zeros of ``nrows[l]`` rows (the operand's, as JAX's
    ``nrows`` rule has it) and type ``dtypes[l]`` (under bf16 the sum runs
    in bf16, as in the JAX package)."""
    F = cfg.features_per_level
    grads = []
    for l in range(cfg.levels):
        h, frac_raw = _cell_index(x01, cfg, l)
        w = _corner_weights(_interp_frac(frac_raw, cfg.interpolation))
        g_l = g[..., l * F:(l + 1) * F]
        gw = (w[..., :, None].to(g_l.dtype) * g_l[..., None, :]).reshape(-1, 8 * F)
        grads.append(torch.zeros((nrows[l], 8 * F), dtype=dtypes[l], device=g.device)
                     .index_add_(0, h.reshape(-1), gw.to(dtypes[l])))
    return grads


def hash_cell_bwd_x(tables, x01: torch.Tensor, g: torch.Tensor, cfg) -> torch.Tensor:
    """The x cotangent of the encode at cotangent g, from rows gathered
    again at h: the elementwise half of ``acn_tpu``'s ``_saved_bwd``,
    dout/df_a = Σ_c sign_a(c) · Π_{b≠a} A_b(c) · (rows_c · g), times the
    Smoothstep chain and the resolution, summed over levels. It works in
    float64 when x01 is float64 (``gradgradcheck``) and in float32 otherwise,
    as ``_saved_bwd`` does for every type JAX takes without x64.
    Differentiable ops, so that under ``create_graph`` its derivative reaches
    the tables, x01 and g. Nearest is piecewise constant in x: zero."""
    dt = torch.float64 if x01.dtype == torch.float64 else torch.float32
    if cfg.interpolation == "Nearest":
        return torch.zeros(x01.shape, dtype=dt, device=x01.device)
    F = cfg.features_per_level
    resolutions = cfg.level_resolutions()
    # (8, 3); a copy from the host, on this path only
    signs = torch.tensor(_CORNER_SIGNS, dtype=dt, device=x01.device)
    gx = None
    for l in range(cfg.levels):
        rows, h, frac_raw = _cell_level_lookup(tables, x01, cfg, l)
        g_l = g[..., l * F:(l + 1) * F]
        f = _interp_frac(frac_raw, cfg.interpolation)
        rg = torch.einsum("...cf,...f->...c",
                          rows.reshape(*rows.shape[:-1], 8, F),
                          g_l.to(rows.dtype)).to(dt)
        fa = f[..., None, :]  # (..., 1, 3)
        A = torch.where(signs > 0, fa, 1.0 - fa).to(dt)  # (..., 8, 3)
        s = torch.stack([
            torch.sum(signs[:, a] * A[..., (a + 1) % 3] * A[..., (a + 2) % 3]
                      * rg, dim=-1) for a in range(3)], dim=-1)
        if cfg.interpolation == "Smoothstep":
            s = s * (6.0 * frac_raw * (1.0 - frac_raw)).to(dt)
        s = s * float(resolutions[l])
        gx = s if gx is None else gx + s
    return gx


# ================================================================ kernels

_LIB = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures on a loaded library: pointers and the stream as
    ``c_void_p`` (a bare int would be cut to 32 bits)."""
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    levels = [vp, vp, vp, i, i, i, i, ll]  # scale, res, dense; L, F, log2, interp; n
    lib.hash_cell_fwd.argtypes = [vp, i, vp, i, *levels, vp, vp]
    lib.hash_cell_fwd.restype = i
    lib.hash_cell_bwd_tables.argtypes = [vp, i, vp, vp, vp, ll, i, *levels, vp]
    lib.hash_cell_bwd_tables.restype = i
    return lib


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = bind(cuda_lib.load("hashgrid"))
    return _LIB


@functools.lru_cache(maxsize=None)
def level_rows(cfg) -> tuple:
    """The config's row ladder, ``cfg.level_rows(l)`` for every level
    (each call of that recomputes the resolutions: a few µs a level)."""
    return tuple(int(cfg.level_rows(l)) for l in range(cfg.levels))


@functools.lru_cache(maxsize=None)
def _consts(cfg, x_dtype: torch.dtype) -> types.SimpleNamespace:
    """What the kernels take that depends on the config and x01's type
    alone: the per-level scale (resolution rounded to x01's type),
    resolution and dense flag, the ladder's rows, the scalar arguments, the
    row width. Refuses only what no card could hold (``log2_hashmap_size``
    above 31) or no kernel knows (the interpolation, F or L below 1)."""
    if cfg.interpolation not in INTERPOLATIONS:
        raise ValueError(f"unknown interpolation {cfg.interpolation!r}")
    if cfg.features_per_level < 1 or cfg.levels < 1:
        raise ValueError(f"the hash kernels take F and levels from 1, got F "
                         f"{cfg.features_per_level}, {cfg.levels} levels")
    if cfg.log2_hashmap_size < 1:
        raise ValueError(f"the hash kernels take log2_hashmap_size from 1, got "
                         f"{cfg.log2_hashmap_size}")
    if cfg.log2_hashmap_size > 31:
        raise ValueError(f"the hash kernels take log2_hashmap_size up to 31, got "
                         f"{cfg.log2_hashmap_size}: a level of 2^32 rows of "
                         f"{8 * cfg.features_per_level} values fits on no card")
    L, F = cfg.levels, cfg.features_per_level
    res = tuple(int(r) for r in cfg.level_resolutions())
    return types.SimpleNamespace(
        x_bf16=_DTYPES[x_dtype], rows=level_rows(cfg), width=8 * F,
        out_dim=L * F, scale=tuple(_res_as(r, x_dtype) for r in res), res=res,
        dense=tuple(int(_is_dense(cfg, l)) for l in range(L)),
        tail=(L, F, cfg.log2_hashmap_size, INTERPOLATIONS.index(cfg.interpolation)))


@functools.lru_cache(maxsize=None)
def _level_consts(cfg, x_dtype: torch.dtype, device: torch.device) -> tuple:
    """The per-level (scale, resolution, dense flag) on ``device``: three
    tensors, uploaded once without a host wait and kept."""
    c = _consts(cfg, x_dtype)
    return (cuda_lib.to_device(c.scale, torch.float32, device),
            cuda_lib.to_device(c.res, torch.int32, device),
            cuda_lib.to_device(c.dense, torch.int32, device))


@functools.lru_cache(maxsize=None)
def _row_offsets(nrows: tuple, width: int, device: torch.device) -> torch.Tensor:
    """Each level's first value in the cotangent's one allocation
    (``_alloc_tables``), on ``device``."""
    offs, at = [], 0
    for r in nrows:
        offs.append(at * width)
        at += r
    return cuda_lib.to_device(offs, torch.int64, device)


def _check_x(x01: torch.Tensor, what: str) -> None:
    if x01.device.type != "cuda":
        raise ValueError(f"{what} needs x01 on a CUDA device, got {x01.device}")
    if x01.dtype not in _DTYPES:
        raise TypeError(f"{what} takes float32 or bfloat16 x01, got {x01.dtype}")
    if x01.shape[-1:] != (3,) or not x01.is_contiguous():
        raise ValueError(f"{what} takes contiguous (..., 3) x01, got "
                         f"{tuple(x01.shape)}")


def _check_tables(tables, c: types.SimpleNamespace, device: int, what: str):
    """Refuse tables the kernels do not take: one per level, float32 or
    bfloat16, all of one type, contiguous, on ``device`` (an index, as
    ``Tensor.get_device`` gives it), (at least the ladder's rows, 8·F),
    16-byte aligned. Returns (their type, their pointers)."""
    if len(tables) != len(c.rows):
        raise ValueError(f"{what}: {len(tables)} tables for {len(c.rows)} levels")
    dtype = tables[0].dtype
    if dtype not in _DTYPES:
        raise TypeError(f"{what} takes float32 or bfloat16 tables, got {dtype}")
    ptrs = []
    for l, (t, need) in enumerate(zip(tables, c.rows)):
        ptr = t.data_ptr()
        if t.dtype != dtype or t.get_device() != device or not t.is_contiguous():
            raise ValueError(f"{what}: table {l} is {t.dtype} on {t.device} "
                             f"(contiguous {t.is_contiguous()}), want contiguous "
                             f"{dtype} on the device of x01")
        if t.dim() != 2 or t.shape[1] != c.width or t.shape[0] < need:
            raise ValueError(f"{what}: table {l} is {tuple(t.shape)}, want at least "
                             f"({need}, {c.width})")
        if ptr % 16:
            raise ValueError(f"{what}: table {l} is not 16-byte aligned")
        ptrs.append(ptr)
    return dtype, ptrs


def _alloc_tables(nrows: Sequence[int], width: int, dtype: torch.dtype, device) -> list:
    """The cotangent's L tables, (nrows[l], width) each, from one
    allocation: contiguous row blocks of it, each 16-byte aligned (a row of
    8·F values is a multiple of 16 bytes)."""
    buf = torch.empty((sum(nrows), width), dtype=dtype, device=device)
    return list(buf.split(list(nrows)))


def _on_stream(x01: torch.Tensor, fn) -> int:
    """``fn(stream)`` with x01's card current, on its current stream."""
    idx = x01.get_device()
    stream = torch.cuda.current_stream(idx).cuda_stream
    if idx == torch.cuda.current_device():
        return fn(stream)
    with torch.cuda.device(idx):
        return fn(stream)


def hash_cell_fwd_kernel(tables, x01: torch.Tensor, cfg,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the forward kernel on the current stream: x01 (..., 3)
    float32 or bfloat16, contiguous; the L tables (rows ≥ the config's
    ladder, 8·F) float32 or bfloat16, all of one type, contiguous, on x01's
    card. Returns (..., L·F) in the tables' type: ``out`` when given (a
    contiguous tensor of that shape and type on x01's card, such as one
    expert's slice of a (K, P, L·F) buffer), else a new tensor. Adds one to
    ``hash_cell_fwd_kernel.launches`` per launch."""
    what = "the hash encode kernel"
    _check_x(x01, what)
    c = _consts(cfg, x01.dtype)
    dtype, ptrs = _check_tables(tables, c, x01.get_device(), what)
    lib = _library()
    shape = (*x01.shape[:-1], c.out_dim)
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=x01.device)
    elif tuple(out.shape) != shape or out.dtype != dtype or out.device != x01.device \
            or not out.is_contiguous():
        raise ValueError(f"{what}: out is {out.dtype} {tuple(out.shape)} on {out.device} "
                         f"(contiguous {out.is_contiguous()}), want contiguous {dtype} "
                         f"{shape} on {x01.device}")
    n = x01.numel() // 3
    if n == 0:
        return out
    lvl = _level_consts(cfg, x01.dtype, x01.device)
    ptr_table = cuda_lib.device_table(ptrs, x01.device)
    err = _on_stream(x01, lambda s: lib.hash_cell_fwd(
        x01.data_ptr(), c.x_bf16, ptr_table.data_ptr(), _DTYPES[dtype],
        *(t.data_ptr() for t in lvl), *c.tail, n, out.data_ptr(), s))
    if err != 0:
        raise RuntimeError(f"hash_cell_fwd kernel launch failed: CUDA error {err}")
    hash_cell_fwd_kernel.launches += 1  # no points launched nothing (above)
    return out


def hash_cell_bwd_tables_kernel(x01: torch.Tensor, g: torch.Tensor, cfg,
                                nrows: Sequence[int],
                                dtypes: Sequence[torch.dtype]) -> list:
    """Launch the table cotangent on the current stream: zeroed tables of
    ``nrows[l]`` × 8·F in the one type of ``dtypes``, then w ⊗ g added at h
    (one call, two launches: the zero fill and the scatter). g: (..., L·F)
    contiguous in that type. Adds one to ``hash_cell_bwd_tables_kernel.launches``
    per call."""
    what = "the hash cotangent kernel"
    dtype = dtypes[0]
    if g.dtype != dtype or any(d != dtype for d in dtypes):
        raise TypeError(f"the hash cotangent kernel takes g and tables of one "
                        f"type, got {g.dtype} / {sorted(map(str, set(dtypes)))}")
    _check_x(x01, what)
    c = _consts(cfg, x01.dtype)
    if g.shape != (*x01.shape[:-1], c.out_dim) or not g.is_contiguous() \
            or g.device != x01.device:
        raise ValueError(f"the hash cotangent kernel takes a contiguous g of "
                         f"{(*x01.shape[:-1], c.out_dim)} on {x01.device}, got "
                         f"{tuple(g.shape)} on {g.device}")
    nrows = tuple(int(r) for r in nrows)
    grads = _alloc_tables(nrows, c.width, dtype, g.device)
    _check_tables(grads, c, x01.get_device(), what)
    lib = _library()
    n = x01.numel() // 3
    lvl = _level_consts(cfg, x01.dtype, x01.device)
    offs = _row_offsets(nrows, c.width, x01.device)
    err = _on_stream(x01, lambda s: lib.hash_cell_bwd_tables(
        x01.data_ptr(), c.x_bf16, g.data_ptr(), grads[0].data_ptr(), offs.data_ptr(),
        sum(nrows), _DTYPES[dtype], *(t.data_ptr() for t in lvl), *c.tail, n, s))
    if err != 0:
        raise RuntimeError(f"hash_cell_bwd_tables kernel launch failed: CUDA error {err}")
    hash_cell_bwd_tables_kernel.launches += 1
    return grads


hash_cell_fwd_kernel.launches = 0
hash_cell_bwd_tables_kernel.launches = 0


def hash_cell_fwd(tables, x01: torch.Tensor, cfg,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The encode's forward: the plain version for a CPU x01, the kernel
    for a CUDA one; into ``out`` when given."""
    if x01.device.type == "cpu":
        return hash_cell_fwd_plain(tables, x01, cfg, out=out)
    return hash_cell_fwd_kernel(tables, x01, cfg, out=out)


def hash_cell_bwd_tables(x01: torch.Tensor, g: torch.Tensor, cfg,
                         nrows: Sequence[int], dtypes: Sequence[torch.dtype]) -> list:
    """The table cotangent: the plain version for a CPU x01, the kernel for
    a CUDA one."""
    if x01.device.type == "cpu":
        return hash_cell_bwd_tables_plain(x01, g, cfg, nrows, dtypes)
    return hash_cell_bwd_tables_kernel(x01, g, cfg, nrows, dtypes)


class HashCellBwdTables(torch.autograd.Function):
    """The table cotangent as a function of the output cotangent g (and of
    x01), with a gradient. It is linear in g, and its transpose is the
    gather and blend at h: the g-cotangent of the tables' cotangents gg is
    the forward encode of gg (the forward kernel on the card). Its x01
    cotangent, when x01 needs one, is the encode's x cotangent with gg for
    the tables and g for the cotangent (``hash_cell_bwd_x``). Differentiable
    once: third derivatives raise."""

    @staticmethod
    def forward(ctx, g, x01, cfg, nrows, dtypes):
        ctx.cfg = cfg
        ctx.save_for_backward(x01, g if ctx.needs_input_grad[1] else None)
        return tuple(hash_cell_bwd_tables(x01, g.contiguous(), cfg, nrows, dtypes))

    @staticmethod
    @once_differentiable
    def backward(ctx, *gg):
        x01, g = ctx.saved_tensors
        gg = [t.contiguous() for t in gg]
        dg = hash_cell_fwd(gg, x01, ctx.cfg) if ctx.needs_input_grad[0] else None
        dx = (hash_cell_bwd_x(gg, x01, g, ctx.cfg).to(x01.dtype)
              if ctx.needs_input_grad[1] else None)
        return dg, dx, None, None, None


def launch_counts() -> tuple:
    """(forward launches, table-cotangent calls) since the counters were
    last set to 0."""
    return (hash_cell_fwd_kernel.launches, hash_cell_bwd_tables_kernel.launches)


def zero_launch_counts() -> None:
    hash_cell_fwd_kernel.launches = 0
    hash_cell_bwd_tables_kernel.launches = 0
