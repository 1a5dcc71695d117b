"""Input encodings: spherical harmonics, frequency (NeRF PE), and the
multiresolution hash grid in its two layouts.

Port of ``acn_tpu/models/encodings.py``: SH, ``frequency_encode``,
``HashGridConfig``, ``init_hash_table`` (both layouts), the corner-layout
encode (``_hash_encode_jnp_impl``: 8 hashed corner rows per point and
level, its backward left to autograd, as JAX's ``hash_encode_jnp`` leaves it
to ``jax.grad``), and the cell-layout encode (``_hash_encode_cell_impl`` /
``_cell_level_lookup``, with dense levels) with its hand-written backward
(``_HashEncodeCellSaved``, the counterpart of ``_hash_encode_cell_saved`` /
``_saved_bwd``). The cell-layout encode and its table cotangent are
hand-written CUDA kernels on the card and their plain PyTorch versions on
the CPU (``ops/hashgrid.py``, where the cell math lives): the forward
gathers and blends one row per (point, level), the backward recomputes the
cells and weights from x01 and scatter-adds, so nothing but x01 is kept.
``hash_encode`` dispatches on the layout as ``acn_tpu``'s does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from acn_tpu_torch.models.nn import norm3
from acn_tpu_torch.ops.hashgrid import (  # noqa: F401  (the cell math lives there)
    HashCellBwdTables, _cell_level_lookup, _corner_weights, _spatial_hash,
    hash_cell_bwd_x, hash_cell_fwd, level_rows)

# ============================ spherical harmonics ============================

MAX_SH_DEGREE = 4


def components_from_spherical_harmonics(degree: int,
                                        directions: torch.Tensor) -> torch.Tensor:
    """Real SH components up to ``degree`` for unit directions (..., 3);
    the basis polynomials of ``acn_tpu`` (and Nerfstudio). Returns
    (..., (degree+1)^2)."""
    assert 0 <= degree <= MAX_SH_DEGREE
    x, y, z = directions[..., 0], directions[..., 1], directions[..., 2]
    xx, yy, zz = x * x, y * y, z * z

    comps = [torch.full_like(x, 0.28209479177387814)]
    if degree > 0:
        comps += [
            0.4886025119029199 * y,
            0.4886025119029199 * z,
            0.4886025119029199 * x,
        ]
    if degree > 1:
        comps += [
            1.0925484305920792 * x * y,
            1.0925484305920792 * y * z,
            0.9461746957575601 * zz - 0.31539156525251999,
            1.0925484305920792 * x * z,
            0.5462742152960396 * (xx - yy),
        ]
    if degree > 2:
        comps += [
            0.5900435899266435 * y * (3 * xx - yy),
            2.890611442640554 * x * y * z,
            0.4570457994644658 * y * (5 * zz - 1),
            0.3731763325901154 * z * (5 * zz - 3),
            0.4570457994644658 * x * (5 * zz - 1),
            1.445305721320277 * z * (xx - yy),
            0.5900435899266435 * x * (xx - 3 * yy),
        ]
    if degree > 3:
        comps += [
            2.5033429417967046 * x * y * (xx - yy),
            1.7701307697799304 * y * z * (3 * xx - yy),
            0.9461746957575601 * x * y * (7 * zz - 1),
            0.6690465435572892 * y * z * (7 * zz - 3),
            0.10578554691520431 * (35 * zz * zz - 30 * zz + 3),
            0.6690465435572892 * x * z * (7 * zz - 3),
            0.47308734787878004 * (xx - yy) * (7 * zz - 1),
            1.7701307697799304 * x * z * (xx - 3 * yy),
            0.6258357354491761 * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
        ]
    return torch.stack(comps, dim=-1)


def sh_encode(d: torch.Tensor, levels: int = 4) -> torch.Tensor:
    """SH encoding of (possibly unnormalized) directions: ``levels`` SH
    levels ⇒ degree levels − 1, out dim levels². Normalizes inside."""
    if levels <= 0 or levels > MAX_SH_DEGREE + 1:
        raise ValueError(
            f"Supported levels ∈ [1, {MAX_SH_DEGREE + 1}], got {levels}")
    d = d / torch.clamp(norm3(d), min=1e-9)
    return components_from_spherical_harmonics(levels - 1, d)


def sh_out_dim(levels: int) -> int:
    return levels**2


# ============================ frequency encoding ============================


def frequency_encode(x: torch.Tensor, pe_dim: int, include_input: bool = True,
                     use_pi: bool = False) -> torch.Tensor:
    """NeRF positional encoding: concat([x?], cos(2^k x), sin(2^k x)) over
    k < pe_dim, per input dim, cos before sin (``acn_tpu``'s order)."""
    bands = 2.0 ** torch.arange(pe_dim, dtype=x.dtype, device=x.device)
    xin = x * (math.pi if use_pi else 1.0)
    x_exp = xin[..., None] * bands  # (..., D, L)
    pe = torch.cat([torch.cos(x_exp), torch.sin(x_exp)], dim=-1)
    pe = pe.reshape(*x.shape[:-1], 2 * pe_dim * x.shape[-1])  # no -1: P may be 0
    return torch.cat([x, pe], dim=-1) if include_input else pe


def frequency_out_dim(in_dim: int, pe_dim: int, include_input: bool = True) -> int:
    return in_dim * (2 * pe_dim + (1 if include_input else 0))


# ============================ hash grid encoding ============================

@dataclass(frozen=True)
class HashGridConfig:
    """``acn_tpu``'s ``HashGridConfig`` fields that the port reads, forward
    and backward (a JAX config carries across by field name,
    ``convert.config_from_dict``).

    ``layout``: ``"corner"``, one (F,) row per hashed corner in one
    (levels · table_size, F) table, 8 gathers per (point, level); or
    ``"cell"``, one (8·F,) row per hashed cell in a table per level.

    ``cell_backward``: ``"save_rows"`` or ``"remat"``, carried from the JAX
    config. Both take the hand-written backward (``_HashEncodeCellSaved``:
    scatter-add plus elementwise, the cells and weights recomputed from x01,
    so nothing but x01 is kept, which is what JAX's remat buys); in JAX the
    two give the same values."""

    levels: int = 16
    min_res: int = 16
    max_res: int = 4096
    log2_hashmap_size: int = 19
    features_per_level: int = 2
    hash_init_scale: float = 1e-3
    interpolation: str = "Linear"  # "Linear" | "Nearest" | "Smoothstep"
    layout: str = "corner"  # "corner" | "cell"
    cell_backward: str = "save_rows"  # "save_rows" | "remat"
    dense_levels: bool = False

    @property
    def table_size(self) -> int:
        return 2**self.log2_hashmap_size

    def level_rows(self, l: int) -> int:
        """Cell-layout rows for level l (dense-clamped when enabled)."""
        if self.layout == "cell" and self.dense_levels:
            res = int(self.level_resolutions()[l])
            return min(self.table_size, res * res * res)
        return self.table_size

    @property
    def out_dim(self) -> int:
        return self.levels * self.features_per_level

    @property
    def growth_factor(self) -> float:
        if self.levels <= 1:
            return 1.0
        return float(math.exp(
            (math.log(self.max_res) - math.log(self.min_res)) / (self.levels - 1)
        ))

    def level_resolutions(self) -> np.ndarray:
        """Per-level resolutions N_l = ⌊N_min · g^l⌋, in float64 numpy
        exactly as ``acn_tpu`` computes them (at min 16 / max 4096 / 8
        levels the top level is 4095, not 4096)."""
        ls = np.arange(self.levels, dtype=np.float64)
        return np.floor(self.min_res * (self.growth_factor**ls)).astype(np.int32)


def init_hash_table(cfg: HashGridConfig, *,
                    generator: Optional[torch.Generator] = None, device=None):
    """U(−s, s) tables, s = hash_init_scale. Cell layout: a list of per-level
    tables (level_rows(l), 8·F). Corner layout: one table
    (levels · table_size, F)."""
    gen_dev = generator.device if generator is not None else "cpu"

    def uniform(shape):
        return ((torch.rand(shape, generator=generator, device=gen_dev) * 2.0 - 1.0)
                * cfg.hash_init_scale).to(device)

    if cfg.layout == "cell":
        w = 8 * cfg.features_per_level
        return [uniform((cfg.level_rows(l), w)) for l in range(cfg.levels)]
    return uniform((cfg.table_size * cfg.levels, cfg.features_per_level))


def _hash_encode_jnp_impl(table: torch.Tensor, x01: torch.Tensor,
                         cfg: HashGridConfig) -> torch.Tensor:
    """Corner-layout encoding (``acn_tpu``'s ``_hash_encode_jnp_impl``):
    per level, scale by the level's resolution (rounded to x01's dtype, as
    ``jnp.asarray(res, x01.dtype)`` rounds it), gather the 8 corner rows by
    spatial hash and blend them one corner at a time with the trilinear
    weights (smoothstepped for Smoothstep), or take the rounded corner's
    row (Nearest). x01 (..., 3) in [0, 1] → (..., levels · F). The backward
    is autograd's: a scatter-add into the table per corner."""
    L, F = cfg.levels, cfg.features_per_level
    res = torch.as_tensor(cfg.level_resolutions(), dtype=x01.dtype, device=x01.device)
    scaled = x01[..., None, :] * res[:, None]  # (..., L, 3)
    offs = torch.arange(L, device=x01.device) * cfg.table_size  # (L,)
    batch_shape = x01.shape[:-1]
    if cfg.interpolation == "Nearest":
        h = _spatial_hash(torch.round(scaled).to(torch.int64), cfg.log2_hashmap_size)
        return table[h + offs].reshape(*batch_shape, L * F)
    floor = torch.floor(scaled)
    frac = scaled - floor
    floor_i = floor.to(torch.int64)
    if cfg.interpolation == "Smoothstep":
        frac = frac * frac * (3 - 2 * frac)
    feats = torch.zeros((*batch_shape, L * F), dtype=table.dtype, device=table.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                c = floor_i + torch.tensor([dx, dy, dz], device=x01.device)
                h = _spatial_hash(c, cfg.log2_hashmap_size)  # (..., L)
                f = table[h + offs].reshape(*batch_shape, L * F)
                w = ((frac[..., 0] if dx else 1.0 - frac[..., 0])
                     * (frac[..., 1] if dy else 1.0 - frac[..., 1])
                     * (frac[..., 2] if dz else 1.0 - frac[..., 2]))  # (..., L)
                w = torch.repeat_interleave(w, F, dim=-1)  # (..., L·F)
                feats = feats + f * w.to(table.dtype)
    return feats


# JAX rematerializes the corner encode (its 16-lane corner temporaries pad
# 8× in TPU tiles); here autograd keeps the indices and weights, a few bytes
# per (point, level, corner)
hash_encode_jnp = _hash_encode_jnp_impl


class _HashEncodeCellSaved(torch.autograd.Function):
    """The cell-layout encode with ``acn_tpu``'s ``save_rows`` backward
    (``acn_tpu/models/encodings.py:413-501``), on the kernels of
    ``ops/hashgrid.py`` for a CUDA x01 and their plain versions for a CPU
    one.

    Forward: ``hash_cell_fwd``; only x01 is kept (and the tables, when x01
    needs a gradient). Backward: the table cotangent is
    ``HashCellBwdTables``, which recomputes the cells and weights from x01
    and adds w ⊗ g at h into zeros of the **operand's** row count and dtype
    (under bf16 the sum runs in bf16, as in the JAX package); on the card
    it adds with atomics, so the order, and so the last bits, are free. The
    x cotangent, only when x01 needs one (in training it never does), comes
    from dw/df on rows gathered again (``hash_cell_bwd_x``).

    Twice differentiable, as JAX's derivative of ``_saved_bwd`` is: the
    table cotangent is linear in g, so under ``create_graph`` it stays on
    the graph and its own backward is the forward encode of the cotangent's
    cotangent (the forward kernel on the card). The x path under
    ``create_graph`` runs on differentiable ops, so that its derivative
    reaches the tables, x01 and g."""

    @staticmethod
    def forward(ctx, x01, cfg, *tables):
        x01 = x01.contiguous()
        ctx.cfg, ctx.x_dtype = cfg, x01.dtype
        ctx.nrows = tuple(int(t.shape[0]) for t in tables)
        ctx.dtypes = tuple(t.dtype for t in tables)
        # the tables only for the x path
        ctx.save_for_backward(x01, *(tables if ctx.needs_input_grad[0] else ()))
        return hash_cell_fwd(tables, x01, cfg)

    @staticmethod
    def backward(ctx, g):
        cfg = ctx.cfg
        x01, *tables = ctx.saved_tensors
        need_t = ctx.needs_input_grad[2:]
        tab_grads = [None] * cfg.levels
        if any(need_t):
            got = HashCellBwdTables.apply(g, x01, cfg, ctx.nrows, ctx.dtypes)
            tab_grads = [t if need else None for t, need in zip(got, need_t)]
        gx = None
        if ctx.needs_input_grad[0]:
            gx = hash_cell_bwd_x(tables, x01, g, cfg).to(ctx.x_dtype)
        return (gx, None, *tab_grads)

def hash_encode_cell(tables, x01: torch.Tensor, cfg: HashGridConfig) -> torch.Tensor:
    """Cell-layout encoding. Checks the tables against the config's row
    ladder, as ``acn_tpu`` does. Every ``cell_backward`` and interpolation
    takes ``_HashEncodeCellSaved``: the kernels on the card, their plain
    versions on the CPU (its backward recomputes from x01, so ``"remat"``
    and ``"save_rows"`` are one path)."""
    _check_rows(tables, cfg)
    return _HashEncodeCellSaved.apply(x01, cfg, *tables)


def _check_rows(tables, cfg: HashGridConfig) -> None:
    got = tuple(int(t.shape[0]) for t in tables)
    want = level_rows(cfg)
    if got != want:
        raise ValueError(
            f"hash table rows do not match the config ladder (config expects "
            f"{want}, tables have {got})")
    if cfg.cell_backward not in ("save_rows", "remat"):
        raise ValueError(f"unknown cell_backward {cfg.cell_backward!r}")


def hash_encode(table, x01: torch.Tensor, cfg: HashGridConfig,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatch on the layout: ``cell`` → ``hash_encode_cell``, ``corner`` →
    ``hash_encode_jnp``. With ``out`` (only where no gradient is recorded)
    the features are written into it: the cell layout's forward writes
    there itself (the kernel on the card), the corner layout's result is
    copied."""
    if out is not None:
        if torch.is_grad_enabled():
            raise ValueError("hash_encode(out=...) records no gradient: call it "
                             "under torch.no_grad()")
        if cfg.layout == "cell":
            _check_rows(table, cfg)
            return hash_cell_fwd(table, x01.contiguous(), cfg, out=out)
        return out.copy_(hash_encode(table, x01, cfg))
    if cfg.layout == "cell":
        return hash_encode_cell(table, x01, cfg)
    if cfg.layout == "corner":
        return hash_encode_jnp(table, x01, cfg)
    raise ValueError(f"Unknown hash layout {cfg.layout!r}")
