"""Input encodings: spherical harmonics, frequency (NeRF PE), and the
multiresolution hash grid in its two layouts.

Port of ``acn_tpu/models/encodings.py``: SH, ``frequency_encode``,
``HashGridConfig``, ``init_hash_table`` (both layouts), the corner-layout
encode (``_hash_encode_jnp_impl``: 8 hashed corner rows per point and
level, its backward left to autograd, as JAX's ``hash_encode_jnp`` leaves it
to ``jax.grad``), the cell-layout forward (``_hash_encode_cell_impl`` /
``_cell_level_lookup``, with dense levels) and its hand-written backward
(``_HashEncodeCellSaved``, the counterpart of ``_hash_encode_cell_saved`` /
``_saved_bwd``): the gathered rows, their indices and the raw intra-cell
fractions are kept, so the backward is a scatter-add per level plus
elementwise work and gathers nothing again. ``hash_encode`` dispatches on
the layout as ``acn_tpu``'s does. The hash encode is plain PyTorch here, as
it is plain XLA in the JAX package; a hand-written gather kernel is a
candidate for a later change.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from acn_tpu_torch.models.nn import norm3

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
    pe = pe.reshape(*x.shape[:-1], -1)
    return torch.cat([x, pe], dim=-1) if include_input else pe


def frequency_out_dim(in_dim: int, pe_dim: int, include_input: bool = True) -> int:
    return in_dim * (2 * pe_dim + (1 if include_input else 0))


# ============================ hash grid encoding ============================

# Instant-NGP 3D spatial hash primes.
HASH_PRIMES = (1, 2654435761, 805459861)


@dataclass(frozen=True)
class HashGridConfig:
    """``acn_tpu``'s ``HashGridConfig`` fields that the port reads, forward
    and backward (a JAX config carries across by field name,
    ``convert.config_from_dict``).

    ``layout``: ``"corner"``, one (F,) row per hashed corner in one
    (levels · table_size, F) table, 8 gathers per (point, level); or
    ``"cell"``, one (8·F,) row per hashed cell in a table per level.

    ``cell_backward``: ``"save_rows"`` keeps the gathered rows and fractions
    for a backward that is scatter-add plus elementwise; ``"remat"`` leaves
    the backward to autograd over ``_hash_encode_cell_impl``."""

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


def _cell_level_lookup(tables, x01: torch.Tensor, cfg: HashGridConfig, l: int):
    """Per-level (rows (..., 8F), h (...,), frac_raw (..., 3))."""
    res_l = int(cfg.level_resolutions()[l])
    scaled = x01 * _res_as(res_l, x01.dtype)
    cell = torch.floor(scaled)
    frac = scaled - cell
    cell_i = cell.to(torch.int64)
    if cfg.dense_levels and res_l**3 <= cfg.level_rows(l):
        # dense level: collision-free linear index of the clipped cell
        ci = torch.clamp(cell_i, 0, res_l - 1)
        h = (ci[..., 0] * res_l + ci[..., 1]) * res_l + ci[..., 2]
    else:
        h = _spatial_hash(cell_i, cfg.log2_hashmap_size)
    return tables[l][h], h, frac


def _encode_levels(tables, x01: torch.Tensor, cfg: HashGridConfig):
    """Cell-packed hash encoding: one gathered row per (point, level) holding
    the cell's 8 corner features, blended trilinearly. (..., 3) in [0, 1] →
    (features (..., L·F), [rows, h, frac_raw] of every level in turn)."""
    F = cfg.features_per_level
    feats, kept = [], []
    for l in range(cfg.levels):
        rows, h, frac = _cell_level_lookup(tables, x01, cfg, l)
        w = _corner_weights(_interp_frac(frac, cfg.interpolation))
        blended = rows.reshape(*rows.shape[:-1], 8, F) * w.to(rows.dtype)[..., None]
        feats.append(blended.sum(dim=-2))  # (..., F)
        kept += [rows, h, frac]
    return torch.cat(feats, dim=-1), kept


def _hash_encode_cell_impl(tables, x01: torch.Tensor,
                           cfg: HashGridConfig) -> torch.Tensor:
    """The encoding with its backward left to autograd."""
    return _encode_levels(tables, x01, cfg)[0]


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


# corner sign per axis in packing order (dz fastest): +1 where the corner
# takes the fraction f, −1 where it takes 1 − f
_CORNER_SIGNS = tuple((1.0 if dx else -1.0, 1.0 if dy else -1.0,
                       1.0 if dz else -1.0)
                      for dx in (0, 1) for dy in (0, 1) for dz in (0, 1))


class _HashEncodeCellSaved(torch.autograd.Function):
    """The cell-layout encode with ``acn_tpu``'s ``save_rows`` backward
    (``acn_tpu/models/encodings.py:413-501``).

    Forward: ``_encode_levels``; it keeps, per level,
    the gathered rows, their indices h and the raw fraction. Backward, per
    level: the table cotangent is ``index_add_`` of w ⊗ g at h into zeros
    of the **operand's** row count and dtype (under bf16 the sum runs in
    bf16, as in the JAX package), and the x cotangent, only when x01 needs
    one (in training it never does), comes from dw/df on the kept rows.
    On the card ``index_add_`` adds with atomics: the order, and so the last
    bits, are free.

    Twice differentiable, as JAX's derivative of ``_saved_bwd`` is: the
    table cotangent is linear in g, so under ``create_graph`` it stays on
    the graph and its own backward is a gather of the cotangent's cotangent
    at h. The x path, when x01 needs a gradient under ``create_graph``,
    recomputes the rows and fractions from the saved tables and x01 with
    differentiable ops, so that its derivative reaches both."""

    @staticmethod
    def forward(ctx, x01, cfg, *tables):
        out, kept = _encode_levels(tables, x01, cfg)
        ctx.cfg, ctx.x_dtype = cfg, x01.dtype
        ctx.nrows = tuple(int(t.shape[0]) for t in tables)
        # the inputs themselves only for the x path's second derivative
        ctx.save_for_backward(*kept, *((x01, *tables) if ctx.needs_input_grad[0]
                                       else ()))
        return out

    @staticmethod
    def backward(ctx, g):
        cfg, saved = ctx.cfg, ctx.saved_tensors
        F = cfg.features_per_level
        need_x = ctx.needs_input_grad[0]
        resolutions = cfg.level_resolutions()
        if need_x and torch.is_grad_enabled():
            x01, tables = saved[3 * cfg.levels], saved[3 * cfg.levels + 1:]
            redo = [_cell_level_lookup(tables, x01, cfg, l) for l in range(cfg.levels)]
        tab_grads = []
        gx = None
        for l in range(cfg.levels):
            rows, h, frac_raw = saved[3 * l:3 * l + 3]
            if need_x and torch.is_grad_enabled():
                rows, h, frac_raw = redo[l]
            g_l = g[..., l * F:(l + 1) * F]
            f = _interp_frac(frac_raw, cfg.interpolation)
            if ctx.needs_input_grad[2 + l]:
                w = _corner_weights(f)
                gw = (w[..., :, None].to(g_l.dtype) * g_l[..., None, :]).reshape(-1, 8 * F)
                tab_grads.append(
                    torch.zeros((ctx.nrows[l], 8 * F), dtype=rows.dtype,
                                device=rows.device)
                    .index_add_(0, h.reshape(-1), gw.to(rows.dtype)))
            else:
                tab_grads.append(None)
            if not need_x:
                continue
            # dout/df_a = Σ_c sign_a(c) · Π_{b≠a} A_b(c) · (rows_c · g)
            rg = torch.einsum("...cf,...f->...c",
                              rows.reshape(*rows.shape[:-1], 8, F),
                              g_l.to(rows.dtype)).to(torch.float32)
            # (8, 3); a copy from the host, on this branch only
            signs = torch.tensor(_CORNER_SIGNS, dtype=torch.float32,
                                 device=rows.device)
            fa = f[..., None, :]  # (..., 1, 3)
            A = torch.where(signs > 0, fa, 1.0 - fa).to(torch.float32)  # (..., 8, 3)
            s = torch.stack([
                torch.sum(signs[:, a] * A[..., (a + 1) % 3] * A[..., (a + 2) % 3]
                          * rg, dim=-1) for a in range(3)], dim=-1)
            if cfg.interpolation == "Smoothstep":
                s = s * (6.0 * frac_raw * (1.0 - frac_raw)).to(torch.float32)
            s = s * float(resolutions[l])
            gx = s if gx is None else gx + s
        return (gx.to(ctx.x_dtype) if need_x else None, None, *tab_grads)


def hash_encode_cell(tables, x01: torch.Tensor, cfg: HashGridConfig) -> torch.Tensor:
    """Cell-layout encoding. Checks the tables against the config's row
    ladder, as ``acn_tpu`` does. Backward per ``cfg.cell_backward``:
    ``"save_rows"`` is the hand-written one; ``"remat"``, and ``"Nearest"``
    interpolation, leave it to autograd over ``_hash_encode_cell_impl``."""
    got = tuple(int(t.shape[0]) for t in tables)
    want = tuple(cfg.level_rows(l) for l in range(cfg.levels))
    if got != want:
        raise ValueError(
            f"hash table rows do not match the config ladder (config expects "
            f"{want}, tables have {got})")
    if cfg.cell_backward not in ("save_rows", "remat"):
        raise ValueError(f"unknown cell_backward {cfg.cell_backward!r}")
    if cfg.cell_backward == "save_rows" and cfg.interpolation != "Nearest":
        return _HashEncodeCellSaved.apply(x01, cfg, *tables)
    return _hash_encode_cell_impl(tables, x01, cfg)


def hash_encode(table, x01: torch.Tensor, cfg: HashGridConfig) -> torch.Tensor:
    """Dispatch on the layout: ``cell`` → ``hash_encode_cell``, ``corner`` →
    ``hash_encode_jnp``."""
    if cfg.layout == "cell":
        return hash_encode_cell(table, x01, cfg)
    if cfg.layout == "corner":
        return hash_encode_jnp(table, x01, cfg)
    raise ValueError(f"Unknown hash layout {cfg.layout!r}")
