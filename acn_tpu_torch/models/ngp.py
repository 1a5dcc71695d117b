"""Instant-NGP-style NeRF expert as functions over a parameter dict.

Port of ``acn_tpu/models/ngp.py``: hash-encoded σ-trunk → {σ head (bias −1,
trunc_exp), geo-feature head} and a color MLP over [geo_feat, dir
encoding (SH or frequency)] with sigmoid RGB. World coords are normalized into the expert's own AABB and
clamped to [eps, 1−eps] before hash encoding. The parameter dict has the
JAX tree's keys and layouts (``hash_table``: a list of per-level tables in
the cell layout, one table in the corner layout; ``sigma_trunk`` list of
``{w, b}``, ``sigma_head``, ``geo_head``, ``color_mlp``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Union

import torch

from acn_tpu_torch.models import nn
from acn_tpu_torch.models.encodings import (
    HashGridConfig,
    frequency_encode,
    frequency_out_dim,
    hash_encode,
    init_hash_table,
    sh_encode,
    sh_out_dim,
)
from acn_tpu_torch.models.trunc_exp import trunc_exp

Params = Dict[str, Any]

ENC_EPS = 1e-6  # hash-input clamp


@dataclass(frozen=True)
class NGPConfig:
    """``acn_tpu``'s ``NGPConfig``: the direction encoding is
    ``spherical`` (SH) or ``frequency`` (PE with ``freq_pe_dim`` bands)."""

    hidden: int = 64
    sigma_depth: int = 2
    color_hidden: int = 64
    color_depth: int = 3
    geo_feat_dim: int = 15
    use_sigmoid_rgb: bool = True
    dir_encoding: str = "spherical"
    sh_levels: int = 4
    freq_pe_dim: int = 4
    hash: HashGridConfig = field(default_factory=HashGridConfig)

    @property
    def dir_enc_dim(self) -> int:
        if self.dir_encoding == "spherical":
            return sh_out_dim(self.sh_levels)
        if self.dir_encoding == "frequency":
            return frequency_out_dim(3, self.freq_pe_dim, include_input=True)
        raise ValueError(f"Unsupported dir_encoding: {self.dir_encoding}")


def init_ngp(cfg: NGPConfig, *, generator: Optional[torch.Generator] = None,
             device=None) -> Params:
    """One expert's parameter dict."""
    kw = dict(generator=generator, device=device)
    trunk_dims = [cfg.hash.out_dim] + [cfg.hidden] * max(cfg.sigma_depth, 0)
    sigma_trunk = nn.init_mlp(trunk_dims, **kw)
    last = trunk_dims[-1]
    sigma_head = nn.init_linear(last, 1, **kw)
    sigma_head["b"] = torch.full_like(sigma_head["b"], -1.0)  # density bias −1
    geo_head = nn.init_linear(last, cfg.geo_feat_dim, **kw)
    color_dims = (
        [cfg.geo_feat_dim + cfg.dir_enc_dim]
        + [cfg.color_hidden] * max(cfg.color_depth, 0)
        + [3]
    )
    return {
        "hash_table": init_hash_table(cfg.hash, **kw),
        "sigma_trunk": sigma_trunk,
        "sigma_head": sigma_head,
        "geo_head": geo_head,
        "color_mlp": nn.init_mlp(color_dims, **kw),
    }


def world_to_unit(x: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    """World → clamped [0,1]^3 inside the expert AABB."""
    aabb = aabb.to(x.dtype)
    x01 = (x - aabb[0]) / (aabb[1] - aabb[0])
    return torch.clamp(x01, ENC_EPS, 1.0 - ENC_EPS)


def _enc_dir(cfg: NGPConfig, d: torch.Tensor) -> torch.Tensor:
    d = d / torch.clamp(nn.norm3(d), min=1e-9)
    if cfg.dir_encoding == "spherical":
        return sh_encode(d, cfg.sh_levels)
    return frequency_encode(d, cfg.freq_pe_dim, include_input=True, use_pi=False)


def ngp_density(
    params: Params,
    cfg: NGPConfig,
    aabb: torch.Tensor,  # (2, 3)
    x: torch.Tensor,  # (..., 3) world coords
    return_feats: bool = False,
) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
    """σ (..., 1), and optionally geo features, at world coords."""
    x01 = world_to_unit(x, aabb)
    h = hash_encode(params["hash_table"], x01, cfg.hash).to(x.dtype)
    h = nn.apply_mlp(params["sigma_trunk"], h, activation="relu",
                     final_activation="relu")
    sigma = trunc_exp(nn.apply_linear(params["sigma_head"], h))
    if not return_feats:
        return sigma
    return {"sigma": sigma, "geo_feat": nn.apply_linear(params["geo_head"], h)}


def ngp_color(
    params: Params,
    cfg: NGPConfig,
    d: torch.Tensor,  # (..., 3) view directions
    geo_feat: torch.Tensor,  # (..., G)
) -> torch.Tensor:
    """View-dependent RGB."""
    d_enc = _enc_dir(cfg, d).to(geo_feat.dtype)
    h = torch.cat([geo_feat, d_enc], dim=-1)
    rgb = nn.apply_mlp(params["color_mlp"], h, activation="relu")
    return torch.sigmoid(rgb) if cfg.use_sigmoid_rgb else rgb


def ngp_forward(
    params: Params,
    cfg: NGPConfig,
    aabb: torch.Tensor,  # (2, 3)
    x_d: torch.Tensor,  # (..., 6) [xyz, dir]
) -> torch.Tensor:
    """(..., 6) [xyz, dir] → (..., 4) [rgb, σ]."""
    x, d = x_d[..., :3], x_d[..., 3:6]
    out = ngp_density(params, cfg, aabb, x, return_feats=True)
    rgb = ngp_color(params, cfg, d, out["geo_feat"])
    return torch.cat([rgb, out["sigma"]], dim=-1)


def param_group_labels(params: Params) -> Params:
    """Every leaf's optimizer group — ``encoding``, ``sigma`` or ``color`` —
    as a tree of strings of the parameters' structure
    (``acn_tpu/models/ngp.py:159``)."""
    group = {"hash_table": "encoding", "sigma_trunk": "sigma",
             "sigma_head": "sigma", "geo_head": "sigma", "color_mlp": "color"}
    return {name: nn.tree_map(lambda _: g, params[name])
            for name, g in group.items()}
