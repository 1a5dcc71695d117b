"""Instant-NGP-style NeRF expert as functions over a parameter dict.

Port of ``acn_tpu/models/ngp.py``: hash-encoded σ-trunk → {σ head (bias −1,
trunc_exp), geo-feature head} and a color MLP over [geo_feat, dir
encoding (SH or frequency)] with sigmoid RGB. World coords are normalized into the expert's own AABB and
clamped to [eps, 1−eps] before hash encoding. The parameter dict has the
JAX tree's keys and layouts (``hash_table``: a list of per-level tables in
the cell layout, one table in the corner layout; ``sigma_trunk`` list of
``{w, b}``, ``sigma_head``, ``geo_head``, ``color_mlp``). The network after
the encode is defined once, in ``ops/ngp_net.py``: its differentiable
composition under autograd, its ``ngp_net`` (the CUDA kernel on the card)
where no gradient is recorded.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Union

import torch

from acn_tpu_torch.models import nn
from acn_tpu_torch.models.encodings import (
    HashGridConfig,
    frequency_out_dim,
    hash_encode,
    init_hash_table,
    sh_out_dim,
)
from acn_tpu_torch.ops import ngp_net

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


def hash_features(params: Params, cfg: NGPConfig, aabb: torch.Tensor, x: torch.Tensor,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The expert's hash features at world coords x (..., 3): (..., L·F) in
    x's type, or written into ``out`` (no gradient; ``hash_encode``)."""
    x01 = world_to_unit(x, aabb)
    if out is not None:
        return hash_encode(params["hash_table"], x01, cfg.hash, out=out)
    return hash_encode(params["hash_table"], x01, cfg.hash).to(x.dtype)


def ngp_density(
    params: Params,
    cfg: NGPConfig,
    aabb: torch.Tensor,  # (2, 3)
    x: torch.Tensor,  # (..., 3) world coords
    return_feats: bool = False,
) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
    """σ (..., 1), and optionally geo features, at world coords. Without a
    gradient (``ngp_net.takes``) σ comes from ``ngp_net``'s ``density``
    mode (the kernel on the card)."""
    h = hash_features(params, cfg, aabb, x)
    if not return_feats and ngp_net.takes(x):
        flat = h.reshape(-1, h.shape[-1])
        return ngp_net.ngp_net("density", flat[None], None, None, [params], cfg).reshape(
            *x.shape[:-1], 1)
    return ngp_net.features_density(params, h, return_feats)


def ngp_color(
    params: Params,
    cfg: NGPConfig,
    d: torch.Tensor,  # (..., 3) view directions
    geo_feat: torch.Tensor,  # (..., G)
) -> torch.Tensor:
    """View-dependent RGB."""
    return ngp_net.features_color(params, cfg, d, geo_feat)


def ngp_forward(
    params: Params,
    cfg: NGPConfig,
    aabb: torch.Tensor,  # (2, 3)
    x_d: torch.Tensor,  # (..., 6) [xyz, dir]
) -> torch.Tensor:
    """(..., 6) [xyz, dir] → (..., 4) [rgb, σ]. Without a gradient
    (``ngp_net.takes``) the network after the encode is ``ngp_net``'s
    ``single`` mode (the kernel on the card)."""
    x, d = x_d[..., :3], x_d[..., 3:6]
    h = hash_features(params, cfg, aabb, x)
    if ngp_net.takes(x_d):
        lead = x_d.shape[:-1]
        out = ngp_net.ngp_net("single", h.reshape(-1, h.shape[-1])[None],
                              d.reshape(-1, 3), None, [params], cfg)
        return out.reshape(*lead, 4)
    return ngp_net.features_forward(params, cfg, h, d)


def param_group_labels(params: Params) -> Params:
    """Every leaf's optimizer group — ``encoding``, ``sigma`` or ``color`` —
    as a tree of strings of the parameters' structure
    (``acn_tpu/models/ngp.py:159``)."""
    group = {"hash_table": "encoding", "sigma_trunk": "sigma",
             "sigma_head": "sigma", "geo_head": "sigma", "color_mlp": "color"}
    return {name: nn.tree_map(lambda _: g, params[name])
            for name, g in group.items()}
