"""Classical (vanilla) NeRF expert as functions over a parameter dict.

Port of ``acn_tpu/models/vanilla.py``: Fourier PE of xyz (no π, input
kept), a trunk of ``sigma_depth`` ReLU layers with the encoding concatenated
again before each skip layer, a σ head (trunc_exp) and a geo-feature head,
and a view-dependent color MLP over [geo_feat, dir encoding] (SH or
frequency) with sigmoid RGB. The expert keeps the NGP expert's ``(…, 6) →
(…, 4)`` interface; its AABB argument is unused (the PE is global). The
parameter dict has the JAX tree's keys: ``trunk`` (list of ``{w, b}``),
``sigma_head``, ``geo_head``, ``color_mlp``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import torch

from acn_tpu_torch.models import nn
from acn_tpu_torch.models.encodings import (
    frequency_encode,
    frequency_out_dim,
    sh_encode,
    sh_out_dim,
)
from acn_tpu_torch.models.trunc_exp import trunc_exp

Params = Dict[str, Any]


@dataclass(frozen=True)
class VanillaConfig:
    """``acn_tpu``'s ``VanillaConfig`` (the reference MetaNeRF's defaults)."""

    hidden: int = 256
    sigma_depth: int = 8
    skips: Tuple[int, ...] = (4,)
    geo_feat_dim: int = 15
    color_hidden: int = 128
    color_depth: int = 2
    use_sigmoid_rgb: bool = True
    pe_dim_xyz: int = 10
    include_input_xyz: bool = True
    dir_encoding: str = "spherical"  # "spherical" | "frequency"
    sh_levels: int = 4
    freq_pe_dim_dir: int = 4

    @property
    def xyz_enc_dim(self) -> int:
        return frequency_out_dim(3, self.pe_dim_xyz, self.include_input_xyz)

    @property
    def dir_enc_dim(self) -> int:
        if self.dir_encoding == "spherical":
            return sh_out_dim(self.sh_levels)
        return frequency_out_dim(3, self.freq_pe_dim_dir, include_input=True)


def init_vanilla(cfg: VanillaConfig, *, generator: Optional[torch.Generator] = None,
                 device=None) -> Params:
    """One expert's parameter dict, torch-default Linear init."""
    kw = dict(generator=generator, device=device)
    in_xyz = cfg.xyz_enc_dim
    trunk = []
    for i in range(cfg.sigma_depth):
        in_dim = in_xyz if i == 0 else cfg.hidden
        if i in cfg.skips and i != 0:
            in_dim = cfg.hidden + in_xyz
        trunk.append(nn.init_linear(in_dim, cfg.hidden, **kw))
    color_dims = ([cfg.geo_feat_dim + cfg.dir_enc_dim]
                  + [cfg.color_hidden] * max(cfg.color_depth - 1, 0) + [3])
    return {
        "trunk": trunk,
        "sigma_head": nn.init_linear(cfg.hidden, 1, **kw),
        "geo_head": nn.init_linear(cfg.hidden, cfg.geo_feat_dim, **kw),
        "color_mlp": nn.init_mlp(color_dims, **kw),
    }


def _enc_dir(cfg: VanillaConfig, d: torch.Tensor) -> torch.Tensor:
    d = d / torch.clamp(nn.norm3(d), min=1e-9)
    if cfg.dir_encoding == "spherical":
        return sh_encode(d, cfg.sh_levels)
    return frequency_encode(d, cfg.freq_pe_dim_dir, include_input=True, use_pi=False)


def vanilla_density(
    params: Params,
    cfg: VanillaConfig,
    aabb: torch.Tensor,  # (2, 3), unused: the PE is global
    x: torch.Tensor,  # (..., 3)
    return_feats: bool = False,
) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
    """xyz → trunk with skips → σ (..., 1) (trunc_exp), and optionally the
    geo features."""
    enc = frequency_encode(x, cfg.pe_dim_xyz, include_input=cfg.include_input_xyz,
                           use_pi=False).to(x.dtype)
    h = enc
    for i, layer in enumerate(params["trunk"]):
        if i in cfg.skips and i != 0:
            h = torch.cat([h, enc], dim=-1)
        h = torch.relu(nn.apply_linear(layer, h))
    sigma = trunc_exp(nn.apply_linear(params["sigma_head"], h))
    if not return_feats:
        return sigma
    return {"sigma": sigma, "geo_feat": nn.apply_linear(params["geo_head"], h)}


def vanilla_color(params: Params, cfg: VanillaConfig, d: torch.Tensor,
                  geo_feat: torch.Tensor) -> torch.Tensor:
    """View-dependent RGB."""
    d_enc = _enc_dir(cfg, d).to(geo_feat.dtype)
    h = torch.cat([geo_feat, d_enc], dim=-1)
    rgb = nn.apply_mlp(params["color_mlp"], h, activation="relu")
    return torch.sigmoid(rgb) if cfg.use_sigmoid_rgb else rgb


def vanilla_forward(params: Params, cfg: VanillaConfig, aabb: torch.Tensor,
                    x_d: torch.Tensor) -> torch.Tensor:
    """(..., 6) [xyz, dir] → (..., 4) [rgb, σ]."""
    x, d = x_d[..., :3], x_d[..., 3:6]
    out = vanilla_density(params, cfg, aabb, x, return_feats=True)
    rgb = vanilla_color(params, cfg, d, out["geo_feat"])
    return torch.cat([rgb, out["sigma"]], dim=-1)


def param_group_labels(params: Params) -> Params:
    """Optimizer groups: the trunk and both heads are ``sigma`` (there is no
    hash encoding), the color MLP ``color``."""
    group = {"trunk": "sigma", "sigma_head": "sigma", "geo_head": "sigma",
             "color_mlp": "color"}
    return {name: nn.tree_map(lambda _: g, params[name]) for name, g in group.items()}
