"""Mixture-of-experts NeRF container: routing, stacked experts, background.

Port of ``acn_tpu/models/container.py``. ``Container`` is the ``nn.Module``
counterpart of the JAX ``variables`` tree: the K experts' parameters keep
their leading K axis (``experts``, a module tree with the JAX tree's keys),
the background head is ``bg_mlp``, and centroids / expert AABBs / the global
AABB are buffers. All-expert evaluation is a loop over K (the JAX package
vmaps it); ``Container.expert(k)`` hands one expert's parameters to the
functional forward of the config's variant (``instant``: ``ngp``,
``vanilla``: ``vanilla``) as views. Training works on ``Container.params()``,
the parameters as a plain tree ``{"experts", "bg_mlp"}``, and runs an expert
on any tree of that structure (fast weights) through
``ContainerConfig.expert_forward``. Where no gradient is recorded, NGP
experts and their blend run through ``ops/ngp_net`` (``uses_net``): the K
hash encodes write into one (K, N, L·F) buffer and one call (the CUDA
kernel on the card) evaluates and blends the K networks.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union

import torch
from torch import nn as tnn

from acn_tpu_torch.models import ngp as ngp_mod
from acn_tpu_torch.models import nn
from acn_tpu_torch.models import vanilla as van_mod
from acn_tpu_torch.models.encodings import (
    frequency_encode,
    frequency_out_dim,
    sh_encode,
    sh_out_dim,
)
from acn_tpu_torch.models.ngp import NGPConfig
from acn_tpu_torch.models.vanilla import VanillaConfig
from acn_tpu_torch.ops import ngp_net


@dataclass(frozen=True)
class ContainerConfig:
    """``acn_tpu``'s ``ContainerConfig``: ``instant`` (NGP) or ``vanilla``
    (frequency-encoded MLP) experts, and a ``spherical`` or ``frequency``
    background encoding."""

    num_submodules: int = 4
    nerf_variant: str = "instant"  # "instant" | "vanilla"
    boundary_margin: float = 1.0
    cluster_2d: bool = True
    use_bg_nerf: bool = True
    bg_hidden: int = 32
    bg_encoding: str = "spherical"  # "spherical" | "frequency"
    bg_sh_levels: int = 4
    bg_freq_pe_dim: int = 4
    expert: Union[NGPConfig, VanillaConfig] = field(default_factory=NGPConfig)

    @property
    def bg_enc_dim(self) -> int:
        if self.bg_encoding == "spherical":
            return sh_out_dim(self.bg_sh_levels)
        return frequency_out_dim(3, self.bg_freq_pe_dim, include_input=True)

    @property
    def expert_forward(self):
        """(params, expert cfg, aabb, x_d (..., 6)) → (..., 4) [rgb, σ]."""
        return (ngp_mod.ngp_forward if self.nerf_variant == "instant"
                else van_mod.vanilla_forward)

    @property
    def expert_density(self):
        """The experts' density query."""
        return (ngp_mod.ngp_density if self.nerf_variant == "instant"
                else van_mod.vanilla_density)

    @property
    def expert_init(self):
        return ngp_mod.init_ngp if self.nerf_variant == "instant" else van_mod.init_vanilla


class _Leaf(tnn.Module):
    """One parameter where a tree holds a tensor beside subtrees (the
    corner layout's single ``hash_table``)."""

    def __init__(self, value: torch.Tensor):
        super().__init__()
        self.value = tnn.Parameter(value)


def _to_module(tree) -> tnn.Module:
    """Nested dicts / lists of tensors → ParameterDict / ParameterList leaves
    under ModuleDict / ModuleList, keeping the keys and order; a tensor
    beside subtrees becomes a ``_Leaf``."""
    if isinstance(tree, torch.Tensor):
        return _Leaf(tree)
    if isinstance(tree, dict):
        if all(isinstance(v, torch.Tensor) for v in tree.values()):
            return tnn.ParameterDict({k: tnn.Parameter(v) for k, v in tree.items()})
        return tnn.ModuleDict({k: _to_module(v) for k, v in tree.items()})
    if all(isinstance(v, torch.Tensor) for v in tree):
        return tnn.ParameterList([tnn.Parameter(v) for v in tree])
    return tnn.ModuleList([_to_module(v) for v in tree])


def _to_tree(m: tnn.Module, k: Optional[int] = None):
    """Inverse of ``_to_module``; with ``k``, every leaf is indexed [k]."""
    pick = (lambda t: t) if k is None else (lambda t: t[k])
    if isinstance(m, _Leaf):
        return pick(m.value)
    if isinstance(m, tnn.ParameterDict):
        return {n: pick(t) for n, t in m.items()}
    if isinstance(m, tnn.ModuleDict):
        return {n: _to_tree(c, k) for n, c in m.items()}
    if isinstance(m, tnn.ParameterList):
        return [pick(t) for t in m]
    return [_to_tree(c, k) for c in m]


class Container(tnn.Module):
    """K stacked experts + background head + routing buffers."""

    def __init__(self, cfg: ContainerConfig, experts: dict,
                 bg_mlp: Optional[list], centroids: torch.Tensor,
                 expert_aabbs: torch.Tensor, global_aabb: torch.Tensor):
        super().__init__()
        K = cfg.num_submodules
        assert tuple(centroids.shape) == (K, 3), centroids.shape
        assert tuple(expert_aabbs.shape) == (K, 2, 3), expert_aabbs.shape
        self.cfg = cfg
        self.experts = _to_module(experts)  # every leaf (K, ...)
        self.bg_mlp = _to_module(bg_mlp) if bg_mlp is not None else None
        self.register_buffer("centroids", centroids.to(torch.float32))
        self.register_buffer("expert_aabbs", expert_aabbs.to(torch.float32))
        self.register_buffer("global_aabb", global_aabb.to(torch.float32))

    def expert(self, k: int) -> dict:
        """Expert k's parameter dict (views into the stacked tensors)."""
        return _to_tree(self.experts, k)

    def params(self) -> dict:
        """The trainable parameters as the JAX ``params`` tree:
        ``{"experts": stacked (K, ...) leaves, "bg_mlp": [...]}`` (no
        ``bg_mlp`` without a background head). The leaves are the module's
        own ``Parameter``s."""
        tree = {"experts": _to_tree(self.experts)}
        if self.bg_mlp is not None:
            tree["bg_mlp"] = _to_tree(self.bg_mlp)
        return tree


def init_container(
    cfg: ContainerConfig,
    centroids: torch.Tensor,  # (K, 3) in world DRB
    expert_aabbs: torch.Tensor,  # (K, 2, 3)
    global_aabb: torch.Tensor,  # (2, 3)
    *,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> Container:
    """Random experts (each from the variant's init, then stacked) and
    background head on ``device``."""
    kw = dict(generator=generator, device=device)
    per_k = [cfg.expert_init(cfg.expert, **kw) for _ in range(cfg.num_submodules)]

    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {n: stack(*(l[n] for l in leaves)) for n in leaves[0]}
        if isinstance(leaves[0], list):
            return [stack(*ls) for ls in zip(*leaves)]
        return torch.stack(leaves)

    bg = (nn.init_mlp([cfg.bg_enc_dim, cfg.bg_hidden, 3], **kw)
          if cfg.use_bg_nerf else None)
    return Container(cfg, stack(*per_k), bg, centroids.to(device),
                     expert_aabbs.to(device), global_aabb.to(device))


# ============================ routing ============================


def routing_weights(
    centroids: torch.Tensor,  # (K, 3)
    pts: torch.Tensor,  # (N, 3) world DRB
    cluster_2d: bool = True,
    boundary_margin: float = 1.0,
) -> torch.Tensor:
    """Per-point expert weights (N, K), dense: inverse-distance weights in
    the clustering subspace (YZ when cluster_2d), masked to experts within
    margin·min-dist when boundary_margin > 1, else a hard one-hot."""
    # a slice, not a list index: a list becomes a host tensor copied to the
    # device, and the host would wait for the card at every call
    idx = slice(1, 3) if cluster_2d else slice(0, 3)
    x = pts[:, idx]
    c = centroids[:, idx]
    d2 = torch.sum((x[:, None, :] - c[None, :, :]) ** 2, dim=-1)
    dist = torch.sqrt(torch.clamp(d2, min=0.0))

    if boundary_margin > 1.0:
        dist = torch.clamp(dist, min=1e-6)
        invd = 1.0 / dist
        mind = torch.amin(dist, dim=1, keepdim=True)
        invd = invd * (dist <= boundary_margin * mind)
        denom = torch.clamp(torch.sum(invd, dim=1, keepdim=True), min=1e-6)
        return invd / denom

    hard = torch.argmin(dist, dim=1)
    return torch.nn.functional.one_hot(hard, centroids.shape[0]).to(pts.dtype)


# ============================ expert access ============================


def expert_slice(experts: dict, k: int) -> dict:
    """Expert ``k`` of a stacked (K, ...) tree, as views."""
    return nn.tree_map(lambda a: a[k], experts)


def param_group_labels(params: dict) -> dict:
    """Optimizer-group labels for ``Container.params()``: a tree of strings
    in {encoding, sigma, color, background} of the parameters' structure
    (``acn_tpu/models/container.py:270-281``), by the experts' variant as
    the tree shows it (a vanilla expert has a ``trunk``)."""
    labels_of = (van_mod.param_group_labels if "trunk" in params["experts"]
                 else ngp_mod.param_group_labels)
    labels = {"experts": labels_of(params["experts"])}
    if "bg_mlp" in params:
        labels["bg_mlp"] = nn.tree_map(lambda _: "background", params["bg_mlp"])
    return labels


# ============================ network calls ============================


def uses_net(model: Container, x: torch.Tensor) -> bool:
    """Whether the experts run through ``ops/ngp_net`` (one call for all K):
    NGP experts, and no gradient recorded at float32 points
    (``ngp_net.takes``)."""
    return model.cfg.nerf_variant == "instant" and ngp_net.takes(x)


def expert_features(model: Container, xyz: torch.Tensor) -> torch.Tensor:
    """(K, N, L·F): every expert's hash features at xyz (N, 3), which the K
    encodes write into one buffer (no gradient: ``hash_encode(out=)``)."""
    ecfg = model.cfg.expert
    K = model.cfg.num_submodules
    h = torch.empty((K, xyz.shape[0], ecfg.hash.out_dim), dtype=xyz.dtype,
                    device=xyz.device)
    for k in range(K):
        ngp_mod.hash_features(model.expert(k), ecfg, model.expert_aabbs[k], xyz, out=h[k])
    return h


def net_experts(model: Container) -> list:
    """The K experts' parameter dicts (views), for ``ngp_net``."""
    return [model.expert(k) for k in range(model.cfg.num_submodules)]


def container_forward(
    model: Container,
    x: torch.Tensor,  # (N, D>=6) [xyz, dir, ...]
    active_module: Optional[int] = None,
) -> torch.Tensor:
    """Routed forward: one expert on everything when ``active_module`` is
    set, else all K experts blended with the dense routing weights,
    y = Σ_k w_k · y_k. Returns (N, 4) [rgb, σ]. Without a gradient
    (``uses_net``) one expert is ``ngp_net``'s ``single`` mode (through
    ``ngp_forward``) and the blend its ``linear_blend`` mode."""
    cfg = model.cfg
    fwd = cfg.expert_forward
    if active_module is not None:
        return fwd(model.expert(active_module), cfg.expert,
                   model.expert_aabbs[active_module], x[..., :6])
    if uses_net(model, x):
        w = routing_weights(model.centroids, x[..., :3], cfg.cluster_2d,
                            cfg.boundary_margin)
        return ngp_net.ngp_net("linear_blend", expert_features(model, x[..., :3]),
                               x[..., 3:6], w, net_experts(model), cfg.expert)
    ys = torch.stack([
        fwd(model.expert(k), cfg.expert, model.expert_aabbs[k], x[..., :6])
        for k in range(cfg.num_submodules)
    ])  # (K, N, 4)
    w = routing_weights(model.centroids, x[..., :3], cfg.cluster_2d,
                        cfg.boundary_margin).to(ys.dtype)
    return torch.einsum("nk,kno->no", w, ys)


def container_density(
    model: Container,
    xyz: torch.Tensor,  # (N, 3)
    active_module: Optional[int] = None,
) -> torch.Tensor:
    """Routed density query → σ (N,): one expert's when ``active_module`` is
    set, else Σ_k w_k · σ_k with the dense routing weights. Without a
    gradient (``uses_net``) both are ``ngp_net``'s ``density`` mode."""
    cfg = model.cfg
    dens = cfg.expert_density
    if active_module is not None:
        return dens(model.expert(active_module), cfg.expert,
                    model.expert_aabbs[active_module], xyz)[..., 0]
    if uses_net(model, xyz):
        w = routing_weights(model.centroids, xyz, cfg.cluster_2d, cfg.boundary_margin)
        return ngp_net.ngp_net("density", expert_features(model, xyz), None, w,
                               net_experts(model), cfg.expert)
    sig = torch.stack([
        dens(model.expert(k), cfg.expert, model.expert_aabbs[k], xyz)[..., 0]
        for k in range(cfg.num_submodules)
    ])  # (K, N)
    w = routing_weights(model.centroids, xyz, cfg.cluster_2d,
                        cfg.boundary_margin).to(sig.dtype)
    return torch.einsum("nk,kn->n", w, sig)


def bg_mlp_color(layers: list, cfg: ContainerConfig,
                 d: torch.Tensor) -> torch.Tensor:
    """Background RGB from ray directions with the head's two layers given
    as a list of ``{w, b}``: SH or frequency encoding → 2-layer sigmoid MLP."""
    dn = d / torch.clamp(nn.norm3(d), min=1e-9)
    if cfg.bg_encoding == "spherical":
        enc = sh_encode(dn, cfg.bg_sh_levels)
    else:
        enc = frequency_encode(dn, cfg.bg_freq_pe_dim, include_input=True)
    h = torch.relu(nn.apply_linear(layers[0], enc.to(torch.float32)))
    return torch.sigmoid(nn.apply_linear(layers[1], h))


def background_color(model: Container, d: torch.Tensor) -> torch.Tensor:
    """Background RGB from ray directions with the model's own head."""
    if not model.cfg.use_bg_nerf:
        raise RuntimeError("background_color called but use_bg_nerf=False")
    return bg_mlp_color(_to_tree(model.bg_mlp), model.cfg, d)
