"""Carry weights, occupancy state and configs across from ``acn_tpu``, and
weights and occupancy state back.

The inputs are what the JAX package holds, as plain Python: the
``variables`` tree and the stacked ``occ_states`` as nested dicts and lists
of numpy arrays (what ``jax.device_get`` returns), and configs as nested
dicts of their fields (what ``dataclasses.asdict`` returns). Nothing here
imports ``jax`` or ``acn_tpu``. Layouts carry over unchanged: Linear weights
``(in, out)``, per-level cell-layout hash tables or the one corner-layout
table, a vanilla expert's ``trunk`` list, a leading K axis on every expert
leaf.

The optimizer state crosses in its state-dict form, the layout that
``utils/checkpoint.py`` keeps (``optim_state_dict`` / ``opt_state_from_dict``;
flax's ``serialization.to_state_dict`` of an optax state gives the same form).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from acn_tpu_torch.models.container import Container, ContainerConfig
from acn_tpu_torch.models.encodings import HashGridConfig
from acn_tpu_torch.models.ngp import NGPConfig
from acn_tpu_torch.models.vanilla import VanillaConfig
from acn_tpu_torch.models.nn import tree_map
from acn_tpu_torch.occupancy.grid import OccConfig


def _tensors(tree, device):
    if isinstance(tree, Mapping):
        return {k: _tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v, device) for v in tree]
    return torch.from_numpy(np.array(tree)).to(device)


def _known(cls, d: Mapping[str, Any]) -> Dict[str, Any]:
    """The entries of ``d`` that are fields of ``cls``: the port's configs
    hold only what its code reads (``cell_backward`` among them; no backend
    switches), so the rest of a JAX config is dropped."""
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def config_from_dict(d: Mapping[str, Any]) -> ContainerConfig:
    """A ``ContainerConfig`` from the field dict of ``acn_tpu``'s (nested:
    ``expert`` holds the NGP fields, ``expert["hash"]`` the hash grid's, or
    the vanilla expert's fields when ``nerf_variant`` is ``vanilla``)."""
    if d.get("nerf_variant", "instant") == "vanilla":
        expert = _known(VanillaConfig, d["expert"])
        expert["skips"] = tuple(expert.get("skips", VanillaConfig.skips))
        expert_cfg = VanillaConfig(**expert)
    else:
        expert = _known(NGPConfig, d["expert"])
        expert["hash"] = HashGridConfig(**_known(HashGridConfig, expert["hash"]))
        expert_cfg = NGPConfig(**expert)
    return ContainerConfig(**{**_known(ContainerConfig, d), "expert": expert_cfg})


def occ_config_from_dict(d: Mapping[str, Any]) -> OccConfig:
    return OccConfig(**_known(OccConfig, d))


def from_jax_variables(tree: Mapping[str, Any], cfg: ContainerConfig,
                       device=None) -> Container:
    """The JAX ``variables`` tree ({"params": {"experts", "bg_mlp"},
    "buffers": {"centroids", "expert_aabbs", "global_aabb"}}) as a
    ``Container`` on ``device``."""
    params, bufs = tree["params"], tree["buffers"]
    t = _tensors
    return Container(
        cfg,
        t(params["experts"], device),
        t(params["bg_mlp"], device) if "bg_mlp" in params else None,
        t(bufs["centroids"], device),
        t(bufs["expert_aabbs"], device),
        t(bufs["global_aabb"], device),
    )


def from_jax_occ_states(tree: Mapping[str, Any], device=None) -> Dict[str, torch.Tensor]:
    """The stacked (K, ...) occupancy states {"occs", "binaries", "aabbs"}
    as tensors on ``device``."""
    return {k: _tensors(v, device) for k, v in tree.items()}


def _numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def to_jax_occ_states(occ_states: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Stacked occupancy states back as numpy arrays, the inverse of
    ``from_jax_occ_states``."""
    return _numpy(dict(occ_states))


def to_jax_variables(model: Container) -> Dict[str, Any]:
    """A ``Container`` back as the JAX ``variables`` tree of numpy arrays
    ({"params": {"experts", "bg_mlp"}, "buffers": {...}}), the inverse of
    ``from_jax_variables``."""
    return {
        "params": _numpy(model.params()),
        "buffers": {name: getattr(model, name).detach().cpu().numpy().copy()
                    for name in ("centroids", "expert_aabbs", "global_aabb")},
    }
