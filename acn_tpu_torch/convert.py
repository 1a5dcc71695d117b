"""Carry weights, occupancy state, optimizer state and configs across from
``acn_tpu``, and weights, occupancy state and optimizer state back.

The inputs are what the JAX package holds, as plain Python: the
``variables`` tree and the stacked ``occ_states`` as nested dicts and lists
of numpy arrays (what ``jax.device_get`` returns), and configs as nested
dicts of their fields (what ``dataclasses.asdict`` returns). Nothing here
imports ``jax`` or ``acn_tpu``. Layouts carry over unchanged: Linear weights
``(in, out)``, per-level cell-layout hash tables, a leading K axis on every
expert leaf.

The optimizer state crosses by duck typing: optax's state is a nest of named
tuples (``ApplyIfFiniteState`` → chain → ``PartitionState`` →
``MaskedState`` → ``ScaleByAdamState``), read here by attribute name and
rebuilt with ``_replace``, so optax is not imported either.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from acn_tpu_torch.models.container import Container, ContainerConfig
from acn_tpu_torch.models.encodings import HashGridConfig
from acn_tpu_torch.models.ngp import NGPConfig
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
    ``expert`` holds the NGP fields, ``expert["hash"]`` the hash grid's)."""
    expert = _known(NGPConfig, d["expert"])
    expert["hash"] = HashGridConfig(**_known(HashGridConfig, expert["hash"]))
    return ContainerConfig(**{**_known(ContainerConfig, d),
                              "expert": NGPConfig(**expert)})


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


# ---- optimizer state: optax <-> utils.optim ----


def _is_masked(x) -> bool:
    return type(x).__name__ == "MaskedNode"


def _partition(ostate):
    """(guard state or None, chain tuple, index of the PartitionState in it,
    whether the partition stood alone) of ``build_optimizer``'s optax state."""
    guard = ostate if hasattr(ostate, "notfinite_count") else None
    chain = guard.inner_state if guard is not None else ostate
    alone = hasattr(chain, "inner_states")  # no clip: no chain around it
    if alone:
        chain = (chain,)
    idx = [i for i, s in enumerate(chain) if hasattr(s, "inner_states")]
    if len(idx) != 1:
        raise ValueError("not the optimizer state of build_optimizer: no "
                         "per-group (multi_transform) state in it")
    return guard, tuple(chain), idx[0], alone


def _adam_of(group_state):
    """(state tuple of one group's adam chain, index of ScaleByAdamState)."""
    inner = getattr(group_state, "inner_state", group_state)  # MaskedState
    idx = [i for i, s in enumerate(inner) if hasattr(s, "mu")]
    if len(idx) != 1:
        raise NotImplementedError("only optax.adam group states carry across")
    return tuple(inner), idx[0]


def opt_state_from_optax(ostate, labels, device=None) -> Dict[str, Any]:
    """``acn_tpu.utils.optim.build_optimizer``'s optax state (after
    ``jax.device_get``) as the state of ``acn_tpu_torch.utils.optim``.
    ``labels`` is ``container.param_group_labels(params)``: each leaf's
    moments are read from its own group's (masked) trees."""
    guard, chain, pi, _ = _partition(ostate)
    groups = {g: _adam_of(st) for g, st in chain[pi].inner_states.items()}
    adam = {g: inner[i] for g, (inner, i) in groups.items()}
    counts = {int(np.asarray(a.count)) for a in adam.values()}
    if len(counts) != 1:
        raise ValueError(f"the groups' step counts differ: {sorted(counts)}")

    def scalar(v, dtype):
        return torch.tensor(np.asarray(v).item(), dtype=dtype, device=device)

    def moment(name):
        return tree_map(
            lambda label, *per_group: _tensors(
                dict(zip(adam, per_group))[label], device),
            labels, *(getattr(a, name) for a in adam.values()))

    state = {"count": scalar(counts.pop(), torch.int32),
             "mu": moment("mu"), "nu": moment("nu")}
    if guard is not None:
        state.update(
            notfinite_count=scalar(guard.notfinite_count, torch.int32),
            last_finite=scalar(guard.last_finite, torch.bool),
            total_notfinite=scalar(guard.total_notfinite, torch.int32))
    return state


def opt_state_into_optax(state: Mapping[str, Any], template, labels):
    """The port's optimizer state written into a copy of ``template``, an
    optax state of the same optimizer (``optimizer.init(params)``): numpy
    leaves, every group's count and schedule count set, masked nodes kept."""
    guard, chain, pi, alone = _partition(template)
    count = np.asarray(int(state["count"]), np.int32)
    mu, nu = _numpy(state["mu"]), _numpy(state["nu"])

    def masked_like(tmpl_tree, values):
        return tree_map(lambda _, t, v: t if _is_masked(t) else v,
                        labels, tmpl_tree, values)

    new_groups = {}
    for g, st in chain[pi].inner_states.items():
        inner, ai = _adam_of(st)
        inner = list(inner)
        inner[ai] = inner[ai]._replace(
            count=count, mu=masked_like(inner[ai].mu, mu),
            nu=masked_like(inner[ai].nu, nu))
        inner = [s._replace(count=count)
                 if i != ai and hasattr(s, "count") else s
                 for i, s in enumerate(inner)]
        new_groups[g] = (st._replace(inner_state=tuple(inner))
                         if hasattr(st, "inner_state") else tuple(inner))
    chain = list(chain)
    chain[pi] = chain[pi]._replace(inner_states=new_groups)
    inner_state = chain[0] if alone else tuple(chain)
    if guard is None:
        return inner_state
    return guard._replace(
        notfinite_count=np.asarray(int(state["notfinite_count"]), np.int32),
        last_finite=np.asarray(bool(state["last_finite"])),
        total_notfinite=np.asarray(int(state["total_notfinite"]), np.int32),
        inner_state=inner_state)
