"""Optimizer and LR schedules, as plain functions over a parameter tree.

Port of ``acn_tpu/utils/optim.py``, which builds an optax chain: the guard
``apply_if_finite`` around ``clip_by_global_norm`` around a per-group
optimizer — Adam, AdamW or SGD — (``multi_transform`` over the labels
encoding / sigma / color / background), each group with its own
exponentially decayed rate. Here that chain is
written out, so that every step equals optax's and the state carries across
to and from optax's through the state-dict form of
``utils/checkpoint.py`` (``optim_state_dict`` / ``opt_state_from_dict``):

* **clip**: scale by ``max_norm / norm`` only where ``norm ≥ max_norm``, with
  no ``+ 1e-6`` (``torch.nn.utils.clip_grad_norm_`` divides by
  ``norm + 1e-6`` and is not used);
* **Adam**: m ← b1·m + (1−b1)·g, v ← b2·v + (1−b2)·g², update
  −lr · m̂ / (√v̂ + 1e-8) with both moments bias-corrected by the count
  **after** the increment, and the rate read at the count **before** it
  (step 0 uses lr₀);
* **AdamW** (``optax.adamw``'s defaults): Adam's step plus ``1e-4 · p``
  (the decayed weight, added before the rate scales it): update
  −lr · (m̂ / (√v̂ + 1e-8) + 1e-4 · p);
* **SGD** (``optax.sgd``, no momentum): update −lr · g;
* **guard**: a gradient with a NaN or Inf leaves parameters, moments and
  count untouched and is counted (until more than ``MAX_CONSECUTIVE_ERRORS``
  in a row, when optax gives up and applies).

The state is explicit: ``{"count", "mu", "nu"}`` (SGD keeps only the
schedule's ``count``) plus, with the guard, ``{"notfinite_count",
"last_finite", "total_notfinite"}``. Counts are 0-dim tensors on the
parameters' device and every decision is a ``torch.where``, so an update
never waits for the card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from acn_tpu_torch.models.nn import tree_leaves, tree_map
from acn_tpu_torch.parallel.mesh import all_finite, tree_sq_norm

Schedule = Callable[[Any], Any]

# optax.adam's defaults, optax.adamw's weight decay, and the patience
# build_optimizer gives apply_if_finite
B1, B2, EPS = 0.9, 0.999, 1e-8
WEIGHT_DECAY = 1e-4
MAX_CONSECUTIVE_ERRORS = 1000
OPTIMIZERS = ("adam", "adamw", "sgd")


def exponential_schedule(base_lr: float, outer_steps: int, decay_factor: float,
                         enabled: bool = True) -> Schedule:
    """lr(t) = lr₀ · decay_factor^(−t/outer_steps); final lr = lr₀/decay.
    ``t`` is a number (→ float) or a tensor (→ float32 tensor)."""
    if not enabled or decay_factor in (None, 1, 1.0):
        return lambda count: base_lr
    steps = max(int(outer_steps), 1)
    rate = 1.0 / float(decay_factor)

    def schedule(count):
        if isinstance(count, torch.Tensor):
            return base_lr * torch.pow(rate, count.to(torch.float32) / steps)
        return base_lr * math.pow(rate, count / steps)

    return schedule


@dataclass(frozen=True)
class Optimizer:
    """Hyperparameters of the chain; the state lives with the caller."""

    labels: Any  # tree of group names, the parameters' structure
    schedules: Dict[str, Schedule]
    grad_clip: Optional[float] = 1.0
    guard_nonfinite: bool = False
    name: str = "adam"  # "adam" | "adamw" | "sgd"

    @property
    def has_moments(self) -> bool:
        return self.name != "sgd"

    def init(self, params: Any) -> Dict[str, Any]:
        dev = tree_leaves(params)[0].device
        zero = lambda dtype: torch.zeros((), dtype=dtype, device=dev)
        state = {"count": zero(torch.int32)}
        if self.has_moments:
            state.update(mu=tree_map(torch.zeros_like, params),
                         nu=tree_map(torch.zeros_like, params))
        if self.guard_nonfinite:
            state.update(notfinite_count=zero(torch.int32),
                         last_finite=~zero(torch.bool),
                         total_notfinite=zero(torch.int32))
        return state

    @torch.no_grad()
    def update(self, grads: Any, state: Dict[str, Any],
               params: Any = None, mesh=None) -> Tuple[Any, Dict[str, Any]]:
        """(updates to add to the parameters, new state). No input is
        changed. AdamW needs ``params`` (its decayed weights). Over a
        ``mesh`` (``grads["experts"]`` this rank's shard) the clip's norm and
        the finite flag are the whole mesh's, so every rank clips, skips and
        counts alike."""
        if self.name == "adamw" and params is None:
            raise ValueError("adamw's update needs the parameters")
        new = {}
        apply = None
        if self.guard_nonfinite:
            finite = all_finite(grads, mesh)
            nf = torch.where(finite, 0, state["notfinite_count"] + 1)
            apply = finite | (nf > MAX_CONSECUTIVE_ERRORS)
            new.update(notfinite_count=nf.to(torch.int32), last_finite=finite,
                       total_notfinite=(state["total_notfinite"]
                                        + (~finite).to(torch.int32)))
        if self.grad_clip is not None:
            max_norm = float(self.grad_clip)
            norm = torch.sqrt(tree_sq_norm(grads, mesh))
            keep = norm < max_norm
            grads = tree_map(
                lambda g: torch.where(keep, g, (g / norm) * max_norm), grads)

        count = state["count"]
        count_inc = count + 1
        lrs = {g: s(count) for g, s in self.schedules.items()}
        if self.has_moments:
            bc1 = 1.0 - torch.pow(B1, count_inc.to(torch.float32))
            bc2 = 1.0 - torch.pow(B2, count_inc.to(torch.float32))
            mu = tree_map(lambda g, m: (1.0 - B1) * g + B1 * m,
                          grads, state["mu"])
            nu = tree_map(lambda g, v: (1.0 - B2) * (g * g) + B2 * v,
                          grads, state["nu"])
            steps = tree_map(lambda m, v: (m / bc1) / (torch.sqrt(v / bc2) + EPS),
                             mu, nu)
            if self.name == "adamw":
                steps = tree_map(lambda u, p: u + WEIGHT_DECAY * p, steps, params)
        else:
            steps = grads
        updates = tree_map(lambda u, label: -lrs[label] * u, steps, self.labels)
        if apply is not None:
            updates = tree_map(lambda u: torch.where(apply, u, 0.0), updates)
            if self.has_moments:
                mu = tree_map(lambda a, b: torch.where(apply, a, b), mu, state["mu"])
                nu = tree_map(lambda a, b: torch.where(apply, a, b), nu, state["nu"])
            count_inc = torch.where(apply, count_inc, count)
        new["count"] = count_inc
        if self.has_moments:
            new.update(mu=mu, nu=nu)
        return updates, new


@torch.no_grad()
def apply_updates(params: Any, updates: Any) -> Any:
    """p ← p + u, in place on the parameters; returns them."""
    tree_map(lambda p, u: p.add_(u), params, updates)
    return params


def build_optimizer(P, group_labels: Any,
                    grad_clip: Optional[float] = 1.0) -> Optimizer:
    """Per-group Adam, AdamW or SGD (``P.optimizer``) with global-norm
    clipping and, with ``P.guard_nonfinite``, the non-finite guard.
    ``group_labels`` is ``container.param_group_labels(params)``."""
    name = str(P.optimizer).lower()
    if name not in OPTIMIZERS:
        raise ValueError(f"Unsupported optimizer {P.optimizer!r}")
    lrs = {"encoding": P.encoding_lr, "sigma": P.sigma_lr,
           "color": P.color_lr, "background": P.bg_lr}
    enabled = not getattr(P, "no_scheduler", False)
    return Optimizer(
        labels=group_labels,
        schedules={g: exponential_schedule(lr, P.outer_steps, P.decay_factor,
                                           enabled) for g, lr in lrs.items()},
        grad_clip=None if grad_clip is None else float(grad_clip),
        guard_nonfinite=bool(getattr(P, "guard_nonfinite", False)),
        name=name,
    )


def current_group_lrs(P, step: int) -> Dict[str, float]:
    """Group LRs at a step, for logging."""
    enabled = not getattr(P, "no_scheduler", False)
    return {g: float(exponential_schedule(lr, P.outer_steps, P.decay_factor,
                                          enabled)(step))
            for g, lr in (("encoding", P.encoding_lr), ("sigma", P.sigma_lr),
                          ("color", P.color_lr), ("background", P.bg_lr))}
