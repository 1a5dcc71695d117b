"""Fisher-information-weighted inner adaptation (``--fim``).

Port of ``acn_tpu/models/fim.py``: an EMA of squared gradients per parameter
leaf, F ← β·F + (1−β)·g², and inner SGD on the gradient blended with its
inverse-Fisher-preconditioned form, g' = (1−λ)·g + λ·g/(F + ε). The state is
a tree shaped like the parameters. The loop is first order, like
``meta_core.task_adapt``'s: a detached copy of the parameters is adapted in
place.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from acn_tpu_torch.models.nn import tree_leaves, tree_map

Params = Any


def fisher_init(params: Params) -> Params:
    return tree_map(lambda p: torch.zeros_like(p.detach()), params)


def fisher_update(fisher: Params, grads: Params, beta: float = 0.95) -> Params:
    """EMA of squared gradients."""
    return tree_map(lambda f, g: beta * f + (1.0 - beta) * torch.square(g), fisher, grads)


def fisher_scaled_grads(fisher: Params, grads: Params, lam: float = 0.1,
                        epsilon: float = 1e-6) -> Params:
    """g' = (1−λ)·g + λ·g/(F + ε)."""
    return tree_map(lambda f, g: (1.0 - lam) * g + lam * g / (f + epsilon), fisher, grads)


def fim_task_adapt(loss_fn, params: Params, fisher: Params, support, inner_lr: float,
                   iterations: int, beta: float = 0.95, lam: float = 0.1,
                   epsilon: float = 1e-6) -> Tuple[Params, Params, torch.Tensor]:
    """Inner loop with Fisher-preconditioned SGD and the Fisher EMA updated
    on each support gradient first. ``loss_fn(params, support, i)`` as in
    ``meta_core.task_adapt``. Returns (fast_params, fisher,
    inner_losses (iterations,))."""
    fast = tree_map(lambda p: p.detach().clone().requires_grad_(True), params)
    leaves = tree_leaves(fast)
    f_leaves = tree_leaves(fisher)
    losses = []
    for i in range(iterations):
        loss = loss_fn(fast, support, i)
        grads = torch.autograd.grad(loss, leaves)
        f_leaves = fisher_update(f_leaves, list(grads), beta)
        scaled = fisher_scaled_grads(f_leaves, list(grads), lam, epsilon)
        with torch.no_grad():
            for w, g in zip(leaves, scaled):
                w.sub_(inner_lr * g)
        losses.append(loss.detach())
    it = iter(f_leaves)
    fisher = tree_map(lambda _: next(it), fisher)
    inner = torch.stack(losses) if losses else torch.zeros(0, device=leaves[0].device)
    return fast, fisher, inner
