"""Meta-learning inner loop, first order.

Port of ``acn_tpu/pipelines/offline_stage/meta_core.py`` for FoMAML: fast
weights are a parameter tree, one inner step is ``p ← p − lr·∇loss(p)``, and
the loop is a plain Python loop (a ``lax.scan`` there). First order means the
inner gradients are constants to the outer gradient, so the loop runs
``torch.autograd.grad`` on a **detached copy** of the parameters and frees
each iteration's graph before the next.

Second-order MAML, Reptile and the Fisher-preconditioned inner loop are not
ported; their entry points raise ``NotImplementedError`` naming ROADMAP M9.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from acn_tpu_torch.models.nn import tree_leaves, tree_map

Params = Any
# loss_fn(params, batch, i) -> 0-dim tensor; i is the inner iteration, where
# JAX passes that iteration's key
LossFn = Callable[[Params, Any, int], torch.Tensor]


def sgd_tree(params: Params, grads: Params, lr: float) -> Params:
    """Fast-weight update w ← w − lr·g, **in place** on both trees and
    outside autograd: ``grads`` becomes lr·g and ``params`` the new weights
    (returned). The tables are hundreds of megabytes per expert, and the
    caller owns both trees (``task_adapt``'s detached copy and the fresh
    gradient), so no third copy is made."""
    with torch.no_grad():
        tree_map(lambda w, g: w.sub_(g.mul_(lr)), params, grads)
    return params


def task_adapt(
    loss_fn: LossFn,
    params: Params,
    support: Any,
    inner_lr: float,
    iterations: int,
    first_order: bool = True,
) -> Tuple[Params, torch.Tensor]:
    """Inner adaptation loop: ``iterations`` SGD steps on the support loss
    from a detached copy of ``params``.

    Returns (fast_params, inner_losses (iterations,)). The fast weights are
    leaves that require grad, ready for the query loss's gradient. The JAX
    function splits a key per iteration; here the loss gets the iteration's
    index ``i``, from which the caller takes that iteration's draws (the
    stratified loss jitters anew in every step; the packed and strided
    losses read none: their samples are marched before the loop)."""
    if not first_order:
        raise NotImplementedError(
            "second-order task_adapt (maml) is not ported: ROADMAP.md M9")
    fast = tree_map(lambda p: p.detach().clone().requires_grad_(True), params)
    leaves = tree_leaves(fast)
    losses = []
    for i in range(iterations):
        loss = loss_fn(fast, support, i)
        grads = torch.autograd.grad(loss, leaves)
        sgd_tree(leaves, list(grads), inner_lr)
        losses.append(loss.detach())
    inner = (torch.stack(losses) if losses
             else torch.zeros(0, device=leaves[0].device))
    return fast, inner


def maml_outer_loss(*args, **kwargs):
    raise NotImplementedError(
        "maml_outer_loss (second-order MAML) is not ported: ROADMAP.md M9")


def reptile_adapt(*args, **kwargs):
    raise NotImplementedError(
        "reptile_adapt (Reptile) is not ported: ROADMAP.md M9")


def global_grad_norm(grads: Params) -> torch.Tensor:
    """√Σ g² over every leaf, a 0-dim tensor (no host sync)."""
    return torch.sqrt(sum(torch.sum(torch.square(g)) for g in tree_leaves(grads)))
