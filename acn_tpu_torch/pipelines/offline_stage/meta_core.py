"""Meta-learning inner and outer loops: FoMAML, MAML and Reptile.

Port of ``acn_tpu/pipelines/offline_stage/meta_core.py``. Fast weights are a
parameter tree, one inner step is ``p ← p − lr·∇loss(p)``, and the loop is a
plain Python loop (a ``lax.scan`` there). The loss gets the inner
iteration's index ``i`` where JAX passes that iteration's key; the caller
takes that iteration's draws from it (the query loss is asked at
``i = iterations``).

* **First order** (FoMAML, Reptile): the inner gradients are constants to
  the outer gradient, so the loop runs ``torch.autograd.grad`` on a
  **detached copy** of the parameters and frees each iteration's graph
  before the next; the update is in place (``sgd_tree``).
* **Second order** (MAML): the updates are out of place, ``p − lr·g`` with
  ``g`` from ``create_graph=True``, starting from ``params`` itself, so the
  outer gradient differentiates through every inner step (each step's
  backward is differentiated again: for the packed-budget loss that is the
  scan's double backward, ``ops/segscan.SegExclRSum``). JAX rematerializes
  each inner step (``remat=True``) to bound memory; here every step's graph
  is kept until the outer backward, which fits the card at full width (the
  peak is in PERF.md).
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from acn_tpu_torch.models.nn import tree_leaves, tree_map

Params = Any
# loss_fn(params, batch, i) -> 0-dim tensor; i is the inner iteration, where
# JAX passes that iteration's key
LossFn = Callable[[Params, Any, int], torch.Tensor]

ALGOS = ("maml", "fomaml", "reptile")


def sgd_tree(params: Params, grads: Params, lr: float) -> Params:
    """Fast-weight update w ← w − lr·g, **in place** on both trees and
    outside autograd: ``grads`` becomes lr·g and ``params`` the new weights
    (returned). The tables are hundreds of megabytes per expert, and the
    caller owns both trees (``task_adapt``'s detached copy and the fresh
    gradient), so no third copy is made."""
    with torch.no_grad():
        tree_map(lambda w, g: w.sub_(g.mul_(lr)), params, grads)
    return params


def _stack_losses(losses, like: torch.Tensor) -> torch.Tensor:
    return torch.stack(losses) if losses else torch.zeros(0, device=like.device)


def task_adapt(
    loss_fn: LossFn,
    params: Params,
    support: Any,
    inner_lr: float,
    iterations: int,
    first_order: bool = True,
) -> Tuple[Params, torch.Tensor]:
    """Inner adaptation loop: ``iterations`` SGD steps on the support loss.

    Returns (fast_params, inner_losses (iterations,)). First order: from a
    detached copy of ``params``; the fast weights are leaves that require
    grad, ready for the query loss's gradient. Second order: from
    ``params`` itself; the fast weights are functions of ``params`` (and of
    whatever else the support loss differentiably reads), through every
    inner step and its gradient."""
    if first_order:
        fast = tree_map(lambda p: p.detach().clone().requires_grad_(True), params)
        leaves = tree_leaves(fast)
        losses = []
        for i in range(iterations):
            loss = loss_fn(fast, support, i)
            grads = torch.autograd.grad(loss, leaves)
            sgd_tree(leaves, list(grads), inner_lr)
            losses.append(loss.detach())
        return fast, _stack_losses(losses, leaves[0])
    fast = params
    losses = []
    for i in range(iterations):
        loss = loss_fn(fast, support, i)
        grads = iter(torch.autograd.grad(loss, tree_leaves(fast), create_graph=True))
        fast = tree_map(lambda w: w - inner_lr * next(grads), fast)
        losses.append(loss.detach())
    return fast, _stack_losses(losses, tree_leaves(params)[0])


def fomaml_outer_loss(support_loss_fn: LossFn, query_loss_fn: LossFn, params: Params,
                      support: Any, query: Any, inner_lr: float,
                      iterations: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Query loss after first-order adaptation; its gradient in ``params``
    is the FoMAML meta-gradient, ∇_fast L_q (d fast / dθ = I). The fast
    weights keep their values and take θ's gradient path:
    ``fast.detach() + (θ − θ.detach())``."""
    fast, inner_losses = task_adapt(support_loss_fn, params, support, inner_lr,
                                    iterations, first_order=True)
    fast = tree_map(lambda f, p: f.detach() + (p - p.detach()), fast, params)
    return query_loss_fn(fast, query, iterations), inner_losses


def maml_outer_loss(support_loss_fn: LossFn, query_loss_fn: LossFn, params: Params,
                    support: Any, query: Any, inner_lr: float,
                    iterations: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Second-order MAML: the query loss at weights adapted through
    differentiable inner updates; its gradient flows through them."""
    fast, inner_losses = task_adapt(support_loss_fn, params, support, inner_lr,
                                    iterations, first_order=False)
    return query_loss_fn(fast, query, iterations), inner_losses


def reptile_adapt(support_loss_fn: LossFn, params: Params, support: Any,
                  inner_lr: float, iterations: int) -> Tuple[Params, torch.Tensor]:
    """Reptile's inner run: plain first-order adaptation from a detached
    copy."""
    return task_adapt(support_loss_fn, params, support, inner_lr, iterations,
                      first_order=True)


def reptile_meta_delta(params: Params, fast_batch: Params) -> Params:
    """Δ̄ = mean_i(W_i − θ) over a leading task axis of ``fast_batch``,
    non-finite entries zeroed."""
    def leaf_delta(theta, fast):
        d = torch.mean(fast - theta[None], dim=0)
        return torch.where(torch.isfinite(d), d, 0.0)

    return tree_map(leaf_delta, params, fast_batch)


def global_grad_norm(grads: Params, mesh=None) -> torch.Tensor:
    """√Σ g² over every leaf, a 0-dim tensor (no host sync); over a
    ``mesh`` (the experts sharded) the norm of the whole mesh's gradient."""
    from acn_tpu_torch.parallel.mesh import tree_sq_norm

    return torch.sqrt(tree_sq_norm(grads, mesh))


def outer_loss_fn_for(algo: str):
    algo = algo.lower()
    if algo == "fomaml":
        return fomaml_outer_loss
    if algo == "maml":
        return maml_outer_loss
    raise ValueError(f"No outer loss for algo {algo!r} (reptile has no outer loss)")
