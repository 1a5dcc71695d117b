"""Minimal functional NN primitives over parameter dicts.

Port of ``acn_tpu/models/nn.py``. A Linear layer is a dict ``{"w", "b"}``
with the weight stored ``(in_dim, out_dim)`` and applied as ``y = x @ w + b``
— the JAX layout, not ``torch.nn.Linear``'s ``(out, in)`` — so weights carry
across from the JAX package unchanged. Initialization matches torch
``nn.Linear`` defaults: U(−1/√fan_in, 1/√fan_in) for weight and bias.

A parameter tree is nested dicts and lists with tensors at the leaves (the
JAX pytree, spelled out); ``tree_map`` / ``tree_leaves`` walk it in the
order of its keys.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

Params = Dict[str, torch.Tensor]


def _uniform(shape, bound: float, generator: Optional[torch.Generator],
             device=None, dtype=torch.float32) -> torch.Tensor:
    """U(−bound, bound), drawn on the generator's device and moved."""
    gen_dev = generator.device if generator is not None else "cpu"
    u = torch.rand(shape, generator=generator, dtype=dtype, device=gen_dev)
    return ((u * 2.0 - 1.0) * bound).to(device)


def init_linear(
    in_dim: int,
    out_dim: int,
    *,
    generator: Optional[torch.Generator] = None,
    bias: bool = True,
    device=None,
    dtype=torch.float32,
) -> Params:
    """torch-default Linear init, weight stored (in_dim, out_dim)."""
    bound = 1.0 / math.sqrt(in_dim)
    p = {"w": _uniform((in_dim, out_dim), bound, generator, device, dtype)}
    if bias:
        p["b"] = _uniform((out_dim,), bound, generator, device, dtype)
    return p


def apply_linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "none": lambda x: x,
    "identity": lambda x: x,
}


def init_mlp(
    dims: Sequence[int],
    *,
    generator: Optional[torch.Generator] = None,
    device=None,
    dtype=torch.float32,
) -> List[Params]:
    """A stack of Linear layers with the given dims chain."""
    return [
        init_linear(dims[i], dims[i + 1], generator=generator, device=device,
                    dtype=dtype)
        for i in range(len(dims) - 1)
    ]


def apply_mlp(
    layers: Sequence[Params],
    x: torch.Tensor,
    activation: str = "relu",
    final_activation: str = "none",
) -> torch.Tensor:
    act = _ACTIVATIONS[activation]
    final = _ACTIVATIONS[final_activation]
    n = len(layers)
    for i, p in enumerate(layers):
        x = apply_linear(p, x)
        x = final(x) if i == n - 1 else act(x)
    return x


def norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over a last axis of length 3, keepdim, summed in a
    fixed order (x² + y²) + z². Ray directions feed sample positions and so
    the discrete occupancy and hash cells: writing the sum out keeps it the
    same on the CPU and the card, where a library reduction may not be."""
    x, y, z = v[..., 0:1], v[..., 1:2], v[..., 2:3]
    return torch.sqrt(x * x + y * y + z * z)


# ============================ parameter trees ============================


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and of ``rest``, trees of the same
    structure), keeping dicts and lists. A leaf is whatever is neither."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves in ``tree_map``'s order."""
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in tree_leaves(v)]
    return [tree]


def tree_cast(params: Any, dtype: torch.dtype) -> Any:
    """Cast every floating leaf of a parameter tree (differentiable: the
    gradient comes back in the leaf's own dtype)."""
    return tree_map(
        lambda x: x.to(dtype) if x.is_floating_point() else x, params)


class _ClipHalfTies(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.bounds
        share = None  # 1 inside, 0.5 on a bound, 0 outside
        if lo is not None:
            share = ((x > lo).to(g.dtype) + (x >= lo).to(g.dtype)) * 0.5
        if hi is not None:
            below = ((x < hi).to(g.dtype) + (x <= hi).to(g.dtype)) * 0.5
            share = below if share is None else share * below
        return (g if share is None else g * share), None, None


def clip_half_ties(x: torch.Tensor, lo: Optional[float] = None,
                   hi: Optional[float] = None) -> torch.Tensor:
    """``clamp(x, lo, hi)`` with the gradient of ``jnp.clip`` /
    ``jnp.maximum``: 1 inside, 0 outside and **0.5 where x equals a bound**
    (``torch.clamp`` passes 1 there). A tie is a real value where a ray hits
    nothing over a white or black background (rgb exactly 1.0 or 0.0)."""
    return _ClipHalfTies.apply(x, lo, hi)
