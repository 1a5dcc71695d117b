"""Truncated exponential activation with a dtype-safe gradient.

Port of ``acn_tpu/models/trunc_exp.py``: forward and backward both use the
*clamped* input, so the gradient never overflows in reduced precision.
"""

from __future__ import annotations

import torch

from acn_tpu_torch.models.nn import clip_half_ties

# Strictly below log(dtype_max) so exp(clamp) is finite under any rounding.
_EXP_MAX = {
    torch.float16: 11.0,  # exp ~ 5.99e4 < 65504
    torch.bfloat16: 88.0,  # exp ~ 1.65e38 < 3.39e38
    torch.float32: 88.0,
    torch.float64: 709.0,
}


class _TruncExp(torch.autograd.Function):
    """Backward g·exp(clip(x)). Under a second derivative exp(clip(x)) is
    recomputed from the saved input by differentiable ops, so that it
    carries the clip's mask (and ``jnp.clip``'s half share at a bound), as
    JAX's derivative of ``_trunc_exp_bwd`` does
    (``acn_tpu/models/trunc_exp.py``); a backward that builds no graph
    takes the saved output, the same value."""

    @staticmethod
    def forward(ctx, x):
        m = _EXP_MAX.get(x.dtype, _EXP_MAX[torch.float32])
        y = torch.exp(torch.clamp(x, -m, m))
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        if not torch.is_grad_enabled():
            return g * y  # dy/dx = exp(clamp(x))
        m = _EXP_MAX.get(x.dtype, _EXP_MAX[torch.float32])
        return g * torch.exp(clip_half_ties(x, -m, m))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """exp(x) with input clamped to the dtype-safe range (fwd and bwd)."""
    return _TruncExp.apply(x)
