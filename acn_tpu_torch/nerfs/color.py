"""sRGB ↔ linear color-space conversions.

Port of ``acn_tpu/nerfs/color.py``: the model predicts linear RGB, 8-bit
ground truth is sRGB, and exactly one side is converted so loss and metrics
compare in a single space.

The clips on the prediction use ``nn.clip_half_ties``: ``jnp.clip`` passes
half the gradient where the value equals a bound, ``torch.clamp`` all of it,
and a ray that hits nothing over a white background is exactly 1.0.
"""

from __future__ import annotations

from typing import Tuple

import torch

from acn_tpu_torch.models.nn import clip_half_ties


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    x = clip_half_ties(x, 0.0, 1.0)
    return torch.where(
        x <= 0.0031308,
        12.92 * x,
        1.055 * torch.pow(clip_half_ties(x, 1e-12), 1.0 / 2.4) - 0.055,
    )


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    return torch.where(
        x <= 0.04045,
        x / 12.92,
        torch.pow(clip_half_ties((x + 0.055) / 1.055, 1e-12), 2.4),
    )


def color_space_transformer(
    pred_linear: torch.Tensor, gt_srgb: torch.Tensor, color_space: str
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Put prediction (linear) and GT (sRGB) in one space.

    ``color_space``: "linear" | "srgb" | "identity".
    """
    cs = str(color_space).lower()
    pred32 = pred_linear.to(torch.float32)
    gt32 = torch.clamp(gt_srgb.to(torch.float32), 0.0, 1.0)

    if cs == "linear":
        pred = clip_half_ties(pred32, 0.0, 1.0)
        gt = torch.clamp(srgb_to_linear(gt32), 0.0, 1.0)
    elif cs == "srgb":
        pred = clip_half_ties(linear_to_srgb(pred32), 0.0, 1.0)
        gt = gt32
    elif cs == "identity":
        pred = pred32
        gt = gt32
    else:
        raise ValueError(
            f"Invalid color_space={color_space!r}; use 'linear'|'srgb'|'identity'")
    return pred.to(pred_linear.dtype), gt.to(pred_linear.dtype)
