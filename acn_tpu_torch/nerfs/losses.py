"""Losses and image metrics.

Port of ``acn_tpu/nerfs/losses.py``: color-space-aligned MSE and PSNR.
``ssim`` comes with the online stage.
"""

from __future__ import annotations

import torch

from acn_tpu_torch.nerfs.color import color_space_transformer


def mse(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2)


def aligned_mse_loss(pred_linear: torch.Tensor, gt_srgb: torch.Tensor,
                     color_space: str = "linear") -> torch.Tensor:
    """Color-space-aligned MSE."""
    pred, gt = color_space_transformer(pred_linear, gt_srgb, color_space)
    return mse(pred, gt)


def psnr_from_mse(mse_val: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """PSNR = −10 log10(mse)."""
    return -10.0 * torch.log10(torch.clamp(mse_val, min=eps))


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return psnr_from_mse(mse(pred, gt))
