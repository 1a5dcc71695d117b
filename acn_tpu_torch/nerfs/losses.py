"""Losses and image metrics.

Port of ``acn_tpu/nerfs/losses.py``: color-space-aligned MSE, PSNR and
single-scale SSIM.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


def ssim(img0: torch.Tensor, img1: torch.Tensor, max_val: float = 1.0,
         filter_size: int = 11, filter_sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    """Single-scale SSIM of two (H, W, C) images in [0, max_val], with a
    Gaussian window (Wang et al. 2004), as a 0-dim float32 tensor.

    The blur is separable: two ``F.conv2d`` passes (over H, then W) with
    VALID padding, the channels as the batch. It must accumulate in float32:
    with fewer mantissa bits the E[x²] − μ² variances lose their sign past
    the c2 stabilizer and SSIM leaves [-1, 1] on a near-constant image. On
    the card that means cuDNN's TF32 off, as ``resolve_device`` sets it."""
    hw = filter_size // 2
    offsets = torch.arange(-hw, hw + 1, dtype=torch.float32, device=img0.device)
    g = torch.exp(-0.5 * (offsets / filter_sigma) ** 2)
    g = g / torch.sum(g)

    def filt(img):
        x = img.to(torch.float32).permute(2, 0, 1)[:, None]  # (C, 1, H, W)
        x = F.conv2d(x, g.view(1, 1, -1, 1))
        x = F.conv2d(x, g.view(1, 1, 1, -1))
        return x[:, 0].permute(1, 2, 0)

    mu0 = filt(img0)
    mu1 = filt(img1)
    s00 = filt(img0 * img0) - mu0 * mu0
    s11 = filt(img1 * img1) - mu1 * mu1
    s01 = filt(img0 * img1) - mu0 * mu1
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    num = (2 * mu0 * mu1 + c1) * (2 * s01 + c2)
    den = (mu0 ** 2 + mu1 ** 2 + c1) * (s00 + s11 + c2)
    return torch.mean(num / den)
