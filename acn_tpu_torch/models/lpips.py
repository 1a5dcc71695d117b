"""LPIPS perceptual metric: AlexNet-LPIPS as an ``nn.Module``.

Port of ``acn_tpu/models/lpips.py``. AlexNet's conv features at its five
ReLU taps (64/192/384/256/256 channels, kernels 11/5/3/3/3, strides
4/1/1/1/1, pads 2/2/1/1/1, a 3 × 3 stride-2 max-pool after taps 0 and 1),
each unit-normalized over channels; the squared difference, weighted per
channel by a linear head, averaged over space and summed over the taps; on
inputs scaled to [-1, 1] and shifted and scaled as ``lpips.ScalingLayer``.

Weights: an ``.npz`` of the official AlexNet-LPIPS parameters in
``acn_tpu``'s layout (``conv{i}_w`` OIHW, ``conv{i}_b``, ``lin{i}_w``) at
``weights_path`` (default ``~/.cache/acn_tpu/lpips_alex.npz``, the file
``acn_tpu`` reads); else the deterministic fallback ``_rand_params`` (He
init from numpy's ``default_rng(0)``, the same arrays as ``acn_tpu``'s
fallback), whose scores are not comparable to official LPIPS. The eval
reports LPIPS only with pretrained weights.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from acn_tpu_torch.pipelines.renderer import resolve_device

# (out_ch, in_ch, kernel, stride, pad) per conv; max-pool(3, 2) after convs 0, 1
_ALEX_CONVS = [
    (64, 3, 11, 4, 2),
    (192, 64, 5, 1, 2),
    (384, 192, 3, 1, 1),
    (256, 384, 3, 1, 1),
    (256, 256, 3, 1, 1),
]
_POOL_AFTER = {0, 1}
# lpips.ScalingLayer's shift and scale of inputs in [-1, 1]
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)
DEFAULT_WEIGHTS = Path.home() / ".cache" / "acn_tpu" / "lpips_alex.npz"


def _rand_params(seed: int = 0) -> Dict[str, np.ndarray]:
    """The deterministic He-init fallback, drawn as ``acn_tpu`` draws it."""
    rng = np.random.default_rng(seed)
    params: Dict[str, np.ndarray] = {}
    for i, (oc, ic, k, _, _) in enumerate(_ALEX_CONVS):
        std = float(np.sqrt(2.0 / (ic * k * k)))
        params[f"conv{i}_w"] = rng.normal(0.0, std, (oc, ic, k, k)).astype(np.float32)
        params[f"conv{i}_b"] = np.zeros((oc,), np.float32)
        params[f"lin{i}_w"] = np.full((oc,), 1.0 / oc, np.float32)
    return params


def load_params(weights_path=DEFAULT_WEIGHTS) -> Tuple[Dict[str, np.ndarray], bool]:
    """(parameters, pretrained?): the ``.npz`` at ``weights_path`` if it is
    a file, else the fallback."""
    path = Path(weights_path) if weights_path is not None else None
    if path is not None and path.is_file():
        with np.load(path) as z:
            return {k: z[k] for k in z.files}, True
    return _rand_params(), False


class AlexLPIPS(nn.Module):
    """LPIPS(x, y) of NCHW images in [-1, 1], (N,) distances."""

    def __init__(self, params: Dict[str, np.ndarray], pretrained: bool):
        super().__init__()
        self.pretrained = bool(pretrained)
        for name, value in params.items():
            self.register_buffer(name, torch.from_numpy(np.asarray(value, np.float32)))
        self.register_buffer("shift", torch.from_numpy(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.from_numpy(_SCALE).view(1, 3, 1, 1))

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        h = x
        for i, (_, _, _, stride, pad) in enumerate(_ALEX_CONVS):
            bias: Optional[torch.Tensor] = getattr(self, f"conv{i}_b", None)
            h = F.relu(F.conv2d(h, getattr(self, f"conv{i}_w"), bias, stride, pad))
            feats.append(h)
            if i in _POOL_AFTER:
                h = F.max_pool2d(h, 3, 2)
        return feats

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        fx = self.features((x - self.shift) / self.scale)
        fy = self.features((y - self.shift) / self.scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            na = a / (torch.sqrt(torch.sum(a * a, dim=1, keepdim=True)) + 1e-10)
            nb = b / (torch.sqrt(torch.sum(b * b, dim=1, keepdim=True)) + 1e-10)
            w = getattr(self, f"lin{i}_w")
            lv = torch.sum((na - nb) ** 2 * w[None, :, None, None], dim=1)
            total = total + torch.mean(lv, dim=(1, 2))
        return total


class LPIPS:
    """Scores two (H, W, 3) float sRGB images in [0, 1] on ``device``
    (``None``: the card)."""

    def __init__(self, weights_path=DEFAULT_WEIGHTS, device=None):
        self.device = resolve_device(device)
        params, pretrained = load_params(weights_path)
        self.net = AlexLPIPS(params, pretrained).to(self.device).eval()
        self.pretrained = pretrained
        self.name = "lpips" if pretrained else "lpips(rand-alex)"

    def _nchw(self, img) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(img, np.float32), device=self.device)
        return t.permute(2, 0, 1)[None] * 2.0 - 1.0

    @torch.no_grad()
    def __call__(self, pred, gt) -> float:
        return float(self.net(self._nchw(pred), self._nchw(gt))[0])
