"""Colormaps for viewer visualization (depth / opacity / PCA features).

Port of ``acn_tpu/viewer/colormap.py``, unchanged: display-side numpy, with
matplotlib imported only for the turbo and viridis maps. As there
(nerfstudio-style):
``apply_colormap`` (gray/turbo/viridis/pca), ``apply_depth_colormap`` with
near/far normalization, ``apply_pca_colormap`` with outlier rejection.
Numpy-native (display-side code).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class ColormapOptions:
    colormap: str = "gray"  # "gray" | "turbo" | "viridis" | "pca" | "default"
    normalize: bool = True
    colormap_min: float = 0.0
    colormap_max: float = 1.0
    invert: bool = False


def _matplotlib_map(name: str, x: np.ndarray) -> np.ndarray:
    import matplotlib

    return np.asarray(matplotlib.colormaps[name](x))[..., :3]


def apply_colormap(
    image: np.ndarray,  # (..., 1) or (..., C)
    options: ColormapOptions = ColormapOptions(),
) -> np.ndarray:
    """Scalar → RGB (reference colormap.py:34-60)."""
    cmap = options.colormap
    if image.shape[-1] == 3 and cmap in ("default", "gray"):
        return np.clip(image, 0, 1)
    if image.shape[-1] > 1 or cmap == "pca":
        return apply_pca_colormap(image)

    x = image[..., 0].astype(np.float64)
    if options.normalize:
        lo, hi = np.nanmin(x), np.nanmax(x)
        x = (x - lo) / max(hi - lo, 1e-10)
    x = x * (options.colormap_max - options.colormap_min) + options.colormap_min
    x = np.clip(x, 0, 1)
    if options.invert:
        x = 1.0 - x
    if cmap in ("gray", "default"):
        return np.repeat(x[..., None], 3, axis=-1)
    return _matplotlib_map(cmap, x)


def apply_depth_colormap(
    depth: np.ndarray,  # (..., 1)
    accumulation: Optional[np.ndarray] = None,  # (..., 1)
    near_plane: Optional[float] = None,
    far_plane: Optional[float] = None,
    options: ColormapOptions = ColormapOptions(colormap="turbo"),
) -> np.ndarray:
    """Depth → RGB with near/far normalization and opacity modulation
    (reference colormap.py:63-124)."""
    near = near_plane if near_plane is not None else float(np.nanmin(depth))
    far = far_plane if far_plane is not None else float(np.nanmax(depth))
    x = (depth - near) / max(far - near, 1e-10)
    x = np.clip(x, 0, 1)
    rgb = apply_colormap(x, ColormapOptions(colormap=options.colormap,
                                            normalize=False))
    if accumulation is not None:
        rgb = rgb * np.clip(accumulation, 0, 1)
    return rgb


def apply_pca_colormap(image: np.ndarray, outlier_sigma: float = 2.5) -> np.ndarray:
    """High-dim features → RGB via PCA with robust outlier rejection
    (reference colormap.py:126-180)."""
    flat = image.reshape(-1, image.shape[-1]).astype(np.float64)
    flat = flat - flat.mean(axis=0, keepdims=True)
    # project onto top-3 principal directions
    _, _, vt = np.linalg.svd(flat, full_matrices=False)
    proj = flat @ vt[:3].T  # (N, 3)
    # robust normalization: clip outliers beyond k·MAD
    med = np.median(proj, axis=0, keepdims=True)
    mad = np.median(np.abs(proj - med), axis=0, keepdims=True) + 1e-10
    proj = np.clip(proj, med - outlier_sigma * 3 * mad, med + outlier_sigma * 3 * mad)
    lo = proj.min(axis=0, keepdims=True)
    hi = proj.max(axis=0, keepdims=True)
    rgb = (proj - lo) / np.maximum(hi - lo, 1e-10)
    return rgb.reshape(*image.shape[:-1], 3)
