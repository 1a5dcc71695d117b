"""The in-RAM ray store that the episodic samplers read.

Port of ``acn_tpu/data/ram_rays.py``'s ``RamRaysDataset``: flat numpy
arrays ``rays (N, 8)`` = [o d near far], ``rgbs (N, 3)`` in [0, 1] and
``img_indices (N,)``, with ``num_images``, ``len`` and a uniform ``sample``.
It is built from arrays (``from_arrays``), as ``acn_tpu`` rebuilds a cached
store. Building it from images (decoding, masks, validation balancing)
needs PIL and the ray preparation of ``acn_tpu/data``, which are not ported
(ROADMAP.md M6).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class RamRaysDataset:
    """Flat ray store; indexable and samplable."""

    def __init__(self, metadata_items=None, *args, **kwargs):
        raise NotImplementedError(
            "building a ray store from images (PIL decoding, masks, "
            "validation balancing) is not ported: ROADMAP.md M6; use "
            "RamRaysDataset.from_arrays")

    @classmethod
    def from_arrays(cls, rays: np.ndarray, rgbs: np.ndarray, img_indices: np.ndarray,
                    num_images: Optional[int] = None) -> "RamRaysDataset":
        ds = cls.__new__(cls)
        ds.rays = np.asarray(rays, np.float32)
        ds.rgbs = np.asarray(rgbs, np.float32)
        ds.img_indices = np.asarray(img_indices, np.int32)
        if not len(ds.rays) == len(ds.rgbs) == len(ds.img_indices):
            raise ValueError(f"rays {ds.rays.shape}, rgbs {ds.rgbs.shape} and image "
                             f"indices {ds.img_indices.shape} differ in length")
        ds.num_images = (int(num_images) if num_images is not None
                         else len(np.unique(ds.img_indices)))
        return ds

    def __len__(self) -> int:
        return len(self.rgbs)

    def sample(self, rng: np.random.Generator, n: int):
        """Uniform ray batch, without replacement when the store allows."""
        if len(self) == 0:
            raise ValueError("empty RamRaysDataset")
        idx = rng.choice(len(self), size=n, replace=n > len(self))
        return self.rays[idx], self.rgbs[idx], self.img_indices[idx]
