"""The in-RAM ray store that the episodic samplers and the eval read.

Port of ``acn_tpu/data/ram_rays.py``: for every image, all its pixel rays
against the (expert or global) scene box, the cluster mask, Mega-NeRF
validation balancing and the near/far clamp, kept as flat numpy arrays
``rays (N, 8)`` = [o d near far], ``rgbs (N, 3)`` float32 in [0, 1] and
``img_indices (N,)`` int32, with ``num_images``, ``len`` and a uniform
``sample``. ``from_arrays`` builds a store from arrays.

The images fan out over a process pool made with ``spawn``: by the time
datasets are built the caller has started CUDA (the model is already on
the card), and a fork after that is unsafe. The workers run the top-level
``process_single_image`` and never touch CUDA.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

from acn_tpu_torch.data.image_metadata import ImageMetadata
from acn_tpu_torch.data.ray_prep import (
    clamp_rays_near_far_np,
    get_ray_directions_np,
    get_rays_np,
)


def apply_meganerf_val_balancing(
    keep_mask: np.ndarray, H: int, W: int, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    """Mega-NeRF validation balancing: discard the right half of the image
    and re-add as many formerly unmasked pixels of the left half, so that
    the kept count stays the same."""
    rng = rng or np.random.default_rng(0)
    keep_mask = keep_mask.reshape(H, W).copy()
    left = keep_mask[:, : W // 2]
    right = keep_mask[:, W // 2 :]
    discard_pos = int(right.sum())
    if discard_pos > 0:
        candidates = np.arange(H * W).reshape(H, W)[:, : W // 2]
        not_kept_left = candidates[~left]
        if not_kept_left.size > 0:
            to_add = rng.permutation(not_kept_left)[:discard_pos]
            flat = keep_mask.reshape(-1)
            flat[to_add] = True
            keep_mask = flat.reshape(H, W)
    keep_mask[:, W // 2 :] = False
    return keep_mask.reshape(-1)


def process_single_image(
    md: Optional[ImageMetadata],
    center_pixels: bool,
    val_balancing: bool,
    aabb: Optional[np.ndarray],
    near_far_override,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """One image → (rgbs (M, 3) float32 in [0, 1], rays (M, 8), image
    indices (M,) int32), or None when it keeps no ray."""
    if md is None:
        return None
    img = md.load_image()
    if img is None:
        return None

    keep_mask = md.load_mask()
    if md.is_val and val_balancing:
        if keep_mask is None:
            keep_mask = np.ones((md.H, md.W), bool)
        keep_mask = apply_meganerf_val_balancing(
            keep_mask, md.H, md.W, np.random.default_rng(md.image_index)
        ).reshape(md.H, md.W)

    if keep_mask is not None and keep_mask.sum() == 0:
        return None

    fx, fy, cx, cy = [float(v) for v in md.intrinsics[:4]]
    dirs = get_ray_directions_np(md.H, md.W, fx, fy, cx, cy, center_pixels)
    rays = get_rays_np(dirs, md.c2w, aabb=aabb).reshape(-1, 8)
    img = img.reshape(-1, 3)

    if keep_mask is not None:
        flat_mask = keep_mask.reshape(-1)
        rays = rays[flat_mask]
        img = img[flat_mask]

    rays, valid = clamp_rays_near_far_np(rays, near_far_override)
    if not valid.any():
        return None
    rays = rays[valid]
    rgbs = img[valid].astype(np.float32) / 255.0
    indices = np.full((len(rgbs),), md.image_index, np.int32)
    return rgbs, rays, indices


class RamRaysDataset:
    """Flat ray store; indexable and samplable."""

    def __init__(
        self,
        metadata_items: List[ImageMetadata],
        center_pixels: bool = True,
        val_balancing: bool = False,
        aabb: Optional[np.ndarray] = None,
        near_far_override=None,
        num_workers: Optional[int] = None,
    ):
        cpu_count = os.cpu_count() or 1
        if num_workers is None:
            num_workers = min(8, max(1, cpu_count // 2))
        args = (center_pixels, val_balancing, aabb, near_far_override)

        if len(metadata_items) > 8 and num_workers > 1:
            ctx = multiprocessing.get_context("spawn")
            with ProcessPoolExecutor(max_workers=num_workers, mp_context=ctx) as ex:
                results = list(ex.map(
                    process_single_image, metadata_items,
                    *[[a] * len(metadata_items) for a in args], chunksize=8))
        else:
            results = [process_single_image(md, *args) for md in metadata_items]
        results = [r for r in results if r is not None]

        if not results:
            self.rgbs = np.zeros((0, 3), np.float32)
            self.rays = np.zeros((0, 8), np.float32)
            self.img_indices = np.zeros((0,), np.int32)
            self.num_images = 0
        else:
            self.rgbs = np.concatenate([r[0] for r in results])
            self.rays = np.concatenate([r[1] for r in results])
            self.img_indices = np.concatenate([r[2] for r in results])
            self.num_images = len(results)

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
