"""Viewer helpers: basis conversions, sanitizers, continual-batch validation.

Port of ``acn_tpu/viewer/utils.py`` (numpy; the batch's ``.pt`` metadata is
read with ``torch.load``, as there). As in ``acn_tpu``: RUB↔DRB rotations,
look-at pose builders, bg/module-selection sanitizers, sRGB uint8 conversion,
and ``verify_continual_batch_dir`` — structural validation of a continual
batch before the viewer will train on it (reference viewer/utils.py:126-247).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

# world DRB; viewer (viser) world is RUB-ish — 3×3 basis changes
# (reference viewer/utils.py:18-27)
RUB_TO_DRB = np.array(
    [
        [0.0, -1.0, 0.0],  # Down  <- -Up
        [1.0, 0.0, 0.0],  # Right <- Right
        [0.0, 0.0, 1.0],  # Back  <- Back
    ],
    dtype=np.float32,
)
DRB_TO_RUB = RUB_TO_DRB.T


def srgb_u8(img01: np.ndarray) -> np.ndarray:
    """[0,1] float → uint8 (reference viewer/utils.py:13-15)."""
    return (np.clip(img01, 0.0, 1.0) * 255).astype(np.uint8)


def sanitize_bg_policy(policy: str) -> str:
    p = str(policy).lower()
    return p if p in ("white", "black", "random", "none", "last_sample") else "white"


def sanitize_module_selection(value, num_modules: int) -> Optional[int]:
    """Dropdown value → active module index or None for 'all'
    (reference viewer/utils.py:30-49)."""
    if value in (None, "all", "All", -1, "-1"):
        return None
    try:
        idx = int(value)
    except (TypeError, ValueError):
        return None
    return idx if 0 <= idx < num_modules else None


def look_at_pose(cam_pos: np.ndarray, target: np.ndarray, up: np.ndarray) -> np.ndarray:
    """c2w (3,4) with RUB columns (reference viewer/utils.py:57-70)."""
    fwd = target - cam_pos
    fwd = fwd / max(np.linalg.norm(fwd), 1e-12)
    right = np.cross(fwd, up)
    right = right / max(np.linalg.norm(right), 1e-12)
    upv = np.cross(right, fwd)
    c2w = np.zeros((3, 4), np.float32)
    c2w[:, 0] = right
    c2w[:, 1] = upv
    c2w[:, 2] = -fwd
    c2w[:, 3] = cam_pos
    return c2w


def verify_continual_batch_dir(batch_dir, prepared_root=None) -> Tuple[bool, List[str]]:
    """Structural validation of a continual batch
    (reference viewer/utils.py:126-247): rgbs/metadata id-matching,
    coordinates.pt discovery up the tree, metadata schema spot-check.

    Returns (ok, messages)."""
    msgs: List[str] = []
    batch_dir = Path(batch_dir)
    rgbs = batch_dir / "rgbs"
    meta = batch_dir / "metadata"
    if not rgbs.is_dir() or not meta.is_dir():
        return False, [f"missing rgbs/ or metadata/ under {batch_dir}"]

    rgb_ids = {p.stem for p in rgbs.iterdir() if p.suffix.lower() in
               (".jpg", ".jpeg", ".png")}
    meta_ids = {p.stem for p in meta.iterdir() if p.suffix == ".pt"}
    if not meta_ids:
        return False, ["no metadata .pt files"]
    only_rgb = rgb_ids - meta_ids
    only_meta = meta_ids - rgb_ids
    if only_rgb:
        msgs.append(f"{len(only_rgb)} rgbs without metadata: {sorted(only_rgb)[:3]}…")
    if only_meta:
        msgs.append(f"{len(only_meta)} metadata without rgbs: {sorted(only_meta)[:3]}…")

    # find prepared root (has coordinates.pt) walking up
    root = prepared_root
    if root is None:
        cur = batch_dir
        for _ in range(4):
            if (cur / "coordinates.pt").exists():
                root = cur
                break
            cur = cur.parent
    if root is None:
        msgs.append("coordinates.pt not found above the batch dir")
        return False, msgs

    # spot-check one metadata file's schema
    import torch

    sample = sorted(meta.iterdir())[0]
    md = torch.load(sample, map_location="cpu", weights_only=False)
    for k in ("H", "W", "c2w", "intrinsics"):
        if k not in md:
            msgs.append(f"metadata {sample.name} missing key {k!r}")
            return False, msgs
    c2w = np.asarray(md["c2w"])
    if c2w.shape != (3, 4):
        msgs.append(f"metadata c2w shape {c2w.shape} != (3, 4)")
        return False, msgs
    if np.abs(c2w[:, 3]).max() > 1.5:
        msgs.append("normalized translation out of range (|t| > 1.5)")
        return False, msgs

    ok = not only_meta  # images must exist for every metadata entry
    msgs.append(f"verified {len(meta_ids)} views against {root}")
    return ok, msgs
