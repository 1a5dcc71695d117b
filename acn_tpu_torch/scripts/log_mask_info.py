"""Cluster-mask audit: per-cell coverage and exclusivity.

    python -m acn_tpu_torch.scripts.log_mask_info --mask_dir <data>/masks/<name>
        [--expect_exclusive] [--max_images N]

Port of ``acn_tpu/scripts/log_mask_info.py``, copied (host numpy and
torch I/O; the same text): for a mask directory, per-cell pixel coverage,
images with pixels, the overlap share, and with ``--expect_exclusive`` a
check that strict-Voronoi masks never overlap (exit 1 when they do).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="Audit cluster masks")
    p.add_argument("--mask_dir", type=Path, required=True)
    p.add_argument("--expect_exclusive", action="store_true")
    p.add_argument("--max_images", type=int, default=None)
    return p


def load_mask(path: Path) -> np.ndarray:
    """A plain or zipped ``torch.save`` of a mask, as a bool array."""
    from zipfile import ZipFile

    import torch

    try:
        m = torch.load(path, map_location="cpu", weights_only=False)
    except Exception:
        with ZipFile(path) as zf:
            with zf.open(zf.namelist()[0]) as f:
                m = torch.load(f, map_location="cpu", weights_only=False)
    return np.asarray(m).astype(bool)


def main(h=None):
    if h is None:
        h = build_parser().parse_args()
    mask_dir = Path(h.mask_dir)
    cells = sorted(
        int(d.name) for d in mask_dir.iterdir() if d.is_dir() and d.name.isdigit()
    )
    assert cells, f"no cell subdirs under {mask_dir}"
    names = sorted(p.name for p in (mask_dir / str(cells[0])).glob("*.pt"))
    if h.max_images:
        names = names[: h.max_images]

    K = len(cells)
    pix = np.zeros(K, np.int64)
    imgs = np.zeros(K, np.int64)
    overlap_pix = 0
    assigned_pix = 0
    total = 0
    violations = 0
    for name in names:
        stack = []
        for c in cells:
            p = mask_dir / str(c) / name
            stack.append(load_mask(p) if p.exists() else None)
        shapes = {m.shape for m in stack if m is not None}
        assert len(shapes) <= 1, f"inconsistent mask shapes for {name}: {shapes}"
        ms = np.stack([m if m is not None else np.zeros(next(iter(shapes)), bool)
                       for m in stack])
        counts = ms.sum(axis=(1, 2))
        pix += counts
        imgs += counts > 0
        per_pix = ms.sum(axis=0)
        overlap_pix += int((per_pix > 1).sum())
        assigned_pix += int((per_pix > 0).sum())
        total += per_pix.size
        if h.expect_exclusive and (per_pix > 1).any():
            violations += 1
            print(f"[VIOLATION] {name}: {(per_pix > 1).sum()} overlapping pixels")

    print(f"cells: {K}; images: {len(names)}; total pixels: {total:,}")
    print(f"pixels per cell: {pix.tolist()}")
    print(f"coverage % per cell: {[round(float(x), 3) for x in pix / total * 100]}")
    print(f"images with pixels per cell: {imgs.tolist()}")
    print(
        f"assigned {assigned_pix / total * 100:.2f}% of pixels; "
        f"overlap {overlap_pix / max(assigned_pix, 1) * 100:.2f}% of assigned"
    )
    if h.expect_exclusive:
        print(f"exclusivity violations: {violations} images")
        if violations:
            raise SystemExit(1)


if __name__ == "__main__":
    main()
