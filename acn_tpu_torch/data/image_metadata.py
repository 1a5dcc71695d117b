"""Per-image metadata records and lazy pixel and mask IO.

Port of ``acn_tpu/data/image_metadata.py``: a lazy record {path, c2w (3, 4),
W, H, intrinsics [fx fy cx cy], index, is_val, mask dir}, read from the
prepared dataset's ``.pt`` metadata files, with plain or zipped boolean
``.pt`` masks (nearest-resized when stored at another size).

Images: a PNG is decoded by the port's own codec (``data/png.py``). PIL is
imported only where it is needed: to decode a JPEG, and for the LANCZOS
resize when a file's size differs from the record's; without PIL those two
raise, naming it.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional
from zipfile import ZipFile

import numpy as np

from acn_tpu_torch.data.png import read_png


def torch_load(path_or_file):
    """A pickled dataset file (metadata dicts, masks) on the CPU: the files
    hold dicts and arrays, so ``weights_only`` must be off (torch ≥ 2.6
    defaults it to on)."""
    import torch

    return torch.load(path_or_file, map_location="cpu", weights_only=False)


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "PIL (Pillow) is needed to decode a JPEG or to resize an image whose "
            "size differs from its metadata record's; the port reads PNG files at "
            "the record's size without it") from e
    return Image


@dataclass
class ImageMetadata:
    image_path: Path
    c2w: np.ndarray  # (3, 4) RUB→DRB rotation, normalized DRB translation
    W: int
    H: int
    intrinsics: np.ndarray  # (4,) [fx, fy, cx, cy] (already downscaled)
    image_index: int
    is_val: bool = False
    mask_dir: Optional[Path] = None

    @property
    def mask_path(self) -> Optional[Path]:
        if self.mask_dir is None:
            return None
        return Path(self.mask_dir) / f"{Path(self.image_path).stem}.pt"

    def load_image(self) -> np.ndarray:
        """RGB uint8 (H, W, 3), LANCZOS-resized to the record's size."""
        path = Path(self.image_path)
        if path.suffix.lower() == ".png":
            img = read_png(path)
            if img.shape[:2] == (self.H, self.W):
                return img
            Image = _pil_image()
            pil = Image.fromarray(img)
        else:
            Image = _pil_image()
            pil = Image.open(path).convert("RGB")
            if pil.size == (self.W, self.H):
                return np.asarray(pil, dtype=np.uint8)
        return np.asarray(pil.resize((self.W, self.H), Image.LANCZOS), dtype=np.uint8)

    def load_mask(self) -> Optional[np.ndarray]:
        """Boolean (H, W) cluster mask from a plain or zipped ``.pt``;
        nearest-resized if stored at another resolution; None when the file
        is missing or not an image mask."""
        mp = self.mask_path
        if mp is None or not mp.exists():
            return None
        try:
            m = torch_load(mp)
        except Exception:
            with ZipFile(mp, "r") as zf:
                inner = zf.namelist()[0]
                with zf.open(inner) as f:
                    m = torch_load(f)
        m = np.asarray(m)
        if m.ndim == 1:
            if m.size == self.H * self.W:
                m = m.reshape(self.H, self.W)
            else:
                return None
        if m.ndim != 2:
            return None
        if m.shape != (self.H, self.W):
            # nearest-neighbour resize keeps the mask discrete
            ys = (np.arange(self.H) * m.shape[0] / self.H).astype(np.int64)
            xs = (np.arange(self.W) * m.shape[1] / self.W).astype(np.int64)
            m = m[ys][:, xs]
        return m.astype(bool)


def load_metadata_file(
    metadata_path: Path,
    image_index: int,
    scale_factor: float,
    is_val: bool = False,
    mask_dir: Optional[Path] = None,
) -> Optional[ImageMetadata]:
    """One metadata ``.pt`` → ``ImageMetadata`` with its size and intrinsics
    scaled by ``scale_factor``; None when the image file is missing."""
    metadata_path = Path(metadata_path)
    image_path = None
    for ext in (".jpg", ".JPG", ".png", ".PNG"):
        cand = metadata_path.parent.parent / "rgbs" / f"{metadata_path.stem}{ext}"
        if cand.exists():
            image_path = cand
            break
    if image_path is None:
        return None

    md = torch_load(metadata_path)
    return ImageMetadata(
        image_path=image_path,
        c2w=np.asarray(md["c2w"], np.float32),
        W=int(round(int(md["W"]) * scale_factor)),
        H=int(round(int(md["H"]) * scale_factor)),
        intrinsics=np.asarray(md["intrinsics"], np.float32) * scale_factor,
        image_index=image_index,
        is_val=is_val,
        mask_dir=mask_dir,
    )
