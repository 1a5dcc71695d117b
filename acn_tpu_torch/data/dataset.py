"""Dataset factory and metadata discovery for prepared 'drz'-style datasets.

Port of ``acn_tpu/data/dataset.py``. The on-disk layout is the reference's:
``<data_path>/out/<dirname>/`` with ``coordinates.pt``, the split layout
``train|val/{metadata,rgbs}`` (or the flat ``{metadata,rgbs}`` of continual
batches), and ``masks/<mask_dirname>/`` with ``params.pt``,
``scene_boxes.pt`` and one directory of per-image masks per expert.

Built ray stores are cached as ``.npz`` under ``RAY_CACHE`` (the checkout's
``.cache/`` directory, as ``data/tasks.ROUTE_CACHE``), keyed by the dataset
path, mask set, downscale, near/far override, image cap and box.
"""

from __future__ import annotations

import hashlib
import zipfile
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from acn_tpu_torch.data.image_metadata import ImageMetadata, load_metadata_file, torch_load
from acn_tpu_torch.data.ram_rays import RamRaysDataset

RAY_CACHE = Path(__file__).resolve().parents[2] / ".cache" / "acn_tpu_torch" / "rays"


def load_coordinates(data_path: Path) -> Dict:
    """coordinates.pt → {origin_drb (3,), pose_scale_factor, ...} as numpy."""
    c = torch_load(Path(data_path) / "coordinates.pt")
    return {
        "origin_drb": np.asarray(c["origin_drb"], np.float32),
        "pose_scale_factor": float(c["pose_scale_factor"]),
        "altitude_range_enu": (
            np.asarray(c["altitude_range_enu"], np.float32)
            if "altitude_range_enu" in c
            else None
        ),
        "enu_ref_coords": c.get("enu_ref_coords"),
    }


def _list_metadata_files(d: Path) -> List[Path]:
    if not d.exists() or not d.is_dir():
        return []
    return sorted(
        (p for p in d.iterdir() if p.is_file() and p.suffix == ".pt"),
        key=lambda x: x.name,
    )


def get_image_metadata(
    data_path,
    scale_factor: float,
    mask_dir: Optional[Path] = None,
    only_test: bool = False,
) -> Tuple[List[ImageMetadata], List[ImageMetadata]]:
    """Flat layout (all val; continual batches) or split layout
    (train + val|test), indices over the filename-sorted union
    (reference dataset.py:185-254)."""
    root = Path(data_path)

    flat_meta = _list_metadata_files(root / "metadata")
    if flat_meta and (root / "rgbs").exists():
        image_indices = {p.name: i for i, p in enumerate(flat_meta)}
        val_items = [
            load_metadata_file(p, image_indices[p.name], scale_factor, True, mask_dir)
            for p in flat_meta
        ]
        return [], [m for m in val_items if m is not None]

    train_paths = _list_metadata_files(root / "train" / "metadata")
    eval_paths = _list_metadata_files(root / "val" / "metadata") or _list_metadata_files(
        root / "test" / "metadata"
    )
    if train_paths or eval_paths:
        all_paths = sorted(train_paths + eval_paths, key=lambda x: x.name)
        image_indices = {p.name: i for i, p in enumerate(all_paths)}
        train_items = (
            [
                load_metadata_file(
                    p, image_indices[p.name], scale_factor, False, mask_dir
                )
                for p in train_paths
            ]
            if not only_test
            else []
        )
        val_items = [
            load_metadata_file(p, image_indices[p.name], scale_factor, True, mask_dir)
            for p in eval_paths
        ]
        return (
            [m for m in train_items if m is not None],
            [m for m in val_items if m is not None],
        )
    return [], []


def cap_metadata(md_list, cap_images, rng=None):
    """Random subset (reference dataset.py:148-156)."""
    if cap_images is None or cap_images <= 0 or len(md_list) <= cap_images:
        return md_list
    rng = rng or np.random.default_rng(0)
    idx = rng.permutation(len(md_list))[:cap_images]
    return [md_list[i] for i in idx]


# ---------------------- clustering metadata loaders ----------------------
# (reference utils.py:649-705)


def discover_cluster_cells(mask_dir: Path) -> int:
    params_pt = Path(mask_dir) / "params.pt"
    if params_pt.exists():
        params = torch_load(params_pt)
        n = len(params.get("centroids", []))
        if n:
            return n
    return len([p for p in Path(mask_dir).iterdir() if p.is_dir()])


def load_clustering_meta(mask_dir) -> Dict:
    p = Path(mask_dir)
    params_path = p if (p.is_file() and p.name == "params.pt") else p / "params.pt"
    if not params_path.exists():
        raise FileNotFoundError(f"params.pt not found at: {params_path}")
    meta = torch_load(params_path)
    out = dict(meta)
    for k in ("centroids", "aabb_global"):
        if k in out:
            out[k] = np.asarray(out[k], np.float32)
    return out


def load_scene_boxes(mask_dir) -> Tuple[np.ndarray, np.ndarray]:
    """scene_boxes.pt → (global_aabb (2,3), expert_aabbs (K,2,3)) numpy."""
    boxes_path = Path(mask_dir) / "scene_boxes.pt"
    if not boxes_path.exists():
        raise FileNotFoundError(f"scene_boxes.pt not found at {boxes_path}")
    meta = torch_load(boxes_path)
    aabb_global = np.asarray(meta["aabb_global"], np.float32)
    mins = np.asarray(meta["mins"], np.float32)
    maxs = np.asarray(meta["maxs"], np.float32)
    expert_aabbs = np.stack([mins, maxs], axis=1)  # (K, 2, 3)
    return aabb_global, expert_aabbs


# ---------------------- ray-store disk cache ----------------------


def _cached_ram_rays(cache_key: str, build_fn) -> RamRaysDataset:
    """Build-or-load a ray store. Building decodes every image (minutes of
    host time for a real dataset) while the result is a deterministic
    function of the key, so it caches; an unreadable cache file is rebuilt."""
    RAY_CACHE.mkdir(parents=True, exist_ok=True)
    h = hashlib.sha1(cache_key.encode()).hexdigest()[:16]
    path = RAY_CACHE / f"{h}.npz"
    if path.exists():
        try:
            with np.load(path) as z:
                return RamRaysDataset.from_arrays(z["rays"], z["rgbs"], z["img_indices"],
                                                  num_images=int(z["num_images"]))
        except (OSError, KeyError, ValueError, zipfile.BadZipFile):
            path.unlink(missing_ok=True)
    ds = build_fn()
    tmp = path.with_name(path.stem + ".tmp.npz")
    np.savez(tmp, rays=ds.rays, rgbs=ds.rgbs, img_indices=ds.img_indices,
             num_images=ds.num_images)
    tmp.replace(path)
    return ds


# ---------------------- dataset factory ----------------------


def get_dataset(
    P,
    expert_aabbs: Optional[np.ndarray] = None,  # (K, 2, 3) per-expert boxes
    global_aabb: Optional[np.ndarray] = None,
    only_test: bool = False,
    near_far_override=None,
) -> Tuple[Optional[List[RamRaysDataset]], Optional[List[RamRaysDataset]]]:
    """Build per-expert (masked) or flat ray datasets for 'drz'
    (reference dataset.py:11-143).

    Masked mode: one RamRaysDataset per expert, rays built against the
    expert's own SceneBox (per-ray near/far from its AABB).
    """
    if P.dataset != "drz":
        raise NotImplementedError(P.dataset)

    data_path = Path(P.data_path) / "out" / P.data_dirname

    if getattr(P, "mask_dirname", None) is None:
        train_md, val_md = get_image_metadata(data_path, P.downscale, mask_dir=None)
        kwargs = dict(
            center_pixels=True,
            aabb=global_aabb,
            near_far_override=near_far_override,
            num_workers=P.num_workers,
        )
        key_base = (
            f"{data_path.resolve()}|flat|ds{P.downscale}|nf{near_far_override}"
        )
        test_set = _cached_ram_rays(
            key_base + "|val",
            lambda: RamRaysDataset(val_md, val_balancing=True, **kwargs),
        )
        if only_test:
            return None, [test_set]
        train_set = _cached_ram_rays(
            key_base + "|train", lambda: RamRaysDataset(train_md, **kwargs)
        )
        return [train_set], [test_set]

    mask_root = data_path / "masks" / P.mask_dirname
    mask_cells = discover_cluster_cells(mask_root)
    assert mask_cells == P.num_submodules, (
        f"Mask directory contains {mask_cells} regions but the experiment is "
        f"configured for {P.num_submodules}."
    )

    train_sets: List[RamRaysDataset] = []
    val_sets: List[RamRaysDataset] = []
    for cell_id in range(P.num_submodules):
        cell_mask_dir = mask_root / f"{cell_id}"
        train_md, val_md = get_image_metadata(
            data_path, P.downscale, cell_mask_dir, only_test
        )
        if len(train_md) == 0 and len(val_md) == 0:
            continue
        if P.cap_images is not None:
            train_md = cap_metadata(train_md, P.cap_images)
            val_md = cap_metadata(val_md, P.cap_images)

        aabb = expert_aabbs[cell_id] if expert_aabbs is not None else global_aabb
        kwargs = dict(
            center_pixels=True,
            aabb=aabb,
            near_far_override=near_far_override,
            num_workers=P.num_workers,
        )
        key_base = (
            f"{data_path.resolve()}|{P.mask_dirname}|cell{cell_id}|"
            f"ds{P.downscale}|nf{near_far_override}|cap{P.cap_images}|"
            f"aabb{np.asarray(aabb).tobytes().hex() if aabb is not None else None}"
        )
        if not only_test:
            train_ds = _cached_ram_rays(
                key_base + "|train",
                lambda: RamRaysDataset(train_md, **kwargs),
            )
            if len(train_ds) > 0:
                train_sets.append(train_ds)
        if val_md:
            val_ds = _cached_ram_rays(
                key_base + "|val",
                lambda: RamRaysDataset(val_md, val_balancing=True, **kwargs),
            )
            if len(val_ds) > 0:
                val_sets.append(val_ds)

    return (None if only_test else train_sets), val_sets
