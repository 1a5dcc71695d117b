"""Episodic task sampling for meta-training, in numpy.

Port of ``acn_tpu/data/tasks.py``: an expert's region is cut into a
``(1, cell_dim, cell_dim)`` grid of micro-cells, every ray is routed to the
cell it overlaps most, and an episode draws its support and query rays from
one cell under the reference's episode constraints (support from 2 to 8
images, query from 1 to 4, no image above 40 % of a split, query images
apart from the support's while enough exist, support and query rays
disjoint). ``TaskSampler`` / ``MultiTaskSampler`` sample on the host;
``build_device_pools`` packs the per-cell pools into fixed-shape arrays for
the sampler on the card (``pipelines/offline_stage/train_step.
make_device_batch_fn``). Every function gives the same arrays as
``acn_tpu``'s from the same seed.

Routing results are cached on disk by a fingerprint of the rays and the
cells, under ``ROUTE_CACHE`` (the checkout's ``.cache/`` directory) unless
the caller gives another directory, or None for no cache.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from acn_tpu_torch.data.ram_rays import RamRaysDataset

ROUTE_CACHE = Path(__file__).resolve().parents[2] / ".cache" / "acn_tpu_torch" / "routes"


@dataclass(frozen=True)
class EpisodeConstraints:
    """Reference episode-shaping knobs (task_dataset.py:46-49 defaults +
    nerf_runner.py:204 image_cap)."""

    min_images_support: int = 2
    max_images_support: int = 8
    min_images_query: int = 1
    max_images_query: int = 4
    image_cap: float = 0.4  # max fraction of one split from a single image
    image_disjoint: bool = True


def make_micro_cells(region_aabb: np.ndarray, cell_dim: int) -> np.ndarray:
    """(C, 2, 3) AABBs of a (1, cell_dim, cell_dim) grid over the region
    (x/Down kept whole — aerial scenes partition in the YZ ground plane,
    reference nerf_runner.py:208)."""
    mn, mx = np.asarray(region_aabb[0]), np.asarray(region_aabb[1])
    edges_y = np.linspace(mn[1], mx[1], cell_dim + 1)
    edges_z = np.linspace(mn[2], mx[2], cell_dim + 1)
    cells = []
    for iy in range(cell_dim):
        for iz in range(cell_dim):
            cmin = np.array([mn[0], edges_y[iy], edges_z[iz]], np.float32)
            cmax = np.array([mx[0], edges_y[iy + 1], edges_z[iz + 1]], np.float32)
            cells.append(np.stack([cmin, cmax]))
    return np.stack(cells)  # (C, 2, 3)


def route_rays_to_cells(
    rays: np.ndarray,  # (N, 8)
    cells: np.ndarray,  # (C, 2, 3)
    min_overlap: float = 0.0,
    chunk: int = 262_144,
    cache_dir: Optional[Path] = ROUTE_CACHE,
) -> np.ndarray:
    """Dominant micro-cell per ray by max segment overlap (vectorized
    equivalent of the reference's `_dda_maxoverlap`, task_dataset.py:299-351).

    Decomposed per axis: a slab pair contributes one sorted t-interval per
    axis, and a cell's overlap is the intersection of its three axis
    intervals with [near, far] — O(N·Σ_axis n_edges) work instead of
    materializing (N, C, 3) products. Chunked to bound temporaries.

    Returns (N,) int32 cell ids; −1 where no cell overlaps more than
    ``min_overlap`` (weak-overlap filtering, task_dataset.py:544-627).
    """
    # Pure numpy on the host: routing is one-time preprocessing, a
    # vectorized float32 pass over the store. Results are cached by a
    # fingerprint of their inputs (a restarted run routes the same store).
    N = len(rays)
    cells_np = np.asarray(cells, np.float32)  # (C, 2, 3)

    cache_path = (None if cache_dir is None
                  else _route_cache_path(rays, cells_np, min_overlap, cache_dir))
    if cache_path is not None and cache_path.exists():
        cached = np.load(cache_path)["cell_ids"]
        if len(cached) == N:
            return cached

    out = np.empty(N, np.int32)
    for s in range(0, N, chunk):
        e = min(s + chunk, N)
        r = np.asarray(rays[s:e], np.float32)
        o = r[:, None, :3]
        d = r[:, None, 3:6]
        near = r[:, 6:7]
        far = r[:, 7:8]
        eps = np.float32(1e-9)
        d_safe = np.where(np.abs(d) < eps, np.where(d >= 0, eps, -eps), d)
        inv = 1.0 / d_safe
        t0 = (cells_np[None, :, 0, :] - o) * inv  # (n, C, 3)
        t1 = (cells_np[None, :, 1, :] - o) * inv
        t_lo = np.maximum(np.minimum(t0, t1).max(axis=-1), near)
        t_hi = np.minimum(np.maximum(t0, t1).min(axis=-1), far)
        overlap = np.maximum(t_hi - t_lo, 0.0)  # (n, C)
        best = overlap.argmax(axis=1).astype(np.int32)
        best_val = np.take_along_axis(overlap, best[:, None], axis=1)[:, 0]
        out[s:e] = np.where(best_val <= min_overlap, -1, best)

    if cache_path is not None:
        try:
            cache_path.parent.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(cache_path, cell_ids=out)
        except OSError:
            pass
    return out


def _route_cache_path(rays, cells_np, min_overlap, cache_dir):
    """Content-fingerprinted cache file for a routing result (strided sample
    + shape + exact cell grid — collisions practically impossible)."""
    try:
        r = np.ascontiguousarray(rays, np.float32)
        stride = max(r.size // 1_000_000, 1)
        h = hashlib.sha1()
        h.update(str((r.shape, float(min_overlap))).encode())
        h.update(r.reshape(-1)[::stride].tobytes())
        h.update(np.float64(r.sum()).tobytes())
        h.update(cells_np.tobytes())
        return Path(cache_dir) / f"{h.hexdigest()[:16]}.npz"
    except Exception:
        return None


@dataclass
class Task:
    """One episode (reference task_dataset.py:10-28)."""

    support_rays: np.ndarray  # (S, 8)
    support_rgbs: np.ndarray  # (S, 3)
    query_rays: np.ndarray  # (Q, 8)
    query_rgbs: np.ndarray  # (Q, 3)
    cell_id: int


class TaskSampler:
    """Infinite episodic sampler over one expert's ray store, enforcing the
    reference's episode constraints (task_dataset.py:682-898)."""

    def __init__(
        self,
        dataset: RamRaysDataset,
        region_aabb: np.ndarray,  # (2, 3)
        cell_dim: int,
        support_rays: int,
        query_rays: int,
        seed: int = 0,
        min_pool: Optional[int] = None,
        constraints: EpisodeConstraints = EpisodeConstraints(),
        route_cache: Optional[Path] = ROUTE_CACHE,
    ):
        self.ds = dataset
        self.support_rays = int(support_rays)
        self.query_rays = int(query_rays)
        self.rng = np.random.default_rng(seed)
        self.constraints = constraints

        self.cells = make_micro_cells(region_aabb, cell_dim)
        cell_ids = route_rays_to_cells(dataset.rays, self.cells,
                                       cache_dir=route_cache)

        # per-cell index pools; eligible cells have enough rays for an episode
        # (reference min_rays_cell = 0.5·(S+Q), nerf_runner.py:205)
        min_pool = (
            min_pool if min_pool is not None
            else (support_rays + query_rays) // 2
        )
        self.pools: List[np.ndarray] = []
        self.pool_imgs: List[np.ndarray] = []  # image id per pooled ray
        self.eligible: List[int] = []
        for c in range(len(self.cells)):
            idx = np.nonzero(cell_ids == c)[0]
            self.pools.append(idx)
            self.pool_imgs.append(dataset.img_indices[idx])
            if len(idx) >= min_pool:
                self.eligible.append(c)
        if not self.eligible:
            # degenerate region: fall back to the cells that have any rays
            self.eligible = [c for c in range(len(self.cells)) if len(self.pools[c]) > 0]
        if not self.eligible:
            raise ValueError("TaskSampler: no rays routed to any micro-cell")

    def _choose_images(self, imgs_avail, min_imgs, max_imgs, forbid=None):
        """Random image subset honoring min/max, avoiding ``forbid`` and
        borrowing from it only to reach the minimum
        (reference _choose_images_for_split, task_dataset.py:420-483)."""
        pool = imgs_avail
        if forbid is not None and len(forbid):
            pool = imgs_avail[~np.isin(imgs_avail, forbid)]
        k_max = min(max_imgs, len(imgs_avail)) if max_imgs else len(imgs_avail)
        k_min = max(0, min(min_imgs, k_max))
        if len(pool) >= k_min:
            k = min(k_max, len(pool))
            return self.rng.permutation(pool)[:k]
        chosen = pool
        if forbid is not None and len(forbid) and len(chosen) < k_min:
            borrow = imgs_avail[np.isin(imgs_avail, forbid)]
            need = min(k_min, k_max) - len(chosen)
            if need > 0 and len(borrow):
                chosen = np.concatenate(
                    [chosen, self.rng.permutation(borrow)[:need]]
                )
        if len(chosen) > k_max:
            chosen = self.rng.permutation(chosen)[:k_max]
        return chosen

    def _sample_split(self, c, target, images, forbid_idx=None):
        """Capped random rays from cell ``c`` restricted to ``images``
        (reference _sample_split_from_images, task_dataset.py:485-542)."""
        pool, pimg = self.pools[c], self.pool_imgs[c]
        mask = np.isin(pimg, images)
        if forbid_idx is not None and len(forbid_idx):
            mask &= ~np.isin(pool, forbid_idx)
        cand = pool[mask]
        cand_img = pimg[mask]
        if len(cand) == 0:
            return pool[:0]
        need = min(int(target), len(cand))
        order = self.rng.permutation(len(cand))
        cap = max(1, int(np.ceil(self.constraints.image_cap * need)))
        # greedy cap fill, vectorized: stable-sort candidates by image, rank
        # within image, keep rank < cap, then take the first `need` in the
        # original random order
        img_o = cand_img[order]
        sort_by_img = np.argsort(img_o, kind="stable")
        ranks = np.empty(len(cand), np.int64)
        _, starts = np.unique(img_o[sort_by_img], return_index=True)
        grp = np.zeros(len(cand), np.int64)
        grp[starts] = 1
        grp = np.cumsum(grp) - 1
        ranks[sort_by_img] = np.arange(len(cand)) - starts[grp]
        keep = ranks < cap
        return cand[order[keep][:need]]

    def sample_task(self) -> Task:
        cst = self.constraints
        c = int(self.rng.choice(self.eligible))
        pool, pimg = self.pools[c], self.pool_imgs[c]
        imgs_avail = np.unique(pimg)

        supp_imgs = self._choose_images(
            imgs_avail, cst.min_images_support, cst.max_images_support
        )
        s_idx = self._sample_split(c, self.support_rays, supp_imgs)
        query_imgs = self._choose_images(
            imgs_avail, cst.min_images_query, cst.max_images_query,
            forbid=supp_imgs if cst.image_disjoint else None,
        )
        q_idx = self._sample_split(
            c, self.query_rays, query_imgs, forbid_idx=s_idx
        )
        if len(q_idx) < self.query_rays and cst.image_disjoint:
            # borrow from all images, ray-disjoint (task_dataset.py:871-881)
            borrow = self._sample_split(
                c, self.query_rays - len(q_idx), imgs_avail,
                forbid_idx=np.concatenate([s_idx, q_idx]),
            )
            q_idx = np.concatenate([q_idx, borrow])

        # fixed output shapes: wrap-pad underfilled splits (with replacement)
        def pad_to(idx, n):
            if len(idx) >= n:
                return idx[:n]
            if len(idx) == 0:
                return self.rng.choice(pool, size=n, replace=True)
            reps = -(-n // len(idx))
            return np.tile(idx, reps)[:n]

        s_idx = pad_to(s_idx, self.support_rays)
        q_idx = pad_to(q_idx, self.query_rays)
        return Task(
            support_rays=self.ds.rays[s_idx],
            support_rgbs=self.ds.rgbs[s_idx],
            query_rays=self.ds.rays[q_idx],
            query_rgbs=self.ds.rgbs[q_idx],
            cell_id=c,
        )

    def sample_batch(self, num_tasks: int) -> Dict[str, np.ndarray]:
        """(T, ·, ·) stacked episode batch."""
        tasks = [self.sample_task() for _ in range(num_tasks)]
        return {
            "support_rays": np.stack([t.support_rays for t in tasks]),
            "support_rgbs": np.stack([t.support_rgbs for t in tasks]),
            "query_rays": np.stack([t.query_rays for t in tasks]),
            "query_rgbs": np.stack([t.query_rgbs for t in tasks]),
            "cell_ids": np.array([t.cell_id for t in tasks], np.int32),
        }


def build_device_pools(
    samplers: List["TaskSampler"],
    max_pool: int = 262_144,
    max_images: int = 32,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Package per-expert ray stores + per-cell pools as fixed-shape arrays
    for episodic sampling on the card (``make_device_batch_fn``): no host
    sampling and no host-to-device copy per step.

    Each cell's pool is **segmented by image**: within-image ray order is
    pre-shuffled, images are sorted by ray count (desc) and the top
    ``max_images`` kept (dropping only the thinnest tail slivers). The
    sampler on the card then reproduces the reference's episode constraints
    with fixed shapes: random image subsets per split, capped per-image
    shares, S/Q image disjointness with borrowing.

    Returns numpy arrays (stacked over K experts, padded):
      rays (K, N, 8) f32 · rgbs (K, N, 3) f32 ·
      pool_idx (K, C, P) i32 (image-segmented, within-image shuffled) ·
      img_start (K, C, I) i32 · img_len (K, C, I) i32 · img_count (K, C) i32 ·
      eligible (K, C) bool
    """
    K = len(samplers)
    C = max(len(s.pools) for s in samplers)
    N = max(len(s.ds.rays) for s in samplers)
    P = min(max_pool, max(max((len(p) for p in s.pools), default=1)
                          for s in samplers))
    I = max_images
    rng = np.random.default_rng(seed)

    rays = np.zeros((K, N, 8), np.float32)
    rays[:, :, 7] = -1.0  # padded rays are inert (far < near)
    rgbs = np.zeros((K, N, 3), np.float32)
    pool_idx = np.zeros((K, C, P), np.int32)
    img_start = np.zeros((K, C, I), np.int32)
    img_len = np.zeros((K, C, I), np.int32)
    img_count = np.zeros((K, C), np.int32)
    eligible = np.zeros((K, C), bool)

    for k, s in enumerate(samplers):
        n = len(s.ds.rays)
        rays[k, :n] = s.ds.rays
        rgbs[k, :n] = s.ds.rgbs
        for c, pool in enumerate(s.pools):
            if len(pool) == 0:
                continue
            pimg = s.pool_imgs[c]
            # group by image with one stable sort (not I boolean scans)
            by_img = np.argsort(pimg, kind="stable")
            sorted_img = pimg[by_img]
            uniq, starts_u, counts = np.unique(
                sorted_img, return_index=True, return_counts=True
            )
            order = np.argsort(-counts, kind="stable")[:I]
            pos = 0
            for slot, oi in enumerate(order):
                seg = pool[by_img[starts_u[oi] : starts_u[oi] + counts[oi]]]
                seg = rng.permutation(seg).astype(np.int32)
                seg = seg[: P - pos]
                if len(seg) == 0:
                    break
                pool_idx[k, c, pos : pos + len(seg)] = seg
                img_start[k, c, slot] = pos
                img_len[k, c, slot] = len(seg)
                img_count[k, c] += 1
                pos += len(seg)
            eligible[k, c] = c in s.eligible and img_count[k, c] > 0
    return {
        "rays": rays,
        "rgbs": rgbs,
        "pool_idx": pool_idx,
        "img_start": img_start,
        "img_len": img_len,
        "img_count": img_count,
        "eligible": eligible,
    }


class MultiTaskSampler:
    """Lockstep per-expert episodic batches.

    Counterpart of the reference's ``MultiLoader`` over K per-expert
    DataLoaders (data/multi_loader.py:5-40), but emitting one stacked
    (K, T, ·, ·) array batch per step — the layout the expert-sharded train
    step consumes directly (expert axis shards over the mesh).
    """

    def __init__(self, samplers: List[TaskSampler]):
        assert len(samplers) > 0
        self.samplers = samplers

    @property
    def num_experts(self) -> int:
        return len(self.samplers)

    def sample_batch(self, num_tasks: int) -> Dict[str, np.ndarray]:
        per = [s.sample_batch(num_tasks) for s in self.samplers]
        return {k: np.stack([b[k] for b in per]) for k in per[0]}
