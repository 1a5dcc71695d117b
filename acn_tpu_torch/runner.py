"""Run setup.

Port of the piece of ``acn_tpu/runner.py`` that a training run needs before
its loop and that does not depend on the dataset loaders:
``premark_occ_states``, which starts every expert's occupancy grid with the
cells that no camera sees marked invisible. The rest of the runner (the
context build, the ops, the flag parser) is ROADMAP.md M6.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from acn_tpu_torch.occupancy import grid as occ_grid
from acn_tpu_torch.occupancy.grid import OccConfig
from acn_tpu_torch.pipelines.offline_stage.trainer import init_occ_states
from acn_tpu_torch.pipelines.renderer import resolve_device


def premark_occ_states(occ_cfg: OccConfig, expert_aabbs, intrinsics, c2w,
                       width: int, height: int, near_plane: float,
                       device=None) -> Dict[str, torch.Tensor]:
    """Stacked (K, ...) fresh occupancy states, each over its expert's AABB,
    with the cells outside every camera's frustum marked invisible.

    ``intrinsics`` (C, 4) = (fx, fy, cx, cy) and ``c2w`` (C, 3, 4) RUB
    camera-to-world matrices of all the run's cameras (train and val), all
    ``width`` × ``height`` pixels; C = 0 gives the fresh states. The RUB
    poses are turned into RDF ones (the y and z columns negated) as
    ``acn_tpu`` does, on the host in float32. ``device=None`` is the card."""
    device = resolve_device(device)
    aabbs = torch.as_tensor(np.asarray(expert_aabbs, np.float32), device=device)
    intr = np.asarray(intrinsics, np.float32).reshape(-1, 4)
    if len(intr) == 0:
        return init_occ_states(aabbs, occ_cfg)
    fx, fy, cx, cy = (intr[:, i] for i in range(4))
    zero, one = np.zeros_like(fx), np.ones_like(fx)
    K_mats = np.stack([np.stack([fx, zero, cx], -1), np.stack([zero, fy, cy], -1),
                       np.stack([zero, zero, one], -1)], 1)
    C3 = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
    c2w = np.asarray(c2w, np.float32)
    c2w_rdf = np.concatenate([c2w[:, :, :3] @ C3, c2w[:, :, 3:]], axis=2)
    K_t = torch.from_numpy(K_mats).to(device)
    c2w_t = torch.from_numpy(c2w_rdf).to(device)
    states = [occ_grid.mark_invisible_cells(occ_grid.init_occ_state(ab, occ_cfg), K_t, c2w_t,
                                            int(width), int(height), float(near_plane),
                                            occ_cfg)
              for ab in aabbs]
    return {name: torch.stack([s[name] for s in states]) for name in states[0]}
