"""What the training loop runs between steps: the auto-regime switch and the
occupancy update.

Port of the pieces of ``acn_tpu/pipelines/offline_stage/trainer.py`` that a
run needs beside its steps: ``AutoRegime``, ``make_occ_update_fn``,
``init_occ_states`` and ``dummy_occ_states``. A run of
``configs/train_occ.json`` trains stratified for ``occ_cfg.warmup_steps``
steps, then strided with ``report_budget`` until ``AutoRegime`` switches it
to the packed-budget step; the grids are rebuilt every
``occ_cfg.update_interval`` steps. The loop itself (``meta_trainer``: the
logger, checkpoints, samplers and signals) is not ported (ROADMAP.md M5).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from acn_tpu_torch.models.container import Container, ContainerConfig
from acn_tpu_torch.occupancy import grid as occ_grid
from acn_tpu_torch.occupancy.grid import OccConfig


class AutoRegime:
    """Marching-regime controller: strided until the budget path is safe.

    The packed-budget march drops valid samples batch-tail-first while the
    grids are still dense, which corrupts training. The controller keeps the
    unbiased strided step while the measured would-be overflow
    (``march_rays(report_budget=...)``) stays above ``thresh``, and fires
    after ``patience`` consecutive readings at or under it. One-way."""

    def __init__(self, thresh: float = 0.02, patience: int = 3):
        self.thresh = float(thresh)
        self.patience = int(patience)
        self.streak = 0
        self.switched = False

    def observe(self, would_overflow: float) -> bool:
        """Feed one reading; True exactly once: when the switch fires."""
        if self.switched:
            return False
        if would_overflow <= self.thresh:
            self.streak += 1
        else:
            self.streak = 0
        if self.streak >= self.patience:
            self.switched = True
            return True
        return False


def make_occ_update_fn(cfg: ContainerConfig, occ_cfg: OccConfig):
    """The all-expert occupancy EMA update:
    ``update_all(model, occ_states, jitter=None, generator=None)`` → new
    stacked (K, ...) states.

    The experts are updated one after another (the all-cells density sweep
    is the largest computation of a run), each in float32 on its own
    parameters over its own grid, with step size diag(expert AABB)/1000.
    ``jitter`` (K, L, R³, 3) in [−0.5, 0.5) is injected (JAX draws one per
    expert from a split key), or drawn from ``generator``; one of the two is
    required."""

    def update_all(model: Container, occ_states: Dict[str, torch.Tensor],
                   jitter: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        states = []
        for k in range(model.expert_aabbs.shape[0]):
            params, aabb = model.expert(k), model.expert_aabbs[k]
            states.append(occ_grid.update_occ_grid(
                {name: v[k] for name, v in occ_states.items()},
                lambda x: cfg.expert_density(params, cfg.expert, aabb, x)[..., 0],
                occ_cfg, occ_cfg.step_size_for_traced(aabb),
                jitter=None if jitter is None else jitter[k], generator=generator))
        return {name: torch.stack([s[name] for s in states]) for name in states[0]}

    return update_all


def init_occ_states(expert_aabbs: torch.Tensor, occ_cfg: OccConfig) -> Dict[str, torch.Tensor]:
    """Stacked (K, ...) empty occupancy states, each over its expert's AABB,
    on the AABBs' device."""
    states = [occ_grid.init_occ_state(ab, occ_cfg) for ab in expert_aabbs]
    return {name: torch.stack([s[name] for s in states]) for name in states[0]}


def dummy_occ_states(num_experts: int, device=None) -> torch.Tensor:
    """The stratified regime's placeholder for the occupancy states."""
    return torch.zeros((num_experts,), dtype=torch.float32, device=device)
