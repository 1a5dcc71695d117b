"""Meta-train runner for the viewer: one viewer step = one meta-train step.

Port of ``acn_tpu/viewer/engine/runners/meta_train.py``: episodic batches
from the context's ``train_sampler`` (on the host), one
``make_meta_train_step`` step of the working model, then a publish to the
frames. As in ``acn_tpu`` the step is built without the occupancy config,
so it trains in the stratified regime whatever the context's grids, and the
context must hold a ``train_sampler``, which only ``--op train`` builds.

``draws``: a ``torch.Generator`` on the device (seeded with ``P.seed`` when
none is given), or a function of the step's index (counted over the
runner's life) that returns that step's draws as ``EpisodeDraws`` takes
them, through which a test replays ``acn_tpu``'s keys (its
``PRNGKey(P.seed)`` split once per step).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from acn_tpu_torch.models import container as cont
from acn_tpu_torch.pipelines.offline_stage.train_step import make_meta_train_step
from acn_tpu_torch.pipelines.offline_stage.trainer import dummy_occ_states
from acn_tpu_torch.utils.optim import build_optimizer
from acn_tpu_torch.viewer.engine.runners.base import BaseRunner

BATCH_KEYS = ("support_rays", "support_rgbs", "query_rays", "query_rgbs")


class MetaTrainRunner(BaseRunner):
    def __init__(self, ctx: Dict[str, Any], draws=None):
        if ctx.get("train_sampler") is None:
            raise ValueError("MetaTrainRunner needs a train_sampler in ctx")
        super().__init__(ctx)
        self.sampler = ctx["train_sampler"]
        labels = cont.param_group_labels(self.model.params())
        self.optimizer = build_optimizer(self.P, labels, grad_clip=self.P.grad_clip)
        self._step_fn = make_meta_train_step(self.cfg, self.P, self.optimizer,
                                             device=self.device)
        self._state = {
            "model": self.model,
            "opt_state": self.optimizer.init(self.model.params()),
            "step": 0,
        }
        self._occ = (self.occ_states if self.occ_states is not None
                     else dummy_occ_states(self.cfg.num_submodules, self.device))
        self._draws = (draws if draws is not None else
                       torch.Generator(device=self.device).manual_seed(int(self.P.seed)))
        self._n_draws = 0

    def step(self) -> Dict[str, float]:
        batch_np = self.sampler.sample_batch(self.P.batch_size)
        batch = {k: torch.from_numpy(batch_np[k]).to(self.device) for k in BATCH_KEYS}
        draws = (self._draws if isinstance(self._draws, torch.Generator)
                 else self._draws(self._n_draws))
        self._n_draws += 1
        with self._weights:
            self._state, metrics = self._step_fn(self._state, batch, self._occ, draws)
            self.steps += 1
            self._publish()
        psnr = float(torch.mean(metrics["psnr_out"]))
        self.psnr_history.append(psnr)
        return {
            "loss": float(metrics["loss_total"]),
            "psnr": psnr,
            "step": float(self.steps),
        }
