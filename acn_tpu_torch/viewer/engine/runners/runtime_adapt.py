"""Runtime-Adapt runner: one viewer step = one TTO optimizer update.

Port of ``acn_tpu/viewer/engine/runners/runtime_adapt.py``: the continual
batches under ``<data>/continual/`` are taken oldest first, each becomes a
``RamRaysDataset`` support store, and each step is one Adam update of the
whole working model (``online_stage.runtime_adapt.make_tto_step``, gradient
clip 1.0) on ``support_rays`` rays sampled from it, after which the weights
are published to the frames.

Randomness: the rays come from numpy's ``default_rng(P.seed)``, as in
``acn_tpu``, so the ray ids are the same. The render draws go through
``TTODraws`` with (batch, step) indices, the step counted over the runner's
life: a ``torch.Generator`` on the device (seeded with ``P.seed`` when none is
given), or a function through which a test replays ``acn_tpu``'s keys (its
``PRNGKey(P.seed)`` split once per step).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from acn_tpu_torch.data.dataset import get_image_metadata
from acn_tpu_torch.data.ram_rays import RamRaysDataset
from acn_tpu_torch.models import container as cont
from acn_tpu_torch.pipelines.online_stage.runtime_adapt import TTODraws, make_tto_step
from acn_tpu_torch.utils.optim import build_optimizer
from acn_tpu_torch.viewer.engine.runners.base import BaseRunner


class RuntimeAdaptRunner(BaseRunner):
    def __init__(self, ctx: Dict[str, Any], batch_dir: Optional[Path] = None, draws=None):
        super().__init__(ctx)
        self.rng = np.random.default_rng(self.P.seed)
        self.batch_dirs = self._discover_batches(batch_dir)
        self.batch_idx = -1
        self.support: Optional[RamRaysDataset] = None
        self._tto = None
        self._opt = None
        self._opt_state = None
        self._draw_source = (draws if draws is not None else
                             torch.Generator(device=self.device).manual_seed(int(self.P.seed)))
        self._draws: Optional[TTODraws] = None
        self._n_draws = 0

    def _discover_batches(self, batch_dir) -> List[Path]:
        """Continual batch dirs, oldest first."""
        if batch_dir is not None:
            return [Path(batch_dir)]
        cont_dir = Path(self.ctx["data_path"]) / "continual"
        if not cont_dir.exists():
            return []
        return sorted(d for d in cont_dir.iterdir() if d.is_dir())

    def advance_batch(self) -> bool:
        """Load the next continual batch's support rays. Returns False when
        exhausted."""
        self.batch_idx += 1
        if self.batch_idx >= len(self.batch_dirs):
            return False
        bd = self.batch_dirs[self.batch_idx]
        _, metas = get_image_metadata(bd, self.downscale)
        self.support = RamRaysDataset(
            metas,
            center_pixels=True,
            aabb=np.asarray(self.ctx["global_aabb"]),
            near_far_override=(self.P.near, self.P.far),
            num_workers=self.P.num_workers,
        )
        return len(self.support) > 0

    def _ensure_optimizer(self):
        if self._tto is None:
            labels = cont.param_group_labels(self.model.params())
            # acn_tpu's TTO clip, whatever P.grad_clip says; the lrs are P's
            self._opt = build_optimizer(self.P, labels, grad_clip=1.0)
            self._opt_state = self._opt.init(self.model.params())
            occ_cfg = self.ctx.get("occ_cfg")
            self._use_occ = occ_cfg is not None and self.ctx.get("occ_states") is not None
            self._tto = make_tto_step(self.cfg, self.P, self._opt, occ_cfg, self._use_occ)
            self._draws = TTODraws(self._draw_source, self.device, self._use_occ, self.P,
                                   self.cfg)

    def _on_hparams_changed(self):
        # rebuild the optimizer (fresh moments) on the next step
        self._tto = None

    def step(self) -> Dict[str, float]:
        """One optimizer update on one support batch, then a publish."""
        if self.support is None and not self.advance_batch():
            return {"status": 0.0}
        self._ensure_optimizer()

        rays, rgbs, _ = self.support.sample(self.rng, self.support_rays)
        b, i, n = self.batch_idx, self._n_draws, len(rays)
        self._n_draws += 1
        occ_states = self.ctx["occ_states"] if self._use_occ else None
        with self._weights:
            self._opt_state, loss = self._tto(
                self.model, self._opt_state, occ_states,
                torch.from_numpy(rays).to(self.device), torch.from_numpy(rgbs).to(self.device),
                self._draws.render(b, i, n), bg=self._draws.bg(b, i, n))
            self.steps += 1
            self._publish()
        loss_f = float(loss)
        psnr = float(-10.0 * np.log10(max(loss_f, 1e-12)))
        self.psnr_history.append(psnr)
        return {"loss": loss_f, "psnr": psnr, "step": float(self.steps)}
