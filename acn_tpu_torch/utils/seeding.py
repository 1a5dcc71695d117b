"""Seeding.

Port of ``acn_tpu/utils/seeding.py``. ``set_random_seed`` seeds Python's,
numpy's and torch's global generators (the CPU's and every card's);
``rng_for`` gives an independent numpy generator per named stream, as
``acn_tpu`` does for its samplers. The training loop itself draws from one
explicit ``torch.Generator`` (``pipelines/offline_stage/trainer.LoopDraws``),
not from the global ones.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def set_random_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed % 2**32)
    torch.manual_seed(seed)  # the CPU's generator and every card's


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """Independent numpy generator for a named stream (sampler id, worker
    id, …)."""
    return np.random.default_rng(np.random.SeedSequence([seed, *stream]))
