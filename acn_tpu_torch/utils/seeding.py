"""Seeding.

Port of ``acn_tpu/utils/seeding.py``. ``set_random_seed`` seeds Python's,
numpy's and torch's global generators (the CPU's and every card's);
``rng_for`` gives an independent numpy generator per named stream, as
``acn_tpu`` does for its samplers. The training loop itself draws from one
explicit ``torch.Generator`` (``pipelines/offline_stage/trainer.LoopDraws``),
not from the global ones; a step derives one generator per expert and task
from it (``step_seed``, ``keyed_generator``), so that a rank of a mesh that
runs some episodes draws what a single device draws for them.
"""

from __future__ import annotations

import hashlib
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


def _mix(*ints: int) -> int:
    h = hashlib.blake2b(b",".join(str(int(i)).encode() for i in ints), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1  # a seed in [0, 2⁶³)


def step_seed(gen: torch.Generator) -> int:
    """A seed from ``gen``'s state, read on the host (a card's generator
    keeps its seed and offset there: no wait for the card), then ``gen``
    advanced by one draw so that the next call gives another seed. Ranks
    whose generators are in one state get one seed."""
    digest = hashlib.blake2b(gen.get_state().numpy().tobytes(), digest_size=8).digest()
    seed = int.from_bytes(digest, "little") >> 1
    torch.empty((1,), device=gen.device).uniform_(generator=gen)
    return seed


def keyed_generator(seed: int, *key: int, device=None) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` and ``key`` (an
    expert's and a task's global index, say)."""
    return torch.Generator(device=device).manual_seed(_mix(seed, *key))
