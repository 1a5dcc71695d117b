"""The checkpoint side of the config system.

Port of three functions of ``acn_tpu/utils/config.py``: a run's config
namespace ``P`` is saved beside each checkpoint as ``{tag}.P.json``
(``namespace_to_jsonable``) and read back (``load_checkpoint_cfg``,
``resolve_ckpt_cfg_path``), so that a resumed run sees what the run decided,
``P.occ_regime = "budget"`` after the auto switch among it. The flag parser
and its merge rules are not ported (ROADMAP.md M6).
"""

from __future__ import annotations

import json
import os
from typing import Optional


def namespace_to_jsonable(args) -> dict:
    """The namespace's fields as JSON values; a value JSON cannot hold is
    written as its ``str``."""
    out = {}
    for k, v in vars(args).items():
        try:
            json.dumps(v)
            out[k] = v
        except TypeError:
            out[k] = str(v)
    return out


def load_checkpoint_cfg(cfg_path: str) -> dict:
    """A checkpointed config: ``{prefix}.P.json``, or a reference ``.P``
    file (a pickled namespace, read with ``torch.load``)."""
    if cfg_path.endswith(".json") or os.path.exists(cfg_path + ".json"):
        path = cfg_path if cfg_path.endswith(".json") else cfg_path + ".json"
        with open(path) as f:
            return json.load(f)
    import torch

    cfg_obj = torch.load(cfg_path, map_location="cpu", weights_only=False)
    return vars(cfg_obj) if hasattr(cfg_obj, "__dict__") else dict(cfg_obj)


def resolve_ckpt_cfg_path(checkpoint_path: str, prefix: str) -> Optional[str]:
    """``{prefix}.P.json`` (or ``.P``) of a checkpoint given as a run
    directory or a run name, found as ``resolve_checkpoint_dir`` finds the
    weights; None if there is none."""
    from acn_tpu_torch.utils.checkpoint import resolve_checkpoint_dir

    candidates = []
    try:
        candidates.append(resolve_checkpoint_dir(checkpoint_path))
    except (FileNotFoundError, OSError):
        pass
    candidates.append(checkpoint_path)
    for d in candidates:
        for suffix in (f"{prefix}.P.json", f"{prefix}.P"):
            p = os.path.join(d, suffix)
            if os.path.exists(p):
                return p
    return None
