"""Checkpoint IO in ``acn_tpu``'s on-disk layout, written without flax.

Port of ``acn_tpu/utils/checkpoint.py``. A run directory holds, per tag
(``best``, ``step{N}``, ``last``):

    {tag}.model        msgpack of {"variables", "occ_states"?}
    {tag}.optim        msgpack of the optimizer state, as optax's
    {tag}.P.json       the config namespace
    {tag}.configs.json {"step", "best", "is_best"}

The ``.model`` and ``.optim`` files equal, byte for byte, what ``acn_tpu``
writes for the same state (``utils/msgpack_tree.py`` is the codec), so each
package reads the other's. What that takes:

* **State-dict form.** flax writes a tree as its state dict: lists (and
  tuples) become maps {"0": …, "1": …}; an optax named tuple becomes a map
  of its fields in field order; a masked-out leaf (``MaskedNode``) is {}.
* **Key order.** ``.model`` goes through ``jax.tree_util.tree_map`` before
  it is packed, which sorts every map's keys as strings ("10" before "2").
  ``.optim`` is packed as it is, but every dict in a trained optax state
  came out of a jitted step or a ``tree_map``, which sort too: the groups
  (background, color, encoding, sigma) and the parameter maps are sorted,
  while list maps keep index order and named tuples field order.
* **The optimizer state** of ``build_optimizer`` (guard, clip, per-group
  Adam) is, for the port's {count, mu, nu} and the guard's counters::

      {notfinite_count, last_finite, total_notfinite,
       inner_state: {"0": {},                         # clip_by_global_norm
                     "1": {"inner_states": {g: {"inner_state":
                           {"0": {count, mu_g, nu_g},  # scale_by_adam
                            "1": {count}}}}}}}         # the schedule's count

  where ``mu_g`` is the parameter tree with the leaves of group g and {}
  elsewhere; without the guard the map starts at ``inner_state``'s value,
  without the clip at the per-group map. Counts are int32 and 0-dim. The
  per-group chain of AdamW (``optax.adamw``) is {"0": adam, "1": {}
  (add_decayed_weights), "2": {count}}; of SGD (``optax.sgd`` without
  momentum) {"0": {} (identity), "1": {count}}.

``AsyncCheckpointer`` takes a snapshot on the card (clones, queued on the
training stream before the next step is issued: the step updates the
parameters in place) and leaves the copy to the host, the packing and the
writes to a worker thread.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from acn_tpu_torch.models.nn import tree_map
from acn_tpu_torch.pipelines.renderer import resolve_device
from acn_tpu_torch.utils import msgpack_tree
from acn_tpu_torch.utils.config import namespace_to_jsonable


# ----------------------------------------------------------- state dicts


def _numpy(x) -> Any:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def variables_of(model) -> Dict[str, Any]:
    """A ``Container``'s JAX ``variables`` tree, its leaves the model's own
    tensors: {"params": {"experts", "bg_mlp"?}, "buffers": {...}}."""
    return {"params": model.params(),
            "buffers": {name: getattr(model, name)
                        for name in ("centroids", "expert_aabbs", "global_aabb")}}


def sorted_state_dict(tree) -> Any:
    """``to_state_dict`` then ``tree_map``, as ``acn_tpu`` packs ``.model``:
    lists become maps, every map's keys sorted as strings, leaves numpy."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return _numpy(tree)
    return {k: sorted_state_dict(v) for k, v in sorted(items)}


def _group_state_dict(tree, labels, group: str) -> Any:
    """One group's masked parameter tree as a trained optax state holds it:
    dict keys sorted, lists as maps in index order, other groups' leaves {}."""
    if isinstance(labels, dict):
        return {k: _group_state_dict(tree[k], labels[k], group) for k in sorted(labels)}
    if isinstance(labels, (list, tuple)):
        return {str(i): _group_state_dict(t, l, group)
                for i, (t, l) in enumerate(zip(tree, labels))}
    return _numpy(tree) if labels == group else {}


def optim_state_dict(opt_state: Dict[str, Any], optimizer) -> Dict[str, Any]:
    """The port's optimizer state (``utils/optim.Optimizer``) in the
    state-dict form of ``build_optimizer``'s optax state (module docstring)."""
    count = np.asarray(int(opt_state["count"]), np.int32)
    groups = {}
    for g in sorted(optimizer.schedules):
        if optimizer.name == "sgd":
            chain = [{}]
        else:
            chain = [{"count": count,
                      "mu": _group_state_dict(opt_state["mu"], optimizer.labels, g),
                      "nu": _group_state_dict(opt_state["nu"], optimizer.labels, g)}]
            if optimizer.name == "adamw":
                chain.append({})
        chain.append({"count": count})
        groups[g] = {"inner_state": {str(i): c for i, c in enumerate(chain)}}
    sd: Dict[str, Any] = {"inner_states": groups}
    if optimizer.grad_clip is not None:
        sd = {"0": {}, "1": sd}
    if optimizer.guard_nonfinite:
        sd = {"notfinite_count": np.asarray(int(opt_state["notfinite_count"]), np.int32),
              "last_finite": np.asarray(bool(opt_state["last_finite"])),
              "total_notfinite": np.asarray(int(opt_state["total_notfinite"]), np.int32),
              "inner_state": sd}
    return sd


def _tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.array(a)).to(device)


def opt_state_from_dict(sd: Dict[str, Any], optimizer, device=None) -> Dict[str, Any]:
    """The inverse of ``optim_state_dict``: the port's optimizer state on
    ``device`` (``None``: the card), each leaf's moments read from its own
    group's tree."""
    device = resolve_device(device)
    guard = bool(optimizer.guard_nonfinite)
    part = sd["inner_state"] if guard else sd
    if optimizer.grad_clip is not None:
        part = part["1"]
    chains = {g: s["inner_state"] for g, s in part["inner_states"].items()}
    n_chain = {"adam": 2, "adamw": 3, "sgd": 2}[optimizer.name]

    def fits(c):  # the chain's length, its schedule count, its moments
        return (len(c) == n_chain and "count" in c[str(n_chain - 1)]
                and ("mu" in c["0"]) == (optimizer.name != "sgd"))

    counts = ({int(c[str(n_chain - 1)]["count"]) for c in chains.values()}
              if all(fits(c) for c in chains.values()) else set())
    if len(counts) != 1 or set(chains) != set(optimizer.schedules):
        raise ValueError(f"not this optimizer's state ({optimizer.name}): groups "
                         f"{sorted(chains)}, counts {sorted(counts)}")

    def pick(labels, trees):
        if isinstance(labels, dict):
            return {k: pick(l, {g: t[k] for g, t in trees.items()})
                    for k, l in labels.items()}
        if isinstance(labels, (list, tuple)):
            return [pick(l, {g: t[str(i)] for g, t in trees.items()})
                    for i, l in enumerate(labels)]
        return _tensor(trees[labels], device)

    state = {"count": torch.tensor(counts.pop(), dtype=torch.int32, device=device)}
    if optimizer.name != "sgd":
        adam = {g: c["0"] for g, c in chains.items()}
        state.update(mu=pick(optimizer.labels, {g: a["mu"] for g, a in adam.items()}),
                     nu=pick(optimizer.labels, {g: a["nu"] for g, a in adam.items()}))
    if guard:
        state.update(
            notfinite_count=_tensor(np.asarray(sd["notfinite_count"], np.int32), device),
            last_finite=_tensor(np.asarray(sd["last_finite"], bool), device),
            total_notfinite=_tensor(np.asarray(sd["total_notfinite"], np.int32), device))
    return state


def _lists_back(tree) -> Any:
    """A restored state dict with its list maps ({"0": …, "1": …}, keys
    exactly 0..n−1) as lists again: the variables and occupancy trees hold
    no other maps with such keys."""
    if not isinstance(tree, dict):
        return tree
    if tree and set(tree) == {str(i) for i in range(len(tree))}:
        return [_lists_back(tree[str(i)]) for i in range(len(tree))]
    return {k: _lists_back(v) for k, v in tree.items()}


# ------------------------------------------------------------------ files


def _atomic_write(path: Path, data) -> None:
    """Write to ``{name}.tmp``, fsync, then rename: a crash mid-write never
    leaves a truncated file under the final name (a resume keys on
    ``{tag}.model``). ``data`` is bytes or an iterable of byte pieces."""
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        for piece in ([data] if isinstance(data, (bytes, bytearray)) else data):
            f.write(piece)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_checkpoint(
    run_dir,
    tag: str,
    variables,
    opt_state: Optional[Dict[str, Any]] = None,
    occ_states: Optional[Dict[str, Any]] = None,
    P=None,
    step: int = 0,
    best: float = float("-inf"),
    is_best: bool = False,
    optimizer=None,
) -> None:
    """Write the checkpoint ``tag`` into ``run_dir``. ``variables`` is a
    ``Container`` or its ``variables_of`` tree (tensors on any device, or
    numpy); ``opt_state`` needs the ``optimizer`` it belongs to; ``P`` is a
    namespace or its JSON dict. The sidecars land before ``{tag}.model``, so
    a visible tag is complete."""
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    if isinstance(variables, torch.nn.Module):
        variables = variables_of(variables)
    payload = {"variables": variables}
    if occ_states is not None:
        payload["occ_states"] = occ_states

    if opt_state is not None:
        if optimizer is None:
            raise ValueError("saving an optimizer state needs its optimizer")
        _atomic_write(run_dir / f"{tag}.optim", msgpack_tree.iter_packed(
            optim_state_dict(opt_state, optimizer)))
    if P is not None:
        cfg = P if isinstance(P, dict) else namespace_to_jsonable(P)
        _atomic_write(run_dir / f"{tag}.P.json", json.dumps(cfg, indent=2).encode())
    _atomic_write(run_dir / f"{tag}.configs.json", json.dumps(
        {"step": int(step), "best": float(best), "is_best": bool(is_best)}).encode())
    _atomic_write(run_dir / f"{tag}.model",
                  msgpack_tree.iter_packed(sorted_state_dict(payload)))


def _read(path: Path) -> Any:
    with open(path, "rb") as f:
        return msgpack_tree.unpackb(f.read())


def load_checkpoint(run_dir, tag: str = "best") -> Dict[str, Any]:
    """{variables, occ_states (or None), step, best}, the trees as state
    dicts of numpy arrays (lists as maps), as ``acn_tpu`` returns them."""
    run_dir = Path(run_dir)
    payload = _read(run_dir / f"{tag}.model")
    out = {"variables": payload["variables"], "occ_states": payload.get("occ_states"),
           "step": 0, "best": float("-inf")}
    cfg_path = run_dir / f"{tag}.configs.json"
    if cfg_path.exists():
        with open(cfg_path) as f:
            c = json.load(f)
        out["step"] = int(c.get("step", 0))
        out["best"] = float(c.get("best", float("-inf")))
    return out


def restore_model(payload: Dict[str, Any], cfg, device=None):
    """(``Container`` on ``device`` (``None``: the card), stacked occupancy
    states as tensors or None) from ``load_checkpoint``'s payload."""
    from acn_tpu_torch import convert

    device = resolve_device(device)
    model = convert.from_jax_variables(_lists_back(payload["variables"]), cfg, device)
    occ = payload.get("occ_states")
    return model, (None if occ is None else convert.from_jax_occ_states(occ, device))


def fallback_tags(run_dir, tag: str):
    """Resume candidates in ``run_dir``, best first: ``tag``, then 'last',
    then step{N} from the newest, then 'best' (those with a ``.model``)."""
    run_dir = Path(run_dir)
    steps = sorted((int(p.stem[4:]) for p in run_dir.glob("step*.model")
                    if p.stem[4:].isdigit()), reverse=True)
    out = []
    for t in [tag, "last"] + [f"step{s}" for s in steps] + ["best"]:
        if t not in out and (run_dir / f"{t}.model").exists():
            out.append(t)
    return out


def load_checkpoint_with_fallback(run_dir, tag: str = "best"):
    """``load_checkpoint`` that falls back to the next candidate of
    ``fallback_tags`` when one is unreadable. Returns (payload, tag used)."""
    errors = []
    for t in fallback_tags(run_dir, tag):
        try:
            return load_checkpoint(run_dir, t), t
        except Exception as e:
            errors.append(f"{t}: {e}")
    raise FileNotFoundError(f"No readable checkpoint under {run_dir} (tried {errors or [tag]})")


def load_opt_state(run_dir, tag: str, template: Dict[str, Any], optimizer) -> Dict[str, Any]:
    """The optimizer state saved under ``tag``, on the device of
    ``template`` (``optimizer.init(params)``); the template itself when the
    tag has no ``.optim``."""
    p = Path(run_dir) / f"{tag}.optim"
    if not p.exists():
        return template
    return opt_state_from_dict(_read(p), optimizer, device=template["count"].device)


def _contains_model_files(d: Path) -> bool:
    return d.is_dir() and any(f.suffix == ".model" for f in d.iterdir() if f.is_file())


def resolve_checkpoint_dir(value: str, logs_root: str = "logs") -> str:
    """The run directory of a checkpoint given as a path or as a name under
    ``logs_root``: descend into the last sub-directory (by name) until one
    holds ``*.model`` files."""
    p = Path(value)
    if not p.exists():
        p = Path(logs_root) / value
    if not p.exists() or not p.is_dir():
        raise FileNotFoundError(
            f"Checkpoint path not found: '{value}' (or '{Path(logs_root) / value}')")
    cur = p
    for _ in range(8):
        if _contains_model_files(cur):
            return str(cur.resolve())
        subdirs = sorted((d for d in cur.iterdir() if d.is_dir()), key=lambda x: x.name)
        if not subdirs:
            break
        cur = subdirs[-1]
    raise FileNotFoundError(f"No '*.model' checkpoints found under: {p}")


# ------------------------------------------------------------------ async


class AsyncCheckpointer:
    """Checkpoint saves off the training path.

    ``save`` clones the tensors on their device, on the current (training)
    stream, which takes well under a millisecond for the full-width state;
    a daemon worker then copies the clones to the host on a stream of its
    own (after an event that marks the clones done), packs and writes them.
    Saves run in order; a newer save under the same key (the tag, or
    ``coalesce_key``) replaces one not yet started, so at most one snapshot
    per key waits."""

    def __init__(self):
        self._pending: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._by_key: Dict[str, dict] = {}
        self._stream = None
        self.errors = []
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="checkpoint-writer")
        self._thread.start()

    def _worker(self):
        while True:
            key = self._pending.get()
            try:
                with self._lock:
                    job = self._by_key.pop(key, None)
                if job is not None:
                    self._write(job)
            except Exception as e:  # never kill training
                self.errors.append(f"{key}: {e}")
                print(f"[ckpt] async save '{key}' failed: {e}", flush=True)
            finally:
                self._pending.task_done()

    def _write(self, job: dict) -> None:
        ready = job.pop("ready")
        if ready is None:
            save_checkpoint(**job)
            return
        event, device = ready
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=device)
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(event)
            host = {k: tree_map(lambda t: t.cpu() if isinstance(t, torch.Tensor) else t,
                                job[k]) if job[k] is not None else None
                    for k in ("variables", "opt_state", "occ_states")}
        save_checkpoint(**{**job, **host})

    def save(self, run_dir, tag: str, variables, opt_state=None, occ_states=None,
             P=None, step: int = 0, best: float = float("-inf"),
             is_best: bool = False, coalesce_key: Optional[str] = None,
             optimizer=None) -> None:
        if isinstance(variables, torch.nn.Module):
            variables = variables_of(variables)
        snap = lambda t: None if t is None else tree_map(
            lambda x: x.detach().clone() if isinstance(x, torch.Tensor) else x, t)
        try:
            job = dict(run_dir=run_dir, tag=tag, variables=snap(variables),
                       opt_state=snap(opt_state), occ_states=snap(occ_states),
                       P=None if P is None else namespace_to_jsonable(P),
                       step=step, best=best, is_best=is_best, optimizer=optimizer)
        except torch.cuda.OutOfMemoryError as e:  # skip the save, keep training
            print(f"[ckpt] snapshot for '{tag}' failed ({e}); skipping save", flush=True)
            return
        first = next(iter(job["variables"]["buffers"].values()))
        job["ready"] = None
        if first.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
            job["ready"] = (event, first.device)
        key = f"{run_dir}/{coalesce_key or tag}"
        with self._lock:
            fresh = key not in self._by_key
            self._by_key[key] = job  # the latest wins
        if fresh:
            self._pending.put(key)

    def wait(self) -> None:
        """Block until every queued save is on disk."""
        self._pending.join()
