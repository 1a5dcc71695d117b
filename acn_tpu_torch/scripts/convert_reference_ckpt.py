"""Convert a reference (psklavos1/adaptive-city-nerf) torch checkpoint into
the port's checkpoint format, which ``acn_tpu`` reads too.

    python -m acn_tpu_torch.scripts.convert_reference_ckpt --src <ref run dir>
        --prefix best --dst logs/converted [--data_path data/drz/]
        [--data_dirname example] [--mask_dirname g22_grid_bm110_ss11]

Port of ``acn_tpu/scripts/convert_reference_ckpt.py``. The reference
releases a 4-expert checkpoint whose ``{tag}.model`` is a torch
``state_dict`` of its ``MetaContainer`` and whose ``{tag}.P`` is
``vars(P)``. Key mapping (reference module tree → the port's ``Container``):

    submodules.{k}.xyz_encoder.hash_table        → experts.hash_table (corner layout)
    submodules.{k}.xyz_encoder._tcnn_enc.params  → (a tcnn blob, de-interleaved per level)
    submodules.{k}.sigma_trunk.{i}.linear.weight → experts.sigma_trunk[i].w (transposed)
    submodules.{k}.sigma_head.weight/bias        → experts.sigma_head.w/.b
    submodules.{k}.geo_head.weight/bias          → experts.geo_head.w/.b
    submodules.{k}.color_mlp.{i}.linear.*        → experts.color_mlp[i].*
    submodules.{k}.color_mlp.{n}.weight/bias     → experts.color_mlp[-1].*  (final MetaLinear)
    bg_mlp.{0,2}.weight/bias                     → bg_mlp[0, 1].w/.b
    centroids (buffer)                           → centroids

``nn.Linear`` stores (out, in); the port's layers hold (in, out): transposed.
A layer without a bias in the state dict has none in the result, and a state
dict without ``bg_mlp.0.weight`` gives a model without a background head,
as in ``acn_tpu``.

Leaves the state dict does not overwrite, taken from the template model (the
dataset's ``masks/<mask_dirname>`` boxes and centroids, weights from a
seeded generator): ``expert_aabbs`` and ``global_aabb`` always (they come
from ``scene_boxes.pt``), ``centroids`` when the state dict has no
``centroids``. These are the only leaves that may differ from
``acn_tpu``'s conversion, whose template is drawn from a JAX key; both take
the buffers from the same files, so on a complete state dict the two
outputs are equal leaf for leaf.

Hash tables: the reference's torch fallback encoder holds one
``(levels·2^log2, F)`` parameter that maps one to one onto the corner
layout (the same three-prime XOR hash): convert with the corner layout, as
``main`` does. A tcnn blob is de-interleaved assuming tcnn's level-major
layout with per-level sizes ``next_multiple(min(2^log2, (res+1)^3), 8)``;
its dense levels are re-hashed into the table, collisions resolved last
wins (an approximate parity, as in ``acn_tpu``).

The released checkpoint is not in this repository; the tests and
``chip_smoke.py`` convert state dicts that ``to_reference_state_dict``
builds from a model.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from acn_tpu_torch import convert
from acn_tpu_torch.models.container import Container, init_container


def _t2n(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t,
                      np.float32)


def _expert_from_sd(sd: Dict[str, Any], k: int, template: Dict[str, Any],
                    hash_cfg) -> Dict[str, Any]:
    """One expert's parameter tree (numpy) from the reference's keys; the
    template gives the layer counts."""
    p = f"submodules.{k}."
    out: Dict[str, Any] = {}

    fallback_key = p + "xyz_encoder.hash_table"
    tcnn_key = p + "xyz_encoder._tcnn_enc.params"
    if fallback_key in sd:
        out["hash_table"] = _t2n(sd[fallback_key])
    elif tcnn_key in sd:
        out["hash_table"] = _tcnn_blob_to_corner(_t2n(sd[tcnn_key]), hash_cfg)
    else:
        raise KeyError(f"no hash table for expert {k}")

    def linear(prefix):
        d = {"w": _t2n(sd[prefix + ".weight"]).T}  # (in, out)
        if prefix + ".bias" in sd:
            d["b"] = _t2n(sd[prefix + ".bias"])
        return d

    n_trunk = len(template["sigma_trunk"])
    out["sigma_trunk"] = [linear(p + f"sigma_trunk.{i}.linear") for i in range(n_trunk)]
    out["sigma_head"] = linear(p + "sigma_head")
    out["geo_head"] = linear(p + "geo_head")
    n_color = len(template["color_mlp"])
    color = [linear(p + f"color_mlp.{i}.linear") for i in range(n_color - 1)]
    color.append(linear(p + f"color_mlp.{n_color - 1}"))  # final MetaLinear
    out["color_mlp"] = color
    return out


def _tcnn_blob_to_corner(blob: np.ndarray, cfg) -> np.ndarray:
    """A tcnn HashGrid parameter blob as the corner layout's (levels·2^log2,
    F) table. Hashed tcnn levels copy verbatim (tcnn uses the same spatial
    hash); dense levels are re-hashed (approximate under collisions)."""
    F = cfg.features_per_level
    T = 2 ** cfg.log2_hashmap_size
    res = cfg.level_resolutions()
    out = np.zeros((cfg.levels * T, F), np.float32)
    off = 0
    for l in range(cfg.levels):
        n_dense = (int(res[l]) + 1) ** 3
        n = min(T, n_dense)
        n_aligned = -(-n // 8) * 8
        level = blob[off * F : (off + n) * F].reshape(n, F)
        if n == T:
            out[l * T : (l + 1) * T] = level
        else:
            # dense level: index (x + r(y + r z)) → re-hashed into the table
            r = int(res[l]) + 1
            ix, iy, iz = np.meshgrid(
                np.arange(r), np.arange(r), np.arange(r), indexing="ij"
            )
            coords = np.stack(
                [ix.ravel(), iy.ravel(), iz.ravel()], -1
            ).astype(np.uint32)[:n]
            primes = np.array([1, 2654435761, 805459861], np.uint32)
            h = (
                coords[:, 0] * primes[0]
                ^ coords[:, 1] * primes[1]
                ^ coords[:, 2] * primes[2]
            ) & np.uint32(T - 1)
            out[l * T + h.astype(np.int64)] = level
        off += n_aligned
    return out


def reference_state_dict_to_variables(sd: Dict[str, Any], cfg,
                                      template: Container) -> Container:
    """A reference ``MetaContainer`` state dict as the port's ``Container``
    (on the CPU), the experts stacked along K. ``template`` gives the
    structure and the leaves the state dict does not hold (module
    docstring)."""
    experts = [_expert_from_sd(sd, k, template.expert(0), cfg.expert.hash)
               for k in range(cfg.num_submodules)]

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {n: stack(*(x[n] for x in xs)) for n in xs[0]}
        if isinstance(xs[0], list):
            return [stack(*ls) for ls in zip(*xs)]
        return np.stack(xs)

    params: Dict[str, Any] = {"experts": stack(*experts)}
    if "bg_mlp.0.weight" in sd:
        params["bg_mlp"] = [
            {"w": _t2n(sd["bg_mlp.0.weight"]).T, "b": _t2n(sd["bg_mlp.0.bias"])},
            {"w": _t2n(sd["bg_mlp.2.weight"]).T, "b": _t2n(sd["bg_mlp.2.bias"])},
        ]
    buffers = {name: _t2n(getattr(template, name))
               for name in ("centroids", "expert_aabbs", "global_aabb")}
    if "centroids" in sd:
        buffers["centroids"] = _t2n(sd["centroids"])
    return convert.from_jax_variables({"params": params, "buffers": buffers}, cfg, "cpu")


def to_reference_state_dict(model: Container) -> Dict[str, torch.Tensor]:
    """The inverse mapping: a corner-layout ``Container`` as a reference
    ``MetaContainer`` state dict (CPU tensors), the form the reference
    saves."""
    t = lambda x: x.detach().cpu().clone()
    sd = {}
    for k in range(model.cfg.num_submodules):
        e = model.expert(k)
        p = f"submodules.{k}."
        sd[p + "xyz_encoder.hash_table"] = t(e["hash_table"])
        for i, lin in enumerate(e["sigma_trunk"]):
            sd[p + f"sigma_trunk.{i}.linear.weight"] = t(lin["w"].T)
            sd[p + f"sigma_trunk.{i}.linear.bias"] = t(lin["b"])
        for name in ("sigma_head", "geo_head"):
            sd[p + f"{name}.weight"] = t(e[name]["w"].T)
            sd[p + f"{name}.bias"] = t(e[name]["b"])
        n = len(e["color_mlp"])
        for i, lin in enumerate(e["color_mlp"][:-1]):
            sd[p + f"color_mlp.{i}.linear.weight"] = t(lin["w"].T)
            sd[p + f"color_mlp.{i}.linear.bias"] = t(lin["b"])
        sd[p + f"color_mlp.{n - 1}.weight"] = t(e["color_mlp"][-1]["w"].T)
        sd[p + f"color_mlp.{n - 1}.bias"] = t(e["color_mlp"][-1]["b"])
    if model.bg_mlp is not None:
        bg = model.params()["bg_mlp"]
        for i, lin in zip((0, 2), bg):
            sd[f"bg_mlp.{i}.weight"] = t(lin["w"].T)
            sd[f"bg_mlp.{i}.bias"] = t(lin["b"])
    sd["centroids"] = t(model.centroids)
    return sd


def ours_from_reference_P(p_ns, data_path, data_dirname, mask_dirname):
    """The port's eval namespace for the reference's pinned architecture
    (``{prefix}.P``), in the corner layout."""
    from acn_tpu_torch.utils.config import parse_args

    return parse_args([
        "--op", "eval",
        "--data_path", str(data_path),
        "--data_dirname", data_dirname,
        "--mask_dirname", mask_dirname,
        "--hash_layout", "corner",
        "--num_submodules", str(int(getattr(p_ns, "num_submodules", 4))),
        "--sigma_depth", str(int(getattr(p_ns, "sigma_depth", 2))),
        "--color_depth", str(int(getattr(p_ns, "color_depth", 2))),
        "--dim_hidden", str(int(getattr(p_ns, "dim_hidden", 64))),
        "--color_hidden", str(int(getattr(p_ns, "color_hidden", 64))),
        "--log2_hashmap_size", str(int(getattr(p_ns, "log2_hashmap_size", 20))),
        "--checkpoint_path", "",
        "--fname", "converted",
    ])


def template_model(P, seed: int = 0):
    """(model config, a ``Container`` on the CPU) for namespace ``P`` over
    its dataset's masks: the boxes and centroids from ``scene_boxes.pt`` and
    ``params.pt``, weights from a generator seeded with ``seed``."""
    from acn_tpu_torch.data.dataset import load_clustering_meta, load_scene_boxes
    from acn_tpu_torch.runner import build_model_configs

    mask_dir = Path(P.data_path) / "out" / P.data_dirname / "masks" / P.mask_dirname
    clustering = load_clustering_meta(mask_dir)
    gaabb, eaabbs = load_scene_boxes(mask_dir)
    cfg = build_model_configs(P, clustering)
    model = init_container(cfg, torch.from_numpy(clustering["centroids"]),
                           torch.from_numpy(eaabbs), torch.from_numpy(gaabb),
                           generator=torch.Generator().manual_seed(seed))
    return cfg, model


def main(argv=None):
    from acn_tpu_torch.utils.checkpoint import save_checkpoint

    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True, help="reference run dir")
    ap.add_argument("--prefix", default="best")
    ap.add_argument("--dst", required=True, help="output run dir")
    ap.add_argument("--data_path", default="data/drz/")
    ap.add_argument("--data_dirname", default="example")
    ap.add_argument("--mask_dirname", default="g22_grid_bm110_ss11")
    args = ap.parse_args(argv)

    src = Path(args.src)
    sd = torch.load(src / f"{args.prefix}.model", map_location="cpu", weights_only=True)
    # the reference saves torch.save(vars(P)): a dict, read as a namespace
    p_raw = torch.load(src / f"{args.prefix}.P", map_location="cpu", weights_only=False)
    p_ns = argparse.Namespace(**p_raw) if isinstance(p_raw, dict) else p_raw
    ours = ours_from_reference_P(p_ns, args.data_path, args.data_dirname, args.mask_dirname)
    cfg, template = template_model(ours)
    model = reference_state_dict_to_variables(sd, cfg, template)
    save_checkpoint(args.dst, args.prefix, model, P=ours, step=0)
    print(f"converted {src}/{args.prefix}.model → {args.dst}/{args.prefix}.model "
          f"(hash_layout=corner; eval with --hash_layout corner)")


if __name__ == "__main__":
    main()
