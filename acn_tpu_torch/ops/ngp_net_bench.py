"""Inputs, clocks and bounds for timing the NGP network kernel
(``ops/ngp_net.py``) on one CUDA card: what ``scripts/bench_ngp_net.py`` and
phase 15 of ``chip_smoke.py`` share.

* Config: ``toy.train_occ_config``'s expert (hash features L·F = 32, σ
  trunk 64 wide and 2 deep, colour MLP 64 wide and 2 deep, SH of 4 levels)
  and its 4 quadrant experts, or (``name``) one of ``toy.FLAG_SETS``'
  configurations over it, with ``toy.expert_layout``'s experts; layer
  weights from torch's Linear init (seed), hash features N(0, 1).
* Point sets: ``random``, points uniform in the scene box with directions
  N(0, 1), one row in 97 a zero direction; ``rays``, the packed samples of
  the dense frame's budget march (the union of the experts' grids over the
  global box, 32 a ray) of toy's overhead 1080p camera over toy's 10 %
  grids, ray-major as the network gets them: the chunk of rows 800–815
  (30,720 rays, 983,040 slots) and 1,024 rays drawn from the whole frame
  (32,768 slots). Routing weights from ``container.routing_weights`` at the
  config's boundary margin (1.05).
* Clocks: ``ops/hashgrid_bench.py``'s: card ms per call as a run of calls
  between one pair of CUDA events after a spin kernel, cycling over copies
  of the inputs that span 4 × the L2; host µs per call apart.
* Bounds: the larger of the operations and the bytes. Operations: 2 ×
  the multiply-adds of each (point, expert) the data needs (every point in
  ``single``; in the blends the pairs whose routing weight is not 0), done
  as the kernel does them: three TF32 products a multiply-add (3xTF32) at
  495 TFLOP/s (``ops_bound_ms``, the bound). The same flops once at 67
  TFLOP/s f32 outside the tensor cores (``f32_fma_bound_ms``) are kept
  beside it, the bound of an f32 FMA design. Bytes, each input once (those
  pairs' features, d, w, the layer weights) and each output once, over
  3.35 TB/s.
* Yardstick (``library``): no single PyTorch call computes the network;
  the chain of cuBLAS ``mm`` calls that the plain version issues, alone, on
  inputs of the same shapes, is the nearest library figure, timed in full
  f32 (``library_ms``) and with TF32 allowed (``library_tf32_ms``; the
  setting is restored after: the port never multiplies in TF32).

The plain network is timed through the primitives every tree of the port
has (``nn.apply_mlp``, ``nn.apply_linear``, ``trunc_exp``,
``ngp.ngp_color``), so with an older tree first on ``PYTHONPATH`` it times
that tree's plain network; the kernel only where ``ops/ngp_net.py`` exists.
"""

from __future__ import annotations

import torch

from acn_tpu_torch import toy
from acn_tpu_torch.models import container as cont
from acn_tpu_torch.models import nn
from acn_tpu_torch.models.ngp import ngp_color
from acn_tpu_torch.models.trunc_exp import trunc_exp
from acn_tpu_torch.ops import hashgrid_bench as hb

F32_OPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
TF32_OPS_PER_S = 495e12  # H100 SXM, dense TF32 on the tensor cores
TF32_PRODUCTS = 3  # 3xTF32: the TF32 products the kernel takes a multiply-add
MODES = ("single", "sigma_blend", "linear_blend", "density")
SETS = ("random", "rays")
SIZES = (983_040, 32_768)  # a dense serving chunk; a support march
ROUTED_P = 4_000_000  # a routed chunk (chunk_points), one expert


def config(name: str = "smoke"):
    """(the container config, the expert config) of the smoke's model, or
    of a ``toy.FLAG_SETS`` configuration over it."""
    cfg = toy.train_occ_config()[0]
    if name != "smoke":
        cfg = toy.flag_config(cfg, **toy.FLAG_SETS[name])
    return cfg, cfg.expert


def macs(ecfg) -> int:
    """Multiply-adds of one (point, expert): every layer's in × out."""
    dims = ([ecfg.hash.out_dim] + [ecfg.hidden] * ecfg.sigma_depth)
    trunk = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    cdims = ([ecfg.geo_feat_dim + ecfg.dir_enc_dim] + [ecfg.color_hidden] * ecfg.color_depth
             + [3])
    color = sum(a * b for a, b in zip(cdims[:-1], cdims[1:]))
    return trunk + ecfg.hidden * (1 + ecfg.geo_feat_dim) + color


def density_macs(ecfg) -> int:
    dims = ([ecfg.hash.out_dim] + [ecfg.hidden] * ecfg.sigma_depth)
    return sum(a * b for a, b in zip(dims[:-1], dims[1:])) + ecfg.hidden


def n_params(ecfg, mode: str) -> int:
    p = density_macs(ecfg) + ecfg.hidden * ecfg.sigma_depth + 1  # weights + biases
    if mode != "density":
        p += (macs(ecfg) - density_macs(ecfg)) + ecfg.geo_feat_dim \
            + ecfg.color_hidden * ecfg.color_depth + 3
    return p


def net_params(ecfg, K: int, seed: int, device="cuda") -> list:
    """K experts' layer weights (torch's Linear init from ``seed``, the σ
    head's bias −1 as ``init_ngp`` sets it), no hash tables."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(K):
        p = {"sigma_trunk": nn.init_mlp([ecfg.hash.out_dim] + [ecfg.hidden] * ecfg.sigma_depth,
                                        generator=gen),
             "sigma_head": nn.init_linear(ecfg.hidden, 1, generator=gen),
             "geo_head": nn.init_linear(ecfg.hidden, ecfg.geo_feat_dim, generator=gen),
             "color_mlp": nn.init_mlp([ecfg.geo_feat_dim + ecfg.dir_enc_dim]
                                      + [ecfg.color_hidden] * ecfg.color_depth + [3],
                                      generator=gen)}
        p["sigma_head"]["b"] = torch.full_like(p["sigma_head"]["b"], -1.0)
        out.append(nn.tree_map(lambda t: t.to(device), p))
    return out


def random_xd(P: int, gen: torch.Generator) -> torch.Tensor:
    lo = torch.from_numpy(toy.SCENE_AABB[0]).to(gen.device)
    hi = torch.from_numpy(toy.SCENE_AABB[1]).to(gen.device)
    x = lo + (hi - lo) * torch.rand((P, 3), generator=gen, device=gen.device)
    d = torch.randn((P, 3), generator=gen, device=gen.device)
    d[::97] = 0.0
    return torch.cat([x, d], dim=1)


def inputs(set_name: str, P: int, K: int, gen: torch.Generator, name: str = "smoke"):
    """(h (K, P, L·F), xd (P, 6), w (P, K)) of a point set on the card."""
    cfg, ecfg = config(name)
    if set_name == "random":
        xd = random_xd(P, gen)
    else:
        xd = hb.budget_march(None if P == SIZES[0] else hb.SUPPORT_RAYS)[0]["xd"].contiguous()
        assert xd.shape[0] == P, (set_name, xd.shape)
    cents = torch.from_numpy(toy.expert_layout(cfg.num_submodules)[1]).to(xd.device)
    w = cont.routing_weights(cents[:K], xd[:, :3], cfg.cluster_2d, cfg.boundary_margin)
    h = torch.randn((K, P, ecfg.hash.out_dim), generator=gen, device=xd.device)
    return h, xd, w.contiguous()


def plain_network(mode, h, d, w, experts, ecfg):
    """The plain network from the primitives every tree has (module
    docstring); what ``ngp_net_plain`` computes."""
    def density(p, hk, feats):
        t = nn.apply_mlp(p["sigma_trunk"], hk, activation="relu", final_activation="relu")
        s = trunc_exp(nn.apply_linear(p["sigma_head"], t))
        return (s, nn.apply_linear(p["geo_head"], t)) if feats else s

    def forward(p, hk):
        s, g = density(p, hk, True)
        return torch.cat([ngp_color(p, ecfg, d, g), s], dim=-1)

    if mode == "single":
        return forward(experts[0], h[0])
    if mode == "density":
        sig = torch.stack([density(p, h[k], False)[..., 0] for k, p in enumerate(experts)])
        return torch.einsum("nk,kn->n", w, sig)
    ys = torch.stack([forward(p, h[k]) for k, p in enumerate(experts)], dim=1)  # (P, K, 4)
    if mode == "linear_blend":
        return torch.einsum("nk,nko->no", w, ys)
    SIG, RGB = ys[..., 3], ys[..., :3]
    s_num = torch.clamp(torch.sum(w * SIG, dim=1, keepdim=True), min=1e-12)
    return s_num[:, 0], torch.sum(w[..., None] * SIG[..., None] * RGB, dim=1) / s_num


def mm_chain(mode, P, K, ecfg, gen):
    """The cuBLAS ``mm`` calls of the plain version on inputs of the same
    shapes (a callable, timing only)."""
    L, Hd, CH = ecfg.hash.out_dim, ecfg.hidden, ecfg.color_hidden
    shapes = [(L if l == 0 else Hd, Hd) for l in range(ecfg.sigma_depth)] + [(Hd, 1)]
    if mode != "density":
        shapes += [(Hd, ecfg.geo_feat_dim)] + [
            (ecfg.geo_feat_dim + ecfg.dir_enc_dim if c == 0 else CH, CH)
            for c in range(ecfg.color_depth)] + [(CH, 3)]
    ops = [(torch.randn((P, a), generator=gen, device="cuda"),
            torch.randn((a, b), generator=gen, device="cuda")) for a, b in shapes]
    n = 1 if mode == "single" else K

    def run():
        for _ in range(n):
            for x, wt in ops:
                torch.mm(x, wt)
    return run


def pairs(mode: str, w: torch.Tensor, P: int) -> int:
    """(point, expert) evaluations the data needs."""
    return P if mode == "single" else int((w != 0).sum())


def bounds_ms(mode, P, K, w, ecfg) -> dict:
    n = pairs(mode, w, P)
    flops = 2 * n * (density_macs(ecfg) if mode == "density" else macs(ecfg))
    L = ecfg.hash.out_dim
    byts = 4 * (n * L + K * n_params(ecfg, mode))
    if mode != "density":
        byts += 12 * P
    if mode != "single":
        byts += 4 * P * K
    byts += 4 * P * (1 if mode == "density" else 4)
    ops_ms = 1e3 * TF32_PRODUCTS * flops / TF32_OPS_PER_S
    bytes_ms = 1e3 * byts / hb.HBM_BYTES_PER_S
    return {"pairs": n, "flops": flops, "bytes": byts, "ops_bound_ms": ops_ms,
            "f32_fma_bound_ms": 1e3 * flops / F32_OPS_PER_S,
            "bytes_bound_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def call_args(mode, h, xd, w, experts):
    """(h, d, w, experts) as ``mode`` takes them: one expert (the first)
    for ``single``, all K with their weights for the blends."""
    if mode == "single":
        return h[:1], xd[:, 3:6], None, experts[:1]
    return h, (None if mode == "density" else xd[:, 3:6]), w, experts


def time_case(mode, set_name, P, gen, experts, plain: bool = True, kernel=None,
              ins=None, name: str = "smoke") -> dict:
    """Card ms per call of the kernel (``kernel``: ``ngp_net_kernel``, or
    None on a tree without it), the plain network and the ``mm`` chain at
    one (mode, point set, P) of config ``name``, on ``ins`` (``inputs``'
    (h, xd, w)) or new inputs; the bounds; the kernel's host µs."""
    cfg, ecfg = config(name)
    K = len(experts)
    h, xd, w = ins if ins is not None else inputs(set_name, P, K, gen, name)
    hh, d, ww, ee = call_args(mode, h, xd, w, experts)
    kk = 1 if mode == "single" else K
    work = 4 * P * (kk * ecfg.hash.out_dim + 6 + K)
    copies = hb.copies_for(work)
    clone = lambda t: None if t is None else t.clone()
    runs = [(hh, d, ww)] + [(hh.clone(), clone(d), clone(ww)) for _ in range(copies - 1)]
    row = {"config": name, "mode": mode, "set": set_name, "P": P, "K": kk, "copies": copies,
           **bounds_ms(mode, P, kk, w if ww is not None else w[:, :1], ecfg)}
    if kernel is not None:
        row["ms"] = hb.device_ms([lambda a=a: kernel(mode, a[0], a[1], a[2], ee, ecfg)
                                  for a in runs])
        row["host_us"] = hb.host_us(lambda: kernel(mode, hh, d, ww, ee, ecfg), 50)
    if plain:
        row["plain_ms"] = hb.device_ms([lambda a=a: plain_network(mode, a[0], a[1], a[2], ee,
                                                                  ecfg) for a in runs])
        chain = mm_chain(mode, P, kk, ecfg, gen)
        row["library_ms"] = hb.device_ms(chain)
        allowed = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            row["library_tf32_ms"] = hb.device_ms(chain)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = allowed
    del runs
    return row
