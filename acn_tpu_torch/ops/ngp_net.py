"""The Instant-NGP expert's network after the hash encode, and the
container's blend over experts: a CUDA kernel and its plain version.

Per point, from the expert's hash features h (L·F values) and the view
direction d:

    t     = relu(... relu(h W_0 + b_0) ... W_{D-1} + b_{D-1})    σ trunk
    σ     = trunc_exp(t w_σ + b_σ)                               σ head
    g     = t W_g + b_g                                          geo head (15)
    c     = sigmoid(color_mlp([g, enc(d / |d|)]))                colour

with enc the spherical harmonics of ``sh_levels`` levels or the frequency
encoding (``enc_dir``, ``acn_tpu``'s ``_enc_dir``). The kernel has four modes, one
for each way the port combines experts:

* ``single``: one expert, (P, 4) [rgb, σ] (``container_forward`` with
  ``active_module``, ``ngp_forward``);
* ``sigma_blend``: σ_mix = max(Σ_k w_k σ_k, 1e-12) and
  rgb_mix = Σ_k w_k σ_k c_k / σ_mix (``render_occ._soft_moe_eval``);
* ``linear_blend``: Σ_k w_k [c_k, σ_k] (``container_forward`` without
  ``active_module``);
* ``density``: σ of one expert, or Σ_k w_k σ_k (``ngp_density``,
  ``container_density``).

The JAX package wrote no TPU kernel for this: it is plain XLA there
(``acn_tpu/models/ngp.py:112-156``, ``acn_tpu/models/nn.py:44-85`` under
``jax.vmap`` in ``acn_tpu/nerfs/render_occ.py:147-168`` and
``acn_tpu/models/container.py:181,221``). Here it is one hand-written CUDA
kernel for ``sm_90a`` (``csrc/ngp_net.cu``, built by ``ops/cuda_lib.py``
and called through ``ctypes``; the source has the design and its bound),
templated on the mode. Its layer products run on the tensor cores in
3xTF32 (each f32 operand split into two TF32 parts, three products a
multiply-add): within ≈ 1e-7 of a full f32 product, the tolerance of the
plain f32 network unchanged. Each expert runs only on the points whose
routing weight is not 0. The routing weights w (P, K) come from the plain
``container.routing_weights``; the K hash encodes write into one (K, P, L·F)
buffer (``hash_encode(..., out=)``), which the kernel reads at a stride.

It takes every expert configuration ``acn_tpu`` accepts: any number of
experts, widths and depths, hash features and direction encodings (only
``geo_feat_dim`` 15 and SH levels 1 to 5, which no flag changes, are
fixed). Networks up to 128 wide run in two width classes, one launch a
call. Wider ones take the kernel's wide path, two launches a call: the
split kernel writes every expert's weights, split into their TF32 parts,
into a device buffer the wrapper allocates (``wide_bytes``), and the
network kernel (``wgmma`` on 64-point tiles, the activations in shared
memory) reads them; a network wider than 256, whose activations do not
fit on chip, keeps them in a scratch part of the same buffer. Nothing is
kept across calls, so a weight updated in place is seen by the next call.
``wide_split_plain`` is the split's plain version, ``wide_split_kernel``
the split launch alone. The experts' layer pointers are a device table
(``cuda_lib.device_table``), kept while they repeat.

The plain version (``ngp_net_plain``) is the composition the port ran
before the kernel: ``apply_mlp``, ``trunc_exp``, the direction encoding,
``torch.cat`` and the three blends. ``models/ngp.py`` takes its pieces
(``features_density``, ``features_color``, ``features_forward``) from here,
so both share one definition.

Dispatch. By device: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel or raises. By need of a gradient: ``models/ngp.py``,
``models/container.py`` and ``nerfs/render_occ.py`` call ``ngp_net`` only
where ``takes(x)`` holds: no gradient is being recorded
(``torch.is_grad_enabled()`` false, as under every serving entry point's
``torch.no_grad``) and the points are float32. The kernel has no backward
yet: under autograd (training steps, TTO steps) the differentiable
composition runs as before, and so does the bf16 of a training step's AMP,
whose evaluations under ``no_grad`` (Reptile's query loss, the eval step)
are part of training.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from acn_tpu_torch.models import nn
from acn_tpu_torch.models.encodings import frequency_encode, sh_encode
from acn_tpu_torch.models.trunc_exp import trunc_exp
from acn_tpu_torch.ops import cuda_lib
from acn_tpu_torch.ops.hashgrid import _on_stream

MODES = ("single", "sigma_blend", "linear_blend", "density")
# csrc/ngp_net.cu's constants, checked when it is loaded
GEO = 15  # geo_feat_dim (build_model_configs fixes it)
MAX_SH_LEVELS = 5  # what sh_encode takes
CLASS_WIDTH = 128  # wider networks take the wide path
DIR_KINDS = ("spherical", "frequency")

# ================================================================ plain


def enc_dir(cfg, d: torch.Tensor) -> torch.Tensor:
    """The direction encoding of ``acn_tpu``'s ``_enc_dir``: d normalized
    (norm clamped at 1e-9), then SH (which normalizes again) or the
    frequency encoding (cos before sin, no π)."""
    d = d / torch.clamp(nn.norm3(d), min=1e-9)
    if cfg.dir_encoding == "spherical":
        return sh_encode(d, cfg.sh_levels)
    return frequency_encode(d, cfg.freq_pe_dim, include_input=True, use_pi=False)


def features_density(params, h: torch.Tensor, return_feats: bool = False):
    """σ (..., 1) from hash features h (..., L·F), and optionally the geo
    features: the σ trunk (ReLU on every layer), the σ head through
    ``trunc_exp``, the geo head."""
    t = nn.apply_mlp(params["sigma_trunk"], h, activation="relu", final_activation="relu")
    sigma = trunc_exp(nn.apply_linear(params["sigma_head"], t))
    if not return_feats:
        return sigma
    return {"sigma": sigma, "geo_feat": nn.apply_linear(params["geo_head"], t)}


def features_color(params, cfg, d: torch.Tensor, geo_feat: torch.Tensor) -> torch.Tensor:
    """View-dependent RGB from [geo features, direction encoding]."""
    d_enc = enc_dir(cfg, d).to(geo_feat.dtype)
    h = torch.cat([geo_feat, d_enc], dim=-1)
    rgb = nn.apply_mlp(params["color_mlp"], h, activation="relu")
    return torch.sigmoid(rgb) if cfg.use_sigmoid_rgb else rgb


def features_forward(params, cfg, h: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(..., 4) [rgb, σ] from hash features and view directions."""
    out = features_density(params, h, return_feats=True)
    rgb = features_color(params, cfg, d, out["geo_feat"])
    return torch.cat([rgb, out["sigma"]], dim=-1)


def ngp_net_plain(mode: str, h, d: Optional[torch.Tensor], w: Optional[torch.Tensor],
                  experts: Sequence[dict], cfg):
    """Plain version of every mode. h: (K, P, L·F) (or K tensors of
    (P, L·F)), d: (P, 3) (None for ``density``), w: (P, K) routing weights
    (None for ``single`` and a one-expert ``density``), ``experts``: K
    parameter dicts. Returns ``single`` / ``linear_blend``: (P, 4);
    ``sigma_blend``: (σ_mix (P,), rgb_mix (P, 3)); ``density``: (P,)."""
    if mode == "single":
        return features_forward(experts[0], cfg, h[0], d)
    if mode == "density":
        if w is None:
            return features_density(experts[0], h[0])[..., 0]
        sig = torch.stack([features_density(e, h[k])[..., 0]
                           for k, e in enumerate(experts)])  # (K, P)
        return torch.einsum("nk,kn->n", w.to(sig.dtype), sig)
    if mode == "linear_blend":
        ys = torch.stack([features_forward(e, cfg, h[k], d)
                          for k, e in enumerate(experts)])  # (K, P, 4)
        return torch.einsum("nk,kno->no", w.to(ys.dtype), ys)
    if mode == "sigma_blend":
        outs = torch.stack([features_forward(e, cfg, h[k], d)
                            for k, e in enumerate(experts)], dim=1)  # (P, K, 4)
        SIG, RGB = outs[..., 3], outs[..., :3]
        w = w.to(SIG.dtype)
        s_num = torch.clamp(torch.sum(w * SIG, dim=1, keepdim=True), min=1e-12)
        rgb = torch.sum(w[..., None] * SIG[..., None] * RGB, dim=1) / s_num
        return s_num[:, 0], rgb
    raise ValueError(f"unknown mode {mode!r}, want one of {MODES}")


# ================================================================ kernel

_LIB = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_lib.load("ngp_net")
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ngp_net_fwd.argtypes = [i, vp, ll, vp, ctypes.POINTER(i), i, ll, vp, ll, vp, vp, ll,
                                    vp, ll, vp, ll, vp]
        lib.ngp_net_fwd.restype = i
        lib.ngp_net_wide_bytes.argtypes = [i, ctypes.POINTER(i), i, ll]
        lib.ngp_net_wide_bytes.restype = ll
        lib.ngp_net_wide_image_floats.argtypes = [i, ctypes.POINTER(i)]
        lib.ngp_net_wide_image_floats.restype = ll
        lib.ngp_net_wide_split.argtypes = [i, vp, ctypes.POINTER(i), i, vp, vp]
        lib.ngp_net_wide_split.restype = i
        lib.ngp_net_limits.argtypes = [ctypes.POINTER(i)]
        lib.ngp_net_limits.restype = None
        got = (i * 3)()
        lib.ngp_net_limits(got)
        if tuple(got) != (GEO, MAX_SH_LEVELS, CLASS_WIDTH):
            raise RuntimeError("csrc/ngp_net.cu and ops/ngp_net.py disagree on the "
                               f"constants: {tuple(got)}")
        _LIB = lib
    return _LIB


SUPPORTED = (f"every width, depth, L·F and expert count from 1, geo_feat_dim {GEO}, "
             f"dir_encoding 'spherical' with sh_levels 1 to {MAX_SH_LEVELS} or 'frequency' "
             "with freq_pe_dim from 0, float32")


def check_config(cfg, K: int = 1) -> None:
    """Refuse an expert config (``NGPConfig``) the kernel does not take,
    naming the supported set: only what no parser flag reaches (widths,
    depths or K below 1, ``geo_feat_dim`` other than 15, SH levels outside
    1 to 5, an unknown direction encoding)."""
    why = []
    if min(cfg.hidden, cfg.color_hidden) < 1:
        why.append(f"hidden {cfg.hidden}, color_hidden {cfg.color_hidden}")
    if min(cfg.sigma_depth, cfg.color_depth) < 1:
        why.append(f"sigma_depth {cfg.sigma_depth}, color_depth {cfg.color_depth}")
    if cfg.hash.out_dim < 1:
        why.append(f"L·F {cfg.hash.out_dim}")
    if cfg.geo_feat_dim != GEO:
        why.append(f"geo_feat_dim {cfg.geo_feat_dim}")
    if cfg.dir_encoding not in DIR_KINDS:
        why.append(f"dir_encoding {cfg.dir_encoding!r}")
    elif cfg.dir_encoding == "spherical" and not 1 <= cfg.sh_levels <= MAX_SH_LEVELS:
        why.append(f"sh_levels {cfg.sh_levels}")
    elif cfg.dir_encoding == "frequency" and cfg.freq_pe_dim < 0:
        why.append(f"freq_pe_dim {cfg.freq_pe_dim}")
    if K < 1:
        why.append(f"{K} experts")
    if why:
        raise ValueError(f"the NGP network kernel does not take {', '.join(why)}; it "
                         f"takes {SUPPORTED}")


def wide(cfg, mode: str) -> bool:
    """Whether ``mode`` at ``cfg`` takes the kernel's wide path: a width the
    network carries above ``CLASS_WIDTH`` (hidden, L·F, and but for
    ``density`` the colour MLP's width and input)."""
    widths = [cfg.hidden, cfg.hash.out_dim]
    if mode != "density":
        widths += [cfg.color_hidden, 1 + GEO + cfg.dir_enc_dim]
    return max(widths) > CLASS_WIDTH


def _layers(params) -> list:
    """An expert's layers in the kernel's slot order: the trunk, σ head,
    geo head, the colour MLP (its last layer included)."""
    return (list(params["sigma_trunk"]) + [params["sigma_head"], params["geo_head"]]
            + list(params["color_mlp"]))


def _expert_ptrs(params, cfg, device, what: str) -> list:
    """The expert's weight and bias pointers in slot order, after checking
    every tensor: float32, contiguous, on ``device``, of the config's shape."""
    L, H, CH = cfg.hash.out_dim, cfg.hidden, cfg.color_hidden
    shapes = ([(L if l == 0 else H, H) for l in range(cfg.sigma_depth)] + [(H, 1), (H, GEO)]
              + [(GEO + cfg.dir_enc_dim if c == 0 else CH, CH) for c in range(cfg.color_depth)]
              + [(CH, 3)])
    if len(params["sigma_trunk"]) != cfg.sigma_depth or \
            len(params["color_mlp"]) != cfg.color_depth + 1:
        raise ValueError(f"{what}: {len(params['sigma_trunk'])} trunk and "
                         f"{len(params['color_mlp'])} colour layers for sigma_depth "
                         f"{cfg.sigma_depth}, color_depth {cfg.color_depth}")
    ptrs = []
    for layer, shape in zip(_layers(params), shapes):
        for t, want in ((layer["w"], shape), (layer["b"], shape[1:])):
            if t.dtype != torch.float32 or t.device != device or not t.is_contiguous() \
                    or tuple(t.shape) != want:
                raise ValueError(f"{what}: a layer tensor is {t.dtype} {tuple(t.shape)} on "
                                 f"{t.device} (contiguous {t.is_contiguous()}), want "
                                 f"contiguous float32 {want} on {device}")
            ptrs.append(t.data_ptr())
    return ptrs


def _dims(cfg) -> ctypes.Array:
    return (ctypes.c_int * 8)(cfg.hash.out_dim, cfg.hidden, cfg.sigma_depth, cfg.color_hidden,
                              cfg.color_depth, DIR_KINDS.index(cfg.dir_encoding),
                              cfg.sh_levels if cfg.dir_encoding == "spherical"
                              else cfg.freq_pe_dim, int(bool(cfg.use_sigmoid_rgb)))


def wide_bytes(mode: str, cfg, K: int, P: int) -> int:
    """The bytes of the device buffer a launch takes: 0 in the width
    classes; on the wide path K experts' split images (``wide_shapes``),
    and where the activations spill (a layer wider than 256), the blocks'
    scratch, two buffers of 64 points × the widest layer a tile."""
    if not wide(cfg, mode):
        return 0
    got = _library().ngp_net_wide_bytes(MODES.index(mode), _dims(cfg), K, P)
    if got < 0:
        raise RuntimeError(f"ngp_net wide-path plan failed: CUDA error {-got}")
    return int(got)


BLOCK = 64  # columns of a wide-path block (a wgmma's n)
ROUND_BLOCKS = 4  # blocks a warpgroup sums in registers
BLOCK_FLOATS = 512  # one TF32 part of a block's k-step: 64 columns × 8 rows


def wide_shapes(mode: str, cfg) -> tuple:
    """csrc/ngp_net.cu's ``wide_shapes``: each layer's (in, out, kt input
    tiles of 8, nb output blocks of 64, image offset, bias offset) in
    floats, and the floats of one expert's split image."""
    ins_outs = ([(cfg.hash.out_dim if l == 0 else cfg.hidden, cfg.hidden)
                 for l in range(cfg.sigma_depth)] + [(cfg.hidden, 1 + GEO)])
    if mode != "density":
        ins_outs += ([(1 + GEO + cfg.dir_enc_dim, cfg.color_hidden)]
                     + [(cfg.color_hidden, cfg.color_hidden)] * (cfg.color_depth - 1)
                     + [(cfg.color_hidden, 3)])
    shapes, off = [], 0
    for n_in, n_out in ins_outs:
        kt, nb = -(-n_in // 8), -(-n_out // BLOCK)
        shapes.append([n_in, n_out, kt, nb, off, 0])
        off += 2 * BLOCK_FLOATS * kt * nb
    for sh in shapes:
        sh[5] = off
        off += BLOCK * sh[3]
    return [tuple(sh) for sh in shapes], off


def tf32_plain(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` of float32 x: round half away from zero at bit
    13 of the int32 view (the sign bit apart, the pattern is the
    magnitude), the 13 low bits cleared."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _staged(params, cfg, mode: str) -> list:
    """An expert's layers as the wide path stages them, (w (in, out), b
    (out,)) each: the trunk, the heads [σ | geo], the colour MLP's first
    layer behind a zero row (the heads' σ column), the rest of it."""
    layers = [(p["w"], p["b"]) for p in params["sigma_trunk"]]
    layers.append((torch.cat([params["sigma_head"]["w"], params["geo_head"]["w"]], 1),
                   torch.cat([params["sigma_head"]["b"], params["geo_head"]["b"]])))
    if mode != "density":
        first = params["color_mlp"][0]
        layers.append((torch.cat([first["w"].new_zeros((1, first["w"].shape[1])), first["w"]]),
                       first["b"]))
        layers += [(p["w"], p["b"]) for p in params["color_mlp"][1:]]
    return layers


def wide_split_plain(mode: str, experts: Sequence[dict], cfg) -> torch.Tensor:
    """Plain version of the split kernel: (K, image floats) float32, each
    expert's layers split into TF32 big and small parts (the bit patterns
    of ``tf32_plain(w)`` and ``tf32_plain(w − big)``) at csrc/ngp_net.cu's
    ``wide_index`` — the k-slot of row i of a k-step is i/2 for even i and
    4 + i/2 for odd, and each (round of up to 4 blocks, k-step) holds its
    blocks' big parts, then their small parts, 64 columns × 8 rows each in
    wgmma's K-major layout (8 × 4 core matrices: row-halves 32 floats apart,
    8-column groups 64) — then every bias; zeros past each layer."""
    shapes, floats = wide_shapes(mode, cfg)
    out = torch.zeros((len(experts), floats), dtype=torch.float32,
                      device=experts[0]["sigma_trunk"][0]["w"].device)
    for k, params in enumerate(experts):
        for (n_in, n_out, kt, nb, off, boff), (w, b) in zip(shapes, _staged(params, cfg, mode)):
            i = torch.arange(8 * kt, device=out.device)[:, None]
            j = torch.arange(BLOCK * nb, device=out.device)[None, :]
            full = torch.zeros((8 * kt, BLOCK * nb), dtype=torch.float32, device=out.device)
            full[:n_in, :n_out] = w
            big = tf32_plain(full)
            small = tf32_plain(full - big)
            o = i & 7
            slot = torch.where((o & 1) == 1, 4 + (o >> 1), o >> 1)
            blk = j >> 6
            r = blk // ROUND_BLOCKS
            nbr = torch.clamp(nb - ROUND_BLOCKS * r, max=ROUND_BLOCKS)
            n = j & 63
            at = (off + 2 * BLOCK_FLOATS * (kt * ROUND_BLOCKS * r + (i >> 3) * nbr)
                  + (blk - ROUND_BLOCKS * r) * BLOCK_FLOATS + (n >> 3) * 64 + (slot >> 2) * 32
                  + (n & 7) * 4 + (slot & 3))
            out[k, at.reshape(-1)] = big.reshape(-1)
            out[k, (at + nbr * BLOCK_FLOATS).reshape(-1)] = small.reshape(-1)
            out[k, boff:boff + n_out] = b
    return out


def wide_split_kernel(mode: str, experts: Sequence[dict], cfg) -> torch.Tensor:
    """The split kernel alone, on the current stream (what the wide path of
    ``ngp_net_kernel`` launches before the network): ``wide_split_plain``'s
    result, from the experts' tensors on one card. Adds one to
    ``wide_split_kernel.launches``."""
    what = "the NGP network's split kernel"
    K = len(experts)
    check_config(cfg, K)
    dev = experts[0]["sigma_trunk"][0]["w"].device
    if dev.type != "cuda":
        raise ValueError(f"{what} needs tensors on a CUDA device, got {dev}")
    ptrs = [p for e in experts for p in _expert_ptrs(e, cfg, dev, what)]
    lib = _library()
    floats = int(lib.ngp_net_wide_image_floats(MODES.index(mode), _dims(cfg)))
    if floats < 0:
        raise RuntimeError(f"ngp_net wide-path shapes failed: CUDA error {-floats}")
    out = torch.empty((K, floats), dtype=torch.float32, device=dev)
    table = cuda_lib.device_table(ptrs, dev)
    err = _on_stream(out, lambda s: lib.ngp_net_wide_split(
        MODES.index(mode), table.data_ptr(), _dims(cfg), K, out.data_ptr(), s))
    if err != 0:
        raise RuntimeError(f"ngp_net split kernel launch failed: CUDA error {err}")
    wide_split_kernel.launches += 1
    return out


wide_split_kernel.launches = 0


def ngp_net_kernel(mode: str, h, d: Optional[torch.Tensor], w: Optional[torch.Tensor],
                   experts: Sequence[dict], cfg):
    """Launch the kernel on the current stream; arguments and results as
    ``ngp_net_plain``'s. h: one (K, P, L·F) float32 contiguous tensor (read
    at a stride); d: (P, 3) float32 whose rows may be strided (a view of a
    (P, 6) xd); w: (P, K) float32 contiguous; every tensor on one card.
    Adds one to ``ngp_net_kernel.launches`` per launch (none for P = 0),
    and on the wide path one to ``wide_split_kernel.launches`` for the
    split launch before it."""
    what = "the NGP network kernel"
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}, want one of {MODES}")
    K = len(experts)
    check_config(cfg, K)
    if not isinstance(h, torch.Tensor) or len(h) != K:
        raise ValueError(f"{what}: features must be one (K, P, L·F) tensor for {K} experts")
    dev = h.device
    if dev.type != "cuda":
        raise ValueError(f"{what} needs tensors on a CUDA device, got {dev}")
    L = cfg.hash.out_dim
    P = int(h.shape[1]) if h.dim() == 3 else -1
    if h.dtype != torch.float32 or not h.is_contiguous() or tuple(h.shape) != (K, P, L):
        raise ValueError(f"{what}: features {h.dtype} {tuple(h.shape)} on {h.device}, "
                         f"want contiguous float32 ({K}, P, {L}) on {dev}")
    blend = mode in ("sigma_blend", "linear_blend") or (mode == "density" and w is not None)
    if mode == "single" and K != 1:
        raise ValueError(f"{what}: mode single takes one expert, got {K}")
    if blend:
        if w is None or w.dtype != torch.float32 or w.device != dev \
                or not w.is_contiguous() or tuple(w.shape) != (P, K):
            raise ValueError(f"{what}: routing weights must be contiguous float32 "
                             f"({P}, {K}) on {dev}")
    elif K != 1 or w is not None:
        raise ValueError(f"{what}: mode {mode} without weights takes one expert")
    if mode != "density":
        if d is None or d.dtype != torch.float32 or d.device != dev or d.dim() != 2 \
                or tuple(d.shape) != (P, 3) or (P and d.stride(1) != 1):
            raise ValueError(f"{what}: directions must be float32 (P, 3) with unit column "
                             f"stride on {dev}")
    ptrs = [p for e in experts for p in _expert_ptrs(e, cfg, dev, what)]
    if mode in ("single", "linear_blend"):
        out = torch.empty((P, 4), dtype=torch.float32, device=dev)
        rgb, rgb_s, sig, sig_s = out.data_ptr(), 4, out.data_ptr() + 12, 4
        result = out
    elif mode == "sigma_blend":
        s_out = torch.empty((P,), dtype=torch.float32, device=dev)
        c_out = torch.empty((P, 3), dtype=torch.float32, device=dev)
        rgb, rgb_s, sig, sig_s = c_out.data_ptr(), 3, s_out.data_ptr(), 1
        result = (s_out, c_out)
    else:
        s_out = torch.empty((P,), dtype=torch.float32, device=dev)
        rgb, rgb_s, sig, sig_s = None, 0, s_out.data_ptr(), 1
        result = s_out
    if P == 0:
        return result
    lib = _library()
    need = wide_bytes(mode, cfg, K, P)
    buf = torch.empty((need // 4,), dtype=torch.float32, device=dev) if need else None
    table = cuda_lib.device_table(ptrs, dev)
    err = _on_stream(h, lambda s: lib.ngp_net_fwd(
        MODES.index(mode), h.data_ptr(), P * L, table.data_ptr(), _dims(cfg), K, P,
        None if d is None else d.data_ptr(), 0 if d is None else d.stride(0),
        w.data_ptr() if blend else None, rgb, rgb_s, sig, sig_s,
        None if buf is None else buf.data_ptr(), need, s))
    if err != 0:
        raise RuntimeError(f"ngp_net kernel launch failed: CUDA error {err}")
    ngp_net_kernel.launches += 1
    if need:
        wide_split_kernel.launches += 1
    return result


ngp_net_kernel.launches = 0


def ngp_net(mode: str, h, d: Optional[torch.Tensor], w: Optional[torch.Tensor],
            experts: Sequence[dict], cfg):
    """The network in ``mode``: the plain version for CPU tensors, the
    kernel for CUDA ones."""
    if h[0].device.type == "cpu":
        return ngp_net_plain(mode, h, d, w, experts, cfg)
    return ngp_net_kernel(mode, h, d, w, experts, cfg)


def takes(x: torch.Tensor) -> bool:
    """Whether a network evaluation at points x goes through ``ngp_net``:
    no gradient is being recorded and x is float32 (module docstring)."""
    return not torch.is_grad_enabled() and x.dtype == torch.float32


def launch_counts() -> int:
    """The network kernel's launches since the counter was last set to 0."""
    return ngp_net_kernel.launches


def split_launch_counts() -> int:
    """The wide path's split launches since the counter was last set to 0."""
    return wide_split_kernel.launches


def zero_launch_counts() -> None:
    ngp_net_kernel.launches = 0
    wide_split_kernel.launches = 0
