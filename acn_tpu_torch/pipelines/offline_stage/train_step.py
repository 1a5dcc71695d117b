"""One FoMAML meta-training step in each marching regime, and the eval step.

Port of ``acn_tpu/pipelines/offline_stage/train_step.py``: ``make_bg_fn``,
``make_episode_loss`` (all three regimes, ``use_amp``, the unchunked loss),
the ``fomaml`` branch of ``_meta_grads_gradbased``, ``make_meta_train_step``
with its seven metrics, ``make_eval_step``, and the episodic sampler on the
card, ``make_device_batch_fn``. The regime is picked as ``acn_tpu`` picks
it:

* ``occ_cfg=None``: **stratified**, ``P.ray_samples`` jittered samples per
  ray (the occupancy warm-up);
* budget 0 (``P.occ_budget_per_ray``, or ``budget_override``): the
  **strided** per-ray march to ``P.occ_s_kept`` samples and fixed-layout
  compositing; ``report_budget > 0`` makes ``occ_overflow`` the share the
  budget march WOULD drop (the auto-regime switch reads it);
* budget > 0: the **packed-budget** march and packed compositing, whose
  segmented scan runs the CUDA kernel's forward and reverse modes.

Where the JAX step is one XLA program that vmaps the K experts and scans the
T tasks, **the K and T axes are Python loops here**, one episode at a time
(the torch reference this system was modelled on did the same): one expert's
fast weights are in flight at a time, and each loss's graph is freed by
``torch.autograd.grad`` before the next loss is built. Per step that is
K·T·(inner_iter + 1) episode losses, each with one backward.

Randomness: ``acn_tpu`` splits a key per episode, march and loss; here a
step takes ``draws`` (see ``EpisodeDraws``): None (bin midpoints, stride
phase 0, no stratified jitter), a ``torch.Generator`` on the step's device,
or a function that returns each draw (the tests replay JAX's draws with
one).

bf16 (``P.use_amp``): parameters and network inputs are cast to bf16 by hand
before ``world_to_unit`` (so the hash cell and fraction are bf16 decisions
and the table gradient is summed in bf16), sampling, compositing and the loss
stay float32, and gradients come back through the casts onto the float32
parameters. ``torch.autocast`` does none of this and is not used.

Not ported, each raising ``NotImplementedError`` with its ROADMAP item: the
chunked loss (``train_chunk_rays``), ``maml``, ``reptile`` and ``fim``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from acn_tpu_torch.data.tasks import EpisodeConstraints
from acn_tpu_torch.models import container as cont
from acn_tpu_torch.models import ngp as ngp_mod
from acn_tpu_torch.models.container import ContainerConfig
from acn_tpu_torch.models.nn import tree_cast, tree_leaves, tree_map
from acn_tpu_torch.nerfs.losses import aligned_mse_loss, psnr_from_mse
from acn_tpu_torch.nerfs.render import (
    bg_default_color,
    composite,
    composite_packed,
    render_rays_stratified,
    render_weights_from_density,
)
from acn_tpu_torch.occupancy import grid as occ_grid
from acn_tpu_torch.occupancy.grid import OccConfig
from acn_tpu_torch.pipelines.offline_stage import meta_core
from acn_tpu_torch.pipelines.renderer import resolve_device
from acn_tpu_torch.utils.optim import Optimizer, apply_updates


def _budget(P, budget_override: Optional[int]) -> int:
    return (int(budget_override) if budget_override is not None
            else int(getattr(P, "occ_budget_per_ray", 0) or 0))


def regime_of(occ_cfg: Optional[OccConfig], P,
              budget_override: Optional[int] = None) -> str:
    """"stratified", "strided" or "budget", as ``make_episode_loss`` picks."""
    if occ_cfg is None:
        return "stratified"
    return "budget" if _budget(P, budget_override) > 0 else "strided"


class EpisodeDraws:
    """A step's random draws, asked for by episode (expert k, task t).

    * ``march(k, t, j, n)``: march j's draws (j = 0 support, 1 query rays,
      n of them): the budget march's salt, the strided march's (u (n, s_max),
      phase_bits (n,)), or None;
    * ``strat(k, t, i, n)``: the stratified loss's jitter (n, ray_samples)
      for inner iteration i, the query loss at i = inner_iter; or None;
    * ``bg(k, t, i, n)``: that loss's ``random`` background colors (n, 3),
      None under another policy or with the background MLP.

    ``draws``: None (no draws), a ``torch.Generator`` (on the step's
    device), or a function ``fn(what, k, t, j, shape)`` with ``what`` one
    of "salt" (budget march j), "u", "phase" (strided march j),
    "strat_u" (stratified loss j) and "bg" (loss j's ``random``
    background), returning the draw (a salt in
    [0, 2³¹ − 1) as an int or a 0-dim tensor, u in [0, 1), phase bits in
    [0, 2³⁰)) or None."""

    def __init__(self, draws, device: torch.device, regime: str, P, cfg=None):
        self.device, self.regime = device, regime
        self.random_bg = (P.bg_color_default == "random"
                          and not (cfg is not None and cfg.use_bg_nerf))
        self.s_max = int(getattr(P, "occ_s_max", 0) or 0)
        self.ray_samples = int(P.ray_samples)
        if isinstance(draws, torch.Generator):
            if draws.device.type != device.type:
                raise ValueError(f"the generator lies on {draws.device}, the "
                                 f"step runs on {device}")
            self.fn = self._from_generator(draws)
        elif draws is None or callable(draws):
            self.fn = draws
        else:
            raise TypeError("draws: None, a torch.Generator or a function, "
                            f"not {type(draws).__name__}")

    @staticmethod
    def _from_generator(gen: torch.Generator) -> Callable:
        def fn(what, k, t, j, shape):
            if what == "salt":
                return torch.randint(0, 2**31 - 1, (), generator=gen, device=gen.device)
            if what == "phase":
                return torch.randint(0, 1 << 30, shape, generator=gen, device=gen.device)
            return torch.rand(shape, generator=gen, device=gen.device)
        return fn

    def _get(self, what, k, t, j, shape):
        if self.fn is None:
            return None
        x = self.fn(what, k, t, j, shape)
        return x if x is None or isinstance(x, int) else torch.as_tensor(x).to(self.device)

    def march(self, k: int, t: int, j: int, n: int):
        if self.regime == "budget":
            return self._get("salt", k, t, j, ())
        if self.regime == "strided":
            u = self._get("u", k, t, j, (n, self.s_max))
            ph = self._get("phase", k, t, j, (n,))
            return None if u is None and ph is None else (u, ph)
        return None

    def strat(self, k: int, t: int, i: int, n: int):
        if self.regime != "stratified":
            return None
        return self._get("strat_u", k, t, i, (n, self.ray_samples))

    def bg(self, k: int, t: int, i: int, n: int):
        return self._get("bg", k, t, i, (n, 3)) if self.random_bg else None


def make_bg_fn(cfg: ContainerConfig, P) -> Callable:
    """(bg_params, dirs (N,3), u=None) → (N,3) background RGB, or None; ``u``
    (N, 3) are the ``random`` policy's colors."""
    if cfg.use_bg_nerf:
        return lambda bg_params, dirs, u=None: cont.bg_mlp_color(bg_params, cfg, dirs)
    policy = P.bg_color_default
    return lambda bg_params, dirs, u=None: bg_default_color(
        dirs.shape[0], policy, device=dirs.device, u=u)


def make_episode_loss(
    cfg: ContainerConfig,
    P,
    occ_cfg: Optional[OccConfig] = None,
    budget_override: Optional[int] = None,
    report_budget: int = 0,
):
    """The episode loss and its march, for the regime that ``regime_of``
    names.

    Returns (loss_fn, prepare_samples):

    * ``loss_fn(expert_params, bg_params, aabb, rays, rgbs, samples, u=None,
      bg=None)`` → 0-dim loss: render the rays with ONE expert (any
      parameter tree of an expert's structure, so fast weights too) on the
      marched samples, or stratified with jitter ``u`` (N, ray_samples) when
      there is no occupancy, over the background MLP or the default policy
      (``bg``: the ``random`` policy's (N, 3) colors), and align and MSE
      against the ground truth.
    * ``prepare_samples(occ_state, rays, rand)``: the march of one episode's
      rays over that expert's grid, with ``rand`` the budget march's salt or
      the strided march's (u, phase_bits), None for midpoints and phase 0;
      None in the stratified regime. Marching has no trainable input, so the
      step marches once per episode and reuses the samples in every inner
      iteration.
    """
    if int(getattr(P, "train_chunk_rays", 0) or 0) > 0:
        raise NotImplementedError(
            "the chunked episode loss (train_chunk_rays > 0) is not ported: "
            "ROADMAP.md M2")
    regime = regime_of(occ_cfg, P, budget_override)
    budget = _budget(P, budget_override)
    bg_fn = make_bg_fn(cfg, P)
    use_amp = bool(getattr(P, "use_amp", False))

    def prepare_samples(occ_state, rays, rand):
        if regime == "budget":
            return occ_grid.march_rays_budget(occ_state, rays, occ_cfg,
                                              int(P.occ_s_max), budget, salt=rand)
        if regime == "strided":
            u, phase_bits = rand if rand is not None else (None, None)
            return occ_grid.march_rays(
                occ_state, rays, occ_cfg, int(P.occ_s_max), int(P.occ_s_kept),
                u=u, phase_bits=phase_bits, report_budget=int(report_budget))
        return None

    def loss_fn(expert_params, bg_params, aabb, rays, rgbs, samples, u=None, bg=None):
        bg = bg_fn(bg_params, rays[:, 3:6], bg)
        if use_amp:
            expert_params = tree_cast(expert_params, torch.bfloat16)

        def fwd(xd):
            if use_amp:
                xd = xd.to(torch.bfloat16)
            return ngp_mod.ngp_forward(expert_params, cfg.expert, aabb,
                                       xd).to(torch.float32)

        n = rays.shape[0]
        if regime == "stratified":
            rgb_map = render_rays_stratified(fwd, rays, int(P.ray_samples), u=u,
                                             bg_rgb=bg)[0]
        elif regime == "budget":
            out = fwd(samples["xd"])
            rgb_map = composite_packed(out[..., 3], out[..., :3], samples, n,
                                       bg_rgb=bg, with_stats=False)[0]
        else:
            x = samples["positions"]
            xd = torch.cat([x, rays[:, None, 3:6].expand_as(x)], dim=-1)
            out = fwd(xd.reshape(-1, 6)).reshape(x.shape[0], x.shape[1], 4)
            weights, _ = render_weights_from_density(
                samples["t_starts"], samples["t_ends"], out[..., 3],
                sample_mask=samples["mask"], dts=samples["dts"])
            t_mid = 0.5 * (samples["t_starts"] + samples["t_ends"])
            rgb_map = composite(weights, out[..., :3], t_mid, bg_rgb=bg)[0]
        return aligned_mse_loss(rgb_map, rgbs, P.color_space)

    return loss_fn, prepare_samples


def _expert_occ(occ_states, k: int):
    """Expert k's occupancy state, or None (the stratified regime's
    placeholder, ``trainer.dummy_occ_states``, or None)."""
    if isinstance(occ_states, dict):
        return {name: v[k] for name, v in occ_states.items()}
    return None


def _check_devices(device, params, batch, occ_states) -> None:
    occ = (list(occ_states.values()) if isinstance(occ_states, dict)
           else [] if occ_states is None else [occ_states])
    on = {t.device.type for t in (*tree_leaves(params), *batch.values(), *occ)}
    if on != {device.type}:
        raise ValueError(f"this step runs on {device.type!r}; the model, "
                         f"batch or occupancy states lie on {sorted(on)}")


def _meta_grads_fomaml(episode_loss, prep, params, aabbs, occ_states, batch,
                       rnd: EpisodeDraws, inner_lr: float, inner_iter: int):
    """FoMAML meta-gradients, one episode at a time.

    Per expert k and task t: march the support and the query rays once;
    adapt a detached copy of the expert on the support loss (first order: no
    graph through the inner steps); one forward and backward of the query
    loss at the adapted weights gives the gradient for the expert's
    parameters and the shared background head. Task gradients are summed
    and divided by T; the background gradient is summed over the K experts.

    Returns (q_losses (K, T), inner_losses (K, T, I), expert grads stacked
    (K, ...), background grad or None, mean overflow).
    """
    experts, bg = params["experts"], params.get("bg_mlp")
    has_bg = bg is not None
    K, T = batch["support_rays"].shape[:2]
    dev = batch["support_rays"].device
    g_experts = tree_map(torch.zeros_like, experts)
    g_bg = tree_map(torch.zeros_like, bg) if has_bg else None
    bg_const = tree_map(lambda p: p.detach(), bg) if has_bg else None
    q_losses, inner_losses, ovfs = [], [], []
    for k in range(K):
        expert_p = cont.expert_slice(experts, k)
        aabb = aabbs[k]
        occ_state = _expert_occ(occ_states, k)
        g_bg_k = tree_map(torch.zeros_like, bg) if has_bg else None
        for t in range(T):
            sr, sg = batch["support_rays"][k, t], batch["support_rgbs"][k, t]
            qr, qg = batch["query_rays"][k, t], batch["query_rgbs"][k, t]
            smp_s = prep(occ_state, sr, rnd.march(k, t, 0, sr.shape[0]))
            smp_q = prep(occ_state, qr, rnd.march(k, t, 1, qr.shape[0]))
            # the budget march's drop, or the strided march's would-be drop
            ovf = torch.zeros((), device=dev)
            for smp in (smp_s, smp_q):
                if smp is not None and "overflow" in smp:
                    ovf = ovf + smp["overflow"]
            ovfs.append(ovf * 0.5)

            fast, inner = meta_core.task_adapt(
                lambda p, b, i: episode_loss(p, bg_const, aabb, b[0], b[1], smp_s,
                                             u=rnd.strat(k, t, i, b[0].shape[0]),
                                             bg=rnd.bg(k, t, i, b[0].shape[0])),
                expert_p, (sr, sg), inner_lr, inner_iter, first_order=True)
            q_loss = episode_loss(fast, bg, aabb, qr, qg, smp_q,
                                  u=rnd.strat(k, t, inner_iter, qr.shape[0]),
                                  bg=rnd.bg(k, t, inner_iter, qr.shape[0]))
            fast_leaves = tree_leaves(fast)
            wrt = fast_leaves + (tree_leaves(bg) if has_bg else [])
            grads = torch.autograd.grad(q_loss, wrt)
            with torch.no_grad():
                for acc, g in zip(tree_leaves(g_experts), grads):
                    acc[k].add_(g)
                if has_bg:
                    for acc, g in zip(tree_leaves(g_bg_k),
                                      grads[len(fast_leaves):]):
                        acc.add_(g)
            q_losses.append(q_loss.detach())
            inner_losses.append(inner)
            del fast, grads
        if has_bg:
            with torch.no_grad():
                for acc, g in zip(tree_leaves(g_bg), tree_leaves(g_bg_k)):
                    acc.add_(g * (1.0 / T))
    with torch.no_grad():
        for g in tree_leaves(g_experts):
            g.mul_(1.0 / T)
    return (torch.stack(q_losses).reshape(K, T),
            torch.stack(inner_losses).reshape(K, T, -1),
            g_experts, g_bg, torch.mean(torch.stack(ovfs)))


def _refuse_unported(P) -> None:
    algo = str(P.algo).lower()
    if algo in ("maml", "reptile"):
        raise NotImplementedError(
            f"algo {algo!r} is not ported: ROADMAP.md M9 (only 'fomaml' is)")
    if algo != "fomaml":
        raise ValueError(f"Unsupported algo {algo!r}")
    if bool(getattr(P, "fim", False)):
        raise NotImplementedError(
            "the Fisher-preconditioned inner loop (fim) is not ported: "
            "ROADMAP.md M9")


def make_meta_train_step(
    cfg: ContainerConfig,
    P,
    optimizer: Optimizer,
    occ_cfg: Optional[OccConfig] = None,
    budget_override: Optional[int] = None,
    report_budget: int = 0,
    device=None,
):
    """Build the meta-train step of the regime that ``regime_of`` names.

    ``train_step(state, batch, occ_states, draws=None)`` → (state, metrics).
    ``state`` = {"model": ``Container``, "opt_state": ``optimizer.init``'s,
    "step": int}: the model's parameters are updated **in place** and the
    returned state holds the same model. ``batch`` = stacked (K, T, ·, ·)
    episode tensors {support_rays, support_rgbs, query_rays, query_rgbs},
    ``occ_states`` the stacked (K, ...) occupancy states (in the stratified
    regime ``trainer.dummy_occ_states`` or None), ``draws`` as
    ``EpisodeDraws`` takes them. Everything lies on ``device``: ``None``
    means the card, and raises without one.

    ``metrics`` = {loss_out, loss_in, psnr_out, psnr_in (K,), loss_total,
    grad_norm, occ_overflow (0-dim)}, tensors on the device: the step does
    not wait for the card, reading a metric does.
    """
    device = resolve_device(device)
    _refuse_unported(P)
    regime = regime_of(occ_cfg, P, budget_override)
    episode_loss, prep = make_episode_loss(
        cfg, P, occ_cfg, budget_override=budget_override,
        report_budget=report_budget)
    inner_lr = float(P.inner_lr)
    inner_iter = int(P.inner_iter)

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor],
                   occ_states, draws=None) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        model = state["model"]
        params = model.params()
        _check_devices(device, params, batch, occ_states)
        q_losses, inner_losses, g_experts, g_bg, occ_overflow = _meta_grads_fomaml(
            episode_loss, prep, params, model.expert_aabbs, occ_states, batch,
            EpisodeDraws(draws, device, regime, P, cfg), inner_lr, inner_iter)
        grads = {"experts": g_experts}
        if g_bg is not None:
            grads["bg_mlp"] = g_bg

        updates, opt_state = optimizer.update(grads, state["opt_state"])
        apply_updates(params, updates)

        loss_out = torch.mean(q_losses, dim=1)  # (K,)
        loss_in = torch.mean(inner_losses[..., -1], dim=1)  # (K,)
        metrics = {
            "loss_out": loss_out,
            "loss_in": loss_in,
            "psnr_out": psnr_from_mse(loss_out),
            "psnr_in": psnr_from_mse(loss_in),
            # Σ_regions mean_tasks: the fed-avg ×K scaling of the reference
            "loss_total": torch.sum(loss_out),
            "grad_norm": meta_core.global_grad_norm(grads),
            "occ_overflow": occ_overflow,
        }
        new_state = {"model": model, "opt_state": opt_state,
                     "step": state["step"] + 1}
        return new_state, metrics

    return train_step


def make_eval_step(
    cfg: ContainerConfig,
    P,
    occ_cfg: Optional[OccConfig] = None,
    tto: Optional[int] = None,
    device=None,
):
    """Mid-training eval: adapt each test task's expert with ``tto`` inner
    steps (``P.inner_iter`` when None) on its support rays, then the query
    loss at the adapted weights. The batch is the train step's.

    ``eval_step(model, batch, occ_states, draws=None)`` → {loss_out,
    psnr_out (K,), psnr (0-dim)}; the model is not changed."""
    device = resolve_device(device)
    if bool(getattr(P, "fim", False)):
        raise NotImplementedError(
            "the Fisher-preconditioned inner loop (fim) is not ported: "
            "ROADMAP.md M9")
    regime = regime_of(occ_cfg, P)
    episode_loss, prep = make_episode_loss(cfg, P, occ_cfg)
    inner_lr = float(P.inner_lr)
    iterations = int(P.inner_iter if tto is None else tto)

    def eval_step(model, batch: Dict[str, torch.Tensor], occ_states,
                  draws=None) -> Dict[str, torch.Tensor]:
        params = model.params()
        _check_devices(device, params, batch, occ_states)
        rnd = EpisodeDraws(draws, device, regime, P, cfg)
        bg = params.get("bg_mlp")
        bg = tree_map(lambda p: p.detach(), bg) if bg is not None else None
        K, T = batch["support_rays"].shape[:2]
        q_losses = []
        for k in range(K):
            expert_p = cont.expert_slice(params["experts"], k)
            aabb = model.expert_aabbs[k]
            occ_state = _expert_occ(occ_states, k)
            for t in range(T):
                sr, sg = batch["support_rays"][k, t], batch["support_rgbs"][k, t]
                qr, qg = batch["query_rays"][k, t], batch["query_rgbs"][k, t]
                smp_s = prep(occ_state, sr, rnd.march(k, t, 0, sr.shape[0]))
                smp_q = prep(occ_state, qr, rnd.march(k, t, 1, qr.shape[0]))
                fast = expert_p
                if iterations > 0:
                    fast, _ = meta_core.task_adapt(
                        lambda p, b, i: episode_loss(
                            p, bg, aabb, b[0], b[1], smp_s,
                            u=rnd.strat(k, t, i, b[0].shape[0]),
                            bg=rnd.bg(k, t, i, b[0].shape[0])),
                        expert_p, (sr, sg), inner_lr, iterations, first_order=True)
                with torch.no_grad():
                    q_losses.append(episode_loss(
                        fast, bg, aabb, qr, qg, smp_q,
                        u=rnd.strat(k, t, iterations, qr.shape[0]),
                        bg=rnd.bg(k, t, iterations, qr.shape[0])))
                del fast
        q = torch.stack(q_losses).reshape(K, T)
        loss_out = torch.mean(q, dim=1)
        return {"loss_out": loss_out, "psnr_out": psnr_from_mse(loss_out),
                "psnr": psnr_from_mse(torch.mean(q))}

    return eval_step


# ------------------------------------------------------ episodic sampling


def pools_to_device(pools, device=None) -> Dict[str, torch.Tensor]:
    """``data.tasks.build_device_pools``'s arrays as tensors on ``device``
    (``None`` is the card), the ray store and its index pools kept once."""
    device = resolve_device(device)
    return {k: torch.as_tensor(v).to(device) for k, v in pools.items()}


def draw_episodes(pools: Dict[str, torch.Tensor], T: int,
                  generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The four draws of each of the K·T episodes, from ``generator`` (on
    the pools' device): ``cell`` (K, T) uniform over each expert's eligible
    cells (the largest of C uniforms, the others masked), ``u`` (K, T, I)
    uniforms that order the cell's images, and ``offs_s`` / ``offs_q``
    (K, T, I) integers in [0, 2³⁰) that start each image's support and
    fresh query window."""
    elig = pools["eligible"]
    K, C = elig.shape
    I = pools["img_start"].shape[2]
    dev = elig.device
    score = torch.rand((K, T, C), generator=generator, device=dev)
    cell = torch.argmax(torch.where(elig[:, None, :], score, -1.0), dim=-1)
    return {"cell": cell,
            "u": torch.rand((K, T, I), generator=generator, device=dev),
            "offs_s": torch.randint(0, 1 << 30, (K, T, I), generator=generator, device=dev),
            "offs_q": torch.randint(0, 1 << 30, (K, T, I), generator=generator, device=dev)}


def _split_take(lens, n_use, target: int, cap: int):
    """Greedy capped allocation over the image slots: slot i (< n_use)
    takes min(remaining, cap, len_i). Returns (take, cumulative bounds)."""
    slots = torch.arange(lens.shape[-1], device=lens.device)
    desired = torch.where(slots < n_use[..., None], torch.clamp(lens, max=cap), 0)
    before = torch.cumsum(desired, -1) - desired
    take = torch.minimum(torch.clamp(target - before, min=0), desired)
    return take, torch.cumsum(take, -1)


def _gather_split(n: int, bounds, take, starts, lens, offs):
    """Pool positions of a split's n rays: ray j (mod the split's total)
    falls in the slot whose bounds hold it, at its rank within the slot,
    read from that image's circular window that starts at ``offs``."""
    total = torch.clamp(bounds[..., -1], min=1)
    jm = torch.arange(n, device=bounds.device) % total[..., None]
    # Σ_i [jm ≥ bounds_i]; JAX clamps the one out-of-range slot (an empty
    # split), torch's gather would raise
    slot = torch.clamp(torch.searchsorted(bounds, jm, right=True), max=bounds.shape[-1] - 1)
    at = lambda a: torch.gather(a, -1, slot)
    rank = jm - (at(bounds) - at(take))
    return at(starts) + (at(offs) + rank) % torch.clamp(at(lens), min=1)


def episode_ray_ids(pools: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor],
                    S: int, Q: int, constraints: Optional[EpisodeConstraints] = None):
    """(support ids (K, T, S), query ids (K, T, Q)): rows of each expert's
    ray store, for the episodes that ``draws`` (``draw_episodes``'s form)
    pick, as ``acn_tpu``'s ``make_device_batch_fn`` takes them, batched
    over (K, T) in a few tensor ops.

    Per episode: a random order of the cell's images (the slots past its
    image count sort last: stable argsort of u + 10⁹); support from the
    first ``max_images_support`` images, each capped at ⌈cap·S⌉ rays; query
    from the next slots (image-disjoint while images remain, else borrowing
    the support's images in a window after the support's, so that the rays
    stay disjoint), each capped at ⌈cap·Q⌉. Integers are int64; the values
    equal JAX's int32 ones (pool positions < 2³¹)."""
    cst = constraints or EpisodeConstraints()
    cap_s = max(1, int(np.ceil(cst.image_cap * S)))
    cap_q = max(1, int(np.ceil(cst.image_cap * Q)))
    cell = draws["cell"].long()
    K = cell.shape[0]
    dev = cell.device
    kk = torch.arange(K, device=dev)[:, None]
    I = pools["img_start"].shape[2]
    slots = torch.arange(I, device=dev)

    n_img = torch.clamp(pools["img_count"][kk, cell].long(), min=1)  # (K, T)
    rkeys = draws["u"] + (slots >= n_img[..., None]).to(torch.float32) * 1e9
    order = torch.argsort(rkeys, dim=-1, stable=True)  # valid slots first, shuffled
    starts_p = torch.gather(pools["img_start"][kk, cell].long(), -1, order)
    lens_p = torch.gather(pools["img_len"][kk, cell].long(), -1, order)

    n_s = torch.clamp(n_img, max=cst.max_images_support)
    take_s, bounds_s = _split_take(lens_p, n_s, S, cap_s)
    offs_s = draws["offs_s"].long() % torch.clamp(lens_p, min=1)
    s_pos = _gather_split(S, bounds_s, take_s, starts_p, lens_p, offs_s)

    n_disj = torch.clamp(n_img - n_s, min=0)
    n_q = torch.where(n_disj >= cst.min_images_query,
                      torch.clamp(n_disj, max=cst.max_images_query),
                      torch.clamp(n_img, max=cst.min_images_query))
    after = n_s[..., None] + slots
    qsrc = after % n_img[..., None]  # position in the image order per q-slot
    borrowed = after >= n_img[..., None]
    at = lambda a: torch.gather(a, -1, qsrc)
    lens_raw, take_sq = at(lens_p), at(take_s)
    lens_q = torch.where(borrowed, torch.clamp(lens_raw - take_sq, min=0), lens_raw)
    take_q, bounds_q = _split_take(lens_q, n_q, Q, cap_q)
    offs_fresh = draws["offs_q"].long() % torch.clamp(lens_q, min=1)
    # borrowed images continue right after the support's circular window
    offs_q = torch.where(borrowed, (at(offs_s) + take_sq) % torch.clamp(lens_raw, min=1),
                         offs_fresh)
    q_pos = _gather_split(Q, bounds_q, take_q, at(starts_p),
                          torch.where(borrowed, lens_raw, lens_q), offs_q)

    k3, c3 = kk[..., None], cell[..., None]
    return (pools["pool_idx"][k3, c3, s_pos].long(),
            pools["pool_idx"][k3, c3, q_pos].long())


def make_device_batch_fn(T: int, S: int, Q: int,
                         constraints: Optional[EpisodeConstraints] = None):
    """Episodic sampling on the pools' device: ``sample_batch(pools,
    draws)`` → the stacked (K, T, ·, ·) batch of ``make_meta_train_step``
    ({support_rays, support_rgbs, query_rays, query_rgbs}), the layout of
    ``data.tasks.MultiTaskSampler.sample_batch``. ``pools`` from
    ``pools_to_device``; ``draws`` a ``torch.Generator`` on their device or
    ``draw_episodes``'s dict (the tests inject JAX's draws). No host wait."""

    def sample_batch(pools: Dict[str, torch.Tensor], draws) -> Dict[str, torch.Tensor]:
        if isinstance(draws, torch.Generator):
            draws = draw_episodes(pools, T, draws)
        s_ids, q_ids = episode_ray_ids(pools, draws, S, Q, constraints)
        k3 = torch.arange(s_ids.shape[0], device=s_ids.device)[:, None, None]
        return {"support_rays": pools["rays"][k3, s_ids],
                "support_rgbs": pools["rgbs"][k3, s_ids],
                "query_rays": pools["rays"][k3, q_ids],
                "query_rgbs": pools["rgbs"][k3, q_ids]}

    return sample_batch
