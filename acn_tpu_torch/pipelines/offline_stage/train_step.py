"""One FoMAML meta-training step through the packed-budget occupancy renderer.

Port of ``acn_tpu/pipelines/offline_stage/train_step.py`` for the "budget"
regime: ``make_bg_fn``, ``make_episode_loss`` (the budget branch of
``prepare_samples`` and ``render_chunk``, ``use_amp``, the unchunked loss),
the ``fomaml`` branch of ``_meta_grads_gradbased`` and
``make_meta_train_step`` with its seven metrics.

Where the JAX step is one XLA program that vmaps the K experts and scans the
T tasks, **the K and T axes are Python loops here**, one episode at a time
(the torch reference this system was modelled on did the same): one expert's
fast weights are in flight at a time, and each loss's graph is freed by
``torch.autograd.grad`` before the next loss is built. Per step that is
K·T·(inner_iter + 1) episode losses, each with one backward, so on the card
the segmented scan's forward and reverse kernels launch that many times each.

Randomness: ``acn_tpu`` draws one salt per march from its key; here the
caller passes ``salts`` (K, T, 2) — [..., 0] for the support march, [..., 1]
for the query march — drawn with ``draw_salts`` from a ``torch.Generator``,
or ``None`` for bin midpoints.

bf16 (``P.use_amp``): parameters and network inputs are cast to bf16 by hand
before ``world_to_unit`` (so the hash cell and fraction are bf16 decisions
and the table gradient is summed in bf16), sampling, compositing and the loss
stay float32, and gradients come back through the casts onto the float32
parameters. ``torch.autocast`` does none of this and is not used.

Not ported, each raising ``NotImplementedError`` with its ROADMAP item: the
stratified step (``occ_cfg=None``), the strided ``march_rays`` step
(budget 0) and ``report_budget``, the chunked loss (``train_chunk_rays``),
``maml``, ``reptile`` and ``fim``; ``make_eval_step`` and
``make_device_batch_fn`` come with the trainer loop.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from acn_tpu_torch.models import container as cont
from acn_tpu_torch.models import ngp as ngp_mod
from acn_tpu_torch.models.container import ContainerConfig
from acn_tpu_torch.models.nn import tree_cast, tree_leaves, tree_map
from acn_tpu_torch.nerfs.losses import aligned_mse_loss, psnr_from_mse
from acn_tpu_torch.nerfs.render import bg_default_color, composite_packed
from acn_tpu_torch.occupancy import grid as occ_grid
from acn_tpu_torch.occupancy.grid import OccConfig
from acn_tpu_torch.pipelines.offline_stage import meta_core
from acn_tpu_torch.pipelines.renderer import resolve_device
from acn_tpu_torch.utils.optim import Optimizer, apply_updates


def draw_salts(K: int, T: int, generator: torch.Generator) -> torch.Tensor:
    """(K, T, 2) march salts in [0, 2³¹ − 1), as ``acn_tpu`` draws each of
    its own (``jax.random.randint(key, (), 0, int32.max)``)."""
    return torch.randint(0, 2**31 - 1, (K, T, 2), generator=generator,
                         device=generator.device)


def make_bg_fn(cfg: ContainerConfig, P) -> Callable:
    """(bg_params, dirs (N,3)) → (N,3) background RGB, or None."""
    if cfg.use_bg_nerf:
        return lambda bg_params, dirs: cont.bg_mlp_color(bg_params, cfg, dirs)
    policy = P.bg_color_default
    return lambda bg_params, dirs: bg_default_color(
        dirs.shape[0], policy, device=dirs.device)


def make_episode_loss(
    cfg: ContainerConfig,
    P,
    occ_cfg: Optional[OccConfig] = None,
    budget_override: Optional[int] = None,
    report_budget: int = 0,
):
    """The episode loss and its march for the packed-budget regime.

    Returns (loss_fn, prepare_samples):

    * ``loss_fn(expert_params, bg_params, aabb, rays, rgbs, samples)`` → 0-dim
      loss: evaluate ONE expert (any parameter tree of an expert's structure,
      so fast weights too) on the packed samples, composite, align and MSE
      against the ground truth.
    * ``prepare_samples(occ_state, rays, salt)``: the budget march of one
      episode's rays over that expert's grid. Marching has no trainable
      input, so the step marches once per episode and reuses the samples in
      every inner iteration.
    """
    if occ_cfg is None:
        raise NotImplementedError(
            "the stratified episode loss (occ_cfg=None) is not ported: "
            "ROADMAP.md M2 (render_rays_stratified)")
    if int(getattr(P, "train_chunk_rays", 0) or 0) > 0:
        raise NotImplementedError(
            "the chunked episode loss (train_chunk_rays > 0) is not ported: "
            "ROADMAP.md M2")
    if int(report_budget):
        raise NotImplementedError(
            "report_budget (the strided march's would-be overflow) is not "
            "ported: ROADMAP.md M3 (march_rays)")
    budget = (int(budget_override) if budget_override is not None
              else int(getattr(P, "occ_budget_per_ray", 0) or 0))
    if budget <= 0:
        raise NotImplementedError(
            "the per-ray occupancy step (budget 0, strided march_rays) is not "
            "ported: ROADMAP.md M3")
    bg_fn = make_bg_fn(cfg, P)
    use_amp = bool(getattr(P, "use_amp", False))
    s_max = int(P.occ_s_max)

    def prepare_samples(occ_state, rays, salt):
        return occ_grid.march_rays_budget(occ_state, rays, occ_cfg, s_max,
                                          budget, salt=salt)

    def loss_fn(expert_params, bg_params, aabb, rays, rgbs, samples):
        bg = bg_fn(bg_params, rays[:, 3:6])
        xd = samples["xd"]
        if use_amp:
            expert_params = tree_cast(expert_params, torch.bfloat16)
            xd = xd.to(torch.bfloat16)
        out = ngp_mod.ngp_forward(expert_params, cfg.expert, aabb, xd)
        out = out.to(torch.float32)
        rgb_map = composite_packed(out[..., 3], out[..., :3], samples,
                                   rays.shape[0], bg_rgb=bg,
                                   with_stats=False)[0]
        return aligned_mse_loss(rgb_map, rgbs, P.color_space)

    return loss_fn, prepare_samples


def _salt(salts, k: int, t: int, j: int):
    """One march's salt: a Python int from host salts (no copy to the card),
    a 0-dim tensor from salts on the card (no wait for it), None for none."""
    if salts is None:
        return None
    s = salts[k, t, j]
    return s if isinstance(s, torch.Tensor) and s.device.type != "cpu" else int(s)


def _meta_grads_fomaml(episode_loss, prep, params, aabbs, occ_states, batch,
                       salts, inner_lr: float, inner_iter: int):
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
    g_experts = tree_map(torch.zeros_like, experts)
    g_bg = tree_map(torch.zeros_like, bg) if has_bg else None
    bg_const = tree_map(lambda p: p.detach(), bg) if has_bg else None
    q_losses, inner_losses, ovfs = [], [], []
    for k in range(K):
        expert_p = cont.expert_slice(experts, k)
        aabb = aabbs[k]
        occ_state = {name: v[k] for name, v in occ_states.items()}
        g_bg_k = tree_map(torch.zeros_like, bg) if has_bg else None
        for t in range(T):
            sr, sg = batch["support_rays"][k, t], batch["support_rgbs"][k, t]
            qr, qg = batch["query_rays"][k, t], batch["query_rgbs"][k, t]
            smp_s = prep(occ_state, sr, _salt(salts, k, t, 0))
            smp_q = prep(occ_state, qr, _salt(salts, k, t, 1))
            ovfs.append((smp_s["overflow"] + smp_q["overflow"]) * 0.5)

            fast, inner = meta_core.task_adapt(
                lambda p, b: episode_loss(p, bg_const, aabb, b[0], b[1], smp_s),
                expert_p, (sr, sg), inner_lr, inner_iter, first_order=True)
            q_loss = episode_loss(fast, bg, aabb, qr, qg, smp_q)
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


def make_meta_train_step(
    cfg: ContainerConfig,
    P,
    optimizer: Optimizer,
    occ_cfg: Optional[OccConfig] = None,
    budget_override: Optional[int] = None,
    report_budget: int = 0,
    device=None,
):
    """Build the meta-train step of the packed-budget regime.

    ``train_step(state, batch, occ_states, salts=None)`` → (state, metrics).
    ``state`` = {"model": ``Container``, "opt_state": ``optimizer.init``'s,
    "step": int}: the model's parameters are updated **in place** and the
    returned state holds the same model. ``batch`` = stacked (K, T, ·, ·)
    episode tensors {support_rays, support_rgbs, query_rays, query_rgbs},
    ``occ_states`` the stacked (K, ...) occupancy states, ``salts`` as
    ``draw_salts`` makes them (or None: bin midpoints). Everything lies on
    ``device``: ``None`` means the card, and raises without one.

    ``metrics`` = {loss_out, loss_in, psnr_out, psnr_in (K,), loss_total,
    grad_norm, occ_overflow (0-dim)}, tensors on the device: the step does
    not wait for the card, reading a metric does.
    """
    device = resolve_device(device)
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
    episode_loss, prep = make_episode_loss(
        cfg, P, occ_cfg, budget_override=budget_override,
        report_budget=report_budget)
    inner_lr = float(P.inner_lr)
    inner_iter = int(P.inner_iter)

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor],
                   occ_states: Dict[str, torch.Tensor],
                   salts=None) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        model = state["model"]
        params = model.params()
        on = {t.device.type for t in (*tree_leaves(params), *batch.values(),
                                      *occ_states.values())}
        if on != {device.type}:
            raise ValueError(f"this step runs on {device.type!r}; the model, "
                             f"batch or occupancy states lie on {sorted(on)}")

        q_losses, inner_losses, g_experts, g_bg, occ_overflow = _meta_grads_fomaml(
            episode_loss, prep, params, model.expert_aabbs, occ_states, batch,
            salts, inner_lr, inner_iter)
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
