"""Interactive web viewer (viser-based) with live runtime adaptation.

Port of ``acn_tpu/viewer/viewer.py``: ``launch_viewer`` starts a viser server
with GUI panels for visuals (background policy, active-module isolation,
occupancy toggle, sample counts), postprocessing (RGB/Depth/Opacity display,
colormaps, exposure/gamma, near/far overrides), a crop box, camera snapping,
and an Operation-Mode panel (View / Runtime-Adapt / Meta-Train) with
Start/Pause/Resume/Stop/Step-once plus live hyperparameter knobs.

``render_frame`` converts the viser camera (RUB world) into the dataset's
normalized DRB frame and renders through ``Renderer.render_image`` (or the
baked table) from the snapshot that the controller's runner has published,
leased for the frame's length: a training step writes another copy
(``engine/runners/base.py``), so no lock is held around the frame. The
result is tonemapped to uint8.

``viser`` is an optional dependency; without it ``launch_viewer`` raises
``acn_tpu``'s ImportError (the headless engine, controller and runners,
works regardless and is what ``chip_smoke.py`` drives).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np

from acn_tpu_torch.pipelines.renderer import Renderer
from acn_tpu_torch.viewer.colormap import ColormapOptions, apply_colormap, apply_depth_colormap
from acn_tpu_torch.viewer.engine.controller import Controller
from acn_tpu_torch.viewer.utils import (
    RUB_TO_DRB,
    sanitize_bg_policy,
    sanitize_module_selection,
    srgb_u8,
    verify_continual_batch_dir,
)


class ViewerState:
    """Mutable GUI state. ``bg_policy`` follows the Background dropdown but
    no frame reads it, as in ``acn_tpu``."""

    def __init__(self, P):
        self.display = "rgb"  # rgb | depth | opacity
        self.bg_policy = sanitize_bg_policy(P.bg_color_default)
        self.active_module: Optional[int] = None
        self.use_occ = bool(getattr(P, "use_occ", False))
        self.full_samples = int(P.ray_samples)
        self.preview_samples = max(int(P.ray_samples) // 2, 8)
        self.exposure = 0.0
        self.gamma = 1.0
        self.near_override_m: Optional[float] = None
        self.far_override_m: Optional[float] = None
        self.depth_colormap = "turbo"
        self.use_baked = False  # serve the --baked_asset table when present
        # crop box: viewer-world meters; rendering clamps rays to the
        # world-aligned bound of the rotated box (obb_to_aabb) intersected
        # with the global scene box
        self.crop_enabled = False
        self.crop_pos_m = (0.0, 0.0, 0.0)
        self.crop_rpy_deg = (0.0, 0.0, 0.0)
        self.crop_size_m = (100.0, 100.0, 100.0)


def crop_render_aabb(
    global_aabb: np.ndarray,
    origin: np.ndarray,
    psf: float,
    crop_pos_m,
    crop_rpy_deg,
    crop_size_m,
) -> np.ndarray:
    """Render AABB under an OBB crop, as the world-aligned bound of the
    rotated box (obb_to_aabb) intersected with the global scene box. Crop
    parameters are viewer-world (RUB) meters; output is normalized DRB.
    Exact when the rotation is zero."""
    from acn_tpu_torch.nerfs.scene_box import obb_from_params, obb_to_aabb

    R_obb, T_obb, S_obb = obb_from_params(
        (RUB_TO_DRB @ np.asarray(crop_pos_m, np.float32) - origin) / psf,
        tuple(np.deg2rad(v) for v in crop_rpy_deg),
        np.asarray(crop_size_m, np.float32) / psf,
    )
    crop_aabb = obb_to_aabb((RUB_TO_DRB @ R_obb.numpy(), T_obb, S_obb)).numpy()
    return np.stack(
        [
            np.maximum(global_aabb[0], crop_aabb[0]),
            np.minimum(global_aabb[1], crop_aabb[1]),
        ]
    )


def render_frame(
    ctx: Dict[str, Any],
    controller: Controller,
    renderer: Renderer,
    state: ViewerState,
    *,
    c2w_rub_world: np.ndarray,  # (3, 4) pose in un-normalized viewer world
    H: int,
    W: int,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    preview: bool = False,
) -> np.ndarray:
    """Render one frame → uint8 (H, W, 3). A live frame reads one published
    snapshot, leased from the controller until it is done."""
    P = ctx["P"]
    coord = ctx["coordinate_info"]
    psf = float(coord["pose_scale_factor"])
    origin = np.asarray(coord["origin_drb"], np.float32)

    # viewer RUB world → normalized DRB
    R = RUB_TO_DRB @ c2w_rub_world[:, :3]
    t = (RUB_TO_DRB @ c2w_rub_world[:, 3] - origin) / psf
    c2w = np.concatenate([R, t[:, None]], axis=1).astype(np.float32)

    near_far = (
        state.near_override_m / psf if state.near_override_m else None,
        state.far_override_m / psf if state.far_override_m else None,
    )
    baked = ctx.get("baked_renderer")
    if baked is not None and getattr(state, "use_baked", True):
        # amortized serving (--baked_asset): the voxel-table field — no
        # per-sample hash/MLP work, interactive even at full resolution
        rgb, depth, acc = baked.render_image(
            H=H, W=W,
            intrinsics=np.array([fx, fy, cx, cy], np.float32),
            c2w=c2w,
            near_far_override=near_far,
        )
    else:
        render_aabb = np.asarray(ctx["global_aabb"])
        if state.crop_enabled:
            render_aabb = crop_render_aabb(
                render_aabb, origin, psf,
                state.crop_pos_m, state.crop_rpy_deg, state.crop_size_m,
            )
        with controller.get_render_params() as (model, occ_states):
            rgb, depth, acc = renderer.render_image(
                model,
                occ_states,
                H=H,
                W=W,
                intrinsics=np.array([fx, fy, cx, cy], np.float32),
                c2w=c2w,
                aabb=render_aabb,
                active_module=state.active_module,
                use_occ=state.use_occ and occ_states is not None,
                near_far_override=near_far,
                ray_samples=state.preview_samples if preview else state.full_samples,
            )

    if state.display == "depth":
        img = apply_depth_colormap(
            depth.reshape(H, W, 1), acc.reshape(H, W, 1),
            options=ColormapOptions(colormap=state.depth_colormap),
        )
    elif state.display == "opacity":
        img = apply_colormap(acc.reshape(H, W, 1))
    else:
        img = rgb
        if state.exposure != 0.0:
            img = img * (2.0 ** state.exposure)
        if state.gamma != 1.0:
            img = np.power(np.clip(img, 1e-6, 1.0), 1.0 / state.gamma)
    return srgb_u8(img)


def _rot_to_wxyz(R: np.ndarray) -> np.ndarray:
    """Rotation matrix → unit quaternion (w, x, y, z)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([
            0.25 * s, (R[2, 1] - R[1, 2]) / s,
            (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s,
        ])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def _load_snap_views(ctx, max_views: int = 30):
    """Dataset camera poses → viewer-world (position, wxyz) for snapping.
    Inverse of render_frame's RUB→DRB map; none when the dataset cannot be
    read."""
    try:
        from acn_tpu_torch.data.dataset import get_image_metadata

        train_md, val_md = get_image_metadata(
            ctx["data_path"], ctx["P"].downscale
        )
        metas = [m for m in (val_md or train_md) if m is not None][:max_views]
    except Exception:
        return []
    coord = ctx.get("coordinate_info", {})
    psf = float(coord.get("pose_scale_factor", 1.0))
    origin = np.asarray(coord.get("origin_drb", np.zeros(3)), np.float32)
    views = []
    for md in metas:
        c2w = np.asarray(md.c2w, np.float32)  # RUB-cam → normalized DRB world
        R_v = RUB_TO_DRB.T @ c2w[:, :3]
        pos = RUB_TO_DRB.T @ (c2w[:, 3] * psf + origin)
        views.append((pos.astype(np.float64), _rot_to_wxyz(R_v)))
    return views


def launch_viewer(ctx: Dict[str, Any]):
    """Start the viser server and serve until ``P.viewer_timeout`` seconds
    have passed (forever when negative)."""
    try:
        import viser
    except ImportError as e:
        raise ImportError(
            "The interactive viewer needs the optional 'viser' package; the "
            "headless engine (acn_tpu.viewer.engine) works without it."
        ) from e

    P = ctx["P"]
    if "coordinate_info" not in ctx:
        from acn_tpu_torch.data.dataset import load_coordinates

        ctx["coordinate_info"] = load_coordinates(ctx["data_path"])

    controller = Controller(ctx)
    renderer = Renderer(ctx["cfg"], P, ctx["occ_cfg"], device=ctx.get("device"))
    state = ViewerState(P)
    K = ctx["cfg"].num_submodules

    if getattr(P, "baked_asset", None):
        # serve the baked voxel table (--op bake) — interactive full-res
        from acn_tpu_torch.pipelines.baking import BakedRenderer, load_baked

        ctx["baked_renderer"] = BakedRenderer(
            load_baked(P.baked_asset, device=ctx.get("device")),
            budget_per_ray=int(getattr(P, "occ_budget_per_ray", 0) or 24),
            chunk_points=int(P.chunk_points),
            bg_color=P.bg_color_default,
            s_coarse=int(getattr(P, "occ_render_s_coarse", 0) or 0),
        )
        state.use_baked = True

    server = viser.ViserServer(
        host=str(getattr(P, "viewer_public_host", "0.0.0.0")), port=8080
    )

    # ---- Visuals panel ----
    with server.gui.add_folder("Visuals"):
        gui_display = server.gui.add_dropdown(
            "Display", ("rgb", "depth", "opacity"), initial_value="rgb"
        )
        gui_bg = server.gui.add_dropdown(
            "Background", ("white", "black", "random", "none"),
            initial_value=state.bg_policy,
        )
        gui_module = server.gui.add_dropdown(
            "Active module", ("all", *[str(i) for i in range(K)]),
            initial_value="all",
        )
        gui_occ = server.gui.add_checkbox("Occupancy renderer", state.use_occ)
        gui_baked = None
        if ctx.get("baked_renderer") is not None:
            gui_baked = server.gui.add_checkbox(
                "Serve baked table", True,
                hint="render from the --baked_asset voxel table (fast) "
                     "instead of the live field",
            )

    with server.gui.add_folder("Sampling"):
        gui_full_samples = server.gui.add_slider(
            "Full samples", 8, 256, 4, state.full_samples
        )
        gui_preview_samples = server.gui.add_slider(
            "Preview samples", 4, 128, 4, state.preview_samples
        )

    # ---- Postprocessing ----
    with server.gui.add_folder("Postprocessing"):
        gui_exposure = server.gui.add_slider("Exposure", -4.0, 4.0, 0.1, 0.0)
        gui_gamma = server.gui.add_slider("Gamma", 0.5, 3.0, 0.05, 1.0)
        gui_depth_cmap = server.gui.add_dropdown(
            "Depth colormap", ("turbo", "viridis", "gray"),
            initial_value=state.depth_colormap,
        )
        psf = float(ctx.get("coordinate_info", {}).get("pose_scale_factor", 1.0))
        gui_near = server.gui.add_slider("Near (m)", 0.0, 500.0, 1.0, 0.0)
        gui_far = server.gui.add_slider("Far (m)", 0.0, 5000.0, 10.0, 0.0)

    # ---- Crop box ----
    with server.gui.add_folder("Crop"):
        gui_crop_on = server.gui.add_checkbox("Enable crop", False)
        gui_crop_pos = server.gui.add_vector3(
            "Center (m)", (0.0, 0.0, 0.0), step=1.0
        )
        gui_crop_rpy = server.gui.add_vector3(
            "Roll/Pitch/Yaw (deg)", (0.0, 0.0, 0.0), step=1.0
        )
        gui_crop_size = server.gui.add_vector3(
            "Size (m)", (100.0, 100.0, 100.0), step=1.0
        )

    # ---- Camera ----
    snap_views = _load_snap_views(ctx)
    last_cam = {"c2w": None, "client": None}
    with server.gui.add_folder("Camera"):
        gui_snap = server.gui.add_dropdown(
            "Dataset view",
            tuple(str(i) for i in range(max(len(snap_views), 1))),
            initial_value="0",
        )
        gui_snap_btn = server.gui.add_button("Snap to view")
        gui_dolly_in = server.gui.add_button("Dolly in")
        gui_dolly_out = server.gui.add_button("Dolly out")
        gui_shot = server.gui.add_button("Screenshot")

    # ---- Operation mode ----
    with server.gui.add_folder("Operation Mode"):
        gui_mode = server.gui.add_dropdown(
            "Mode", ("view", "runtime_adapt", "meta_train"), initial_value="view"
        )
        gui_target = server.gui.add_number("Target steps", 0)
        gui_start = server.gui.add_button("Start")
        gui_pause = server.gui.add_button("Pause")
        gui_resume = server.gui.add_button("Resume")
        gui_stop = server.gui.add_button("Stop")
        gui_step = server.gui.add_button("Step once")
        gui_reset = server.gui.add_button("Reset weights")
        gui_status = server.gui.add_text("Status", initial_value="idle", disabled=True)

    # ---- Live hyperparameters ----
    with server.gui.add_folder("Hyperparameters"):
        gui_support = server.gui.add_number(
            "Support rays", int(P.support_rays)
        )
        gui_downscale = server.gui.add_number(
            "Downscale", float(P.downscale)
        )
        gui_lrs = {
            g: server.gui.add_number(f"lr/{g}", float(v))
            for g, v in (
                ("encoding", P.encoding_lr), ("sigma", P.sigma_lr),
                ("color", P.color_lr), ("background", P.bg_lr),
            )
        }

    # ---- Continual batches + checkpoints ----
    with server.gui.add_folder("Continual batches"):
        gui_batch_dir = server.gui.add_text("Batch dir", initial_value="")
        gui_scan = server.gui.add_button("Scan && Verify")
        gui_scan_out = server.gui.add_text("Scan result", initial_value="",
                                           disabled=True)
        gui_save_ckpt = server.gui.add_button("Save runtime checkpoint")

    def sync_state(_=None):
        state.display = gui_display.value
        state.bg_policy = sanitize_bg_policy(gui_bg.value)
        state.active_module = sanitize_module_selection(gui_module.value, K)
        state.use_occ = bool(gui_occ.value)
        state.exposure = float(gui_exposure.value)
        state.gamma = float(gui_gamma.value)
        state.depth_colormap = gui_depth_cmap.value
        state.full_samples = int(gui_full_samples.value)
        state.preview_samples = int(gui_preview_samples.value)
        state.near_override_m = float(gui_near.value) or None
        state.far_override_m = float(gui_far.value) or None
        if gui_baked is not None:
            state.use_baked = bool(gui_baked.value)
        state.crop_enabled = bool(gui_crop_on.value)
        state.crop_pos_m = tuple(map(float, gui_crop_pos.value))
        state.crop_rpy_deg = tuple(map(float, gui_crop_rpy.value))
        state.crop_size_m = tuple(map(float, gui_crop_size.value))

    for h in (gui_display, gui_bg, gui_module, gui_occ, gui_exposure,
              gui_gamma, gui_depth_cmap, gui_full_samples,
              gui_preview_samples, gui_near, gui_far,
              gui_crop_on, gui_crop_pos, gui_crop_rpy, gui_crop_size,
              *([gui_baked] if gui_baked is not None else [])):
        h.on_update(sync_state)

    def sync_hparams(_=None):
        r = controller.runner
        r.support_rays = max(int(gui_support.value), 16)
        r.downscale = float(gui_downscale.value)
        for g, h in gui_lrs.items():
            r.update_lr(g, float(h.value))

    for h in (gui_support, gui_downscale, *gui_lrs.values()):
        h.on_update(sync_hparams)

    def on_scan(_):
        try:
            res = verify_continual_batch_dir(gui_batch_dir.value)
            gui_scan_out.value = f"OK: {res}"
        except Exception as e:
            gui_scan_out.value = f"FAIL: {e}"

    gui_scan.on_click(on_scan)
    gui_save_ckpt.on_click(
        lambda _: controller.runner.save_runtime_checkpoint(
            ctx["logger"].logdir if "logger" in ctx else "logs/viewer"
        )
    )
    gui_reset.on_click(lambda _: controller.runner.reset_fast())

    def on_mode(_):
        kwargs = {}
        if gui_mode.value == "runtime_adapt" and gui_batch_dir.value:
            from pathlib import Path

            kwargs["batch_dir"] = Path(gui_batch_dir.value)
        controller.set_mode(gui_mode.value, **kwargs)
        sync_hparams()

    gui_mode.on_update(on_mode)
    gui_start.on_click(lambda _: controller.start(int(gui_target.value)))
    gui_pause.on_click(lambda _: controller.pause())
    gui_resume.on_click(lambda _: controller.resume())
    gui_stop.on_click(lambda _: controller.stop())
    gui_step.on_click(lambda _: controller.step_once())

    def snap_camera(_):
        client = last_cam["client"]
        if client is None or not snap_views:
            return
        i = min(int(gui_snap.value), len(snap_views) - 1)
        pos_rub, wxyz = snap_views[i]
        client.camera.position = pos_rub
        client.camera.wxyz = wxyz

    def dolly(sign):
        client = last_cam["client"]
        if client is None:
            return
        import viser.transforms as vtf

        Rm = vtf.SO3(client.camera.wxyz).as_matrix()
        fwd = -Rm[:, 2]  # RUB: -z forward
        step = 0.05 * float(
            ctx.get("coordinate_info", {}).get("pose_scale_factor", 1.0)
        )
        client.camera.position = client.camera.position + sign * step * fwd

    gui_snap_btn.on_click(snap_camera)
    gui_dolly_in.on_click(lambda _: dolly(+1.0))
    gui_dolly_out.on_click(lambda _: dolly(-1.0))

    def screenshot(_):
        c2w = last_cam["c2w"]
        if c2w is None:
            return
        from pathlib import Path

        from acn_tpu_torch.data.png import write_png

        H, W = 1080, 1920
        fy = H / (2 * np.tan(last_cam.get("fov", 1.0) / 2))
        img = render_frame(
            ctx, controller, renderer, state, c2w_rub_world=c2w,
            H=H, W=W, fx=fy, fy=fy, cx=W / 2, cy=H / 2, preview=False,
        )
        out = Path("logs/screenshots")
        out.mkdir(parents=True, exist_ok=True)
        p = out / f"shot_{int(time.time())}.png"
        write_png(p, img)
        gui_status.value = f"saved {p}"

    gui_shot.on_click(screenshot)

    @server.on_client_connect
    def _(client: "viser.ClientHandle"):
        last_cam["client"] = client

        @client.camera.on_update
        def _(_):
            cam = client.camera
            H, W = 480, int(480 * cam.aspect)
            fy = H / (2 * np.tan(cam.fov / 2))
            import viser.transforms as vtf

            R = vtf.SO3(cam.wxyz).as_matrix()
            c2w = np.concatenate([R, cam.position[:, None]], axis=1)
            last_cam["c2w"] = c2w.astype(np.float32)
            last_cam["fov"] = float(cam.fov)
            img = render_frame(
                ctx, controller, renderer, state,
                c2w_rub_world=c2w.astype(np.float32),
                H=H, W=W, fx=fy, fy=fy, cx=W / 2, cy=H / 2, preview=True,
            )
            client.scene.set_background_image(img)

    timeout = int(getattr(P, "viewer_timeout", 900))
    t0 = time.time()
    try:
        while timeout < 0 or time.time() - t0 < timeout:
            if controller.is_running:
                m = controller.last_metrics
                gui_status.value = (
                    f"step {int(m.get('step', 0))} psnr {m.get('psnr', 0):.2f}"
                )
            time.sleep(0.5)
    finally:
        controller.stop()
        server.stop()
