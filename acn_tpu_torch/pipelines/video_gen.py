"""Novel-view video along a camera path, live or from a baked asset.

Port of ``acn_tpu/pipelines/video_gen.py``: the five camera paths
(turntable orbit, east-west and north-south cosine-eased sweeps, an inside
spiral, a serpentine grid) as host numpy, fog suppression from opacity and
weight-shape statistics, and ``render_video``: live frames from host rays
through ``Renderer.render_rays(with_stats=True)`` with fog suppressed, or
frames of a ``--baked_asset`` through ``BakedRenderer``. ``_write_video``
writes an MP4 through imageio (libx264); when imageio is not importable or
has no MP4 backend, an animated GIF through Pillow; it logs which encoder
wrote the file, and raises naming both when neither is importable.

Conventions: the world is DRB (x Down, y Right/east, z Back/south), cameras
are RUB with columns [right, up, −forward]; world up is −D = (−1, 0, 0).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict

import numpy as np


def _write_video(out_path: str, frames, fps: int, logger) -> str:
    """Encode ``frames`` (u8 (H, W, 3) each) as an MP4 at ``out_path``, or as
    a GIF beside it; returns the path written."""
    try:
        import imageio.v3 as iio
    except ImportError:
        iio = None
        logger.log("[video] imageio is not importable: no MP4 backend; "
                   "falling back to GIF via Pillow")
    if iio is not None:
        try:
            iio.imwrite(out_path, np.stack(frames), fps=fps, codec="libx264", quality=8)
            logger.log(f"[video] wrote {out_path} ({len(frames)} frames, imageio libx264)")
            return out_path
        except Exception as e:  # no ffmpeg / pyav backend
            logger.log(f"[video] mp4 encode unavailable ({type(e).__name__}); "
                       "falling back to GIF via Pillow")
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("writing a video needs imageio (MP4) or Pillow (GIF), and "
                          "neither is importable") from e
    gif_path = str(Path(out_path).with_suffix(".gif"))
    ims = [Image.fromarray(f) for f in frames]
    ims[0].save(gif_path, save_all=True, append_images=ims[1:],
                duration=max(int(1000 / fps), 20), loop=0)
    logger.log(f"[video] wrote {gif_path} ({len(frames)} frames, Pillow GIF)")
    return gif_path


UP_WORLD = np.array([-1.0, 0.0, 0.0], np.float32)  # −D is up in DRB


def _look_at(cam: np.ndarray, target: np.ndarray) -> np.ndarray:
    """c2w (4, 4) with RUB columns, looking from cam toward target."""
    fwd = target - cam
    fwd = fwd / max(np.linalg.norm(fwd), 1e-12)
    right = np.cross(fwd, UP_WORLD)
    right = right / max(np.linalg.norm(right), 1e-12)
    up = np.cross(right, fwd)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.stack([right, up, -fwd], axis=1)
    c2w[:3, 3] = cam
    return c2w


def _look_same_height(cam: np.ndarray, center: np.ndarray) -> np.ndarray:
    """Look at the center moved to the camera's own height (D axis)."""
    target = np.array([cam[0], center[1], center[2]], np.float32)
    return _look_at(cam, target)


def poses_turntable(center: np.ndarray, radius: float, phi_deg: float = 20.0,
                    n_poses: int = 120, tilt_deg: float = 0.0) -> np.ndarray:
    """An orbit around the center at elevation phi (at least 12°), rolled by
    ``tilt_deg`` about the view axis. Returns (T, 4, 4)."""
    phi = math.radians(max(phi_deg, 12.0))
    s_phi, c_phi = math.sin(phi), math.cos(phi)
    thetas = np.linspace(0, 2 * math.pi, n_poses + 1)[:-1]
    poses = []
    for th in thetas:
        d = -radius * s_phi  # above the scene (−D is up)
        r = radius * c_phi * math.cos(th)
        b = radius * c_phi * math.sin(th)
        cam = center + np.array([d, r, b], np.float32)
        c2w = _look_at(cam, center)
        if abs(tilt_deg) > 1e-6:
            k = c2w[:3, 2] / max(np.linalg.norm(c2w[:3, 2]), 1e-12)  # back axis
            K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]], np.float32)
            ct, st = math.cos(math.radians(tilt_deg)), math.sin(math.radians(tilt_deg))
            R_tilt = np.eye(3, dtype=np.float32) * ct + (1 - ct) * np.outer(k, k) + st * K
            c2w[:3, :3] = c2w[:3, :3] @ R_tilt
        poses.append(c2w)
    return np.stack(poses)


def _sweep(center, extent, n_poses, axis: int, height_frac=-0.12, margin=0.90):
    """A cosine-eased sweep along one ground axis (1 = R, east-west; 2 = B,
    north-south) with a sinusoidal offset on the other."""
    half = 0.5 * np.abs(extent)
    other = 3 - axis
    a0, a1 = -margin * half[axis], +margin * half[axis]
    off_amp = 0.15 * half[other]
    d = height_frac * half[0]

    ts = np.linspace(0, 1, n_poses)
    u = 0.5 * (1 - np.cos(np.pi * ts))
    poses = []
    for t, w in zip(ts, u):
        pos = np.array([d, 0.0, 0.0], np.float32)
        pos[axis] = (1 - w) * a0 + w * a1
        pos[other] = off_amp * math.sin(2 * math.pi * t)
        poses.append(_look_same_height(center + pos, center))
    return np.stack(poses)


def poses_east_west(center, extent, n_poses, **kw):
    return _sweep(center, extent, n_poses, axis=1, **kw)


def poses_north_south(center, extent, n_poses, **kw):
    return _sweep(center, extent, n_poses, axis=2, **kw)


def poses_spiral_in(center, extent, n_poses, turns: float = 2.0,
                    radial_frac: float = 0.6, height_center_frac: float = -0.15,
                    height_amp_frac: float = 0.10) -> np.ndarray:
    """A spiral inside the box with a mild height variation."""
    half = 0.5 * np.abs(extent)
    min_half = 0.5 * float(np.min(np.abs(extent)))
    r_base = radial_frac * min_half
    d_center = height_center_frac * half[0]
    d_amp = height_amp_frac * half[0]

    thetas = np.linspace(0, 2 * math.pi * turns, n_poses)
    poses = []
    for th in thetas:
        rad = r_base * (0.85 + 0.15 * math.cos(th * 0.5))
        r = np.clip(rad * math.cos(th), -half[1] * 0.95, half[1] * 0.95)
        b = np.clip(rad * math.sin(th), -half[2] * 0.95, half[2] * 0.95)
        d = np.clip(d_center + d_amp * math.sin(0.5 * th), -half[0] * 0.9, half[0] * 0.9)
        poses.append(_look_at(center + np.array([d, r, b], np.float32), center))
    return np.stack(poses)


def poses_full_coverage(center, extent, n_poses, rows: int = 6, cols: int = 9,
                        height_start_frac: float = -0.18,
                        height_end_frac: float = +0.18) -> np.ndarray:
    """A serpentine sweep over a rows × cols grid of waypoints with eased
    legs and a slow height ramp, cut or padded to ``n_poses``."""
    half = 0.5 * np.abs(extent)
    Rvals = np.linspace(-0.85 * half[1], 0.85 * half[1], cols)
    Bvals = np.linspace(-0.85 * half[2], 0.85 * half[2], rows)

    waypoints = []
    for i, b in enumerate(Bvals):
        Rs = Rvals if i % 2 == 0 else Rvals[::-1]
        waypoints.extend((float(r), float(b)) for r in Rs)

    legs = max(1, len(waypoints) - 1)
    f_per_leg = max(2, math.ceil(n_poses / legs))
    total = legs * f_per_leg
    t_heights = np.linspace(0, 1, total)
    d0, d1 = height_start_frac * half[0], height_end_frac * half[0]

    poses = []
    idx = 0
    for k in range(legs):
        (r0, b0), (r1, b1) = waypoints[k], waypoints[k + 1]
        for j in range(f_per_leg):
            w = 0.5 * (1 - math.cos(math.pi * j / f_per_leg))
            r = (1 - w) * r0 + w * r1
            b = (1 - w) * b0 + w * b1
            d = (1 - t_heights[idx]) * d0 + t_heights[idx] * d1
            idx += 1
            poses.append(_look_at(center + np.array([d, r, b], np.float32), center))
    poses = np.stack(poses)
    if len(poses) > n_poses:
        poses = poses[:n_poses]
    elif len(poses) < n_poses:
        poses = np.concatenate([poses, np.repeat(poses[-1:], n_poses - len(poses), 0)])
    return poses


PATH_GENERATORS = {
    "turntable": None,  # special-cased (radius argument)
    "east_west": poses_east_west,
    "north_south": poses_north_south,
    "spiral_in": poses_spiral_in,
    "full_coverage": poses_full_coverage,
}


def suppress_fog(rgb: np.ndarray, acc: np.ndarray, wmax: np.ndarray, went: np.ndarray,
                 bg_val: float, acc_thr: float = 0.05, wmax_thr: float = 0.08,
                 entropy_thr: float = 1.4) -> Dict[str, float]:
    """Set low-opacity and hazy pixels of ``rgb`` (N, 3) to the background,
    in place: pure background where acc is tiny, and where opacity is low
    and the weights are flat or spread (no surface)."""
    low = acc < acc_thr
    rgb[low] = bg_val
    fog = (acc < max(acc_thr * 1.3, 0.10)) & ((wmax < wmax_thr) | (went > entropy_thr))
    rgb[fog] = bg_val
    return {"pct_low": float(low.mean()), "pct_fog": float(fog.mean())}


def camera_path(P, aabb: np.ndarray, n_poses: int) -> np.ndarray:
    """The (n_poses, 4, 4) poses of ``P.camera_path`` over the scene box,
    dropped a little toward the ground."""
    center = 0.5 * (aabb[0] + aabb[1])
    extent = np.abs(aabb[1] - aabb[0])
    path = P.camera_path
    if path == "turntable":
        poses = poses_turntable(center, 0.75 * float(np.linalg.norm(extent)), n_poses=n_poses)
    elif path in PATH_GENERATORS:
        poses = PATH_GENERATORS[path](center, extent, n_poses)
    else:
        raise ValueError(f"Unknown camera_path: {path}")
    poses[:, 0, 3] += 0.15 * extent[0]
    return poses


def render_video(ctx, n_poses: int = 120, fps: int = 30) -> str:
    """Render ``n_poses`` frames along ``P.camera_path`` with the first test
    view's size and intrinsics and write the video; returns its path (under
    the run's log directory, ``<path>.mp4`` or ``<path>_baked.mp4``, or the
    GIF beside it)."""
    from acn_tpu_torch.data.ray_prep import get_ray_directions_np, get_rays_np
    from acn_tpu_torch.pipelines.renderer import Renderer

    P = ctx["P"]
    logger = ctx["logger"]
    aabb = np.asarray(ctx["global_aabb"], np.float32)
    extent = np.abs(aabb[1] - aabb[0])
    md = ctx["test_metadata"][0]
    H, W = md.H, md.W
    fx, fy, cx, cy = [float(v) for v in md.intrinsics[:4]]
    path = P.camera_path
    poses = camera_path(P, aabb, n_poses)
    near_bias = 0.15 * 0.5 * float(np.linalg.norm(extent))
    bg_val = 0.0 if P.bg_color_default == "black" else 1.0

    if getattr(P, "baked_asset", None):
        # frames of the baked table; fog suppression is for the live field
        from acn_tpu_torch.pipelines.baking import BakedRenderer, load_baked

        br = BakedRenderer(
            load_baked(P.baked_asset, device=ctx.get("device")),
            budget_per_ray=int(getattr(P, "occ_budget_per_ray", 0) or 24),
            chunk_points=int(P.chunk_points), bg_color=P.bg_color_default,
            s_coarse=int(getattr(P, "occ_render_s_coarse", 0) or 0))
        frames = []
        for i, c2w in enumerate(poses):
            rgb, _, _ = br.render_image(H=H, W=W, intrinsics=np.asarray([fx, fy, cx, cy]),
                                        c2w=c2w[:3], near_far_override=(near_bias, None))
            frames.append((np.clip(rgb, 0, 1) * 255).astype(np.uint8))
            if (i + 1) % 10 == 0:
                logger.log(f"[video:{path}:baked] frame {i + 1}/{len(poses)}")
        return _write_video(str(Path(logger.logdir) / f"{path}_baked.mp4"), frames, fps,
                            logger)

    renderer = Renderer(ctx["cfg"], P, ctx["occ_cfg"], device=ctx.get("device"))
    use_occ = ctx["occ_cfg"] is not None and ctx["occ_states"] is not None
    dirs = get_ray_directions_np(H, W, fx, fy, cx, cy, center_pixels=True)
    frames = []
    for i, c2w in enumerate(poses):
        rays = get_rays_np(dirs, c2w[:3], aabb=aabb).reshape(-1, 8)
        near = np.clip(rays[:, 6], 0.0, None) + near_bias
        rays[:, 6] = np.minimum(near, rays[:, 7] - 1e-4)
        invalid = rays[:, 7] <= rays[:, 6]
        rays[invalid, 7] = -1.0  # inert
        rgb, _, acc, wmax, went = renderer.render_rays(
            ctx["model"], ctx["occ_states"], rays, use_occ=use_occ, with_stats=True)
        rgb[invalid] = bg_val
        suppress_fog(rgb, acc, wmax, went, bg_val)
        frames.append((np.clip(rgb.reshape(H, W, 3), 0, 1) * 255).astype(np.uint8))
        if (i + 1) % 10 == 0:
            logger.log(f"[video:{path}] frame {i + 1}/{len(poses)}")
    return _write_video(str(Path(logger.logdir) / f"{path}.mp4"), frames, fps, logger)
