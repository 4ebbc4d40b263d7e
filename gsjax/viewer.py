"""Headless viewer: render camera trajectories to PNG frames.

The headless form of the reference's browser render loop + controls
(/root/reference/examples/*/src/main.ts requestAnimationFrame loops and
OrbitControls): instead of an interactive canvas, a jitted render step
walks a camera trajectory and writes frames — the fade-in pass animates
exactly like the reference's FadeInPass.
"""

from __future__ import annotations

import os

import jax
import numpy as np

from gsjax.camera.orbit import OrbitCamera
from gsjax.core.config import RenderConfig
from gsjax.render.passes import depth_fade
from gsjax.render.pipeline import render
from gsjax.utils.image import write_png


def render_trajectory(
    g,
    cameras,
    cfg: RenderConfig = RenderConfig(),
    out_dir=None,
    fade_in: bool = False,
    fade_speed: float = 1.0,
):
    """Render a list of cameras; returns frames [F, H, W, 3] (numpy) and
    optionally writes frame_%04d.png into out_dir.

    fade_in ≙ the reference's FadeInPass: the fade value advances by
    speed·0.01 per frame until 1 (FadeInPass.ts:29-36)."""
    frames = []
    fade = 0.0
    jitted = {}
    for i, cam in enumerate(cameras):
        passes = ()
        if fade_in and fade < 1.0:
            fade = min(fade + fade_speed * 0.01, 1.0)
            passes = (depth_fade(fade),)
        key = (cam.width, cam.height, bool(passes))
        if key not in jitted:
            jitted[key] = jax.jit(lambda g, cam, p=passes: render(g, cam, cfg, passes=p))
        img = np.asarray(jitted[key](g, cam))
        frames.append(img)
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            write_png(os.path.join(out_dir, f"frame_{i:04d}.png"), img)
    return np.stack(frames)


def render_orbit(
    g,
    n_frames: int = 30,
    radius: float = 5.0,
    target=(0.0, 0.0, 0.0),
    beta: float = 0.0,
    cfg: RenderConfig = RenderConfig(),
    out_dir=None,
    **cam_kwargs,
):
    """Render a full orbit around the scene (BASELINE config 3's
    trajectory shape)."""
    cams = OrbitCamera(radius=radius, target=target, beta=beta).trajectory(
        n_frames, **cam_kwargs
    )
    return render_trajectory(g, cams, cfg, out_dir=out_dir)
