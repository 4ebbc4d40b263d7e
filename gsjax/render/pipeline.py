"""The render entry point: one pure, jit-able, differentiable function
`render(gaussians, camera, cfg) -> image`.

This is the replacement for the reference's whole render loop —
WebGLRenderer.render (/root/reference/src/renderers/WebGLRenderer.ts:
241-296), the async sort worker round-trip (:269, Worker.ts:36-43), and
the instanced draw (:290) — collapsed into one jitted step:
projection → (tile, depth) binning → per-tile front-to-back compositing.

Backends:
  oracle — O(N·pixels) pure-jnp ground truth (render/oracle.py)
  xla    — binned, vectorized jnp (render/binning.py + composite.py),
           differentiable by autodiff
  stream — home layout + the Triton tile blend (render/pallas_stream.py),
           hand-derived VJP
  auto   — stream on the GPU, xla on the CPU (gsjax/device.py)
"""

from __future__ import annotations

import jax

from gsjax import device
from gsjax.core.camera import Camera
from gsjax.core.config import RenderConfig
from gsjax.core.gaussians import Gaussians
from gsjax.render.binning import build_tile_bins
from gsjax.render.composite import composite_tiles
from gsjax.render.oracle import render_oracle
from gsjax.render.project import project


def _project_any(g, cam, cfg):
    """project() for Gaussians or BandedGaussians (per-band SH groups,
    core/banded.py — each group evaluates only its own SH degree)."""
    from gsjax.core.banded import BandedGaussians, project_banded

    if isinstance(g, BandedGaussians):
        return project_banded(g, cam, cfg)
    return project(g, cam, cfg)


def render(
    g: Gaussians,
    cam: Camera,
    cfg: RenderConfig = RenderConfig(),
    return_aux: bool = False,
    passes=(),
):
    """Render an [H, W, 3] image. Differentiable w.r.t. every Gaussians
    field (and the camera pose/intrinsics). `passes` are post-projection
    transformations (gsjax.render.passes ≙ the reference's ShaderPass
    hook)."""
    backend = device.resolve_backend(cfg.backend)
    if backend == "oracle":
        from gsjax.core.banded import BandedGaussians

        if passes or isinstance(g, BandedGaussians):
            from gsjax.render.oracle import composite_oracle

            p = _project_any(g, cam, cfg)
            for ps in passes:
                p = ps(p, cam, cfg)
            return composite_oracle(p, cam, cfg, return_aux=return_aux)
        return render_oracle(g, cam, cfg, return_aux=return_aux)
    if backend == "stream":
        return _render_stream(g, cam, cfg, return_aux, passes)
    p = _project_any(g, cam, cfg)
    for ps in passes:
        p = ps(p, cam, cfg)
    # exact-footprint mode: all backends render the UNCLAMPED rect by
    # splitting fat splats into per-block home rows (render/homesort.py);
    # legacy mode bins the span-clamped rect directly.
    if cfg.footprint_clamp:
        bins = build_tile_bins(p, cam, cfg)
        fat_ovf = None
    else:
        from gsjax.render.homesort import build_home_layout

        p, layout = build_home_layout(p, cam, cfg)
        bins = build_tile_bins(p, cam, cfg, anchor="home", layout=layout)
        fat_ovf = layout.n_fat_overflow
    if backend != "xla":
        raise ValueError(f"unknown backend {backend!r}")
    img, aux = composite_tiles(p, bins, cam, cfg)
    if fat_ovf is not None:
        aux["n_fat_overflow"] = fat_ovf
    img = img[: cam.height, : cam.width]
    aux["transmittance"] = aux["transmittance"][: cam.height, : cam.width]
    if return_aux:
        aux["projected"] = p
        return img, aux
    return img


def _render_stream(g, cam, cfg, return_aux, passes):
    """Stream backend: project → home-layout re-sort (+ fat-splat split
    in exact mode) → home-anchored bins → Triton blend
    (render/pallas_stream.py)."""
    from gsjax.render.homesort import build_home_layout
    from gsjax.render.pallas_stream import composite_tiles_stream

    with jax.named_scope("project"):
        p = _project_any(g, cam, cfg)
    for ps in passes:
        p = ps(p, cam, cfg)
    with jax.named_scope("home_layout"):
        p, layout = build_home_layout(p, cam, cfg)
    with jax.named_scope("binning"):
        bins = build_tile_bins(p, cam, cfg, anchor="home", layout=layout)
    img, aux = composite_tiles_stream(p, layout, bins, cam, cfg)
    img = img[: cam.height, : cam.width]
    aux["transmittance"] = aux["transmittance"][: cam.height, : cam.width]
    if return_aux:
        aux["projected"] = p
        return img, aux
    return img
