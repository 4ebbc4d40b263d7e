"""Shared pieces of the rasterization pipeline used by every backend
(oracle / xla / stream), so that all backends agree bit-closely.

Depth ordering: the reference sorts on a 16-bit normalized depth key
(/root/reference/wasm/wasm.cpp:16-39); graphdeco sorts on the raw f32
depth bits. We match graphdeco: positive f32 depth bit patterns are
monotone as signed i32, so every ordering op sorts (tile_id, depth_bits)
as two i32 radix operands — full depth resolution, no truncation-tie
divergence from the reference rasterizer.
"""

from __future__ import annotations

import jax.numpy as jnp

MAX_TILES = (1 << 30) - 1  # i32 tile ids; INVALID_TILE = i32 max


def depth_bits(depth: jnp.ndarray) -> jnp.ndarray:
    """Monotone i32 key for positive f32 depths (the raw bit pattern)."""
    return jnp.asarray(depth, jnp.float32).view(jnp.int32)


def tile_rect(mean2d, radius, tiles_x, tiles_y, tile_size):
    """Inclusive-min/exclusive-max tile rect per splat (graphdeco getRect).

    Returns (x0, y0, x1, y1) int32 arrays; empty rect for culled splats
    (radius == 0 yields x0 == x1 at the clamped mean tile — callers must
    also check validity).
    """
    mx, my = mean2d[..., 0], mean2d[..., 1]
    x0 = jnp.clip(jnp.floor((mx - radius) / tile_size), 0, tiles_x).astype(jnp.int32)
    y0 = jnp.clip(jnp.floor((my - radius) / tile_size), 0, tiles_y).astype(jnp.int32)
    x1 = jnp.clip(
        jnp.floor((mx + radius + tile_size - 1) / tile_size), 0, tiles_x
    ).astype(jnp.int32)
    y1 = jnp.clip(
        jnp.floor((my + radius + tile_size - 1) / tile_size), 0, tiles_y
    ).astype(jnp.int32)
    return x0, y0, x1, y1


def clamp_rect_to_span(x0, y0, x1, y1, mean2d, tile_size, span,
                       center_window: bool = True):
    """Clamp a tile rect to at most span×span tiles, centered on the
    splat's own (home) tile (the static pair-expansion budget — see
    RenderConfig.tile_span). Returns (x0, y0, x1, y1, clamped_mask).
    Backends applying the same clamp agree exactly; the clamped count is
    surfaced in RenderAux (no silent caps).

    With `center_window` (legacy footprint_clamp mode), ODD spans are
    additionally intersected with the span-window centered on the home
    tile, [home - span//2, home + span//2] — the invariant the stream
    backend's class-segment layout relies on. In exact-footprint mode
    (cfg.footprint_clamp=False) the rect-anchored backends use only the
    budget clamp (center_window=False): a rect within the span budget is
    never trimmed, and the stream backend covers arbitrary rects by
    fat-splat splitting instead (render/homesort.py)."""
    mtx = jnp.floor(mean2d[..., 0] / tile_size).astype(jnp.int32)
    mty = jnp.floor(mean2d[..., 1] / tile_size).astype(jnp.int32)
    clamped = (x1 - x0 > span) | (y1 - y0 > span)

    def clamp1(lo, hi, mt):
        over = hi - lo > span
        lo2 = jnp.clip(mt - span // 2, lo, jnp.maximum(hi - span, lo))
        hi2 = lo2 + span
        return jnp.where(over, lo2, lo), jnp.where(over, hi2, hi)

    x0, x1 = clamp1(x0, x1, mtx)
    y0, y1 = clamp1(y0, y1, mty)
    if span % 2 == 1 and center_window:
        h = span // 2
        nx0 = jnp.maximum(x0, mtx - h)
        nx1 = jnp.minimum(x1, mtx + h + 1)
        ny0 = jnp.maximum(y0, mty - h)
        ny1 = jnp.minimum(y1, mty + h + 1)
        clamped = clamped | (nx0 != x0) | (nx1 != x1) | (ny0 != y0) | (ny1 != y1)
        x0, x1, y0, y1 = nx0, nx1, ny0, ny1
    return x0, y0, x1, y1, clamped


def gaussian_power(conic, dx, dy):
    """Log-weight: -0.5(a dx² + 2b dx dy + c dy²). Broadcasts conic [..., 3]
    against dx/dy pixel offsets."""
    a, b, c = conic[..., 0], conic[..., 1], conic[..., 2]
    return -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy


def cull_threshold(opacity, alpha_min):
    """2·ln(op/alpha_min) + slack: a splat reaches alpha_min somewhere in
    a pixel rect iff the conic quadratic's minimum over it is below
    this (the slack absorbs exp's last-bit differences across
    backends)."""
    return 2.0 * jnp.log(jnp.maximum(opacity, alpha_min) / alpha_min) + 1e-3


def rect_qmin(mx, my, ca, cb, cc, x0, x1, y0, y1, tile_size: float):
    """Minimum of the conic quadratic a·dx² + 2b·dx·dy + c·dy² over the
    pixel rect [x0·ts, x1·ts − 1] × [y0·ts, y1·ts − 1] (tile units,
    exclusive max). Closed form: 0 if the mean is inside, else the min
    over the 4 edges, where the free coordinate's optimum is the clamped
    1-D minimizer. The exact ellipse cull of binning (one tile) and of
    the fat-splat split (one block) both use it; all arguments
    broadcast. ca, cc > 0 for valid splats (conic of a PSD cov2d with
    the low-pass)."""
    dxl = x0.astype(jnp.float32) * tile_size - mx
    dxr = x1.astype(jnp.float32) * tile_size - 1.0 - mx
    dyl = y0.astype(jnp.float32) * tile_size - my
    dyr = y1.astype(jnp.float32) * tile_size - 1.0 - my
    inside = (dxl <= 0) & (dxr >= 0) & (dyl <= 0) & (dyr >= 0)
    neg_cb_rcc = -cb / cc
    neg_cb_rca = -cb / ca

    def edge_x(dx):
        dy = jnp.clip(neg_cb_rcc * dx, dyl, dyr)
        return ca * dx * dx + 2.0 * cb * dx * dy + cc * dy * dy

    def edge_y(dy):
        dx = jnp.clip(neg_cb_rca * dy, dxl, dxr)
        return ca * dx * dx + 2.0 * cb * dx * dy + cc * dy * dy

    qmin = jnp.minimum(
        jnp.minimum(edge_x(dxl), edge_x(dxr)),
        jnp.minimum(edge_y(dyl), edge_y(dyr)),
    )
    return jnp.where(inside, 0.0, qmin)
