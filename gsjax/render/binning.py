"""Tile binning: build per-tile, depth-ordered splat lists on device.

This generalizes the reference's native depth sorter — the C++/WASM
16-bit counting sort over all splats (/root/reference/wasm/wasm.cpp:33-51,
dispatched asynchronously from a Web Worker, Worker.ts:36-43) — to the
(tile, depth) radix key that tile-based rasterization needs, running
synchronously inside the jitted step (SURVEY §2.2: the sort is a device
op).

Mechanism:
  1. pair expansion — each splat emits up to tile_span² (tile, depth-key)
     pairs covering its footprint rect, enumerated in a static slot grid
     (static shapes), with an exact ellipse-tile cull,
  2. one sort over (tile, depth bits, pair id) — tile-major, then
     near-to-far, ties by pair id, which matches the oracle's stable
     depth argsort exactly (the exact-footprint path uses the bucket
     repack of render/repack.py instead),
  3. per-tile segment starts by binary search over the sorted keys.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from gsjax.core.camera import Camera
from gsjax.core.config import RenderConfig
from gsjax.render.common import (
    MAX_TILES,
    clamp_rect_to_span,
    cull_threshold,
    rect_qmin,
    tile_rect,
)
from gsjax.render.project import ProjectedSplats

# invalid pairs sort after every real tile id (i32 max keeps the
# 3-operand radix sort a plain signed sort)
INVALID_TILE = jnp.int32(0x7FFFFFFF)

_EXPAND_R = 4096  # home-row padding of the expansion grid


def expand_home_pairs(p, layout, ty0, band_rows, tiles_x: int, cfg):
    """Exact-mode pair expansion over the home layout: home row r emits
    class c's pair at tile home + (c % span − h, c // span − h) when
    that tile lies in the row's window (its block ∩ rect, computed by
    homesort), in the band, and inside the splat's alpha_min ellipse.
    Shared by build_tile_bins and the occupancy pre-pass
    (core/autotune.py). Returns (tile2d [K, nh_pad] i32 band tile ids
    with INVALID for dead pairs, pid2d [K, nh_pad] i32 = row·K + class,
    dbits [nh_pad] i32 depth bits, nh_pad)."""
    with jax.named_scope("pair_expansion"):
        return _expand_home_pairs(p, layout, ty0, band_rows, tiles_x, cfg)


def _expand_home_pairs(p, layout, ty0, band_rows, tiles_x: int, cfg):
    n = p.depth.shape[0]
    span = cfg.tile_span
    k_slots = span * span
    h = span // 2
    nh_pad = -(-n // _EXPAND_R) * _EXPAND_R
    sg = jax.lax.stop_gradient
    pad = lambda x: jnp.pad(sg(x), (0, nh_pad - n))[None, :]
    hx, hy = pad(layout.home_x), pad(layout.home_y)
    wx0, wx1 = pad(layout.win[:, 0]), pad(layout.win[:, 1])
    wy0, wy1 = pad(layout.win[:, 2]), pad(layout.win[:, 3])
    c = jnp.arange(k_slots, dtype=jnp.int32)[:, None]  # [K, 1]
    tx = hx + (c % span - h)
    ty = hy + (c // span - h)
    ty0 = jnp.asarray(ty0, jnp.int32)
    ok = (
        pad(p.valid)
        & (tx >= wx0) & (tx < wx1)
        & (ty >= wy0) & (ty < wy1)
        & (ty >= ty0) & (ty < ty0 + band_rows)
    )
    qmin = rect_qmin(
        pad(p.mean2d[:, 0]), pad(p.mean2d[:, 1]),
        pad(p.conic[:, 0]), pad(p.conic[:, 1]), pad(p.conic[:, 2]),
        tx, tx + 1, ty, ty + 1, float(cfg.tile_size),
    )
    ok &= qmin <= pad(cull_threshold(p.opacity, cfg.alpha_min))
    tile2d = jnp.where(ok, (ty - ty0) * tiles_x + tx, INVALID_TILE)
    pid2d = jnp.arange(nh_pad, dtype=jnp.int32)[None, :] * k_slots + c
    dbits = pad(jnp.asarray(p.depth, jnp.float32).view(jnp.int32))[0]
    return tile2d, pid2d, dbits, nh_pad


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "pid_sorted",
        "tile_starts",
        "tile_counts",
        "n_clamped",
        "n_pairs",
        "ty0",
        "n_repack_overflow",
    ],
    meta_fields=["tiles_x", "band_rows"],
)
@dataclasses.dataclass(frozen=True)
class TileBins:
    """pid_sorted [S] int32 *pair* ids (pid = splat·K + slot, so
    sid = pid // tile_span²), tile-major / near-to-far; tile_starts [T+1]
    int32 segment offsets into pid_sorted; tile_counts [T] int32;
    n_clamped, n_pairs: scalar diagnostics; ty0: first tile row of the
    band these bins cover (traced). Carrying pair ids instead of splat
    ids lets the backward route gradients through *unique* indices
    (scatter-set + K-axis reduce) instead of a scatter-add."""

    pid_sorted: jax.Array
    tile_starts: jax.Array
    tile_counts: jax.Array
    n_clamped: jax.Array
    n_pairs: jax.Array
    ty0: jax.Array
    n_repack_overflow: jax.Array
    tiles_x: int
    band_rows: int


def build_tile_bins(
    p: ProjectedSplats,
    cam: Camera,
    cfg: RenderConfig,
    ty0=None,
    band_rows: int = None,
    anchor: str = "rect",
    layout=None,
    rows_live=None,
) -> TileBins:
    """Bin into the tile rows [ty0, ty0 + band_rows) — the whole image by
    default. `ty0` may be a traced value (each device of a tile-sharded
    mesh bins only its own band); `band_rows` must be static.

    `anchor` selects the slot-grid numbering of the static pair-expansion
    budget: "rect" anchors slot (0,0) at the clamped rect's corner;
    "home" (odd spans only) anchors the span×span grid centered on the
    splat's home tile, so slot k IS the pair's home-relative class — the
    property the stream backend's class-segment windows rely on.

    With `layout` (a homesort.HomeLayout, exact-footprint mode) the home
    anchor uses the layout's per-row home tiles and block∩rect windows:
    `p` rows are home rows (fat splats appear once per 3×3-tile block)
    and the merged pair stream equals an UNCLAMPED rect enumeration.
    Without `layout` (legacy mode) both anchors enumerate the SAME
    span-clamped (tile, depth) pair set, bit-identically."""
    n = p.depth.shape[0]
    span = cfg.tile_span
    k_slots = span * span
    tiles_x = cfg.tiles_x(cam.width)
    tiles_y = cfg.tiles_y(cam.height)
    if band_rows is None:
        band_rows = tiles_y
    if ty0 is None:
        ty0 = jnp.int32(0)
    ty0 = jnp.asarray(ty0, jnp.int32)
    n_tiles = tiles_x * band_rows
    if n_tiles > MAX_TILES:
        raise ValueError(
            f"{n_tiles} tiles exceeds the {MAX_TILES} addressable by the "
            f"packed radix key; increase tile_size"
        )

    slot = jnp.arange(k_slots, dtype=jnp.int32)
    sx = (slot % span)[None, :]  # [1, K]
    sy = (slot // span)[None, :]
    if anchor == "home" and layout is not None and not cfg.footprint_clamp:
        if span % 2 != 1:
            raise ValueError("anchor='home' requires an odd tile_span")
        # rows_live (traced) bounds the expansion's band check to the
        # device's OWNED rows under an equal-content row-cut split;
        # shapes stay band_rows-static (tiles beyond emit no pairs)
        tile2d, pid2d, dbits, nh_pad = expand_home_pairs(
            p, layout, ty0,
            band_rows if rows_live is None else rows_live,
            tiles_x, cfg,
        )
        n_pairs = jnp.sum((tile2d != INVALID_TILE).astype(jnp.int32))
        if cfg.pair_repack:
            # balanced bucket-repack + 2-D row sorts + live compaction
            # (render/repack.py): bit-identical per-tile pid sequences,
            # and the compacted stream drops the culled-candidate tail
            # before the blend
            from gsjax.render.repack import repack_pair_sort, resolve_repack_dims

            _w, _q, rr = resolve_repack_dims(nh_pad, k_slots, cfg)
            cap_out = rr * _w
            if cfg.pair_cap:
                cap_out = min(cap_out, -(-cfg.pair_cap // 128) * 128)
            seg_row0 = getattr(layout, "seg_row0", jnp.int32(0))
            pid_sorted, tile_of, n_over = repack_pair_sort(
                tile2d,
                dbits,
                layout.seg_starts,
                ty0,
                seg_row0,
                ty0 - seg_row0,
                tiles_x,
                band_rows,
                layout.rows_present,
                nh_pad,
                k_slots,
                span,
                cap_out,
                cfg,
            )
        else:
            tile_i = tile2d.reshape(-1)
            pids = pid2d.reshape(-1)
            dpair = jnp.broadcast_to(
                dbits[None, :], (k_slots, nh_pad)
            ).reshape(-1)
            tile_of, _, pid_sorted = jax.lax.sort(
                (tile_i, dpair, pids), num_keys=3, is_stable=False
            )
            n_over = jnp.zeros((), jnp.int32)
        tile_starts = jnp.searchsorted(
            tile_of, jnp.arange(n_tiles + 1, dtype=jnp.int32), side="left"
        ).astype(jnp.int32)
        return TileBins(
            pid_sorted=pid_sorted,
            tile_starts=tile_starts,
            tile_counts=tile_starts[1:] - tile_starts[:-1],
            n_clamped=jnp.zeros((), jnp.int32),  # budgets in layout
            n_pairs=n_pairs,
            ty0=ty0,
            n_repack_overflow=jnp.asarray(n_over, jnp.int32),
            tiles_x=tiles_x,
            band_rows=band_rows,
        )
    else:
        x0, y0, x1, y1 = tile_rect(
            p.mean2d, p.radius, tiles_x, tiles_y, cfg.tile_size
        )
        x0, y0, x1, y1, clamped = clamp_rect_to_span(
            x0, y0, x1, y1, p.mean2d, cfg.tile_size, span,
            center_window=cfg.footprint_clamp or anchor == "home",
        )
        n_clamped = jnp.sum(clamped & p.valid)
        if anchor == "home":
            # legacy span budget: home = the mean's tile, clipped to the
            # image (matching homesort._legacy_home) — the clamped rect
            # is ⊆ home±span//2 by construction
            htx = jnp.clip(
                jnp.floor(p.mean2d[:, 0] / cfg.tile_size).astype(jnp.int32),
                0,
                tiles_x - 1,
            )
            hty = jnp.clip(
                jnp.floor(p.mean2d[:, 1] / cfg.tile_size).astype(jnp.int32),
                0,
                tiles_y - 1,
            )
            txs = (htx - span // 2)[:, None] + sx  # [N, K]
            tys = (hty - span // 2)[:, None] + sy
        elif anchor == "rect":
            txs = x0[:, None] + sx  # [N, K]
            tys = y0[:, None] + sy
        else:
            raise ValueError(f"unknown anchor {anchor!r}")

    pair_ok = (
        p.valid[:, None]
        & (txs >= x0[:, None])
        & (txs < x1[:, None])
        & (tys >= y0[:, None])
        & (tys < y1[:, None])
        & (tys >= ty0)
        & (tys < ty0 + band_rows)
    )

    # exact ellipse-tile cull: drop pairs whose max possible alpha anywhere
    # in the tile's pixel rect is < alpha_min (common.rect_qmin), so the
    # composited output is unchanged while corner/edge tiles of
    # anisotropic splats drop before the sort.
    qmin = rect_qmin(
        p.mean2d[:, 0:1], p.mean2d[:, 1:2],
        p.conic[:, 0:1], p.conic[:, 1:2], p.conic[:, 2:3],
        txs, txs + 1, tys, tys + 1, float(cfg.tile_size),
    )
    pair_ok &= qmin <= cull_threshold(p.opacity[:, None], cfg.alpha_min)

    # FULL-resolution depth ordering: graphdeco sorts on the raw f32
    # depth bits (its 64-bit tile|depth key); a truncated key would
    # swap nearby splats (~1e-3 relative at 19 bits) and diverge from
    # both graphdeco and the oracle by visible amounts. Depths are
    # positive (near-culled), so the i32 bit pattern is monotone.
    # 3-operand radix sort (tile, depth_bits, pid): ties in (tile,
    # depth) break by ascending pid deterministically.
    tile_i = ((tys - ty0) * tiles_x + txs).astype(jnp.int32)
    tile_i = jnp.where(pair_ok, tile_i, INVALID_TILE).reshape(-1)
    dbits = jnp.asarray(p.depth, jnp.float32).view(jnp.int32)
    dpair = jnp.broadcast_to(dbits[:, None], (n, k_slots)).reshape(-1)
    pids = jnp.arange(n * k_slots, dtype=jnp.int32)
    tile_of, _, pid_sorted = jax.lax.sort(
        (tile_i, dpair, pids), num_keys=3, is_stable=False
    )

    tile_starts = jnp.searchsorted(
        tile_of, jnp.arange(n_tiles + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    tile_counts = tile_starts[1:] - tile_starts[:-1]

    return TileBins(
        pid_sorted=pid_sorted,
        tile_starts=tile_starts,
        tile_counts=tile_counts,
        n_clamped=n_clamped,
        n_pairs=jnp.sum(pair_ok.astype(jnp.int32)),
        ty0=ty0,
        n_repack_overflow=jnp.zeros((), jnp.int32),
        tiles_x=tiles_x,
        band_rows=band_rows,
    )
