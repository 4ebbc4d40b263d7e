"""Occupancy pre-pass: derive every static capacity knob from one cheap
measured pass over the actual (scene, camera) pair.

The render pipeline's static budgets (fat-split caps, pair budget,
repack grid) depend on the scene and the camera: a mis-sized cap is a
hard bench failure (the gate) or a silent slowdown (oversized grids).
This module runs the cheap deterministic prefix of the pipeline once
(project → home layout → pair expansion — no sort, no blend), measures
the actual occupancies, and returns a RenderConfig with every cap sized
at `slack` headroom:

  * fat_cap / fat_live_cap   — copy enumeration / live copy rows
  * pair_cap                 — live pairs (+ repack 128-pad slack)
  * repack_rows / repack_w   — greedy row packing SIMULATED exactly on
                               the measured per-tile candidate totals

All caps remain static shapes: call this at load time (outside jit) and
use the returned config for the training/render jit. Scene drift during
training is absorbed by `slack`; every cap stays overflow-COUNTED, so a
scene that outgrows the derived budgets fails loudly, and the caller can
re-derive.

The reference has no analogue (its only capacity is the 65,536-bucket
sort histogram, hard-coded: /root/reference/wasm/wasm.cpp:33); this is
the cost of static shapes, paid once per scene.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from gsjax.core.config import RenderConfig


def _ceil(a, b):
    return -(-a // b)


def _round_up(x, m):
    return _ceil(int(x), m) * m


@partial(jax.jit, static_argnums=(2,))
def _measure_pass(g, cam, cfg: RenderConfig):
    """Device half of measure_occupancy. `cam` is a TRACED pytree (its
    width/height are static meta), so one compile covers every view of an
    orbit trajectory — the per-view cap derivation the orbit headline
    needs would otherwise recompile the whole prologue 30 times."""
    from gsjax.render.binning import INVALID_TILE, expand_home_pairs
    from gsjax.render.common import tile_rect
    from gsjax.render.homesort import build_home_layout
    from gsjax.render.pipeline import _project_any

    tiles_x = cfg.tiles_x(cam.width)
    tiles_y = cfg.tiles_y(cam.height)
    p = _project_any(g, cam, cfg)
    # live PRIMARY count, pre-layout (same rule as build_home_layout's
    # `on`): n_valid below counts live primaries + live copies, so the
    # live-copy demand is n_valid - n_live_prim — NOT n_valid - n, which
    # undercounts (even zeroes) it whenever a fraction of the scene is
    # off-frustum (culled primaries are in n but not in n_valid)
    x0, y0, x1, y1 = tile_rect(
        p.mean2d, p.radius, tiles_x, tiles_y, cfg.tile_size
    )
    n_live_prim = jnp.sum(
        (p.valid & (x1 > x0) & (y1 > y0)).astype(jnp.int32)
    )
    p, layout = build_home_layout(p, cam, cfg)
    tile2d, _, _, nh_pad = expand_home_pairs(
        p, layout, jnp.int32(0), tiles_y, tiles_x, cfg
    )
    n_pairs = jnp.sum((tile2d != INVALID_TILE).astype(jnp.int32))
    return (
        layout.seg_starts,
        layout.n_valid,
        layout.n_fat_overflow,
        layout.n_copies,
        n_pairs,
        n_live_prim,
    )


def measure_occupancy(g, cam, cfg: RenderConfig):
    """One measuring pass. Returns a dict of host-side occupancy facts.

    The pass is the expensive part (project → layout → expansion on
    device); every derive_* below accepts the returned dict via `m=` so
    callers measure once per (scene, camera, cfg) and share."""
    tiles_x = cfg.tiles_x(cam.width)
    tiles_y = cfg.tiles_y(cam.height)
    seg_d, n_valid, fat_ovf, n_copies, n_pairs, n_live_prim = _measure_pass(
        g, cam, cfg
    )
    seg = np.asarray(jax.device_get(seg_d), np.int64)
    n = int(g.means.shape[0]) if hasattr(g, "means") else int(
        sum(gr.means.shape[0] for gr in g.groups)
    )

    # per-tile 9-class candidate totals (live + culled expansion slots
    # of the tile's 9 source segments) — exactly repack_pair_sort's
    # linear-range arithmetic, vectorized host-side
    T = tiles_x * tiles_y
    tau = np.arange(T, dtype=np.int64)
    cand = np.zeros(T, np.int64)
    for c in range(cfg.tile_span * cfg.tile_span):
        dy = c // cfg.tile_span - cfg.tile_span // 2
        dx = c % cfg.tile_span - cfg.tile_span // 2
        s = tau - dy * tiles_x - dx
        s0 = np.clip(s, 0, T)
        s1 = np.clip(s + 1, 0, T)
        cand += seg[s1] - seg[s0]

    return {
        "n": n,
        "tiles_x": tiles_x,
        "tiles_y": tiles_y,
        "seg": seg,
        "cand": cand,
        "n_valid": int(jax.device_get(n_valid)),
        "n_fat_overflow": int(jax.device_get(fat_ovf)),
        "n_copies": int(jax.device_get(n_copies)),
        "n_pairs": int(jax.device_get(n_pairs)),
        "n_live_prim": int(jax.device_get(n_live_prim)),
    }


def _simulate_greedy_rows(cand, w_eff: int) -> int:
    """Exact greedy row packing over the measured per-tile candidate
    totals (same rule as repack_pair_sort's boundary scan): number of
    rows actually needed."""
    rows = 0
    fill = 0
    for c in cand:
        c = int(c)
        if fill + c > w_eff and fill > 0:
            rows += 1
            fill = 0
        fill += c  # a single tile > w_eff overflows (counted at render)
    return rows + (1 if fill > 0 else 0)


def derive_caps(
    g, cam, cfg: RenderConfig = RenderConfig(), slack: float = 1.2,
    ms=None,
) -> RenderConfig:
    """Measure the scene's occupancy once and return `cfg` with every
    static budget sized at `slack` headroom. The measuring pass runs
    with cfg's own (generous default) fat caps; if those already
    overflow, raise — the caller must start from a bigger base.

    `cam` may be a LIST of cameras (an orbit trajectory): every budget is
    then sized for the worst view, so one static config covers the whole
    trajectory (one compile — _measure_pass traces the camera). `ms`
    (list of measure_occupancy dicts) skips re-measuring."""
    if ms is None:
        cams = cam if isinstance(cam, (list, tuple)) else [cam]
        ms = [measure_occupancy(g, c, cfg) for c in cams]
    for m in ms:
        if m["n_fat_overflow"] > 0:
            raise ValueError(
                f"measuring pass overflowed the base fat budgets "
                f"(n_fat_overflow={m['n_fat_overflow']}); raise fat_cap / "
                f"fat_max_blocks on the base config and re-derive"
            )
    n = ms[0]["n"]

    # fat caps: live rows (primaries + copies) drive live_cap; the
    # enumeration cap covers the measured pre-cull copy demand.
    # live copies = n_valid - live PRIMARIES (not - n: culled primaries
    # are in n but not n_valid, so "- n" collapses the cap to its floor
    # on any scene with a significant off-frustum fraction)
    live_copies = max(
        max(m["n_valid"] - m["n_live_prim"], 0) for m in ms
    )
    fat_live_cap = _round_up(max(int(live_copies * slack), 4096), 4096)
    # < 2^24: the merged parent gather's f32-exactness bound
    # (homesort.resolve_fat_caps); demand beyond it overflows, counted
    fat_cap = min(
        _round_up(
            max(int(max(m["n_copies"] for m in ms) * slack), 8192), 8192
        ),
        (1 << 24) - 8192,
    )

    # repack grid: W must hold the densest tile + block slack; rows from
    # exact greedy simulation (worst view)
    k_slots = cfg.tile_span * cfg.tile_span
    blk_slack = k_slots * 2 * 127 + 128
    w = max(
        cfg.repack_w,
        _round_up(
            int(max(m["cand"].max() for m in ms)) + blk_slack + 1024, 1024
        ),
    )
    rows_true = max(
        _simulate_greedy_rows(m["cand"], w - blk_slack) for m in ms
    )
    repack_rows = int(rows_true * slack) + 2

    # pair budget: live pairs + per-row 128-padding
    pair_cap = _round_up(
        int(max(m["n_pairs"] for m in ms) * slack) + 128 * repack_rows, 128
    )

    return dataclasses.replace(
        cfg,
        fat_cap=fat_cap,
        fat_live_cap=fat_live_cap,
        pair_cap=pair_cap,
        repack_w=w,
        repack_rows=repack_rows,
    )


def _rect_y_ranges(g, cam, cfg: RenderConfig):
    """Per-splat footprint tile-row ranges (host side)."""
    from gsjax.render.common import tile_rect
    from gsjax.render.pipeline import _project_any

    tiles_x = cfg.tiles_x(cam.width)
    tiles_y = cfg.tiles_y(cam.height)

    @jax.jit
    def pass_(g):
        p = _project_any(g, cam, cfg)
        _, y0, _, y1 = tile_rect(
            p.mean2d, p.radius, tiles_x, tiles_y, cfg.tile_size
        )
        on = p.valid & (p.radius > 0)
        # push non-relevant splats out of every band's range
        return (
            jnp.where(on, y0, tiles_y + 4),
            jnp.where(on, y1, tiles_y + 4),
        )

    y0, y1 = pass_(g)
    return np.asarray(jax.device_get(y0)), np.asarray(jax.device_get(y1))


def derive_row_cuts(g, cam, cfg: RenderConfig, n_devices: int, m=None,
                    row_weight: float = 0.0):
    """Equal-CONTENT tile-row partition: cuts [D+1] so every band holds
    ≈ the same per-tile candidate mass (the quantity per-device cost
    actually follows under rows_live-bounded static shapes). Use with
    make_train_step_equalized + derive_shard_caps(bands=...). `m` (a
    measure_occupancy dict) skips re-measuring.

    `row_weight` adds a per-tile-row constant (in candidate units) to
    the balanced mass, for a step whose cost is ≈ a·candidates + b·rows
    (pass row_weight = b/a)."""
    if m is None:
        m = measure_occupancy(g, cam, cfg)
    row_cand = (
        m["cand"].reshape(m["tiles_y"], m["tiles_x"]).sum(1)
        + float(row_weight)
    )
    cum = np.concatenate([[0], np.cumsum(row_cand)])
    total = cum[-1]
    cuts = [0]
    for d in range(1, n_devices):
        c = int(np.searchsorted(cum, total * d / n_devices))
        c = min(max(c, cuts[-1] + 1), m["tiles_y"] - (n_devices - d))
        cuts.append(c)
    cuts.append(m["tiles_y"])
    return cuts


def derive_shard_caps(
    g,
    cam,
    cfg: RenderConfig,
    band_rows: int = None,
    origins=None,
    bands=None,
    slack: float = 1.25,
    m=None,
) -> RenderConfig:
    """Measure the WORST band of size `band_rows` over the given origins
    (default: every ty0 a contiguous or balanced split can produce) and
    set the tile-sharded path's static budgets exactly:

      * shard_prefilter_cap — max splats whose rect reaches any band
      * shard_slice_cap     — max home rows in any band's halo range
      * pair_cap            — full-image live pairs scaled by the worst
                              band's candidate share (gate-checked)

    The slack heuristics this replaces either overflow on skewed scenes
    or saturate at full scene size (no 1/D shrink); measured caps give
    every device the worst band's actual footprint, which IS the skew.

    Pass `bands` = [(ty0, rows), ...] for a non-uniform (equal-content)
    partition; otherwise a uniform `band_rows` grid (optionally with
    explicit `origins`). `m` (a measure_occupancy dict) skips
    re-measuring."""
    if m is None:
        m = measure_occupancy(g, cam, cfg)
    tiles_y = m["tiles_y"]
    tiles_x = m["tiles_x"]
    if bands is None:
        if band_rows is None:
            raise ValueError(
                "derive_shard_caps needs either band_rows (uniform grid) "
                "or bands=[(ty0, rows), ...]"
            )
        if origins is None:
            origins = sorted(
                {min(i * band_rows, tiles_y - band_rows)
                 for i in range(-(-tiles_y // band_rows))}
            )
        bands = [(ty0, band_rows) for ty0 in origins]
    y0, y1 = _rect_y_ranges(g, cam, cfg)
    y0s = np.sort(y0)
    y1s = np.sort(y1)
    n = y0.shape[0]

    pref_cap = 0
    for ty0, rows_b in bands:
        # relevant = (y1 > ty0 - 1) & (y0 < ty0 + rows_b + 1)
        ends_before = np.searchsorted(y1s, ty0 - 1, side="right")
        starts_after = n - np.searchsorted(
            y0s, ty0 + rows_b + 1, side="left"
        )
        pref_cap = max(pref_cap, n - ends_before - starts_after)
    pref_cap = _round_up(max(int(pref_cap * slack), 4096), 4096)

    # home rows + candidate share per band (from the FULL-image layout;
    # the prefiltered per-band layout has at most these rows)
    seg = m["seg"]
    cand = m["cand"]
    row_cand = cand.reshape(tiles_y, tiles_x).sum(1)
    slice_cap = 0
    worst_share = 0.0
    for ty0, rows_b in bands:
        r0 = max(ty0 - 1, 0)
        r1 = min(ty0 + rows_b + 1, tiles_y)
        rows = int(seg[r1 * tiles_x] - seg[r0 * tiles_x])
        slice_cap = max(slice_cap, rows)
        worst_share = max(
            worst_share,
            float(row_cand[ty0 : ty0 + rows_b].sum())
            / max(float(cand.sum()), 1.0),
        )
    # the prefiltered layout appends its own live_cap of copy rows; the
    # slice cap must admit the band's rows of THAT layout — bound it by
    # the full-image band rows + proportional copy slack
    slice_cap = _round_up(max(int(slice_cap * slack) + 8192, 8192), 4096)

    pair_cap = _round_up(
        int(m["n_pairs"] * min(worst_share * slack * 1.15, 1.0)) + 65536,
        128,
    )

    # the full-image caps (fat enumeration, repack rows) must ALSO scale
    # to the worst band, or the band's homesort and repack sort run at
    # full-scene size regardless of the prefilter/slice
    pref_share = min(pref_cap / max(n, 1), 1.0)
    fat_cap = cfg.fat_cap
    if fat_cap is not None:
        fat_cap = _round_up(max(int(fat_cap * pref_share * slack), 8192), 8192)
        fat_cap = min(fat_cap, (1 << 24) - 8192)
    fat_live_cap = cfg.fat_live_cap
    if fat_live_cap is not None:
        fat_live_cap = _round_up(
            max(int(fat_live_cap * pref_share * slack), 4096), 4096
        )
    # repack grid: None → resolve_repack_dims sizes R from the SLICED
    # nh_pad, which already scales with the band. Sizing from owned
    # content alone under-counts: the slice's static cap admits
    # neighbor-band rows whose (dead, band-check-culled) candidates
    # still occupy gather lanes (measured overflow at the equalized
    # D=8 center band)
    repack_rows = None

    return dataclasses.replace(
        cfg,
        shard_prefilter_cap=pref_cap,
        shard_slice_cap=slice_cap,
        pair_cap=pair_cap,
        fat_cap=fat_cap,
        fat_live_cap=fat_live_cap,
        repack_rows=repack_rows,
    )
