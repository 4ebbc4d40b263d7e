"""The Triton blend against its plain-XLA reference on one pair stream.

`frame_stream` runs the stream backend's real prologue (project → home
layout → home-anchored bins) and returns the blend's inputs;
`reference_blend` feeds the same pair stream to composite.blend_padded;
`compare_blend` runs both, forward and backward, on a band of tile
rows and returns their differences. chip_smoke.py (phase 2), the
GPU-marked tests and the CPU tests all call these.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from gsjax.core.config import RenderConfig
from gsjax.render.composite import blend_padded
from gsjax.render.pallas_stream import ATT_COLS, blend_stream, stream_cols

FWD_LIMIT = 2e-5  # image max |Δ|, f32 attributes
GRAD_LIMIT = 1e-3  # per leaf max |Δ| / max |ref|: summation order


@partial(jax.jit, static_argnums=(2,))
def frame_stream(g, cam, cfg: RenderConfig):
    """(cols, pid, starts, counters): the 9 home-row attribute columns,
    the clipped pair stream and its tile segments of the full frame."""
    from gsjax.render.binning import build_tile_bins
    from gsjax.render.composite import clipped_pair_stream
    from gsjax.render.homesort import build_home_layout
    from gsjax.render.pipeline import _project_any

    p = _project_any(g, cam, cfg)
    p, layout = build_home_layout(p, cam, cfg)
    bins = build_tile_bins(p, cam, cfg, anchor="home", layout=layout)
    pid, starts, n_dropped = clipped_pair_stream(bins, cfg)
    counters = {
        "n_pair_overflow": n_dropped + bins.n_repack_overflow,
        "n_fat_overflow": layout.n_fat_overflow,
    }
    return stream_cols(p), pid, starts, counters


def reference_blend(cols, pid, starts, ty0, tiles_x: int, band_rows: int,
                    cfg: RenderConfig, cap: int):
    """blend_padded on the same pair stream and home-row columns:
    per-tile lists padded to `cap` (a chunk multiple that holds the
    band's largest tile). Differentiable by autodiff."""
    k = cfg.tile_span * cfg.tile_span
    nh = cols[0].shape[0]
    att_rows = jnp.stack(cols, axis=1)  # [NH, 9]
    counts = starts[1:] - starts[:-1]
    lane = jnp.arange(cap, dtype=jnp.int32)
    idx = jnp.minimum(starts[:-1][:, None] + lane, pid.shape[0] - 1)
    sid = pid[idx] // k
    live = (lane[None, :] < counts[:, None]) & (sid < nh)
    att = jnp.where(live[..., None], att_rows[jnp.where(live, sid, 0)], 0.0)
    cfg_ref = dataclasses.replace(cfg, tile_list_cap=cap)
    return blend_padded(att, counts, ty0, tiles_x, band_rows, cfg_ref)


def band_cap(starts, t0: int, t1: int, chunk: int) -> int:
    """Padded-list capacity holding the largest tile of tiles [t0, t1)."""
    s = np.asarray(starts)
    worst = int(np.max(s[t0 + 1 : t1 + 1] - s[t0:t1], initial=1))
    return -(-max(worst, 1) // chunk) * chunk


def densest_band(starts, tiles_x: int, tiles_y: int, rows: int) -> int:
    """First tile row of the `rows`-row band holding the most pairs."""
    s = np.asarray(starts, np.int64)
    row_end = s[np.minimum(np.arange(1, tiles_y + 1) * tiles_x, len(s) - 1)]
    row_start = s[np.arange(tiles_y) * tiles_x]
    per_row = row_end - row_start
    sums = np.convolve(per_row, np.ones(rows, np.int64), "valid")
    return int(np.argmax(sums))


def compare_blend(cols, pid, starts, row0: int, rows: int, tiles_x: int,
                  cfg: RenderConfig, seed: int = 0):
    """Triton blend vs reference_blend on tile rows [row0, row0 + rows)
    of the stream: forward image and transmittance, and the gradients
    w.r.t. the 9 columns of a loss that weights both outputs with fixed
    random cotangents. Returns a dict of errors and sizes."""
    t0, t1 = row0 * tiles_x, (row0 + rows) * tiles_x
    starts_b = starts[t0 : t1 + 1]
    cap = band_cap(starts, t0, t1, cfg.chunk)
    n_px = cfg.tile_size * cfg.tile_size
    key_i, key_t = jax.random.split(jax.random.PRNGKey(seed))
    w_img = jax.random.uniform(key_i, (t1 - t0, n_px, 3), jnp.float32)
    w_T = jax.random.uniform(key_t, (t1 - t0, n_px), jnp.float32)
    ty0 = jnp.int32(row0)

    def loss(cols, blend):
        img, T = blend(cols)
        return jnp.sum(img * w_img) + jnp.sum(T * w_T), (img, T)

    triton = lambda c: blend_stream(c, pid, starts_b, ty0, tiles_x, rows, cfg)
    plain = lambda c: reference_blend(
        c, pid, starts_b, ty0, tiles_x, rows, cfg, cap
    )
    with jax.default_matmul_precision("highest"):
        (_, (img_k, T_k)), g_k = jax.jit(
            jax.value_and_grad(partial(loss, blend=triton), has_aux=True)
        )(cols)
        (_, (img_r, T_r)), g_r = jax.jit(
            jax.value_and_grad(partial(loss, blend=plain), has_aux=True)
        )(cols)
    img_k, img_r = np.asarray(img_k), np.asarray(img_r)
    grad_rel = []
    for a, b in zip(g_k, g_r):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        grad_rel.append(float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30)))
    return {
        "fwd_err": float(np.abs(img_k - img_r).max()),
        "T_err": float(np.abs(np.asarray(T_k) - np.asarray(T_r)).max()),
        "grad_rel": grad_rel,
        "finite": bool(
            np.isfinite(img_k).all()
            and all(np.isfinite(np.asarray(x)).all() for x in g_k)
        ),
        "tiles": t1 - t0,
        "pairs": int(np.asarray(starts)[t1] - np.asarray(starts)[t0]),
        "cap": cap,
    }


def within_limits(err) -> bool:
    return (
        err["finite"]
        and err["fwd_err"] <= FWD_LIMIT
        and max(err["grad_rel"]) <= GRAD_LIMIT
        and len(err["grad_rel"]) == ATT_COLS
    )
