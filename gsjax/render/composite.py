"""Tile compositing, XLA backend: per-tile front-to-back alpha blending
over the binned, depth-ordered splat lists.

This is the per-pixel hot loop of the reference — the fragment shader's
gaussian falloff (/root/reference/src/renderers/webgl/shaders/
frag.glsl.ts:13-21) plus the ONE_MINUS_DST_ALPHA blend state
(WebGLRenderer.ts:141) — restructured as a vectorized chunked scan: each
16×16 tile walks its splat list in chunks of `cfg.chunk`, with the
termination rule folded into a virtual-cumprod carry (see
render/oracle.py for why that is exactly graphdeco's sticky `done`).

Two carries per pixel:
  C      — the *virtual* transmittance (product over all eligible
           splats), which implements the sticky termination test,
  T_act  — the *actual* transmittance (product over included splats
           only), which weights the background and is the output
           transmittance map. They diverge only after termination.

`build_padded_lists` + `blend_padded` also serve as the plain reference
for the stream backend's Triton kernels (same inputs, same blend math).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gsjax.core.camera import Camera
from gsjax.core.config import RenderConfig
from gsjax.render.binning import TileBins
from gsjax.render.common import gaussian_power
from gsjax.render.project import ProjectedSplats

ATT_DIM = 9  # mean2d(2) + conic(3) + rgb(3) + opacity(1)


def att_table(p: ProjectedSplats):
    """Per-splat packed attributes [N, 9]:
    mean2d(2) + conic(3) + rgb(3) + opacity(1)."""
    return jnp.concatenate(
        [p.mean2d, p.conic, p.rgb, p.opacity[:, None]], axis=-1
    )


def clipped_pair_stream(bins: TileBins, cfg: RenderConfig):
    """Apply the optional total-pair budget. Returns
    (pid_sorted [S'] i32, starts [T+1] i32, n_dropped scalar)."""
    S = bins.pid_sorted.shape[0]
    cap = min(cfg.pair_cap, S) if cfg.pair_cap else S
    pid = bins.pid_sorted[:cap]
    starts = jnp.minimum(bins.tile_starts, cap).astype(jnp.int32)
    n_dropped = jnp.maximum(bins.tile_starts[-1] - cap, 0)
    return pid, starts, n_dropped


def build_padded_lists(p: ProjectedSplats, bins: TileBins, cfg: RenderConfig):
    """Gather per-pair attributes into per-tile padded lists.

    Returns (att [T, cap, 9] f32, counts [T] i32). Overflow beyond
    cfg.tile_list_cap is dropped far-to-near (counted by the caller via
    bins.tile_counts)."""
    cap = cfg.tile_list_cap
    k_slots = cfg.tile_span * cfg.tile_span
    counts = jnp.minimum(bins.tile_counts, cap)  # [T]
    lane = jnp.arange(cap, dtype=jnp.int32)
    idx = bins.tile_starts[:-1][:, None] + lane[None, :]  # [T, cap]
    idx = jnp.minimum(idx, bins.pid_sorted.shape[0] - 1)
    sid = bins.pid_sorted[idx] // k_slots  # [T, cap]
    # the repack stream's 128-alignment pads carry sid = nh_pad >= N
    # (render/repack.py) — without the mask the clamped gather would read
    # a REAL row's attributes into dead lanes
    live = (lane[None, :] < counts[:, None]) & (sid < p.depth.shape[0])
    sid = jnp.where(live, sid, 0)

    att = att_table(p)[sid]  # [T, cap, 9]
    # zero attributes of padding/dead lanes so masked math stays finite
    att = jnp.where(live[:, :, None], att, 0.0)
    return att, counts


def blend_padded(att, counts, ty0, tiles_x: int, band_rows: int, cfg: RenderConfig):
    """Front-to-back composite of padded tile lists (XLA implementation).

    att [T, cap, 9], counts [T], ty0 scalar (first tile row).
    Returns (img [T, n_px, 3], T_act [T, n_px]) — per-tile flattened
    pixels, row-major within the tile."""
    ts = cfg.tile_size
    cap = cfg.tile_list_cap
    chunk = cfg.chunk
    assert cap % chunk == 0, "tile_list_cap must be a multiple of chunk"
    n_tiles = tiles_x * band_rows
    n_px = ts * ts

    t_ids = jnp.arange(n_tiles, dtype=jnp.int32)
    org_x = (t_ids % tiles_x) * ts  # [T]
    org_y = (jnp.asarray(ty0, jnp.int32) + t_ids // tiles_x) * ts
    lx = jnp.arange(ts, dtype=jnp.float32)
    pxl = jnp.tile(lx, ts)  # [n_px] x-local, row-major
    pyl = jnp.repeat(lx, ts)
    px = org_x[:, None].astype(jnp.float32) + pxl[None, :]  # [T, n_px]
    py = org_y[:, None].astype(jnp.float32) + pyl[None, :]

    eps_T = cfg.transmittance_eps

    def chunk_body(carry, att_c, valid_c, px_t, py_t):
        """One chunk for one tile. carry = (C, T_act [n_px], img [n_px,3])."""
        C, T_act, img = carry
        mean_x, mean_y = att_c[:, 0], att_c[:, 1]
        conic = att_c[:, 2:5]
        rgb = att_c[:, 5:8]
        op = att_c[:, 8]
        dx = px_t[:, None] - mean_x[None, :]  # [n_px, chunk]
        dy = py_t[:, None] - mean_y[None, :]
        power = gaussian_power(conic[None, :, :], dx, dy)
        alpha = jnp.minimum(cfg.alpha_clamp, op[None, :] * jnp.exp(power))
        eligible = valid_c[None, :] & (alpha >= cfg.alpha_min) & (power <= 0.0)
        f = jnp.where(eligible, 1.0 - alpha, 1.0)
        Cc = C[:, None] * jnp.cumprod(f, axis=1)  # virtual inclusive T
        include = eligible & (Cc >= eps_T)
        w = jnp.where(include, (Cc / f) * alpha, 0.0)  # [n_px, chunk]
        img = img + jnp.matmul(w, rgb, precision="highest")
        T_act = T_act * jnp.prod(jnp.where(include, f, 1.0), axis=1)
        return (Cc[:, -1], T_act, img)

    chunk_body = jax.checkpoint(chunk_body)

    def tile_fn(att_t, count_t, px_t, py_t):
        att_s = att_t.reshape(cap // chunk, chunk, att_t.shape[-1])
        lane_c = jnp.arange(chunk, dtype=jnp.int32)

        def body(carry, inp):
            att_c, k = inp
            valid_c = (k * chunk + lane_c) < count_t
            return chunk_body(carry, att_c, valid_c, px_t, py_t), None

        init = (
            jnp.ones(n_px, jnp.float32),
            jnp.ones(n_px, jnp.float32),
            jnp.zeros((n_px, 3), jnp.float32),
        )
        (C, T_act, img), _ = jax.lax.scan(
            body, init, (att_s, jnp.arange(cap // chunk, dtype=jnp.int32))
        )
        return img, T_act

    return jax.vmap(tile_fn)(att, counts, px, py)  # [T, n_px, 3], [T, n_px]


def assemble_band(img_t, T_t, bins: TileBins, cfg: RenderConfig):
    """Per-tile flat pixels → band image. Adds the background weighted by
    the actual transmittance, then untiles."""
    ts = cfg.tile_size
    tiles_x, band_rows = bins.tiles_x, bins.band_rows
    bg = jnp.asarray(cfg.background, jnp.float32)
    img_t = img_t + T_t[..., None] * bg[None, None, :]
    img = img_t.reshape(band_rows, tiles_x, ts, ts, 3)
    img = img.transpose(0, 2, 1, 3, 4).reshape(band_rows * ts, tiles_x * ts, 3)
    T_map = T_t.reshape(band_rows, tiles_x, ts, ts)
    T_map = T_map.transpose(0, 2, 1, 3).reshape(band_rows * ts, tiles_x * ts)
    return img, T_map


def composite_tiles(
    p: ProjectedSplats,
    bins: TileBins,
    cam: Camera,
    cfg: RenderConfig,
    blend_fn=None,
):
    """Composite the tile band covered by `bins`. Returns
    (img [band_rows·ts, tiles_x·ts, 3], aux dict); the caller crops to the
    camera viewport (single chip) or stacks bands (tile-sharded mesh)."""
    att, counts = build_padded_lists(p, bins, cfg)
    blend = blend_fn or blend_padded
    img_t, T_t = blend(att, counts, bins.ty0, bins.tiles_x, bins.band_rows, cfg)
    img, T_map = assemble_band(img_t, T_t, bins, cfg)

    aux = {
        "transmittance": T_map,
        "n_clamped": bins.n_clamped,
        "n_pairs": bins.n_pairs,
        "n_tile_overflow": jnp.sum(
            jnp.maximum(bins.tile_counts - cfg.tile_list_cap, 0)
        ),
    }
    return img, aux
