"""Stream backend: the tile blend as one Triton kernel pair.

The shape is graphdeco's CUDA rasterizer (the BASELINE correctness
target): one program per 16×16 tile, whose 256 pixels are one vector;
the tile's depth-sorted pairs are walked in order, and the walk stops
once every pixel is done.

  * Attributes: the 9 home-row columns (mean2d, conic, rgb, opacity) are
    gathered into pair order ONCE in XLA ([9, S] f32, `pair_attrs`), so
    the kernels read each tile's segment contiguously. Pairs whose home
    row is a repack pad (sid >= NH) or that lie past the stream's end
    get zero opacity and contribute nothing.
  * Forward: per pair, per pixel, the virtual transmittance C (product
    over every ELIGIBLE splat) implements graphdeco's sticky termination
    (`C·(1-α) >= eps`, render/oracle.py), while the actual transmittance
    T_act multiplies only over INCLUDED splats and weights the
    background. The tile leaves its chunk loop once max(C) < eps. Per
    pixel the kernel records the index of its last included pair.
  * Backward: the hand-derived rule, graphdeco-style. Walking back from
    the tile's last included pair, T before pair i is recovered by
    division from T_act (never from the virtual C, which can underflow
    after termination), inclusion is `eligible ∧ i <= last[pixel]`, and

      dL/dα_i = v_i·T_i − (U_i + ct_T·T_act)/(1−α_i)
      v_i = Σ_c ct_c·rgb_ic,   U_i = Σ_{j>i included} v_j·w_j

    chains to mean2d/conic/rgb/opacity. Each pair belongs to exactly one
    tile, so its gradient is the tile's pixel sum, written to the pair's
    own slot; `pairs_to_rows` then sums a home row's (at most 9) pair
    slots through the inverse pair permutation — deterministic, no
    scatter-add.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl

from gsjax import device
from gsjax.core.config import RenderConfig

ATT_COLS = 9  # mx, my, conic a/b/c, r, g, b, opacity
_NUM_WARPS = 8


def pair_attrs(cols, pid, starts, k_slots: int):
    """9 home-row columns [NH] → pair-ordered attributes [9, S]."""
    nh = cols[0].shape[0]
    s = pid.shape[0]
    sid = pid // k_slots
    live = (sid < nh) & (jnp.arange(s, dtype=jnp.int32) < starts[-1])
    sidc = jnp.where(live, sid, 0)
    g = [c[sidc] for c in cols]
    g[8] = jnp.where(live, g[8], 0.0)
    return jnp.stack(g)


def pairs_to_rows(dpair, pid, starts, nh: int, k_slots: int):
    """Per-pair values [9, S] → per-home-row sums [9, NH]. Pair ids are
    unique (sid·K + class), so the inverse permutation is a scatter-SET
    of positions and the class sum a gather + reduce: deterministic."""
    s = pid.shape[0]
    live = (pid // k_slots < nh) & (jnp.arange(s, dtype=jnp.int32) < starts[-1])
    inv = (
        jnp.full((nh * k_slots,), s, jnp.int32)
        .at[jnp.where(live, pid, nh * k_slots)]
        .set(jnp.arange(s, dtype=jnp.int32), mode="drop")
    )
    dpad = jnp.pad(dpair, ((0, 0), (0, 1)))
    return dpad[:, inv].reshape(ATT_COLS, nh, k_slots).sum(-1)


def _pixels(t, ty0, tiles_x: int, ts: int):
    lane = jnp.arange(ts * ts, dtype=jnp.int32)
    px = ((t % tiles_x) * ts + lane % ts).astype(jnp.float32)
    py = ((t // tiles_x + ty0) * ts + lane // ts).astype(jnp.float32)
    return px, py


def _splat(att_ref, i, px, py, alpha_clamp, alpha_min):
    """Pair i's attributes and its per-pixel falloff quantities."""
    a = [att_ref[c, i] for c in range(ATT_COLS)]
    mx, my, ca, cb, cc, op = a[0], a[1], a[2], a[3], a[4], a[8]
    dx = px - mx
    dy = py - my
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    G = jnp.exp(power)
    raw = op * G
    alpha = jnp.minimum(alpha_clamp, raw)
    eligible = (alpha >= alpha_min) & (power <= 0.0)
    return a, dx, dy, G, raw, alpha, eligible


def _fwd_kernel(meta_ref, starts_ref, att_ref, out_ref, last_ref, *,
                ts, tiles_x, chunk, n_pairs, alpha_clamp, alpha_min, eps_T):
    t = pl.program_id(0)
    s0 = starts_ref[t]
    s1 = starts_ref[t + 1]
    px, py = _pixels(t, meta_ref[0], tiles_x, ts)
    n_px = ts * ts
    one = jnp.ones((n_px,), jnp.float32)
    zero = jnp.zeros((n_px,), jnp.float32)

    def pair(j, st, base):
        C, T, r, g, b, last = st
        i = base + j
        ic = jnp.minimum(i, n_pairs - 1)
        a, _dx, _dy, _G, _raw, alpha, eligible = _splat(
            att_ref, ic, px, py, alpha_clamp, alpha_min
        )
        eligible = eligible & (i < s1)
        Cn = C * jnp.where(eligible, 1.0 - alpha, 1.0)
        include = eligible & (Cn >= eps_T)
        w = jnp.where(include, C * alpha, 0.0)
        return (
            Cn,
            jnp.where(include, Cn, T),
            r + w * a[5],
            g + w * a[6],
            b + w * a[7],
            jnp.where(include, i, last),
        )

    def cond(carry):
        k, st = carry
        return (s0 + k * chunk < s1) & (jnp.max(st[0]) >= eps_T)

    def body(carry):
        k, st = carry
        base = s0 + k * chunk
        st = jax.lax.fori_loop(0, chunk, partial(pair, base=base), st)
        return k + 1, st

    init = (one, one, zero, zero, zero, jnp.full((n_px,), s0 - 1, jnp.int32))
    _, (C, T, r, g, b, last) = jax.lax.while_loop(
        cond, body, (jnp.int32(0), init)
    )
    out_ref[t, 0, :] = r
    out_ref[t, 1, :] = g
    out_ref[t, 2, :] = b
    out_ref[t, 3, :] = T
    last_ref[t, :] = last


def _bwd_kernel(meta_ref, starts_ref, att_ref, tact_ref, last_ref, ct_ref,
                dz_ref, d_ref, *, ts, tiles_x, alpha_clamp, alpha_min):
    del dz_ref  # zero-initialised storage aliased to d_ref
    t = pl.program_id(0)
    s0 = starts_ref[t]
    px, py = _pixels(t, meta_ref[0], tiles_x, ts)
    T_act = tact_ref[t, :]
    last = last_ref[t, :]
    ctr, ctg, ctb = ct_ref[t, 0, :], ct_ref[t, 1, :], ct_ref[t, 2, :]
    ctT_Tact = ct_ref[t, 3, :] * T_act
    lmax = jnp.max(last)

    def pair(j, st):
        T, U = st
        i = lmax - j
        a, dx, dy, G, raw, alpha, eligible = _splat(
            att_ref, i, px, py, alpha_clamp, alpha_min
        )
        include = eligible & (i <= last)
        f = 1.0 - alpha
        Tb = jnp.where(include, T / f, T)
        w = jnp.where(include, Tb * alpha, 0.0)
        v = a[5] * ctr + a[6] * ctg + a[7] * ctb
        dalpha = jnp.where(include, v * Tb - (U + ctT_Tact) / f, 0.0)
        unclamped = raw < alpha_clamp
        dpow = jnp.where(unclamped, dalpha * alpha, 0.0)
        ca, cb, cc = a[2], a[3], a[4]
        grads = (
            jnp.sum(dpow * (ca * dx + cb * dy)),
            jnp.sum(dpow * (cb * dx + cc * dy)),
            jnp.sum(dpow * (-0.5 * dx * dx)),
            jnp.sum(dpow * (-dx * dy)),
            jnp.sum(dpow * (-0.5 * dy * dy)),
            jnp.sum(w * ctr),
            jnp.sum(w * ctg),
            jnp.sum(w * ctb),
            jnp.sum(jnp.where(unclamped, dalpha * G, 0.0)),
        )
        for c in range(ATT_COLS):
            d_ref[c, i] = grads[c]
        return Tb, U + v * w

    jax.lax.fori_loop(
        0, jnp.maximum(lmax - s0 + 1, 0), pair,
        (T_act, jnp.zeros_like(T_act)),
    )


def _fwd_call(att, starts, ty0, tiles_x: int, band_rows: int,
              cfg: RenderConfig):
    ts = cfg.tile_size
    n_px = ts * ts
    n_tiles = tiles_x * band_rows
    kernel = partial(
        _fwd_kernel, ts=ts, tiles_x=tiles_x, chunk=cfg.chunk,
        n_pairs=att.shape[1], alpha_clamp=cfg.alpha_clamp,
        alpha_min=cfg.alpha_min, eps_T=cfg.transmittance_eps,
    )
    return device.pallas_call(
        kernel,
        num_warps=_NUM_WARPS,
        grid=(n_tiles,),
        out_shape=[
            jax.ShapeDtypeStruct((n_tiles, 4, n_px), jnp.float32),
            jax.ShapeDtypeStruct((n_tiles, n_px), jnp.int32),
        ],
        name="blend_fwd",
    )(_meta(ty0), starts, att)


def _bwd_call(att, starts, ty0, T_act, last, ct, tiles_x: int,
              band_rows: int, cfg: RenderConfig):
    kernel = partial(
        _bwd_kernel, ts=cfg.tile_size, tiles_x=tiles_x,
        alpha_clamp=cfg.alpha_clamp, alpha_min=cfg.alpha_min,
    )
    return device.pallas_call(
        kernel,
        num_warps=_NUM_WARPS,
        grid=(tiles_x * band_rows,),
        out_shape=jax.ShapeDtypeStruct(att.shape, jnp.float32),
        input_output_aliases={6: 0},
        name="blend_bwd",
    )(_meta(ty0), starts, att, T_act, last, ct, jnp.zeros_like(att))


def _meta(ty0):
    return jnp.asarray(ty0, jnp.int32).reshape(1)


def _check(cfg: RenderConfig):
    n_px = cfg.tile_size * cfg.tile_size
    if n_px & (n_px - 1):
        raise ValueError(
            f"tile_size={cfg.tile_size}: the Triton blend needs a "
            "power-of-two pixel count per tile"
        )


# --------------------------------------------------------------------------
# differentiable entry point
# --------------------------------------------------------------------------


@partial(jax.custom_vjp, nondiff_argnums=(4, 5, 6))
def blend_stream(cols, pid, starts, ty0, tiles_x, band_rows, cfg):
    """Stream tile blend. cols = 9 home-row f32 columns (mx, my, conic
    a/b/c, r, g, b, opacity), each [NH]; pid [S] the tile-major,
    near-to-far pair stream (pid = home row·9 + class); starts [T+1] its
    tile segments. Returns (img [T, n_px, 3], T_act [T, n_px])."""
    return _blend_stream_fwd(cols, pid, starts, ty0, tiles_x, band_rows,
                             cfg)[0]


def _blend_stream_fwd(cols, pid, starts, ty0, tiles_x, band_rows, cfg):
    _check(cfg)
    k = cfg.tile_span * cfg.tile_span
    att = pair_attrs(cols, pid, starts, k)
    out, last = _fwd_call(att, starts, ty0, tiles_x, band_rows, cfg)
    T_act = out[:, 3, :]
    res = (att, pid, starts, ty0, T_act, last, cols[0].shape[0])
    return (jnp.swapaxes(out[:, 0:3, :], 1, 2), T_act), res


def _blend_stream_bwd(tiles_x, band_rows, cfg, res, cts):
    att, pid, starts, ty0, T_act, last, nh = res
    ct_img, ct_T = cts
    ct = jnp.concatenate(
        [jnp.swapaxes(ct_img, 1, 2), ct_T[:, None, :]], axis=1
    )
    dpair = _bwd_call(att, starts, ty0, T_act, last, ct, tiles_x,
                      band_rows, cfg)
    k = cfg.tile_span * cfg.tile_span
    d = pairs_to_rows(dpair, pid, starts, nh, k)
    f0 = jax.dtypes.float0
    z = lambda x: np.zeros(jnp.shape(x), f0)
    return (tuple(d[c] for c in range(ATT_COLS)), z(pid), z(starts), z(ty0))


blend_stream.defvjp(_blend_stream_fwd, _blend_stream_bwd)


# --------------------------------------------------------------------------
# render-pipeline integration
# --------------------------------------------------------------------------


def stream_cols(p):
    """The blend's 9 attribute columns of projected (home-ordered)
    splats."""
    return (
        p.mean2d[:, 0], p.mean2d[:, 1],
        p.conic[:, 0], p.conic[:, 1], p.conic[:, 2],
        p.rgb[:, 0], p.rgb[:, 1], p.rgb[:, 2],
        p.opacity,
    )


def composite_tiles_stream(p, layout, bins, cam, cfg: RenderConfig):
    """Composite the tile band covered by `bins` with the stream kernels.

    `p` must be the HOME-ordered projected splats returned by
    homesort.build_home_layout, and `bins` built with anchor="home" and
    the same layout."""
    from gsjax.render.composite import assemble_band, clipped_pair_stream

    if cfg.tile_span != 3:
        raise ValueError("stream backend requires tile_span == 3")
    pid, starts, n_dropped = clipped_pair_stream(bins, cfg)
    with jax.named_scope("blend"):
        img_t, T_t = blend_stream(
            stream_cols(p), pid, starts, bins.ty0, bins.tiles_x,
            bins.band_rows, cfg,
        )
    img, T_map = assemble_band(img_t, T_t, bins, cfg)
    aux = {
        "transmittance": T_map,
        "n_clamped": bins.n_clamped,
        "n_pairs": bins.n_pairs,
        "n_tile_overflow": jnp.zeros((), jnp.int32),
        "n_pair_overflow": n_dropped + bins.n_repack_overflow,
        "n_band_overflow": jnp.zeros((), jnp.int32),
        "n_fat_overflow": layout.n_fat_overflow,
    }
    return img, aux
