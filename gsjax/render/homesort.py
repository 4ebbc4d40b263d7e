"""Home-tile splat layout for the stream backend.

The projected splats are re-laid out ONCE per frame in (home_tile,
depth) order:

  * a splat's *home tile* is the center of the 3×3-tile block of its
    footprint rect it is responsible for, so every pair's tile is one of
    the 9 fixed class offsets from its home, and a home row's pairs are
    enumerated in a static [9, NH] grid (render/binning.py);
  * EXACT footprints (cfg.footprint_clamp=False, the default): a splat
    whose rect spans more than one 3×3-tile block is *split* — extra
    home rows are appended, one per additional block, each a copy of the
    parent's projected attributes homed at that block's center tile and
    windowed to block ∩ rect. The blocks partition the rect, so the
    merged (tile, depth) pair stream is identical to an unclamped
    enumeration and compositing is exact (≙ the reference's up-to-1024-px
    screen axes, vertex.glsl.ts:173-175). Copy blocks whose window the
    splat's ellipse cannot reach at alpha_min are culled at enumeration
    (exactly the per-tile cull binning applies — a dead block contributes
    zero pairs, so the output is bit-identical). Budget overflow
    (fat_max_blocks / fat_cap / fat_live_cap) is counted, never silent.
  * LEGACY span budget (cfg.footprint_clamp=True): home = the splat's
    mean tile, rects clamped to tile_span×tile_span (round-1 semantics).
  * gradients: the blend accumulates per-home-row gradients; one
    inverse-permutation row gather returns primaries to the caller's
    splat order, and copy-row gradients reduce onto their parents by a
    contiguous-segment sum (copies of one parent are consecutive
    enumeration slots) — never a large scatter-add.

Copy enumeration is RAGGED: parents of consecutive copy slots are
consecutive FAT splats, so the parent of every copy slot is a scatter
of marks plus a running max (`fat_parents`), followed by one parent-row
gather and the per-copy block math (`copy_rows`). Windows ride the big
sort as packed payloads; liveness is the home-key sentinel.

This generalizes the reference's single global depth sort
(/root/reference/wasm/wasm.cpp:33-51) into the (home tile, depth) order
the tile blend walks.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from gsjax.core.camera import Camera
from gsjax.core.config import RenderConfig
from gsjax.render.common import (
    cull_threshold,
    depth_bits,
    rect_qmin,
    tile_rect,
)
from gsjax.render.project import ProjectedSplats

PCOLS = 11  # mean2d(2) + depth(1) + conic(3) + radius(1) + rgb(3) + opacity(1)


def fat_parents(is_fat, base, fat_cap: int):
    """Parent splat of each copy slot [fat_cap]: copy slots of fat splat
    i are [base_i, base_i + n_ex_i), consecutive and non-decreasing in
    i, so scattering each fat splat's index at its first slot and taking
    a running max fills every segment. Slots past the last copy inherit
    the last parent (they are dead: slot >= n_copies)."""
    n = is_fat.shape[0]
    marks = (
        jnp.zeros((fat_cap,), jnp.int32)
        .at[jnp.where(is_fat & (base < fat_cap), base, fat_cap)]
        .max(jnp.arange(n, dtype=jnp.int32), mode="drop")
    )
    return jax.lax.cummax(marks)


def copy_rows(g, n_copies, *, tiles_x, tiles_y, span, ts, alpha_min):
    """Fat-splat copy rows from their parents' rows `g` [F, 18] (cols:
    0 base, 1-2 mean2d, 3-5 conic, 6 opacity, 7 depth, 8 radius,
    9-11 rgb, 12 blocks per row sbx, 13-16 rect x0 y0 x1 y1,
    17 n_ex; integers as exact f32 values). Copy slot j is block
    b = j − base + 1 of its parent's rect (block 0 is the primary row).

    Returns (tail [F, 12] — mean2, depth, conic, radius, rgb, opacity,
    pad: the parent's attributes in home_gather's column order;
    home_key [F] i32 — the block's center tile, or tiles_x·tiles_y for
    dead slots and blocks the splat's alpha_min ellipse cannot reach;
    depth [F]; wpa/wpb [F] — the block ∩ rect window packed as
    wx0·16384 + wx1 and wy0·16384 + wy1)."""
    f = g.shape[0]
    h = span // 2
    slot = jnp.arange(f, dtype=jnp.int32)
    b = slot - _f2i(g[:, 0]) + 1
    sbx = jnp.maximum(_f2i(g[:, 12]), 1)
    x0, y0, x1, y1 = (_f2i(g[:, k]) for k in (13, 14, 15, 16))
    cwx0 = x0 + span * (b % sbx)
    cwx1 = jnp.minimum(cwx0 + span, x1)
    cwy0 = y0 + span * (b // sbx)
    cwy1 = jnp.minimum(cwy0 + span, y1)
    chx = jnp.minimum(cwx0 + h, tiles_x - 1)
    chy = jnp.minimum(cwy0 + h, tiles_y - 1)
    qmin = rect_qmin(
        g[:, 1], g[:, 2], g[:, 3], g[:, 4], g[:, 5],
        cwx0, cwx1, cwy0, cwy1, float(ts),
    )
    ok = (slot < n_copies) & (qmin <= cull_threshold(g[:, 6], alpha_min))
    home_key = jnp.where(ok, chy * tiles_x + chx, tiles_x * tiles_y)
    depth = jnp.where(ok, g[:, 7], 1.0)
    cw = [jnp.clip(c, 0, 16383) for c in (cwx0, cwx1, cwy0, cwy1)]
    tail = jnp.concatenate(
        [g[:, 1:3], g[:, 7:8], g[:, 3:6], g[:, 8:9], g[:, 9:12], g[:, 6:7],
         jnp.zeros((f, 1), g.dtype)],
        axis=1,
    )
    return (tail, home_key.astype(jnp.int32), depth,
            cw[0] * 16384 + cw[1], cw[2] * 16384 + cw[3])


# --------------------------------------------------------------------------
# differentiable home gather with cheap transpose
# --------------------------------------------------------------------------


@partial(jax.custom_vjp, nondiff_argnums=())
def home_gather(x, tail_x, perm, inv, inv_tail, seg_base):
    """concat(x [N,C], tail_x [F,C])[perm] with a cheap VJP.

    `tail_x` holds the fat-splat copy rows (each a function of its
    parent's row of `x` — here always an exact copy, so its cotangent
    sums onto the parent). `inv` [N] / `inv_tail` [F]: each pre-sort
    row's position in the OUTPUT (≥ len(perm) ⇒ truncated ⇒ zero grad).
    `seg_base` [N+1]: copies of parent i occupy tail slots
    [seg_base[i], seg_base[i+1]) — contiguous, so the parent reduction
    is a cumsum + boundary-difference instead of a scatter-add."""
    return jnp.concatenate([x, tail_x])[perm]


def _home_gather_fwd(x, tail_x, perm, inv, inv_tail, seg_base):
    out = home_gather(x, tail_x, perm, inv, inv_tail, seg_base)
    return out, (x.shape[0], tail_x.shape[0], inv, inv_tail, seg_base)


def reduce_copy_segments(d_tail, seg_base):
    """[F, C] copy-row values → [N, C] per-parent segment sums (copies of
    parent i occupy tail rows [seg_base[i], seg_base[i+1])).

    A segment sum over the rows' parent ids (a scatter-add): every sum
    is formed from its own segment's values only, so its rounding error
    is relative to the segment, whatever its neighbours hold. Prefix
    differencing (p[b-1] − p[a-1]) would difference running sums that
    carry the neighbouring segments' magnitudes — large relative errors
    on small segments, and gradient noise that depends on how the rows
    happen to be laid out. The GPU's atomic adds make the last bits
    vary from run to run.

    Shared by home_gather's VJP and the lazy fold-back
    (render/lazy.py): the copy-delta reduction at resort cadence is the
    same operation as the per-step copy-gradient reduction it replaces."""
    f = d_tail.shape[0]
    n = seg_base.shape[0] - 1
    sb = jnp.minimum(seg_base, f)  # [N+1]
    # parent of each row: mark each segment's first row with its parent
    # (an empty segment shares its start with the next one; the max
    # keeps the later, non-empty parent) and carry the marks forward
    marks = (
        jnp.zeros((f,), jnp.int32)
        .at[sb[:-1]]
        .max(jnp.arange(n, dtype=jnp.int32), mode="drop")
    )
    rows = jnp.arange(f, dtype=jnp.int32)
    ids = jnp.where(rows < sb[-1], jax.lax.cummax(marks), n)
    return jax.ops.segment_sum(
        d_tail.astype(jnp.float32), ids, num_segments=n + 1,
        indices_are_sorted=True,
    )[:n]


def reduce_home_rows(d, n, f, inv, inv_tail, seg_base):
    """[NH, C] home-row values → [N, C] splat-order values: primary rows
    route through the inverse permutation (>= NH ⇒ truncated ⇒ zero),
    copy rows segment-sum onto their parents. The transpose of
    home_gather as a standalone op (the lazy fold-back applies it to
    parameter/optimizer DELTAS at resort cadence)."""
    nh = d.shape[0]
    dpad = jnp.concatenate([d, jnp.zeros((1,) + d.shape[1:], d.dtype)])
    take = lambda idx: dpad[jnp.where(idx < nh, idx, nh)]
    dx = take(inv)  # primary rows, bijective into the kept window
    if f:
        d_tail = take(inv_tail)  # [F, C] copy-row values, parent-contiguous
        dx = dx + reduce_copy_segments(d_tail, seg_base).astype(d.dtype)
    return dx


def _home_gather_bwd(res, d):
    n, f, inv, inv_tail, seg_base = res
    dx = reduce_home_rows(d, n, f, inv, inv_tail, seg_base)
    return (dx, None, None, None, None, None)


home_gather.defvjp(_home_gather_fwd, _home_gather_bwd)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "perm",
        "seg_starts",
        "home_x",
        "home_y",
        "win",
        "n_valid",
        "n_fat_overflow",
        "n_copies",
        "seg_row0",
    ],
    meta_fields=["tiles_x", "tiles_y", "rows_present"],
)
@dataclasses.dataclass(frozen=True)
class HomeLayout:
    """perm [NH] i32: home row i holds pre-sort entry perm[i] (entries
    ≥ N are fat-splat copies); seg_starts [T+2]: home rows of tile t are
    [seg_starts[t], seg_starts[t+1]) (segment T holds culled rows);
    home_x/home_y [NH]: home tile coords per row; win [NH, 4] i32
    (wx0, wx1, wy0, wy1): the row's tile window = its block ∩ rect
    (exact mode) — binning enumerates pairs strictly inside it;
    n_fat_overflow: footprint blocks/rows lost to the fat budgets
    (0 ⇒ the frame is exactly unclamped)."""

    perm: jax.Array
    seg_starts: jax.Array
    home_x: jax.Array
    home_y: jax.Array
    win: jax.Array
    n_valid: jax.Array
    n_fat_overflow: jax.Array
    n_copies: jax.Array  # copy-slot ENUMERATION demand (pre block-cull)
    seg_row0: jax.Array
    tiles_x: int
    tiles_y: int
    rows_present: int


def resolve_fat_caps(n: int, cfg: RenderConfig):
    """Static fat-split budgets: (fat_cap, live_cap). fat_cap bounds the
    copy ENUMERATION (pre block-cull); live_cap bounds the copy rows kept
    in the sorted layout (post-cull). None-configured caps scale with the
    scene; overflow is counted either way."""
    fat_cap = cfg.fat_cap
    if fat_cap is None:
        fat_cap = min(4_194_304, max(1024, 2 * n))
    if fat_cap >= 1 << 24:
        # copy-block decoding rides the merged parent gather as f32
        # VALUES (_i2f): `base` up to fat_cap must be exactly
        # representable, or gbase silently corrupts and windows/homes
        # decode wrong with no overflow count
        raise ValueError(
            f"fat_cap={fat_cap} >= 2^24 breaks the f32-exactness "
            "precondition of the merged parent gather (homesort._i2f); "
            "use a smaller cap (overflow is counted, never silent)"
        )
    live_cap = cfg.fat_live_cap
    if live_cap is None:
        live_cap = min(2_097_152, max(1024, n + n // 4))
    return fat_cap, min(live_cap, fat_cap)


def _legacy_home(p, tiles_x, tiles_y, cfg):
    """Round-1 semantics: home = the mean's tile, window = the span-3
    rect clamp (applied later in binning via clamp_rect_to_span)."""
    mx, my = p.mean2d[:, 0], p.mean2d[:, 1]
    htx = jnp.clip(
        jnp.floor(mx / cfg.tile_size).astype(jnp.int32), 0, tiles_x - 1
    )
    hty = jnp.clip(
        jnp.floor(my / cfg.tile_size).astype(jnp.int32), 0, tiles_y - 1
    )
    # splats within 2 tiles outside the viewport keep a CLIPPED home tile
    # so their in-image pairs stay renderable; farther ones go to the
    # sentinel segment (their span-clamped rect cannot reach the image)
    on = (
        p.valid
        & (mx >= -cfg.tile_size * 2)
        & (mx < tiles_x * cfg.tile_size + cfg.tile_size * 2)
        & (my >= -cfg.tile_size * 2)
        & (my < tiles_y * cfg.tile_size + cfg.tile_size * 2)
    )
    return htx, hty, on


def _i2f(x):
    """Integer columns ride row gathers as f32 VALUES (exact below 2^24,
    which every tile/block/slot index here satisfies). NOT a bitcast:
    small-int bit patterns are denormal floats, which devices may flush
    to zero in copies."""
    return x.astype(jnp.float32)


def _f2i(x):
    return x.astype(jnp.int32)


def build_home_layout(p: ProjectedSplats, cam: Camera, cfg: RenderConfig,
                      return_extras: bool = False):
    """Sort the PROJECTED scene by (home tile, depth), splitting fat
    splats into per-block copies in exact mode. Returns
    (p_home: ProjectedSplats [NH], HomeLayout); NH = N + live_cap
    (exact mode) or N (legacy). All key/geometry math runs under
    stop_gradient — the permutation is order information.

    With return_extras, additionally returns a dict with the inverse
    structure the lazy fold-back needs (render/lazy.py): `inv` [N] /
    `inv_tail` [F] (each pre-sort row's home position, >= NH ⇒
    truncated), `seg_base` [N+1] (copy-slot segments per parent), and
    `parent_of_slot` [F] (the parent splat of each copy slot — a
    scatter + cummax over the non-decreasing slot bases)."""
    n = p.depth.shape[0]
    tiles_x = cfg.tiles_x(cam.width)
    tiles_y = cfg.tiles_y(cam.height)
    if max(tiles_x, tiles_y) > 1023:
        # windows ride the sort as base-16384 packed payloads and tile
        # coords ride the repeat kernel as f32 values: both are exact
        # only below 1024 tiles per axis (16,368 px at tile_size=16)
        raise ValueError(
            f"{tiles_x}x{tiles_y} tiles exceeds the 1023-per-axis bound "
            "of the packed window payloads; increase tile_size"
        )
    span = cfg.tile_span
    sg = jax.lax.stop_gradient
    mean2d, radius, depth, valid = (
        sg(p.mean2d), sg(p.radius), sg(p.depth), p.valid,
    )
    t_sent = jnp.int32(tiles_x * tiles_y)
    h = span // 2

    if cfg.footprint_clamp:
        htx, hty, on = _legacy_home(p, tiles_x, tiles_y, cfg)
        home_key = jnp.where(on, hty * tiles_x + htx, t_sent)
        dkey = depth_bits(jnp.where(valid, depth, 1.0))
        nt = n
        nh = n
        fat_cap = 0
        base = None
        is_fat = None
        parent = jnp.zeros((0,), jnp.int32)
        seg_base = jnp.zeros((n + 1,), jnp.int32)
        # zero packed windows = the all-zero win sentinel: binning reclamps
        wpa = jnp.zeros((n,), jnp.int32)
        wpb = jnp.zeros((n,), jnp.int32)
        on_ext = on
        n_ovf = jnp.zeros((), jnp.int32)
        n_copies = jnp.zeros((), jnp.int32)
    else:
        if cfg.fat_max_blocks >= 1024:
            # the VJP's block-bounded segment reduction (_home_gather_bwd)
            # requires every parent's copy run to span <= 2 of its
            # 1024-row blocks, i.e. run length < 1024
            raise ValueError(
                f"fat_max_blocks={cfg.fat_max_blocks} must be < 1024"
            )
        x0, y0, x1, y1 = tile_rect(mean2d, radius, tiles_x, tiles_y, cfg.tile_size)
        on = valid & (x1 > x0) & (y1 > y0)
        sbx = -(-(x1 - x0) // span)  # blocks per axis (≥1 when on)
        sby = -(-(y1 - y0) // span)
        maxb = cfg.fat_max_blocks
        nb_full = jnp.where(on, sbx * sby, 1)
        n_blocks = jnp.minimum(nb_full, maxb)
        # primary row = block (0, 0); home = block center, clipped into
        # the image (the window stays ⊆ home±1 after the clip)
        phx = jnp.minimum(x0 + h, tiles_x - 1)
        phy = jnp.minimum(y0 + h, tiles_y - 1)
        pwin = jnp.stack(
            [x0, jnp.minimum(x0 + span, x1), y0, jnp.minimum(y0 + span, y1)],
            axis=-1,
        )

        fat_cap, live_cap = resolve_fat_caps(n, cfg)
        n_ex = n_blocks - 1  # extra blocks per splat (0 for thin/off)
        is_fat = on & (n_ex > 0)
        n_ex = jnp.where(is_fat, n_ex, 0)
        base = jnp.cumsum(n_ex) - n_ex  # copy slots [base, base+n_ex)
        n_copies = base[-1] + n_ex[-1]
        seg_base = jnp.minimum(
            jnp.concatenate([base, (base[-1] + n_ex[-1])[None]]), fat_cap
        ).astype(jnp.int32)

        # copy slot → parent splat (marks + cummax), then ONE [F, 18]
        # parent-row gather feeds the per-copy block math
        parent = fat_parents(is_fat, base, fat_cap)
        src18 = jnp.concatenate(
            [
                _i2f(base)[:, None],
                mean2d,
                p.conic,
                p.opacity[:, None],
                depth[:, None],
                p.radius[:, None],
                p.rgb,
                _i2f(jnp.stack([sbx, x0, y0, x1, y1], axis=-1)),
                _i2f(n_ex)[:, None],
            ],
            axis=-1,
        )  # [N, 18]
        with jax.named_scope("fat_repeat"):
            tail_tab, hk_tail, dep_tail, wpa_tail, wpb_tail = copy_rows(
                sg(src18)[parent], sg(n_copies), tiles_x=tiles_x,
                tiles_y=tiles_y, span=span, ts=cfg.tile_size,
                alpha_min=cfg.alpha_min,
            )
        tail_ok = hk_tail < t_sent  # dead/culled rows carry the sentinel
        on_ext = jnp.concatenate([on, tail_ok])
        home_key = jnp.concatenate(
            [jnp.where(on, phy * tiles_x + phx, t_sent), hk_tail]
        )
        dkey = depth_bits(jnp.concatenate([depth, dep_tail]))
        # per-row windows ride the big sort as two packed payload
        # operands (wx0*16384+wx1 / wy0*16384+wy1, both < 2^24 with tile
        # coords <= 1023 — guarded above)
        wpa = jnp.concatenate([pwin[:, 0] * 16384 + pwin[:, 1], wpa_tail])
        wpb = jnp.concatenate([pwin[:, 2] * 16384 + pwin[:, 3], wpb_tail])
        nt = n + fat_cap
        nh = n + live_cap
        # overflow: blocks beyond fat_max_blocks + copies beyond fat_cap
        # (live-row truncation beyond nh is added after the sort)
        n_ovf = (
            jnp.sum(jnp.where(on, nb_full - n_blocks, 0))
            + jnp.maximum(n_copies - fat_cap, 0)
        ).astype(jnp.int32)

    # full f32 depth resolution (graphdeco semantics): 3 KEYS
    # (home, depth_bits, idx — idx makes tie order ascending-index
    # deterministically) + the packed per-row windows as payloads.
    # With return_extras the SOURCE SPLAT index (self for primaries,
    # fat parent for copy slots) rides as one more payload: the lazy
    # plan's pidx then needs no separate NH-row gather.
    if return_extras and not cfg.footprint_clamp:
        src_pre = jnp.concatenate([jnp.arange(n, dtype=jnp.int32), parent])
        home_sorted, _, perm_full, wpa_s, wpb_s, src_s = jax.lax.sort(
            (home_key, dkey, jnp.arange(nt, dtype=jnp.int32), wpa, wpb,
             src_pre),
            num_keys=3,
            is_stable=False,
        )
    else:
        home_sorted, _, perm_full, wpa_s, wpb_s = jax.lax.sort(
            (home_key, dkey, jnp.arange(nt, dtype=jnp.int32), wpa, wpb),
            num_keys=3,
            is_stable=False,
        )
        src_s = perm_full
    # perm_full is a permutation (unique keys), so the inverse needs only
    # a 1-KEY sort with the iota as payload
    _, inv_ext = jax.lax.sort(
        (perm_full, jnp.arange(nt, dtype=jnp.int32)),
        num_keys=1,
        is_stable=False,
    )
    perm = perm_full[:nh]
    home_sorted = home_sorted[:nh]
    n_live = jnp.sum(on_ext.astype(jnp.int32))
    n_ovf = n_ovf + jnp.maximum(n_live - nh, 0)

    seg_starts = jnp.searchsorted(
        home_sorted,
        jnp.arange(tiles_x * tiles_y + 2, dtype=jnp.int32),
        side="left",
    ).astype(jnp.int32)

    packed_n = jnp.concatenate(
        [
            p.mean2d,
            p.depth[:, None],
            p.conic,
            p.radius[:, None],
            p.rgb,
            p.opacity[:, None],
        ],
        axis=-1,
    )  # [N, 11]
    # tail rows = parent attribute copies, emitted by the repeat kernel
    # directly in this column order (no XLA-side column shuffling of the
    # [F, ...] array), under stop_gradient: the parent GRADIENT flows
    # through home_gather's contiguous-segment sum onto packed_n, so no
    # gather transpose runs. Windows and liveness do NOT ride the
    # gather: windows arrive via the sort payloads, liveness is the
    # home-key sentinel.
    if cfg.footprint_clamp:
        tail_full = jnp.zeros((0, PCOLS + 1), packed_n.dtype)
    else:
        tail_full = sg(tail_tab)
    full_n = jnp.pad(packed_n, ((0, 0), (0, 1)))
    tail_full, full_n = jax.lax.optimization_barrier((tail_full, full_n))
    ph = home_gather(
        full_n, tail_full, perm, inv_ext[:n], inv_ext[n:], seg_base
    )
    wpa_h, wpb_h = wpa_s[:nh], wpb_s[:nh]
    win = jnp.stack(
        [wpa_h // 16384, wpa_h % 16384, wpb_h // 16384, wpb_h % 16384],
        axis=-1,
    )
    hs = jnp.minimum(home_sorted, t_sent - 1)
    p_home = ProjectedSplats(
        mean2d=ph[:, 0:2],
        depth=ph[:, 2],
        conic=ph[:, 3:6],
        radius=ph[:, 6],
        rgb=ph[:, 7:10],
        opacity=ph[:, 10],
        valid=home_sorted < t_sent,  # liveness = the home-key sentinel
    )
    layout = HomeLayout(
        perm=perm,
        seg_starts=seg_starts,
        home_x=hs % tiles_x,
        home_y=hs // tiles_x,
        win=win,
        n_valid=jnp.sum(on_ext.astype(jnp.int32)),
        n_fat_overflow=jnp.asarray(n_ovf, jnp.int32),
        n_copies=jnp.asarray(n_copies, jnp.int32),
        seg_row0=jnp.zeros((), jnp.int32),
        tiles_x=tiles_x,
        tiles_y=tiles_y,
        rows_present=tiles_y,
    )
    if not return_extras:
        return p_home, layout
    extras = {
        "inv": inv_ext[:n],
        "inv_tail": inv_ext[n:],
        "seg_base": seg_base,
        "parent_of_slot": parent,
        "src_sorted": src_s[:nh],  # source splat per home row
    }
    return p_home, layout, extras


# --------------------------------------------------------------------------
# band prefilter: band-local prologue for the tile-sharded mesh
# --------------------------------------------------------------------------


@partial(jax.custom_vjp, nondiff_argnums=())
def _band_select(packed, idx, inv):
    """packed[idx] with a gather (not scatter-add) VJP: `idx` [cap] are
    unique source rows (a compacted permutation prefix; dead slots point
    at row N = the zero pad row); `inv` [N] is each source row's output
    position (>= cap ⇒ not selected ⇒ zero grad)."""
    return packed[idx]


def _band_select_fwd(packed, idx, inv):
    return packed[idx], (packed.shape[0], inv)


def _band_select_bwd(res, d):
    n_pad, inv = res
    cap = d.shape[0]
    dpad = jnp.concatenate([d, jnp.zeros((1,) + d.shape[1:], d.dtype)])
    dx = dpad[jnp.where(inv < cap, inv, cap)]
    return (
        jnp.pad(dx, ((0, n_pad - dx.shape[0]),) + ((0, 0),) * (d.ndim - 1)),
        None,
        None,
    )


_band_select.defvjp(_band_select_fwd, _band_select_bwd)


def band_prefilter_cap(n: int, tiles_y: int, band_rows: int,
                       slack: float = 2.5) -> int:
    """Static per-device SPLAT budget for band_prefilter: the band's
    proportional share (band + 2 halo rows) times `slack` for density
    skew, rounded to the expansion grid."""
    cap = int(n * (band_rows + 2) / max(tiles_y, 1) * slack)
    cap = -(-cap // 4096) * 4096
    return min(-(-n // 4096) * 4096, max(cap, 4096))


def band_prefilter(p: ProjectedSplats, ty0, band_rows, tiles_y: int,
                   tiles_x: int, cap_n: int, cfg: RenderConfig,
                   return_idx: bool = False):
    """Select the splats whose footprint rect can reach the tile-row band
    [ty0 − 1, ty0 + band_rows + 1) and compact them to a static [cap_n]
    prefix — BEFORE build_home_layout, so the whole prologue (fat-splat
    enumeration, the (home, depth) sort, the relayout gather) runs on
    the band share instead of the full scene. With slice_band_rows this
    makes every stage of the tile-sharded step scale ~1/D instead of
    replicating the full-scene prologue on every device.

    Returns (p_band [cap_n], n_dropped). Splats beyond cap_n are dropped
    far-index-first and COUNTED; gradients flow back through a gather
    VJP (inverse positions), never a scatter-add. `band_rows` may be
    TRACED (the equal-content row-cut split gives each device a
    different live row count under one static program)."""
    n = p.depth.shape[0]
    sg = jax.lax.stop_gradient
    ty0 = jnp.asarray(ty0, jnp.int32)
    _, y0, _, y1 = tile_rect(
        sg(p.mean2d), sg(p.radius), tiles_x, tiles_y, cfg.tile_size
    )
    relevant = p.valid & (y1 > ty0 - 1) & (y0 < ty0 + band_rows + 1)
    # unique keys: relevant splats keep their index, the rest shift by N
    # — so the 1-key sorted values ARE the compacted order, and the
    # inverse permutation needs only a second 1-key sort
    iota = jnp.arange(n, dtype=jnp.int32)
    key = jnp.where(relevant, iota, n + iota)
    order_full = jax.lax.sort(key, is_stable=False)
    _, inv_full = jax.lax.sort(
        (jnp.where(order_full < n, order_full, order_full - n), iota),
        num_keys=1,
        is_stable=False,
    )
    order = order_full[:cap_n]
    live = order < n
    idx = jnp.where(live, order, n)  # row n = zero pad row
    # a non-relevant splat can land at an output position < cap_n when
    # the band underfills the cap — its forward row is the zero pad, so
    # its cotangent must NOT route back (mask to the dropped sentinel)
    inv_full = jnp.where(relevant, inv_full, cap_n)
    n_rel = jnp.sum(relevant.astype(jnp.int32))
    n_dropped = jnp.maximum(n_rel - cap_n, 0)

    packed = jnp.concatenate(
        [
            p.mean2d,
            p.depth[:, None],
            p.conic,
            p.radius[:, None],
            p.rgb,
            p.opacity[:, None],
        ],
        axis=-1,
    )  # [N, 11]
    packed = jnp.pad(packed, ((0, 1), (0, 0)))
    pb = _band_select(packed, idx, inv_full)
    p_band = ProjectedSplats(
        mean2d=pb[:, 0:2],
        depth=pb[:, 2],
        conic=pb[:, 3:6],
        radius=jnp.where(live, pb[:, 6], 0.0),
        rgb=pb[:, 7:10],
        opacity=pb[:, 10],
        valid=live,
    )
    if return_idx:
        # idx [cap_n]: each compacted row's GLOBAL splat row (n = the
        # zero pad) — the lazy band plan maps home rows to global
        # parameter rows through it (render/lazy.py)
        return p_band, n_dropped, idx
    return p_band, n_dropped


def band_slice_cap(nh: int, tiles_y: int, band_rows: int,
                   slack: float = 2.0) -> int:
    """Static per-device home-row budget for slice_band_rows: the band's
    proportional share (band+2 halo rows of tiles_y) times `slack` for
    density skew, rounded up to the expansion-kernel block."""
    cap = int(nh * (band_rows + 2) / max(tiles_y, 1) * slack)
    cap = -(-cap // 4096) * 4096
    return min(-(-nh // 4096) * 4096, max(cap, 4096))


def slice_band_rows(p: ProjectedSplats, layout: HomeLayout, ty0,
                    band_rows: int, cap: int, rows_live=None,
                    extra_rows=()):
    """Restrict the home layout to the tile-row band [ty0, ty0+band_rows)
    plus its one-row halo — the rows that can emit pairs into the band.
    They are CONTIGUOUS in the (home, depth) order, so this is one
    dynamic_slice per array: everything downstream (pair expansion, the
    (tile, depth) sort, both blend kernels and their gradients) then
    scales with the band share instead of the full scene — the
    structural 1/D of the tile-sharded mesh. Gradients flow back through the slice's
    dynamic_update_slice transpose (zero-pad), so sharded grads still
    equal the replicated ones.

    `cap` is the static row budget (see band_slice_cap); rows beyond it
    are dropped far-end-first and counted in the returned n_dropped.
    Rows outside the band that ride along (halo slack, clamp shift) are
    masked by binning's band check and contribute nothing.

    `rows_live` (traced, default band_rows): the device's OWNED row
    count under an equal-content row-cut split — only rows
    [ty0 − 1, ty0 + rows_live + 1) are kept, so the kept content tracks
    the owned share while shapes stay band_rows-static."""
    tiles_x, tiles_y = layout.tiles_x, layout.tiles_y
    nh = layout.perm.shape[0]
    cap = min(cap, nh)
    ty0 = jnp.asarray(ty0, jnp.int32)
    if rows_live is None:
        rows_live = band_rows
    r0 = jnp.clip(ty0 - 1, 0, tiles_y)
    r1 = jnp.clip(ty0 + jnp.asarray(rows_live, jnp.int32) + 1, 0, tiles_y)
    start = layout.seg_starts[r0 * tiles_x]
    end = layout.seg_starts[r1 * tiles_x]
    start_c = jnp.minimum(start, jnp.maximum(nh - cap, 0))
    n_dropped = jnp.maximum(end - start_c - cap, 0)

    rows_present = band_rows + 2
    # Band-local segment table by INDEX-CLAMPED gather, clamped at
    # tiles_x*tiles_y — the LIVE-row boundary (seg_starts[T] = end of
    # real-tile rows; entries beyond delimit the dead/sentinel
    # segment). Two hazards this kills: (1) a dynamic_slice with a
    # short pad clamps the start by a non-multiple of tiles_x for the
    # last device of an uneven tiles_y % D split (silent misalignment —
    # tests/test_parallel.py::test_sharded_stream_uneven_band_split);
    # (2) when the band's halo extends past the last image row, local
    # segment indices map into the DEAD segment and the repack's
    # linear-range arithmetic counts every dead row as one tile's
    # candidates (a phantom tile of every dead row's candidates, which
    # overflows the repack grid).
    idx = jnp.clip(
        r0 * tiles_x
        + jnp.arange(rows_present * tiles_x + 1, dtype=jnp.int32),
        0,
        tiles_x * tiles_y,
    )
    seg_local = jnp.clip(layout.seg_starts[idx] - start_c, 0, cap)

    sl = lambda a: jax.lax.dynamic_slice_in_dim(a, start_c, cap, axis=0)
    p2 = ProjectedSplats(
        mean2d=sl(p.mean2d),
        depth=sl(p.depth),
        conic=sl(p.conic),
        radius=sl(p.radius),
        rgb=sl(p.rgb),
        opacity=sl(p.opacity),
        valid=sl(p.valid),
    )
    layout2 = HomeLayout(
        perm=sl(layout.perm),
        seg_starts=seg_local,
        home_x=sl(layout.home_x),
        home_y=sl(layout.home_y),
        win=sl(layout.win),
        n_valid=layout.n_valid,
        n_fat_overflow=layout.n_fat_overflow,
        n_copies=layout.n_copies,
        seg_row0=r0,
        tiles_x=tiles_x,
        tiles_y=tiles_y,
        rows_present=rows_present,
    )
    if extra_rows:
        # per-home-row side arrays (e.g. the lazy plan's source index)
        # sliced by the SAME window, plus start_c so callers can rebase
        # inverse positions
        return p2, layout2, n_dropped, [sl(a) for a in extra_rows], start_c
    return p2, layout2, n_dropped
