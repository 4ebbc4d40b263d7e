"""Bucket-repack pair sort: balanced 2-D row sorts replace the global
(tile, depth) lax.sort.

The plain pair sort is one 1-D 3-operand `lax.sort` over the whole
class-major candidate stream, whose cost grows superlinearly with its
length. This module instead cuts the stream into balanced rows of
`cfg.repack_w` lanes — each row a
contiguous RANGE OF TILES' candidate runs — sorts rows independently,
and compacts the per-row live prefixes into one gapless stream.

Why rows of whole tiles decompose the sort exactly:
  * home rows are (home_tile, depth)-sorted, so the class-c candidates
    of tile τ are ONE contiguous slice of the home layout: the segment
    with band-local linear index s = τ + Kc, Kc = (off0 − dy)·tiles_x −
    dx (off0 = ty0 − seg_row0). For consecutive tiles the slices are
    consecutive, so a row covering tiles [τa, τb] needs only NINE
    contiguous source ranges — gathered at 128-lane block granularity
    instead of per element.
  * a VALID candidate in segment s, class c always stores tile id
    s − Kc in the expansion output (linear identity, wraps go INVALID),
    so masking gathered keys to [τa, τb] exactly partitions candidates
    across rows: block-rounding slack and image-edge wrap junk are
    masked to INVALID and sort to the row's end.
  * all pairs of one tile land in one row, so the per-row 3-key
    (tile, depth_bits, pid) sort reproduces the global 3-key sort's
    per-tile sequences BIT-IDENTICALLY (same pid tie rule).

The compacted stream pads each row's live prefix to a 128 multiple with
provably-dead pairs (pid = n_rows·k_slots: a home row past the table,
which the blend reads as zero opacity), so rows stay block-aligned; the
remaining tail is INVALID. Every capacity loss (row width, output cap)
is counted in n_repack_overflow — never silent.

This replaces the reference's single native component — the O(N) WASM
counting sort (/root/reference/wasm/wasm.cpp:33-51) — with the
on-device equivalent SURVEY §2.2 calls for: the counting-sort structure
generalized to (tile, depth) keys as balanced on-device partition +
batched sort, fused into the jitted step.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

INVALID_TILE_I = 0x7FFFFFFF  # matches binning.INVALID_TILE
_G = 128  # gather/compaction block granularity (lanes)


def _ceil(a, b):
    return -(-a // b)


def resolve_repack_dims(nh_pad: int, k_slots: int, cfg):
    """Static (W, Q, R): row width, assumed average fill, row count.

    Rows are packed GREEDILY to capacity (each row takes whole tiles
    while its candidate total fits W minus the 9 × 2·(G−1)
    block-rounding slack), so Q is not a hard per-row bound — it is the
    fill assumption that sizes the static row count: R·W is the sort
    volume actually paid, so R tracks the candidate budget
    (cfg.repack_cap, default the k_slots·nh_pad worst case) at Q fill.
    A scene whose greedy packing fills rows worse than Q overflows the
    grid far-tiles-first — counted, gated in bench."""
    w = cfg.repack_w
    q = cfg.repack_q or (w * 13) // 16
    if cfg.repack_rows is not None:
        return w, q, cfg.repack_rows
    cap = k_slots * nh_pad
    if cfg.repack_cap is not None:
        cap = min(cap, cfg.repack_cap)
    r = _ceil(cap, q) + 1
    return w, q, r


def repack_pair_sort(
    tile2d,
    dbits_pad,
    seg,
    ty0,
    seg_row0,
    off0,
    tiles_x: int,
    band_rows: int,
    rows_present: int,
    nh_pad: int,
    k_slots: int,
    span: int,
    cap_out: int,
    cfg,
):
    """tile2d [K, nh_pad] i32 class-major candidate tiles (INVALID for
    culled/dead), dbits_pad [nh_pad] i32 depth bits, seg [≥ nseg+1] i32
    band-local segment starts. Returns (pid_sorted [cap_out] i32,
    tile_sorted [cap_out] i32, n_overflow) — the live (tile, depth,
    pid)-sorted pair stream, 128-padded per row with dead pids, INVALID
    tail."""
    h = span // 2
    T = tiles_x * band_rows
    nseg = rows_present * tiles_x
    W, Q, R = resolve_repack_dims(nh_pad, k_slots, cfg)
    WB = W // _G
    NB = nh_pad // _G  # blocks per class stream
    pid_dead = jnp.int32(nh_pad * k_slots)
    inval = jnp.int32(INVALID_TILE_I)
    off0 = jnp.asarray(off0, jnp.int32)

    # Kc per class: source segment linear index = τ + Kc
    kcs = []
    for c in range(k_slots):
        dy, dx = c // span - h, c % span - h
        kcs.append((off0 - dy) * tiles_x - dx)

    # per-tile candidate counts (linear-range semantics: includes
    # maskable wrap junk so row contents match the gather ranges)
    tau = jnp.arange(T, dtype=jnp.int32)
    cand = jnp.zeros((T,), jnp.int32)
    for c in range(k_slots):
        s = tau + kcs[c]
        s0 = jnp.clip(s, 0, nseg)
        s1 = jnp.clip(s + 1, 0, nseg)
        cand = cand + (seg[s1] - seg[s0])
    cum = jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(cand)])

    # row boundaries: GREEDY packing — each row takes whole tiles while
    # its candidate total fits the row minus the block-rounding slack.
    # A fixed Q-stride grid overflows wherever a dense tile lands on a
    # filled row; greedy exclusion of the straddling tile caps every
    # row's content at w_eff by construction (a single tile > w_eff
    # still overflows — counted below). Sequential scan of R scalar
    # searchsorteds.
    w_eff = W - k_slots * 2 * (_G - 1) - _G

    def _bound(b, _):
        nb = (
            jnp.searchsorted(cum, cum[b] + w_eff, side="right").astype(
                jnp.int32
            )
            - 1
        )
        nb = jnp.minimum(jnp.maximum(nb, b + 1), jnp.int32(T))
        return nb, nb

    _, taus = jax.lax.scan(_bound, jnp.int32(0), None, length=R)
    taua = jnp.concatenate([jnp.zeros((1,), jnp.int32), taus])  # [R+1]

    # per (row, class) source block ranges
    b0s, nbs = [], []
    for c in range(k_slots):
        sa = seg[jnp.clip(taua[:R] + kcs[c], 0, nseg)]
        se = seg[jnp.clip(taua[1:] + kcs[c], 0, nseg)]
        b0 = sa // _G
        nb = jnp.where(se > sa, _ceil_j(se, _G) - b0, 0)
        b0s.append(b0)
        nbs.append(nb)
    nb_arr = jnp.stack(nbs, axis=1)  # [R, K]
    nbcum = jnp.concatenate(
        [jnp.zeros((R, 1), jnp.int32), jnp.cumsum(nb_arr, axis=1)], axis=1
    )  # [R, K+1] exclusive
    nbtot = nbcum[:, k_slots]
    n_over = jnp.sum(jnp.maximum(nbtot - WB, 0)) * _G
    # grid exhaustion: tiles past the last row boundary are never
    # gathered — count their full candidate mass (greedy packing fills
    # rows to w_eff, so this fires only when R (cfg.repack_cap / Q) is
    # undersized for the scene)
    n_over = n_over + (cum[T] - cum[taua[R]])

    # destination block j of row r → source block (class select chain)
    j = jnp.arange(WB, dtype=jnp.int32)[None, :]  # [1, WB]
    srcblk = jnp.zeros((R, WB), jnp.int32)
    for c in range(k_slots):
        inc = (j >= nbcum[:, c : c + 1]) & (j < nbcum[:, c + 1 : c + 2])
        srcblk = jnp.where(
            inc, b0s[c][:, None] + (j - nbcum[:, c : c + 1]) + c * NB, srcblk
        )
    used = j < jnp.minimum(nbtot, WB)[:, None]
    srcblk = jnp.where(used, srcblk, 0)

    # 128-lane block gathers + in-place payload reconstruction; the
    # source is assembled by concatenating per-class [NB, G] reshapes
    flat = jnp.concatenate(
        [tile2d[c].reshape(-1, _G) for c in range(k_slots)], axis=0
    )
    keys = flat[srcblk].reshape(R, W)
    depth = dbits_pad.reshape(-1, _G)[srcblk % NB].reshape(R, W)
    lane = jnp.arange(_G, dtype=jnp.int32)[None, None, :]
    srcpos = srcblk[:, :, None] * _G + lane  # [R, WB, G]
    c_of = srcpos // nh_pad
    pid = ((srcpos - c_of * nh_pad) * k_slots + c_of).reshape(R, W)

    # mask to the row's tile range: everything else (rounding slack,
    # wrap junk, unused blocks) becomes INVALID and sorts to the row end
    ublane = jnp.repeat(used, _G, axis=1)
    keep = (
        ublane
        & (keys >= taua[:R, None])
        & (keys <= taua[1:, None] - 1)
    )
    keys = jnp.where(keep, keys, inval)

    keys, _, pid = jax.lax.sort(
        (keys, depth, pid), num_keys=3, is_stable=False, dimension=1
    )

    # compact live prefixes (128-padded with dead pairs) into [cap_out]
    live = jnp.sum((keys != inval).astype(jnp.int32), axis=1)  # [R]
    livep = _ceil_j(live, _G) * _G
    dstblk = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(livep // _G)]
    )  # [R+1] exclusive dst block offsets
    M = cap_out // _G
    n_over = n_over + jnp.maximum(dstblk[R] * _G - cap_out, 0)
    marks = (
        jnp.zeros((M + 1,), jnp.int32)
        .at[jnp.clip(dstblk[:R], 0, M)]
        .add(1, mode="drop")
    )
    r_of = jnp.clip(jnp.cumsum(marks[:M]) - 1, 0, R - 1)  # [M]
    src2 = r_of * WB + (jnp.arange(M, dtype=jnp.int32) - dstblk[r_of])
    src2 = jnp.clip(src2, 0, R * WB - 1)
    tile_c = keys.reshape(-1, _G)[src2].reshape(-1)  # [cap_out]
    pid_c = pid.reshape(-1, _G)[src2].reshape(-1)

    pos_in_row = jnp.arange(cap_out, dtype=jnp.int32) - jnp.repeat(
        dstblk[r_of] * _G, _G
    )
    live_l = jnp.repeat(live[r_of], _G)
    livep_l = jnp.repeat(livep[r_of], _G)
    in_any = jnp.arange(cap_out, dtype=jnp.int32) < dstblk[R] * _G
    keep2 = in_any & (pos_in_row < live_l)
    pad2 = in_any & (pos_in_row < livep_l)
    # pad tile = the row's LAST LIVE tile: it is >= every live tile in
    # the row and < the next row's first live tile, so the stream stays
    # globally sorted; pad pid (nh_pad·K) decodes to a home row past
    # every real one, which the blend reads as zero opacity
    # (pallas_stream.pair_attrs)
    last_live = jnp.take_along_axis(
        keys, jnp.maximum(live - 1, 0)[:, None], axis=1
    )[:, 0]  # [R]; garbage (INVALID) only when live == 0 ⇒ no pads
    taupad = jnp.repeat(jnp.maximum(last_live[r_of], 0), _G)
    tile_out = jnp.where(keep2, tile_c, jnp.where(pad2, taupad, inval))
    pid_out = jnp.where(keep2, pid_c, pid_dead)
    return pid_out, tile_out, n_over


def _ceil_j(a, b):
    return -(-a // b)
