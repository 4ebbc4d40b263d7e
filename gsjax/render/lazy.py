"""Lazy frame plans: cross-frame layout reuse + home-resident training
state (render/DESIGN.md).

The per-frame-exact stream pipeline rebuilds, from scratch every step, a
data layout that barely changes between training steps: the (home tile,
depth) sort, the fat-splat enumeration, the pair expansion + repack
sort — and, in the backward, three inverse row gathers returning
gradients to splat order. The reference does not pay this tax:
its depth sort is asynchronous and frames draw with a STALE permutation
while only the attributes are fresh
(/root/reference/src/renderers/webgl/utils/Worker.ts:45-57 — the
worker throttles to one sort at a time; WebGLRenderer.ts:269 posts the
fresh camera and draws with the last completed index buffer).

This module makes that trade explicit and bounded:

  * `build_frame_plan` runs the full prologue ONCE (a "resort") and
    captures every order-dependent artifact as a static FramePlan: the
    home permutation's inverse structure and the sorted pair stream.
  * Between resorts, parameters AND optimizer state live in HOME ORDER
    (`extract_home`): a lazy step is just project(home rows) → fresh
    attribute table → blend kernels → adam on home rows. No sort, no
    gathers — forward or backward (rung 2: gradients arrive in home
    order and are consumed there).
  * Fat-splat copy rows carry their own parameter copies and train
    independently between resorts; at resort cadence `fold_back`
    reduces each row's parameter/moment DELTA onto its source splat
    (the same block-bounded segment reduction as home_gather's VJP) —
    averaged over a splat's live rows by default, which keeps the
    Adam step magnitude of a many-copy splat at one step's scale
    (summing the per-copy Adam deltas would amplify it by the copy
    count). Exactness: a scene with no fat splats under a
    gradient-linear optimizer folds back EXACTLY; in general the drift
    vs the per-frame-exact path is bounded by K steps of per-row update
    divergence and is measured at the bench (tools/probe_lazy_drift.py).

What is stale between resorts (≙ the reference's stale permutation):
pair membership and order, per-row windows/culls, tile segment
boundaries. What is fresh every step: every rendered ATTRIBUTE
(projection of the current parameters under the current camera) — a
splat that moved slightly renders at its fresh position inside its
stale pair set; a splat culled by the fresh projection is masked to
zero opacity.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from gsjax.core.camera import Camera
from gsjax.core.config import RenderConfig
from gsjax.render.binning import build_tile_bins
from gsjax.render.composite import assemble_band, clipped_pair_stream
from gsjax.render.homesort import (
    build_home_layout,
    reduce_copy_segments,
    reduce_home_rows,
)
from gsjax.render.pallas_stream import blend_stream
from gsjax.render.pipeline import _project_any


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "pidx",
        "inv",
        "inv_tail",
        "seg_base",
        "pid",
        "starts",
        "ty0",
        "ovf",
    ],
    meta_fields=["tiles_x", "band_rows", "n"],
)
@dataclasses.dataclass(frozen=True)
class FramePlan:
    """Everything order-dependent about one frame, captured at resort.

    pidx [NH] i32: the SOURCE SPLAT of each home row (primary rows map
    through the permutation, copy rows to their fat parent; dead rows
    to N = an inert zero pad). inv [N] / inv_tail [F] / seg_base [N+1]:
    the inverse structure fold_back reduces deltas through (same
    machinery as home_gather's VJP). pid / starts / ty0: the sorted pair
    stream the blend kernels walk (pallas_stream). ovf: the overflow
    counters measured at plan
    build — the plan's streams are static, so these are the step's
    counters too."""

    pidx: jax.Array
    inv: jax.Array
    inv_tail: jax.Array
    seg_base: jax.Array
    pid: jax.Array
    starts: jax.Array
    ty0: jax.Array
    ovf: dict
    tiles_x: int
    band_rows: int
    n: int

    @property
    def nh(self) -> int:
        return self.pidx.shape[0]


@partial(jax.jit, static_argnums=(2,))
def _build_plan_jit(g, cam: Camera, cfg: RenderConfig):
    p = _project_any(g, cam, cfg)
    p, layout, extras = build_home_layout(p, cam, cfg, return_extras=True)
    bins = build_tile_bins(p, cam, cfg, anchor="home", layout=layout)
    pid, starts, n_dropped = clipped_pair_stream(bins, cfg)
    n = extras["inv"].shape[0]
    # dead rows (sentinel segment / culled copies) point at the inert pad
    # row N: their extracted params render nothing and receive no grads,
    # so their fold-back delta is exactly zero. The source index rode
    # the (home, depth) sort as a payload — no NH-row gather here.
    pidx = jnp.where(p.valid, extras["src_sorted"], n)
    ovf = {
        "n_pair_overflow": jnp.asarray(
            n_dropped + bins.n_repack_overflow, jnp.int32
        ),
        "n_band_overflow": jnp.zeros((), jnp.int32),
        "n_fat_overflow": jnp.asarray(layout.n_fat_overflow, jnp.int32),
        "n_tile_overflow": jnp.zeros((), jnp.int32),
        "n_pairs": jnp.asarray(bins.n_pairs, jnp.int32),
    }
    return FramePlan(
        pidx=pidx,
        inv=extras["inv"],
        inv_tail=extras["inv_tail"],
        seg_base=extras["seg_base"],
        pid=pid,
        starts=starts,
        ty0=bins.ty0,
        ovf=ovf,
        tiles_x=bins.tiles_x,
        band_rows=bins.band_rows,
        n=n,
    )


@partial(jax.jit, static_argnums=(2, 4))
def _build_band_plan_jit(g, cam: Camera, cfg: RenderConfig, ty0,
                         band_rows: int, rows_live):
    """Band-restricted frame plan: the tile-sharded prologue
    (band_prefilter → home layout → slice_band_rows → band bins/streams,
    the same chain as parallel.render_sharded._render_band) captured as
    a static plan. pidx maps the band's home rows to GLOBAL splat rows
    (prefilter idx ∘ source index), so extract_home/lazy_render/
    make_lazy_step work unchanged; inv/inv_tail are PREFILTER-space and
    band-rebased — fold_back across bands is future work (a use would
    fail loudly on the shape mismatch)."""
    from gsjax.render.homesort import (
        band_prefilter,
        band_prefilter_cap,
        band_slice_cap,
        slice_band_rows,
    )

    tiles_y = cfg.tiles_y(cam.height)
    tiles_x = cfg.tiles_x(cam.width)
    p = _project_any(g, cam, cfg)
    n = p.depth.shape[0]
    cap_n = cfg.shard_prefilter_cap or band_prefilter_cap(
        n, tiles_y, band_rows, cfg.band_prefilter_slack
    )
    cap_n = min(cap_n, -(-n // 4096) * 4096)
    p, n_pref, gidx = band_prefilter(
        p, ty0, rows_live, tiles_y, tiles_x, cap_n, cfg, return_idx=True
    )
    p, layout, extras = build_home_layout(p, cam, cfg, return_extras=True)
    cap = cfg.shard_slice_cap or band_slice_cap(
        layout.perm.shape[0], tiles_y, band_rows, cfg.band_slice_slack
    )
    p, layout, n_sliced, (src_b,), start_c = slice_band_rows(
        p, layout, ty0, band_rows, cap, rows_live,
        extra_rows=(extras["src_sorted"],),
    )
    bins = build_tile_bins(
        p, cam, cfg, ty0=ty0, band_rows=band_rows, anchor="home",
        layout=layout, rows_live=rows_live,
    )
    pid, starts, n_dropped = clipped_pair_stream(bins, cfg)
    # home row → global splat row: prefilter idx (cap_n → global, pad n)
    # composed with the band source index (home → prefiltered row)
    gpad = jnp.concatenate([gidx, jnp.full((1,), n, jnp.int32)])
    gsrc = gpad[jnp.clip(src_b, 0, cap_n)]
    pidx = jnp.where(p.valid, gsrc, n)
    cap_h = p.depth.shape[0]
    inv_b = jnp.where(
        (extras["inv"] >= start_c) & (extras["inv"] < start_c + cap_h),
        extras["inv"] - start_c, cap_h,
    )
    invt_b = jnp.where(
        (extras["inv_tail"] >= start_c)
        & (extras["inv_tail"] < start_c + cap_h),
        extras["inv_tail"] - start_c, cap_h,
    )
    ovf = {
        "n_pair_overflow": jnp.asarray(
            n_dropped + bins.n_repack_overflow, jnp.int32
        ),
        "n_band_overflow": jnp.asarray(
            n_pref + n_sliced, jnp.int32
        ),
        "n_fat_overflow": jnp.asarray(layout.n_fat_overflow, jnp.int32),
        "n_tile_overflow": jnp.zeros((), jnp.int32),
        "n_pairs": jnp.asarray(bins.n_pairs, jnp.int32),
    }
    return FramePlan(
        pidx=pidx,
        inv=inv_b,
        inv_tail=invt_b,
        seg_base=extras["seg_base"],
        pid=pid,
        starts=starts,
        ty0=bins.ty0,
        ovf=ovf,
        tiles_x=tiles_x,
        band_rows=band_rows,
        n=n,
    )


def build_band_plan(g, cam: Camera, cfg: RenderConfig, ty0,
                    band_rows: int, rows_live=None) -> FramePlan:
    """One band resort for the tile-sharded lazy path: each device of a
    mesh rebuilds its own band plan at resort cadence and runs lazy
    steps on its band's home rows only — the per-device step is then
    project(band share) + band kernels, which is exactly the fixed
    prologue the equal-content scaling analysis blamed for the 48%
    efficiency ceiling (DESIGN.md r4)."""
    if cfg.tile_span != 3 or cfg.footprint_clamp:
        raise ValueError("band plans require the exact stream path")
    if rows_live is None:
        rows_live = band_rows
    return _build_band_plan_jit(
        g, cam, cfg, jnp.asarray(ty0, jnp.int32), band_rows,
        jnp.asarray(rows_live, jnp.int32),
    )


def build_frame_plan(g, cam: Camera, cfg: RenderConfig) -> FramePlan:
    """One resort: run the full prologue (project → home layout → pair
    expansion → repack sort) at the
    CURRENT params/camera and freeze the result. `cam` is traced — one
    compile covers every view of an orbit. The stream backend's
    exact-footprint path is required (cfg.backend is not consulted;
    the plan is only consumed by the stream kernels)."""
    if cfg.tile_span != 3:
        raise ValueError("frame plans require tile_span == 3 (stream backend)")
    if cfg.footprint_clamp:
        raise ValueError("frame plans require exact footprints "
                         "(footprint_clamp=False)")
    return _build_plan_jit(g, cam, cfg)


# --------------------------------------------------------------------------
# home-resident state
# --------------------------------------------------------------------------


def _is_per_splat(x, n: int):
    return hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] == n


def _packable(x, n: int):
    return _is_per_splat(x, n) and x.dtype == jnp.float32


#: column-group bound for the packed extract/fold passes: one giant
#: [NH, C_all] pack needs ~4 GB per temporary at garden scale (5M
#: splats, sh2: C_all = 116); at these widths a row gather's cost
#: follows its bytes, so ≤_GROUP_COLS-column groups cost the same and
#: bound peak memory.
_GROUP_COLS = 64


def _leaf_mats(tree, n):
    """(leaves, treedef, li, shapes, mats, col_ranges): the per-splat f32
    leaves as [n, w] matrices plus their column ranges in the packed
    layout."""
    leaves, treedef = jax.tree.flatten(tree)
    li = [i for i, l in enumerate(leaves) if _packable(l, n)]
    mats = [leaves[i].reshape(n, -1) for i in li]
    shapes = [leaves[i].shape[1:] for i in li]
    cols = []
    o = 0
    for m in mats:
        cols.append((o, o + m.shape[1]))
        o += m.shape[1]
    return leaves, treedef, li, shapes, mats, cols


def _leaf_groups(widths, max_cols=_GROUP_COLS):
    """[(leaf_lo, leaf_hi, col_lo, col_hi)] — consecutive leaves grouped
    to ≤ max_cols packed columns each (group temps stay bounded at
    garden scale; see _GROUP_COLS)."""
    out = []
    l0 = 0
    c0 = 0
    w = 0
    for j, lw in enumerate(widths):
        if w and w + lw > max_cols:
            out.append((l0, j, c0, c0 + w))
            l0, c0 = j, c0 + w
            w = 0
        w += lw
    if w:
        out.append((l0, len(widths), c0, c0 + w))
    return out


def _leaf_info(tree, n):
    """Like _leaf_mats but WITHOUT reshaping (host-side reshapes
    dispatch device copies): (leaves, treedef, li, widths)."""
    leaves, treedef = jax.tree.flatten(tree)
    li = [i for i, l in enumerate(leaves) if _packable(l, n)]
    widths = []
    for i in li:
        w = 1
        for s in leaves[i].shape[1:]:
            w *= s
        widths.append(w)
    return leaves, treedef, li, widths


def extract_home(tree, plan: FramePlan, return_packed: bool = False):
    """Re-index every per-splat leaf ([N, ...]) of `tree` into home order
    ([NH, ...]) through plan.pidx; other leaves (optimizer step counts)
    pass through. Copies of a fat parent start as identical rows. Leaves
    ride packed row gathers in ≤_GROUP_COLS-column groups (one gather's
    cost is ∝ bytes at these widths, so grouping is free; a single
    all-columns pack OOM'd at garden scale) — paid at resort cadence
    only. `tree` may be any pytree (params, optimizer state, or a tuple
    of both). With return_packed, also returns the packed [NH, C]
    matrix — the resort-time snapshot fold_back diffs against."""
    idx = plan.pidx  # [NH]; value N = the inert zero pad row
    leaves, treedef, li, shapes, mats, _cols = _leaf_mats(tree, plan.n)
    if not mats:
        return (tree, None) if return_packed else tree
    out = list(leaves)
    parts = []
    for l0, l1, c0, c1 in _leaf_groups([m.shape[1] for m in mats]):
        src = (
            mats[l0] if l1 == l0 + 1
            else jnp.concatenate(mats[l0:l1], axis=1)
        )
        pp = jnp.concatenate([src, jnp.zeros_like(src[:1])])
        home_g = pp[idx]
        if return_packed:
            parts.append(home_g)
        o = 0
        for j in range(l0, l1):
            w = mats[j].shape[1]
            out[li[j]] = home_g[:, o : o + w].reshape(
                (plan.nh,) + tuple(shapes[j])
            )
            o += w
    res = jax.tree.unflatten(treedef, out)
    if return_packed:
        return res, jnp.concatenate(parts, axis=1) if len(parts) > 1 else parts[0]
    return res


def fold_back(master, hp, hp0, plan: FramePlan, reduce: str = "mean",
              copy_cols=None):
    """Fold K steps of home-space training back into splat order:
    master + reduce_rows(hp − hp0). Primary rows map bijectively through
    the inverse permutation; copy rows segment-reduce onto their fat
    parent (the same machinery as home_gather's VJP, now paid once per
    resort instead of every step). All leaves (e.g. params + both Adam
    moments as a tuple tree) ride ONE packed pair of row gathers, with
    the live-row count as an extra column.

    reduce="mean" divides each splat's summed delta by its live row
    count: per-row Adam steps are lr-scale regardless of how the
    gradient mass splits across a splat's copies, so SUMMING deltas
    would scale a many-copy splat's effective step by its copy count —
    the mean keeps it at one step's scale (and is exact for thin
    splats, where the row count is 1). reduce="sum" is exact for
    gradient-linear optimizers (plain SGD).

    `copy_cols`: a pytree of bools matching `master` (or None = all
    True): leaves marked False skip the copy-segment reduction and fold
    the PRIMARY row's delta only. The trainer marks the Adam moments
    False — they are per-row statistics whose primary value is
    representative, and the segment cumsum is the fold's widest cost
    (the reduction's column count drops 43 → 15 at bench scale)."""
    if reduce not in ("mean", "sum"):
        raise ValueError(f"unknown reduce {reduce!r}")
    n = plan.n
    f = plan.inv_tail.shape[0]
    nh = plan.nh
    m_leaves, m_def, m_li, m_shapes, m_mats, _ = _leaf_mats(master, n)
    h_leaves, _, h_li, _, h_mats, _ = _leaf_mats(hp, plan.nh)
    # non-packed leaves (scalars like the Adam step count): take the
    # stepped home-space value
    out = list(m_leaves)
    for i in range(len(m_leaves)):
        if i not in m_li:
            out[i] = h_leaves[i]
    if not m_mats:
        return jax.tree.unflatten(m_def, out)
    # per-column copy-reduction mask from the per-leaf tree; the True
    # columns must form a contiguous PREFIX of the packed layout (they
    # do for the trainer's (params, opt_state) tuple — params flatten
    # first) so the tail reduction is a plain slice, not a lane gather
    widths = [m.shape[1] for m in m_mats]
    C = sum(widths)
    if copy_cols is None:
        k_copy = C
    else:
        cc_leaves = jax.tree.flatten(copy_cols)[0]
        cmask = []
        for j, i in enumerate(m_li):
            cmask += [bool(cc_leaves[i])] * widths[j]
        k_copy = sum(cmask)
        if any(cmask[k_copy:]) or not all(cmask[:k_copy]):
            raise ValueError(
                "copy_cols=True leaves must pack as a contiguous prefix "
                "(put the parameter tree first in the master tuple)"
            )

    cnt = None  # computed with the first group, shared by the rest
    m_leaves_p = [m_leaves[i] for i in m_li]
    h_leaves_p = [h_leaves[i] for i in m_li]
    for l0, l1, c0, c1 in _leaf_groups(widths):
        h0_g = None
        if isinstance(hp0, jax.Array):
            h0_g = hp0[:, c0:c1]  # the packed resort snapshot
        elif hp0 is not None:
            _, _, _, _, h0_mats, _ = _leaf_mats(hp0, plan.nh)
            h0_g = (
                h0_mats[l0] if l1 == l0 + 1
                else jnp.concatenate(h0_mats[l0:l1], axis=1)
            )
        kc_g = min(max(k_copy - c0, 0), c1 - c0)
        folded, cnt = _fold_group_body(
            tuple(m_leaves_p[l0:l1]), tuple(h_leaves_p[l0:l1]), h0_g,
            cnt, kc_g, reduce, plan,
        )
        for j in range(l0, l1):
            out[m_li[j]] = folded[j - l0]
    return jax.tree.unflatten(m_def, out)


def _fold_group_body(m_leaves_g, h_leaves_g, h0_g, cnt, kc_g: int,
                     reduce: str, plan: FramePlan):
    """One column group's fold: (master [N, ...] leaves, home [NH, ...]
    leaves, optional snapshot slice, optional shared live-count) →
    (folded leaves, cnt). Leaves are reshaped/concatenated INSIDE (a
    host-side reshape dispatches a real device copy of every leaf —
    measured +5 GiB before any group ran at garden scale). h0_g=None
    re-derives the resort-time home state from the master
    (snapshot-free memory mode)."""
    n, f, nh = plan.n, plan.inv_tail.shape[0], plan.nh
    m_mats_g = [l.reshape(n, -1) for l in m_leaves_g]
    m_g = (
        m_mats_g[0] if len(m_mats_g) == 1
        else jnp.concatenate(m_mats_g, axis=1)
    )
    h_mats_g = [l.reshape(nh, -1) for l in h_leaves_g]
    h_g = (
        h_mats_g[0] if len(h_mats_g) == 1
        else jnp.concatenate(h_mats_g, axis=1)
    )
    # only LIVE rows carry state (dead rows hold the inert pad and
    # receive no grads, but mask anyway so arbitrary deltas — and any
    # numerical junk parked on dead rows — never reach a parent)
    live = (plan.pidx < n).astype(jnp.float32)[:, None]
    if h0_g is None:
        mp = jnp.concatenate([m_g, jnp.zeros_like(m_g[:1])])
        h0_g = mp[jnp.where(plan.pidx < n, plan.pidx, n)]
    d = (h_g - h0_g) * live
    need_cnt = cnt is None
    if kc_g or need_cnt:
        d = jnp.concatenate([d, live], axis=1)
    dpad = jnp.concatenate([d, jnp.zeros_like(d[:1])])
    take = lambda idx: dpad[jnp.where(idx < nh, idx, nh)]
    dx = take(plan.inv)
    cnt_live = None
    if kc_g or need_cnt:
        dx, cnt_live = dx[:, :-1], dx[:, -1:]
    red = dx
    if f and kc_g:
        d_tail = take(plan.inv_tail)
        seg = reduce_copy_segments(
            jnp.concatenate([d_tail[:, :kc_g], d_tail[:, -1:]], axis=1),
            plan.seg_base,
        )
        red = jnp.concatenate(
            [red[:, :kc_g] + seg[:, :-1], red[:, kc_g:]], axis=1
        )
        if need_cnt:
            cnt = jnp.maximum(cnt_live + seg[:, -1:], 1.0)
    elif need_cnt:
        # a group with no copy-reduced columns still derives the shared
        # live count once (primary + live-copy rows per splat)
        if f:
            lt = take(plan.inv_tail)[:, -1:]
            cnt = jnp.maximum(
                cnt_live + reduce_copy_segments(lt, plan.seg_base), 1.0
            )
        else:
            cnt = jnp.maximum(cnt_live, 1.0)
    if reduce == "mean" and kc_g:
        # copy-reduced columns average over all live rows; primary-only
        # columns took exactly one row's delta
        red = jnp.concatenate(
            [red[:, :kc_g] / cnt, red[:, kc_g:]], axis=1
        )
    folded = m_g + red
    # split back into leaf shapes INSIDE the jit (host-side slicing
    # dispatches one copy per leaf while the packed matrix stays alive)
    outs = []
    o = 0
    for l in m_leaves_g:
        w = 1
        for s in l.shape[1:]:
            w *= s
        outs.append(folded[:, o : o + w].reshape(l.shape))
        o += w
    return tuple(outs), cnt


_fold_group_jit = partial(jax.jit, static_argnums=(4, 5))(_fold_group_body)


@partial(jax.jit, static_argnums=(2,))
def _extract_group_jit(leaves_g, plan, want_packed):
    n, nh = plan.n, plan.nh
    mats = [l.reshape(n, -1) for l in leaves_g]
    src = mats[0] if len(mats) == 1 else jnp.concatenate(mats, axis=1)
    pp = jnp.concatenate([src, jnp.zeros_like(src[:1])])
    home_g = pp[plan.pidx]
    outs = []
    o = 0
    for l in leaves_g:
        w = 1
        for s in l.shape[1:]:
            w *= s
        outs.append(
            home_g[:, o : o + w].reshape((nh,) + tuple(l.shape[1:]))
        )
        o += w
    if want_packed:
        return tuple(outs), home_g
    return tuple(outs), None


# --------------------------------------------------------------------------
# the lazy step
# --------------------------------------------------------------------------


def lazy_cols(hp, cam: Camera, cfg: RenderConfig, plan: FramePlan):
    """Fresh per-home-row attribute columns for the blend: project the
    home-resident params under the (fresh) camera. Rows the fresh
    projection culls are masked to zero opacity and sanitized geometry —
    the lazy analogue of a splat leaving the frustum between the
    reference's sorts (it keeps its stale index-buffer slot but draws
    nothing)."""
    p = _project_any(hp, cam, cfg)
    val = p.valid
    op = jnp.where(val, p.opacity, 0.0)
    mx = jnp.where(val, p.mean2d[:, 0], 0.0)
    my = jnp.where(val, p.mean2d[:, 1], 0.0)
    ca = jnp.where(val, p.conic[:, 0], 1.0)
    cb = jnp.where(val, p.conic[:, 1], 0.0)
    cc = jnp.where(val, p.conic[:, 2], 1.0)
    return (mx, my, ca, cb, cc, p.rgb[:, 0], p.rgb[:, 1], p.rgb[:, 2], op)


def lazy_render(hp, cam: Camera, cfg: RenderConfig, plan: FramePlan,
                return_aux: bool = False):
    """Render with the plan's frozen layout and FRESH attributes.
    Differentiable w.r.t. hp (gradients arrive in home order — no
    inverse gathers anywhere in the backward)."""
    cols = lazy_cols(hp, cam, cfg, plan)
    with jax.named_scope("blend"):
        img_t, T_t = blend_stream(
            cols, plan.pid, plan.starts, plan.ty0, plan.tiles_x,
            plan.band_rows, cfg,
        )
    img, T_map = assemble_band(img_t, T_t, plan, cfg)
    if plan.band_rows >= cfg.tiles_y(cam.height):
        # full-image plan: crop to the viewport; band plans return the
        # band-padded image like parallel.render_sharded._render_band
        img = img[: cam.height]
        T_map = T_map[: cam.height]
    img = img[:, : cam.width]
    if not return_aux:
        return img
    aux = dict(plan.ovf)
    aux["transmittance"] = T_map[:, : cam.width]
    return img, aux


def make_lazy_step(cfg: RenderConfig, optimizer):
    """Jitted lazy training step over home-resident state:
    (hp, opt_state, target, cam, plan) → (hp, opt_state, loss).
    hp/opt_state are donated (consumed and replaced); cam and plan are
    traced, so one compile covers every view/resort of a trajectory."""
    import optax

    @partial(jax.jit, static_argnums=(), donate_argnums=(0, 1))
    def step(hp, opt_state, target, cam, plan):
        def loss_fn(hp):
            img = lazy_render(hp, cam, cfg, plan)
            return jnp.mean((img - target) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(hp)
        updates, opt_state = optimizer.update(grads, opt_state, hp)
        hp = optax.apply_updates(hp, updates)
        return hp, opt_state, loss

    return step


# --------------------------------------------------------------------------
# host-side trainer: resort cadence + fold-back bookkeeping
# --------------------------------------------------------------------------


_STEP_CACHE = {}


def _lazy_step_cached(cfg, optimizer):
    """Share one compiled lazy step across LazyTrainer instances (a
    fresh jit wrapper per instance would recompile at every
    construction)."""
    key = (cfg, id(optimizer))
    if key not in _STEP_CACHE:
        _STEP_CACHE[key] = make_lazy_step(cfg, optimizer)
    return _STEP_CACHE[key]


def _extract_dispatch(master, plan, want_parts):
    """Group-wise extract as SEPARATE jit dispatches: device programs
    serialize, so the peak is one group's temporaries (an in-trace
    group loop gets overlapped by XLA's scheduler no matter how the
    groups are gated — measured 14.7 GiB fold peaks at garden scale).
    Returns (home tree, parts list or None) — `parts` is the resort
    snapshot, one [NH, w] matrix per group."""
    leaves, treedef, li, widths = _leaf_info(master, plan.n)
    out = list(leaves)
    parts = [] if want_parts else None
    lp = [leaves[i] for i in li]
    for l0, l1, c0, c1 in _leaf_groups(widths):
        outs, home_g = _extract_group_jit(
            tuple(lp[l0:l1]), plan, want_parts
        )
        if want_parts:
            parts.append(home_g)
        for j in range(l0, l1):
            out[li[j]] = outs[j - l0]
    return jax.tree.unflatten(treedef, out), parts


def _fold_dispatch(master, hp, h0_parts, plan, reduce, fold_moments):
    """Group-wise fold as separate jit dispatches (see
    _extract_dispatch). Params fold through the copy-segment reduction;
    fold_moments="primary" folds optimizer moments primary-row-only
    (the segment cumsum runs at param width only), "mean" averages them
    like params — a measured DEAD END (diverges; DESIGN.md r5)."""
    g, opt_state = master
    if fold_moments == "mean":
        copy_cols = None
    else:
        copy_cols = (
            jax.tree.map(lambda _: True, g),
            jax.tree.map(lambda _: False, opt_state),
        )
    m_leaves, m_def, m_li, widths = _leaf_info(master, plan.n)
    h_leaves = jax.tree.flatten(hp)[0]
    out = list(m_leaves)
    for i in range(len(m_leaves)):
        if i not in m_li:
            out[i] = h_leaves[i]
    mp = [m_leaves[i] for i in m_li]
    hpp = [h_leaves[i] for i in m_li]
    if copy_cols is None:
        k_copy = sum(widths)
    else:
        cc = jax.tree.flatten(copy_cols)[0]
        cmask = []
        for j, i in enumerate(m_li):
            cmask += [bool(cc[i])] * widths[j]
        k_copy = sum(cmask)
        assert all(cmask[:k_copy]) and not any(cmask[k_copy:])
    cnt = None
    for gi, (l0, l1, c0, c1) in enumerate(_leaf_groups(widths)):
        h0_g = h0_parts[gi] if h0_parts is not None else None
        kc_g = min(max(k_copy - c0, 0), c1 - c0)
        folded, cnt = _fold_group_jit(
            tuple(mp[l0:l1]), tuple(hpp[l0:l1]), h0_g, cnt,
            kc_g, reduce, plan,
        )
        for j in range(l0, l1):
            out[m_li[j]] = folded[j - l0]
    return jax.tree.unflatten(m_def, out)


class LazyTrainer:
    """Drives lazy training: master (g, opt_state) in splat order,
    home-resident (hp, hp_opt) between resorts.

        tr = LazyTrainer(g, cfg, optimizer)
        for view in trajectory:
            tr.resort(view)                  # fold back + rebuild plan
            for _ in range(steps_per_view):
                loss = tr.step(target, view)
        g = tr.sync()                        # final fold-back

    The first step after a resort is EXACT (the plan was built at the
    current params); subsequent steps reuse the layout with fresh
    attributes. Resort overflow counters gate via `tr.plan.ovf`."""

    def __init__(self, g, cfg: RenderConfig, optimizer, reduce="mean",
                 fold_moments="primary", snapshot=True):
        self.g = g
        self.cfg = cfg
        self.optimizer = optimizer
        self.reduce = reduce
        self.fold_moments = fold_moments
        # snapshot=False trades ~160 ms/resort (the fold re-derives the
        # resort-time home state from the master, group-sized) for not
        # keeping a full packed [NH, C] copy alive — required at garden
        # scale (5M splats, sh2: the snapshot alone is ~3.9 GB)
        self.snapshot = snapshot
        self.opt_state = optimizer.init(g)
        self.plan = None
        self.hp = None
        self.hp_opt = None
        self._h0 = None  # packed [NH, C] resort snapshot (own buffer —
        #                  the step donates hp/hp_opt, never this)
        self._step = _lazy_step_cached(cfg, optimizer)

    def sync(self):
        """Fold home-space progress back into the master state (packed
        group reductions over params + both Adam moments)."""
        if self.plan is not None:
            self.g, self.opt_state = _fold_dispatch(
                (self.g, self.opt_state), (self.hp, self.hp_opt),
                self._h0, self.plan, self.reduce, self.fold_moments,
            )
            self.hp = self.hp_opt = self._h0 = None
            self.plan = None
        return self.g

    def resort(self, cam: Camera):
        """Fold back, rebuild the frame plan at the current params and
        this camera, and re-extract home-resident state."""
        self.sync()
        self.plan = build_frame_plan(self.g, cam, self.cfg)
        (self.hp, self.hp_opt), self._h0 = _extract_dispatch(
            (self.g, self.opt_state), self.plan, self.snapshot
        )
        return self.plan

    def step(self, target, cam: Camera):
        if self.plan is None:
            raise RuntimeError("call resort(cam) before step()")
        self.hp, self.hp_opt, loss = self._step(
            self.hp, self.hp_opt, target, cam, self.plan
        )
        return loss
