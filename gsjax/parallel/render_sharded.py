"""Tile-sharded rendering and training over a device mesh.

Design (SURVEY §2.5 / §5.8, BASELINE configs 4-5):
  - splat parameters replicated on every chip (they are small next to the
    pair/pixel work; ≤ a few hundred MB for 5M splats),
  - the image's tile rows sharded over the `tiles` mesh axis: every
    device projects all splats (cheap, elementwise), prefilters those
    that can reach its band, builds their (home, depth) layout, then
    SLICES it to the band's contiguous home-row range
    (homesort.slice_band_rows): the pair expansion, (tile, depth) sort
    and blend kernels all run on the band share, so the dominant costs
    scale ~1/D by construction (tests assert the per-device sorted sizes
    shrink),
  - the loss is a local mean over the band + `psum`; parameter gradients
    come out of the local backward and are `psum`ed (XLA hands the
    all-reduce to NCCL and overlaps it with the remaining backward).

The reference's analogue of this layer is postMessage+transferable
buffers between the render thread and the sort worker
(/root/reference/src/renderers/webgl/utils/Worker.ts:42); here it is XLA
collectives over the mesh.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from gsjax import device
from gsjax.core.camera import Camera
from gsjax.core.config import RenderConfig
from gsjax.core.gaussians import Gaussians
from gsjax.parallel.mesh import TILES_AXIS, band_rows_for, padded_height
from gsjax.render.binning import build_tile_bins
from gsjax.render.composite import composite_tiles
from gsjax.render.project import project


def _render_band(g, cam, cfg, ty0, band, rows_live=None):
    """Render one tile-row band [ty0, ty0+band): the per-device body of
    the sharded render/train step.

    `rows_live` (traced, default band): the device's OWNED row count
    under an equal-content row-cut split — prefilter, slice and pair
    expansion bound their content to [ty0, ty0+rows_live) while every
    shape stays `band`-static, so per-device cost tracks the owned
    CONTENT share (~1/D for equal-content cuts) instead of the worst
    equal-rows band (with static worst-band caps, shapes and not work
    would set the time).

    Stream path: the band prefilter compacts the splats whose rect can
    reach the band before the (home, depth) sort, and the layout is
    then RESTRICTED to the band's contiguous home-row range
    (homesort.slice_band_rows) before anything expensive runs — pair
    expansion, the (tile, depth) sort and both blend kernels operate on
    a static band-share-sized slice, so per-device work scales ~1/D."""
    if device.resolve_backend(cfg.backend) == "stream":
        from gsjax.render.homesort import (
            band_prefilter,
            band_prefilter_cap,
            band_slice_cap,
            build_home_layout,
            slice_band_rows,
        )
        from gsjax.render.pallas_stream import composite_tiles_stream

        tiles_y = cfg.tiles_y(cam.height)
        tiles_x = cfg.tiles_x(cam.width)
        if rows_live is None:
            rows_live = band
        p = project(g, cam, cfg)
        n_pref = jnp.zeros((), jnp.int32)
        if band < tiles_y:
            # band-local prologue: compact to the splats whose rect can
            # reach this band BEFORE the (home, depth) sort, so the
            # whole layout build scales ~1/D instead of replicating the
            # full-scene prologue on every device
            cap_n = cfg.shard_prefilter_cap or band_prefilter_cap(
                p.depth.shape[0], tiles_y, band, cfg.band_prefilter_slack
            )
            cap_n = min(cap_n, -(-p.depth.shape[0] // 4096) * 4096)
            p, n_pref = band_prefilter(
                p, ty0, rows_live, tiles_y, tiles_x, cap_n, cfg
            )
        p, layout = build_home_layout(p, cam, cfg)
        n_sliced = jnp.zeros((), jnp.int32)
        if band < tiles_y:
            cap = cfg.shard_slice_cap or band_slice_cap(
                layout.perm.shape[0], tiles_y, band, cfg.band_slice_slack
            )
            p, layout, n_sliced = slice_band_rows(
                p, layout, ty0, band, cap, rows_live
            )
        bins = build_tile_bins(
            p, cam, cfg, ty0=ty0, band_rows=band, anchor="home",
            layout=layout, rows_live=rows_live,
        )
        img, aux = composite_tiles_stream(p, layout, bins, cam, cfg)
        aux["n_band_overflow"] = aux["n_band_overflow"] + n_sliced + n_pref
        return img, aux
    p = project(g, cam, cfg)
    bins = build_tile_bins(p, cam, cfg, ty0=ty0, band_rows=band)
    return composite_tiles(p, bins, cam, cfg)


def render_sharded(g: Gaussians, cam: Camera, cfg: RenderConfig, mesh):
    """Render with tile rows sharded over `mesh`. Returns the image with
    rows sharded on the `tiles` axis, shape [padded_H, tiles_x·ts, 3]
    (crop to (cam.height, cam.width) after gathering if needed)."""
    n_dev = mesh.shape[TILES_AXIS]
    band = band_rows_for(cfg, cam.height, n_dev)

    def local_render(g):
        d = jax.lax.axis_index(TILES_AXIS)
        img, _ = _render_band(g, cam, cfg, d * band, band)
        return img

    return shard_map(
        local_render,
        mesh=mesh,
        in_specs=(P(),),
        out_specs=P(TILES_AXIS),
        check_vma=False,
    )(g)


#: scalar diagnostics surfaced (psum-summed over the mesh) by the train
#: steps. Every capacity cap on the sharded path — including
#: slice_band_rows' band_slice_cap drops, folded into n_band_overflow by
#: _render_band — is visible to the caller: "counted, never silent"
#: holds on the multi-chip path too (a skewed scene that overflows a
#: band budget shows up here, not as silently truncated gradients).
AUX_COUNTERS = (
    "n_clamped",
    "n_pairs",
    "n_tile_overflow",
    "n_pair_overflow",
    "n_band_overflow",
    "n_fat_overflow",
)


def _aux_counters(aux):
    return {
        k: jnp.asarray(aux.get(k, 0), jnp.int32).reshape(())
        for k in AUX_COUNTERS
    }


def _image_px(cam: Camera) -> int:
    """The loss normalizer of every split: the image's pixel count, so a
    sharded loss equals jnp.mean over the [H, W, 3] render."""
    return cam.height * cam.width


def _in_image(cam: Camera, cfg: RenderConfig, row0, n_rows: int):
    """[n_rows·ts, tiles_x·ts, 1] mask of a band's pixels that lie inside
    the image. A band's last tile row and column can reach past the
    image, where the render is NOT black (splats cover those pixels) but
    the single-device render crops them; the loss must ignore them.
    `row0` (first tile row) may be traced."""
    ts = cfg.tile_size
    r = row0 * ts + jnp.arange(n_rows * ts, dtype=jnp.int32)
    c = jnp.arange(cfg.tiles_x(cam.width) * ts, dtype=jnp.int32)
    return ((r < cam.height)[:, None] & (c < cam.width)[None, :])[..., None]


def make_train_step(cam: Camera, cfg: RenderConfig, mesh, optimizer):
    """Build a jitted tile-sharded training step
    (render → L2 loss vs target → grads → psum → optax update).
    Returns a step (g, opt_state, target) -> (g, opt_state, loss, aux)
    where aux holds the AUX_COUNTERS summed over the mesh.

    The target image must have padded height
    `parallel.mesh.padded_height(cfg, cam.height, D)` and width
    tiles_x·tile_size (use `pad_target`)."""
    n_dev = mesh.shape[TILES_AXIS]
    band = band_rows_for(cfg, cam.height, n_dev)
    n_px_total = _image_px(cam)

    def local_loss_and_grad(g, target_band):
        d = jax.lax.axis_index(TILES_AXIS)
        inside = _in_image(cam, cfg, d * band, band)

        def loss_fn(g):
            img, aux = _render_band(g, cam, cfg, d * band, band)
            loss = jnp.sum(jnp.where(inside, (img - target_band) ** 2, 0.0)) / (
                n_px_total * 3
            )
            return loss, _aux_counters(aux)

        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(g)
        loss = jax.lax.psum(loss, TILES_AXIS)
        grads = jax.lax.psum(grads, TILES_AXIS)
        aux = jax.lax.psum(aux, TILES_AXIS)
        return loss, grads, aux

    sharded_grad = shard_map(
        local_loss_and_grad,
        mesh=mesh,
        in_specs=(P(), P(TILES_AXIS)),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )

    import optax

    @jax.jit
    def train_step(g, opt_state, target):
        loss, grads, aux = sharded_grad(g, target)
        updates, opt_state = optimizer.update(grads, opt_state, g)
        g = optax.apply_updates(g, updates)
        return g, opt_state, loss, aux

    return train_step


def pad_target(cfg: RenderConfig, cam: Camera, target, n_devices: int):
    """Zero-pad a [H, W, 3] target to the sharded render's padded shape."""
    ph = padded_height(cfg, cam.height, n_devices)
    pw = cfg.tiles_x(cam.width) * cfg.tile_size
    return jnp.pad(
        jnp.asarray(target, jnp.float32),
        ((0, ph - target.shape[0]), (0, pw - target.shape[1]), (0, 0)),
    )


# --------------------------------------------------------------------------
# equal-CONTENT band assignment (variable rows per device)
# --------------------------------------------------------------------------


def make_grad_equalized(cam: Camera, cfg: RenderConfig, mesh, row_cuts):
    """(g, target) → (loss, grads, aux): the sharded loss and parameter
    gradients of make_train_step_equalized, before the optimizer."""
    cuts = [int(c) for c in row_cuts]
    n_dev = mesh.shape[TILES_AXIS]
    assert len(cuts) == n_dev + 1
    rows_d = [cuts[i + 1] - cuts[i] for i in range(n_dev)]
    band_max = max(rows_d)
    ts = cfg.tile_size
    n_px_total = _image_px(cam)
    ty0s = jnp.asarray(cuts[:-1], jnp.int32)
    livs = jnp.asarray(rows_d, jnp.int32)

    def local_loss_and_grad(g, target_full):
        d = jax.lax.axis_index(TILES_AXIS)
        ty0 = ty0s[d]
        rows_live = livs[d]
        trow = jnp.arange(band_max * ts, dtype=jnp.int32)
        own = (trow < rows_live * ts)[:, None, None] & _in_image(
            cam, cfg, ty0, band_max
        )
        tband = jax.lax.dynamic_slice_in_dim(
            target_full, ty0 * ts, band_max * ts, axis=0
        )

        def loss_fn(g):
            img, aux = _render_band(g, cam, cfg, ty0, band_max, rows_live)
            loss = jnp.sum(jnp.where(own, (img - tband) ** 2, 0.0)) / (
                n_px_total * 3
            )
            return loss, _aux_counters(aux)

        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(g)
        loss = jax.lax.psum(loss, TILES_AXIS)
        grads = jax.lax.psum(grads, TILES_AXIS)
        aux = jax.lax.psum(aux, TILES_AXIS)
        return loss, grads, aux

    return jax.jit(
        shard_map(
            local_loss_and_grad,
            mesh=mesh,
            in_specs=(P(), P()),
            out_specs=(P(), P(), P()),
            check_vma=False,
        )
    )


def make_train_step_equalized(cam: Camera, cfg: RenderConfig, mesh,
                              optimizer, row_cuts):
    """Tile-sharded training step over an EQUAL-CONTENT row partition:
    device d owns tile rows [row_cuts[d], row_cuts[d+1]) — cuts chosen
    (autotune.derive_row_cuts) so every band holds ≈ the same candidate
    mass. All devices run one static program sized for the largest
    band's ROW count, but the prefilter/slice/expansion bound their
    content to each device's owned rows (rows_live), so per-device cost
    tracks the ~1/D content share — on skewed scenes the equal-ROWS
    split pins every device to the dense center band's static cost
    (render/DESIGN.md).

    The loss masks rows beyond each device's owned range and pixels
    outside the image, so the psum over devices equals the whole-image
    loss exactly (each image pixel is owned by exactly one device);
    `target` must be the pad_target_rows padded full image, replicated."""
    sharded_grad = make_grad_equalized(cam, cfg, mesh, row_cuts)

    import optax

    @jax.jit
    def train_step(g, opt_state, target):
        loss, grads, aux = sharded_grad(g, target)
        updates, opt_state = optimizer.update(grads, opt_state, g)
        g = optax.apply_updates(g, updates)
        return g, opt_state, loss, aux

    return train_step


def pad_target_rows(cfg: RenderConfig, cam: Camera, target, band_max: int):
    """Zero-pad a [H, W, 3] target to tile-rounded width and
    (tiles_y + band_max) tile rows of height, so every device's static
    band window slices in-range."""
    ph = (cfg.tiles_y(cam.height) + band_max) * cfg.tile_size
    pw = cfg.tiles_x(cam.width) * cfg.tile_size
    return jnp.pad(
        jnp.asarray(target, jnp.float32),
        ((0, ph - target.shape[0]), (0, pw - target.shape[1]), (0, 0)),
    )


# --------------------------------------------------------------------------
# balanced (boustrophedon) band assignment
# --------------------------------------------------------------------------


def make_train_step_balanced(cam: Camera, cfg: RenderConfig, mesh, optimizer):
    """Tile-sharded training step with COUNT-BALANCED band assignment:
    the image splits into 2D row groups; device d composites groups
    (d, d+D) — one from each image half, so a unimodal density profile
    gives every device one dense-ish and one sparse-ish group. On the 1080p bench scene the contiguous equal-row split gives
    the center device several times the pairs of the edge device (the
    step runs at the slowest device); the pairing cancels most of that
    for radially-concentrated scenes. The loss is a sum over pixels, so
    the group permutation changes nothing semantically — only the
    TARGET must be pre-permuted with `pad_target_balanced`."""
    from gsjax.parallel.mesh import band_rows_balanced

    n_dev = mesh.shape[TILES_AXIS]
    gband = band_rows_balanced(cfg, cam.height, n_dev)
    n_px_total = _image_px(cam)

    def local_loss_and_grad(g, target_band):
        d = jax.lax.axis_index(TILES_AXIS)
        inside = jnp.concatenate([
            _in_image(cam, cfg, d * gband, gband),
            _in_image(cam, cfg, (d + n_dev) * gband, gband),
        ])

        def loss_fn(g):
            img0, aux0 = _render_band(g, cam, cfg, d * gband, gband)
            img1, aux1 = _render_band(
                g, cam, cfg, (d + n_dev) * gband, gband
            )
            img = jnp.concatenate([img0, img1])
            loss = jnp.sum(jnp.where(inside, (img - target_band) ** 2, 0.0)) / (
                n_px_total * 3
            )
            aux = jax.tree.map(
                jnp.add, _aux_counters(aux0), _aux_counters(aux1)
            )
            return loss, aux

        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(g)
        loss = jax.lax.psum(loss, TILES_AXIS)
        grads = jax.lax.psum(grads, TILES_AXIS)
        aux = jax.lax.psum(aux, TILES_AXIS)
        return loss, grads, aux

    sharded_grad = shard_map(
        local_loss_and_grad,
        mesh=mesh,
        in_specs=(P(), P(TILES_AXIS)),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )

    import optax

    @jax.jit
    def train_step(g, opt_state, target):
        loss, grads, aux = sharded_grad(g, target)
        updates, opt_state = optimizer.update(grads, opt_state, g)
        g = optax.apply_updates(g, updates)
        return g, opt_state, loss, aux

    return train_step


def pad_target_balanced(cfg: RenderConfig, cam: Camera, target, n_devices: int):
    """Pad a [H, W, 3] target and permute its row groups into the
    balanced sharded order (device d's shard = groups d, d+D)."""
    from gsjax.parallel.mesh import (
        balanced_group_order,
        band_rows_balanced,
    )

    gband = band_rows_balanced(cfg, cam.height, n_devices)
    gh = gband * cfg.tile_size
    ph = 2 * n_devices * gh
    pw = cfg.tiles_x(cam.width) * cfg.tile_size
    t = jnp.pad(
        jnp.asarray(target, jnp.float32),
        ((0, ph - target.shape[0]), (0, pw - target.shape[1]), (0, 0)),
    )
    groups = t.reshape(2 * n_devices, gh, pw, 3)
    order = jnp.asarray(balanced_group_order(n_devices), jnp.int32)
    return groups[order].reshape(ph, pw, 3)
