"""Tile-sharded rendering/training tests on the 8-device virtual CPU mesh
(SURVEY §4: the standard JAX trick for testing pjit/shard_map without a
pod)."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from gsjax import Camera, RenderConfig, render
from gsjax.parallel.mesh import make_mesh, padded_height
from gsjax.parallel.render_sharded import (
    make_train_step,
    pad_target,
    pad_target_rows,
    render_sharded,
)
from conftest import make_random_scene

CFG = RenderConfig(backend="xla", tile_list_cap=256, chunk=64)


@pytest.fixture(scope="module")
def mesh8():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(8)


def _cam():
    return Camera.create(fx=120, fy=120, width=96, height=128)


def test_sharded_render_matches_single_device(rng, mesh8):
    g = make_random_scene(rng, n=150, spread=1.3)
    cam = _cam()
    img1 = np.asarray(render(g, cam, CFG))
    imgs = render_sharded(g, cam, CFG, mesh8)
    imgs = np.asarray(imgs)[: cam.height, : cam.width]
    np.testing.assert_allclose(imgs, img1, atol=2e-5)


def test_sharded_render_odd_height(rng, mesh8):
    """Height that doesn't divide evenly across devices (pad path)."""
    g = make_random_scene(rng, n=100)
    cam = Camera.create(fx=120, fy=120, width=80, height=90)
    img1 = np.asarray(render(g, cam, CFG))
    imgs = np.asarray(render_sharded(g, cam, CFG, mesh8))
    assert imgs.shape[0] == padded_height(CFG, 90, 8)
    np.testing.assert_allclose(imgs[:90, :80], img1, atol=2e-5)


def test_sharded_train_step_decreases_loss_and_matches_grads(rng, mesh8):
    g = make_random_scene(rng, n=120, spread=1.2)
    cam = _cam()
    target = np.asarray(render(g, cam, CFG))
    # perturb and train back toward the target
    g0 = jax.tree.map(lambda x: x, g)
    import dataclasses

    g0 = dataclasses.replace(g0, means=g0.means + 0.01)

    opt = optax.adam(1e-3)
    step = make_train_step(cam, CFG, mesh8, opt)
    tgt = pad_target(CFG, cam, target, 8)
    opt_state = opt.init(g0)

    g1, opt_state, loss0, aux = step(g0, opt_state, tgt)
    g1_first = g1
    losses = [float(loss0)]
    for _ in range(4):
        g1, opt_state, loss, aux = step(g1, opt_state, tgt)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses

    # parity: the same step on a 1-device mesh produces the same loss and
    # the same first update (H=128 → the tile grid pads identically)
    mesh1 = make_mesh(1)
    step1 = make_train_step(cam, CFG, mesh1, opt)
    assert pad_target(CFG, cam, target, 1).shape == tgt.shape
    g1_ref, _, loss0_ref, _aux = step1(g0, opt.init(g0), tgt)
    assert float(loss0_ref) == pytest.approx(float(loss0), rel=1e-5)
    for a, b in zip(jax.tree.leaves(g1_first), jax.tree.leaves(g1_ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_sharded_stream_backend_matches_single_device(rng, mesh8):
    """The stream path (Triton kernels in interpret mode on CPU) under
    shard_map:
    each device home-sorts, bins, and blends only its own tile band."""
    cfg = RenderConfig(
        backend="stream",
        chunk=32,
    )
    g = make_random_scene(rng, n=200, spread=1.2, z_range=(3.0, 8.0))
    cam = _cam()
    img1 = np.asarray(render(g, cam, cfg))
    imgs = np.asarray(render_sharded(g, cam, cfg, mesh8))
    np.testing.assert_allclose(imgs[: cam.height, : cam.width], img1, atol=2e-5)


def test_band_slice_shrinks_sorted_work(rng):
    """Per-device sorted-array sizes shrink with D by construction
    (VERDICT r2 weak #3): the band slice bounds the home rows — and
    hence the pair stream fed to the (tile, depth) sort — by the band's
    proportional share, not the full scene."""
    from gsjax.render.binning import build_tile_bins
    from gsjax.render.homesort import (
        band_slice_cap,
        build_home_layout,
        slice_band_rows,
    )
    from gsjax.render.project import project

    cfg = RenderConfig(backend="stream", chunk=32)
    g = make_random_scene(rng, n=20000, spread=1.3, z_range=(3.0, 8.0))
    cam = _cam()
    p = project(g, cam, cfg)
    p_full, layout_full = build_home_layout(p, cam, cfg)
    tiles_y = cfg.tiles_y(cam.height)
    band = 1  # 8 devices over 8 tile rows
    cap = band_slice_cap(layout_full.perm.shape[0], tiles_y, band)
    assert cap < layout_full.perm.shape[0], (
        "cap must shrink at this scene size for the test to bite"
    )
    p_b, layout_b, n_drop = slice_band_rows(p_full, layout_full, 2, band, cap)
    assert layout_b.perm.shape[0] == cap
    assert int(n_drop) == 0

    bins_full = build_tile_bins(
        p_full, cam, cfg, anchor="home", layout=layout_full
    )
    bins_b = build_tile_bins(
        p_b, cam, cfg, ty0=2, band_rows=band, anchor="home", layout=layout_b
    )
    # the sliced pair stream (the sort's static size) shrinks with the cap
    assert bins_b.pid_sorted.shape[0] < bins_full.pid_sorted.shape[0]
    from gsjax.render.repack import resolve_repack_dims

    w, _, r = resolve_repack_dims(-(-cap // 4096) * 4096, 9, cfg)
    assert bins_b.pid_sorted.shape[0] <= r * w


def test_sharded_stream_grads_match_replicated(rng, mesh8):
    """Gradients through the band-sliced stream path equal the
    single-device (replicated) gradients: the slice's VJP zero-pads back
    into the full home table, and psum over the band losses reassembles
    the full-image loss."""
    cfg = RenderConfig(
        backend="stream",
        chunk=32,
    )
    g = make_random_scene(rng, n=150, spread=1.2, z_range=(3.0, 8.0))
    cam = _cam()
    target = np.asarray(render(g, cam, cfg))
    opt = optax.adam(1e-3)
    tgt = pad_target(cfg, cam, target, 8)
    step8 = make_train_step(cam, cfg, mesh8, opt)
    step1 = make_train_step(cam, cfg, make_mesh(1), opt)
    g8, _, loss8, aux8 = step8(g, opt.init(g), tgt)
    g1, _, loss1, _aux1 = step1(g, opt.init(g), tgt)
    assert float(loss8) == pytest.approx(float(loss1), rel=1e-5)
    for a, b in zip(jax.tree.leaves(g8), jax.tree.leaves(g1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4)
    # the train step SURFACES every capacity counter (psum over the
    # mesh) — "counted, never silent" holds on the sharded path
    for k in ("n_pair_overflow", "n_band_overflow", "n_tile_overflow",
              "n_fat_overflow"):
        assert int(aux8[k]) == 0, (k, aux8)


def test_sharded_stream_uneven_band_split(rng, mesh8):
    """tiles_y % n_devices != 0 with the last in-image device's band
    overhanging the image: slice_band_rows' seg_starts slice must not
    clamp (a short pad made dynamic_slice clamp the start by a
    non-multiple of tiles_x, misaligning every per-tile run on that
    device — silent corruption with n_band_overflow=0; ADVICE r3 high).
    tiles_y=9, D=8 → band=2: device 4 renders in-image row 8 from a
    slice that previously needed clamping."""
    cfg = RenderConfig(
        backend="stream",
        chunk=32,
    )
    g = make_random_scene(rng, n=200, spread=1.4, z_range=(3.0, 8.0))
    cam = Camera.create(fx=120, fy=120, width=96, height=144)
    assert cfg.tiles_y(cam.height) % 8 != 0
    img1 = np.asarray(render(g, cam, cfg))
    imgs = np.asarray(render_sharded(g, cam, cfg, mesh8))
    assert np.isfinite(imgs).all()
    np.testing.assert_allclose(imgs[: cam.height, : cam.width], img1, atol=2e-5)

    # gradients too: the sharded step must match the replicated one
    opt = optax.adam(1e-3)
    tgt = pad_target(cfg, cam, img1, 8)
    g8, _, loss8, aux8 = make_train_step(cam, cfg, mesh8, opt)(
        g, opt.init(g), tgt
    )
    tgt1 = pad_target(cfg, cam, img1, 1)  # shorter padding than D=8
    g1_, _, loss1, _a = make_train_step(cam, cfg, make_mesh(1), opt)(
        g, opt.init(g), tgt1
    )
    assert float(loss8) == pytest.approx(float(loss1), rel=1e-5)
    for a, b in zip(jax.tree.leaves(g8), jax.tree.leaves(g1_)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4)
    assert int(aux8["n_band_overflow"]) == 0


def test_balanced_bands_match_and_balance(rng, mesh8):
    """Balanced (boustrophedon) band assignment: same loss/grads as the
    contiguous split (the loss is permutation-invariant over pixels),
    and a center-heavy scene's per-device pair counts even out."""
    from gsjax.parallel.mesh import (
        TILES_AXIS,
        balanced_group_order,
        band_rows_balanced,
        band_rows_for,
    )
    from gsjax.parallel.render_sharded import (
        make_train_step_balanced,
        pad_target_balanced,
    )
    from gsjax.render.binning import build_tile_bins
    from gsjax.render.project import project
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    # center-heavy: tight spread → most splats land mid-image
    g = make_random_scene(rng, n=600, spread=0.35, z_range=(3.0, 6.0))
    cam = _cam()
    target = np.asarray(render(g, cam, CFG))

    opt = optax.adam(1e-3)
    # D=4 over 8 tile rows -> 8 groups of 1 row, every group real; D=8
    # would mirror-pair with out-of-image groups (degenerate)
    mesh4 = make_mesh(4)
    step_b = make_train_step_balanced(cam, CFG, mesh4, opt)
    tgt_b = pad_target_balanced(CFG, cam, target, 4)
    g_b, _, loss_b, _auxb = step_b(g, opt.init(g), tgt_b)

    step_c = make_train_step(cam, CFG, make_mesh(1), opt)
    tgt_c = pad_target(CFG, cam, target, 1)
    g_c, _, loss_c, _auxc = step_c(g, opt.init(g), tgt_c)
    assert float(loss_b) == pytest.approx(float(loss_c), rel=1e-5)
    for a, b in zip(jax.tree.leaves(g_b), jax.tree.leaves(g_c)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)

    # degenerate: D=8 over 8 tile rows -> groups 8..15 are out of image
    # (render black, contribute nothing); loss must still match
    step8 = make_train_step_balanced(cam, CFG, mesh8, opt)
    tgt8 = pad_target_balanced(CFG, cam, target, 8)
    _, _, loss8, _aux8 = step8(g, opt.init(g), tgt8)
    assert float(loss8) == pytest.approx(float(loss_c), rel=1e-5)

    # balance: max-device pair count strictly improves vs contiguous
    p = project(g, cam, CFG)

    def pairs_for(ty0, band):
        return int(
            build_tile_bins(p, cam, CFG, ty0=ty0, band_rows=band).n_pairs
        )

    band_c = band_rows_for(CFG, cam.height, 4)
    contig = [pairs_for(d * band_c, band_c) for d in range(4)]
    gband = band_rows_balanced(CFG, cam.height, 4)
    bal = [
        pairs_for(d * gband, gband)
        + pairs_for((d + 4) * gband, gband)
        for d in range(4)
    ]
    assert sum(bal) == sum(contig)
    assert max(bal) < max(contig), (max(bal), max(contig))


def test_equalized_row_cuts_match_replicated(rng, mesh8):
    """The equal-CONTENT row-cut step (variable owned rows per device,
    one static program, rows_live-bounded content) produces the SAME
    loss and gradients as the replicated step — owned-row masking
    partitions the image exactly, and the traced live bounds only cull
    work that contributes nothing."""
    from gsjax.parallel.render_sharded import (
        make_train_step_equalized,
        pad_target_rows,
    )

    cfg = RenderConfig(
        backend="stream",
        chunk=32,
    )
    g = make_random_scene(rng, n=150, spread=1.2, z_range=(3.0, 8.0))
    cam = _cam()  # 96x128 -> 8 tile rows
    target = np.asarray(render(g, cam, cfg))
    opt = optax.adam(1e-3)
    # deliberately uneven cuts over 8 rows / 8 devices won't fit; use 4
    # devices x {1..3} rows
    mesh4 = make_mesh(4)
    cuts = [0, 3, 4, 6, 8]
    band_max = 3
    step_eq = make_train_step_equalized(cam, cfg, mesh4, opt, cuts)
    tgt = pad_target_rows(cfg, cam, target, band_max)
    g_eq, _, loss_eq, aux_eq = step_eq(g, opt.init(g), tgt)

    step1 = make_train_step(cam, cfg, make_mesh(1), opt)
    tgt1 = pad_target(cfg, cam, target, 1)
    g1, _, loss1, _ = step1(g, opt.init(g), tgt1)
    assert float(loss_eq) == pytest.approx(float(loss1), rel=1e-5)
    for a, b in zip(jax.tree.leaves(g_eq), jax.tree.leaves(g1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4)
    for k in ("n_pair_overflow", "n_band_overflow", "n_tile_overflow",
              "n_fat_overflow"):
        assert int(aux_eq[k]) == 0, (k, dict(aux_eq))


def test_sharded_loss_ignores_pixels_past_the_image(rng):
    """Height and width not multiples of the tile: the bands' last tile
    row/column reach past the image, where the render is not black. The
    sharded loss and gradients must equal jnp.mean over the cropped
    single-device render."""
    from gsjax.parallel.render_sharded import make_grad_equalized

    g = make_random_scene(rng, n=150, spread=1.3)
    cam = Camera.create(fx=60, fy=60, width=56, height=40)
    tgt = jnp.asarray(rng.uniform(0, 1, (40, 56, 3)), jnp.float32)
    loss1, g1 = jax.value_and_grad(
        lambda g: jnp.mean((render(g, cam, CFG) - tgt) ** 2)
    )(g)
    cuts = [0, 1, 3]
    loss2, g2, _ = make_grad_equalized(cam, CFG, make_mesh(2), cuts)(
        g, pad_target_rows(CFG, cam, tgt, 2)
    )
    assert float(loss2) == pytest.approx(float(loss1), rel=1e-5)
    for a, b in zip(jax.tree.leaves(g1), jax.tree.leaves(g2)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-4, atol=1e-7)
