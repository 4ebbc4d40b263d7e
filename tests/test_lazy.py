"""Lazy frame plans (render/lazy.py — DESIGN.md rungs 1+2).

Three layers of guarantees:
  1. a lazy render right after a resort is EXACT (bit-close to the
     per-frame-exact stream path) — for any scene, fat splats included:
     copy rows project their parent's params, reproducing the repeat
     kernel's exact attribute reconstruction;
  2. a whole lazy TRAINING trajectory with per-step resorts equals the
     per-frame-exact trajectory exactly for thin scenes under SGD
     (the fold-back is a bijection + linear reduction);
  3. with layout reuse (K > 1) and Adam on a fat scene, the loss drifts
     BOUNDEDLY from the exact trajectory and fold-back keeps the master
     state finite and close (the reference's stale-permutation trade,
     Worker.ts:45-57, made measurable).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from conftest import make_random_scene

from gsjax import Camera, Gaussians, RenderConfig, render
from gsjax.render.lazy import (
    LazyTrainer,
    build_frame_plan,
    extract_home,
    fold_back,
    lazy_render,
    make_lazy_step,
)

CFG = RenderConfig(
    backend="stream",
    chunk=32,
    fat_max_blocks=64,
    fat_cap=8192,
    fat_live_cap=4096,
)


def _cam(w=320, h=240):
    return Camera.create(fx=300.0, fy=300.0, width=w, height=h,
                         position=(0.0, 0.0, 0.0))


def _thin_scene(rng, n=800):
    """A scene with no fat splats (every footprint fits one 3x3 block)."""
    g = make_random_scene(rng, n=n, sh_degree=0, spread=2.0,
                          z_range=(5.0, 9.0))
    g = dataclasses.replace(
        g, log_scales=jnp.minimum(g.log_scales, jnp.log(0.02))
    )
    return g


def test_lazy_render_matches_exact(rng):
    """Plan + fresh extract == the exact stream render (fat splats in)."""
    g = make_random_scene(rng, n=3000, sh_degree=1, spread=2.2,
                          z_range=(3.0, 9.0))
    cam = _cam()
    img_exact = jax.jit(lambda g: render(g, cam, CFG))(g)
    plan = build_frame_plan(g, cam, CFG)
    assert int(plan.ovf["n_fat_overflow"]) == 0
    assert int(plan.ovf["n_pair_overflow"]) == 0
    hp = extract_home(g, plan)
    assert plan.inv_tail.shape[0] > 0  # the scene does exercise copies
    img_lazy = jax.jit(lambda hp: lazy_render(hp, cam, CFG, plan))(hp)
    np.testing.assert_allclose(
        np.asarray(img_lazy), np.asarray(img_exact), atol=2e-5
    )


def test_lazy_sgd_thin_equals_exact_trajectory(rng):
    """Per-step resorts + SGD on a thin scene: the lazy trajectory's
    losses and final params equal the exact path's (fold-back is a
    bijection; sum == mean at one row per splat)."""
    g = _thin_scene(rng)
    cam = _cam(256, 192)
    opt = optax.sgd(5e-2)
    target = jnp.full((cam.height, cam.width, 3), 0.25, jnp.float32)

    # exact reference trajectory
    @jax.jit
    def exact_step(g, opt_state):
        def loss_fn(g):
            img = render(g, cam, CFG)
            return jnp.mean((img - target) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(g)
        updates, opt_state = opt.update(grads, opt_state, g)
        return optax.apply_updates(g, updates), opt_state, loss

    ge, se = g, opt.init(g)
    exact_losses = []
    for _ in range(4):
        ge, se, loss = exact_step(ge, se)
        exact_losses.append(float(loss))

    tr = LazyTrainer(g, CFG, opt, reduce="sum")
    lazy_losses = []
    for _ in range(4):
        tr.resort(cam)  # K=1: resort before every step
        lazy_losses.append(float(tr.step(target, cam)))
    gl = tr.sync()

    np.testing.assert_allclose(lazy_losses, exact_losses, rtol=1e-5)
    for f in ("means", "log_scales", "quats", "sh", "opacity_logits"):
        a, b = np.asarray(getattr(ge, f)), np.asarray(getattr(gl, f))
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_lazy_adam_reuse_drift_bounded(rng):
    """K=4 layout reuse with Adam on a fat scene: losses decrease, stay
    finite, and drift from the exact trajectory stays small relative to
    the loss scale; the folded-back master stays close to the exact
    final params."""
    g = make_random_scene(rng, n=2000, sh_degree=0, spread=2.2,
                          z_range=(3.0, 9.0))
    cam = _cam(256, 192)
    opt = optax.adam(2e-3)
    target = jnp.full((cam.height, cam.width, 3), 0.25, jnp.float32)
    steps, K = 8, 4

    @jax.jit
    def exact_step(g, opt_state):
        def loss_fn(g):
            img = render(g, cam, CFG)
            return jnp.mean((img - target) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(g)
        updates, opt_state = opt.update(grads, opt_state, g)
        return optax.apply_updates(g, updates), opt_state, loss

    ge, se = g, opt.init(g)
    exact_losses = []
    for _ in range(steps):
        ge, se, loss = exact_step(ge, se)
        exact_losses.append(float(loss))

    tr = LazyTrainer(g, CFG, opt)  # reduce="mean"
    lazy_losses = []
    for s in range(steps):
        if s % K == 0:
            tr.resort(cam)
        lazy_losses.append(float(tr.step(target, cam)))
    gl = tr.sync()

    lazy_losses = np.asarray(lazy_losses)
    exact_losses = np.asarray(exact_losses)
    assert np.all(np.isfinite(lazy_losses))
    # same first loss (the post-resort step is exact), monotone progress
    np.testing.assert_allclose(lazy_losses[0], exact_losses[0], rtol=1e-5)
    assert lazy_losses[-1] < lazy_losses[0]
    # per-step loss drift bounded at a few percent (measured ~1.3% here)
    rel = np.abs(lazy_losses - exact_losses) / np.abs(exact_losses)
    assert rel.max() < 0.05, rel
    # the folded-back master renders (exactly) to a loss close to the
    # exact path's, and its params stay close
    le = float(jnp.mean((render(gl, cam, CFG) - target) ** 2))
    lee = float(jnp.mean((render(ge, cam, CFG) - target) ** 2))
    assert abs(le - lee) / lee < 0.05, (le, lee)
    for f in ("means", "log_scales", "quats", "sh", "opacity_logits"):
        a, b = np.asarray(getattr(ge, f)), np.asarray(getattr(gl, f))
        assert np.all(np.isfinite(b))
        scale = np.abs(a).max() + 1e-6
        assert np.abs(a - b).max() / scale < 0.05, f


def test_lazy_step_gradients_flow(rng):
    """One lazy step moves every parameter leaf (grads reach home rows
    through the frozen streams)."""
    g = make_random_scene(rng, n=1500, sh_degree=1, spread=2.0,
                          z_range=(3.0, 8.0))
    cam = _cam(192, 160)
    opt = optax.adam(1e-2)
    plan = build_frame_plan(g, cam, CFG)
    hp = extract_home(g, plan)
    hp_opt = extract_home(opt.init(g), plan)
    step = make_lazy_step(CFG, opt)
    target = jnp.zeros((cam.height, cam.width, 3), jnp.float32)
    hp2, _, loss = step(hp, hp_opt, target, cam, plan)
    assert np.isfinite(float(loss))
    moved = {
        f: float(jnp.max(jnp.abs(getattr(hp2, f) - getattr(extract_home(g, plan), f))))
        for f in ("means", "log_scales", "quats", "sh", "opacity_logits")
    }
    for f, d in moved.items():
        assert d > 0, (f, moved)


def test_band_plan_matches_render_band(rng):
    """A band plan + fresh extract reproduces the tile-sharded exact
    band render bit-for-bit (prefilter + slice + band streams frozen,
    attributes fresh) — the per-device resort of the lazy sharded
    path."""
    from gsjax.parallel.render_sharded import _render_band
    from gsjax.render.lazy import build_band_plan

    g = make_random_scene(rng, n=3000, sh_degree=1, spread=2.2,
                          z_range=(3.0, 9.0))
    cam = _cam()
    band = CFG.tiles_y(cam.height) // 2
    for ty0 in (0, band):
        img_e, _ = jax.jit(
            lambda g, t: _render_band(g, cam, CFG, t, band)
        )(g, jnp.int32(ty0))
        plan = build_band_plan(g, cam, CFG, ty0, band)
        assert int(plan.ovf["n_band_overflow"]) == 0
        hp = extract_home(g, plan)
        img_l = jax.jit(
            lambda hp, p: lazy_render(hp, cam, CFG, p)
        )(hp, plan)
        np.testing.assert_allclose(
            np.asarray(img_l), np.asarray(img_e[:, : cam.width]),
            atol=2e-5,
        )


def test_fold_back_mean_vs_sum(rng):
    """A uniform per-row delta folds back to exactly that delta under
    reduce='mean' (row count cancels), and to count x delta under
    'sum'."""
    g = make_random_scene(rng, n=1200, sh_degree=0, spread=2.2,
                          z_range=(3.0, 9.0))
    cam = _cam()
    plan = build_frame_plan(g, cam, CFG)
    hp = extract_home(g, plan)
    eps = 1e-3
    hp2 = dataclasses.replace(hp, means=hp.means + eps)
    gm = fold_back(g, hp2, hp, plan, reduce="mean")
    live = np.asarray(plan.pidx) < plan.n
    touched = np.unique(np.asarray(plan.pidx)[live])
    dm = np.asarray(gm.means - g.means)
    np.testing.assert_allclose(dm[touched], eps, rtol=1e-3)
    # splats with no live rows (culled/truncated) receive nothing
    untouched = np.setdiff1d(np.arange(plan.n), touched)
    if untouched.size:
        np.testing.assert_allclose(dm[untouched], 0.0, atol=1e-9)
    # snapshot-free mode (hp0=None): the fold re-derives the resort-time
    # home state from the master — identical result
    gm2 = fold_back(g, hp2, None, plan, reduce="mean")
    np.testing.assert_allclose(
        np.asarray(gm2.means), np.asarray(gm.means), atol=1e-7
    )
    gs = fold_back(g, hp2, hp, plan, reduce="sum")
    ds = np.asarray(gs.means - g.means)
    cnt = np.bincount(np.asarray(plan.pidx)[live], minlength=plan.n + 1)[:-1]
    np.testing.assert_allclose(
        ds[touched],
        np.broadcast_to(eps * cnt[touched][:, None], ds[touched].shape),
        rtol=1e-3,
    )
