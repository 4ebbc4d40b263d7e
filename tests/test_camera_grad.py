"""Camera differentiability: render() is differentiable w.r.t. the
camera pose (position, quat) and intrinsics (fx, fy) on every backend
(the claim at render/pipeline.py). Ground truth = oracle autodiff.

Camera gradients flow only through projection (mean2d/conic/rgb); the
layout machinery
(home sort keys, tile ids, segment starts) is integer-valued so no
cotangent can leak through it. These tests prove the chain is complete.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import make_random_scene

from gsjax import Camera, RenderConfig, render


def _cam(w=96, h=64):
    # generic pose: slightly rotated/offset so no splat sits exactly on a
    # tile boundary (binning decisions are piecewise-constant there)
    q = np.array([0.99, 0.02, -0.03, 0.015])
    q = q / np.linalg.norm(q)
    return Camera.create(
        position=(0.05, -0.04, 0.03),
        quat=tuple(q),
        fx=83.0,
        fy=79.0,
        width=w,
        height=h,
    )


def _loss_fn(g, tgt, cfg):
    def loss(cam):
        img = render(g, cam, cfg)
        return jnp.mean((img - tgt) ** 2)

    return loss


CFGS = {
    "xla": RenderConfig(backend="xla", tile_list_cap=256, chunk=32),
    "stream": RenderConfig(backend="stream", chunk=32),
}


@pytest.mark.parametrize("backend", list(CFGS))
def test_camera_grads_match_oracle(rng, backend):
    g = make_random_scene(rng, n=250, sh_degree=1, spread=1.2, z_range=(3.0, 8.0))
    cam = _cam()
    tgt = jnp.asarray(rng.uniform(0, 1, (64, 96, 3)), jnp.float32)

    go = jax.grad(_loss_fn(g, tgt, RenderConfig(backend="oracle")))(cam)
    gb = jax.grad(_loss_fn(g, tgt, CFGS[backend]))(cam)

    for f in ("position", "quat", "fx", "fy"):
        a = np.asarray(getattr(go, f), np.float64).ravel()
        b = np.asarray(getattr(gb, f), np.float64).ravel()
        peak = np.abs(a).max() + 1e-12
        assert peak > 0, f"oracle produced zero {f} gradient (dead chain?)"
        rel = np.abs(a - b) / peak
        assert rel.max() < 2e-2, (f, rel.max(), a, b)


def test_camera_grads_nonzero_every_leaf(rng):
    """Every camera leaf must receive a nonzero cotangent (a silently
    dead path — e.g. grads cut by an int conversion — would zero it)."""
    g = make_random_scene(rng, n=120, sh_degree=0, spread=1.0, z_range=(3.0, 7.0))
    cam = _cam(64, 48)
    tgt = jnp.zeros((48, 64, 3), jnp.float32)
    gc = jax.grad(_loss_fn(g, tgt, CFGS["stream"]))(cam)
    for f in ("position", "quat", "fx", "fy"):
        assert np.abs(np.asarray(getattr(gc, f))).max() > 0, f


def test_camera_grad_finite_difference(rng):
    """fx gradient against a central finite difference on the xla
    backend — an oracle-independent anchor."""
    g = make_random_scene(rng, n=150, sh_degree=0, spread=1.0, z_range=(3.0, 7.0))
    cam = _cam(64, 48)
    tgt = jnp.asarray(rng.uniform(0, 1, (48, 64, 3)), jnp.float32)
    cfg = CFGS["xla"]
    loss = _loss_fn(g, tgt, cfg)

    gfx = float(jax.grad(loss)(cam).fx)
    eps = 0.05
    import dataclasses

    lp = float(loss(dataclasses.replace(cam, fx=cam.fx + eps)))
    lm = float(loss(dataclasses.replace(cam, fx=cam.fx - eps)))
    fd = (lp - lm) / (2 * eps)
    # FD through a renderer with inclusion discontinuities (alpha_min /
    # termination flips inside ±eps) is noisy; this anchors sign+magnitude
    assert abs(gfx - fd) < 0.15 * abs(fd) + 1e-5, (gfx, fd)
