"""Scene transform tests: renders must commute with the inverse camera
motion (the strongest possible check — ≙ Scene.translate/rotate/scale
semantics, /root/reference/src/core/Scene.ts:182-305)."""

import numpy as np
import jax.numpy as jnp
import pytest

from gsjax import Camera, RenderConfig, render_oracle, transforms
from conftest import make_random_scene

CFG = RenderConfig(backend="oracle")


def _cam(**kw):
    return Camera.create(fx=100, fy=100, width=64, height=48, **kw)


def test_translate_matches_camera_shift(rng):
    g = make_random_scene(rng, n=40)
    img0 = np.asarray(render_oracle(g, _cam(), CFG))
    g2 = transforms.translate(g, (0.5, -0.2, 0.1))
    img1 = np.asarray(render_oracle(g2, _cam(position=(0.5, -0.2, 0.1)), CFG))
    np.testing.assert_allclose(img1, img0, atol=1e-5)


def test_rotate_matches_camera_rotation(rng):
    g = make_random_scene(rng, n=40)
    q = np.array([0.9, 0.1, -0.2, 0.15])
    q /= np.linalg.norm(q)
    img0 = np.asarray(render_oracle(g, _cam(), CFG))
    g2 = transforms.rotate(g, q)
    img1 = np.asarray(render_oracle(g2, _cam(quat=q), CFG))
    np.testing.assert_allclose(img1, img0, atol=1e-4)


def test_scale_projective_identity(rng):
    """Exact check: x_px = fx·x/z is invariant under x,z → s·x, s·z and
    σ_px = fx·σ/z likewise, so scaling scene AND camera position by s is
    an exact render identity."""
    g = make_random_scene(rng, n=40)
    cam0 = _cam(position=(0.3, -0.1, -0.4))
    img0 = np.asarray(render_oracle(g, cam0, CFG))
    s = 1.7
    g2 = transforms.scale(g, s)
    cam1 = _cam(position=(0.3 * s, -0.1 * s, -0.4 * s))
    img1 = np.asarray(render_oracle(g2, cam1, CFG))
    np.testing.assert_allclose(img1, img0, atol=1e-4)


def test_limit_box_soft_deletes(rng):
    g = make_random_scene(rng, n=40)
    g2 = transforms.limit_box(g, -0.2, 0.2, -0.2, 0.2, 0.0, 100.0)
    m = np.asarray(g.means)
    inside = (np.abs(m[:, 0]) <= 0.2) & (np.abs(m[:, 1]) <= 0.2)
    op = np.asarray(g2.opacities)
    assert np.all(op[~inside] < 1e-8)
    np.testing.assert_allclose(op[inside], np.asarray(g.opacities)[inside], atol=1e-6)
    with pytest.raises(ValueError):
        transforms.limit_box(g, 1, -1, 0, 1, 0, 1)


def test_crop_box_drops_rows(rng):
    g = make_random_scene(rng, n=40)
    g2 = transforms.crop_box(g, -0.5, 0.5, -0.5, 0.5, 0.0, 100.0)
    m = np.asarray(g2.means)
    assert g2.n < 40
    assert np.all(np.abs(m[:, 0]) <= 0.5) and np.all(np.abs(m[:, 1]) <= 0.5)


def test_rotated_means_match_float64(rng):
    """The rotation is pinned to full f32 precision (a default-precision
    f32 matmul may run in TF32 on the GPU, ~1e-3 relative)."""
    g = make_random_scene(rng, n=200, spread=50.0, z_range=(100.0, 900.0))
    q = np.array([0.8, -0.3, 0.4, 0.2])
    q /= np.linalg.norm(q)
    w, x, y, z = q
    R = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
    want = np.asarray(g.means, np.float64) @ R.T
    got = np.asarray(transforms.rotate(g, q).means, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
