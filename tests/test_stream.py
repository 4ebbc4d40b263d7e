"""Stream backend (render/pallas_stream.py) vs the XLA backend.

The stream backend must reproduce the XLA backend closely (same pair
enumeration per binning anchor equivalence, same blend semantics, f32
attributes; only the accumulation order differs) — forward AND
gradients, over one and several tile rows.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import make_random_scene

from gsjax import Camera, RenderConfig, render


def _cams(w, h):
    return Camera.create(
        position=(0.0, 0.0, 0.0),
        quat=(1.0, 0.0, 0.0, 0.0),
        fx=80.0,
        fy=80.0,
        width=w,
        height=h,
    )


def _cfgs(chunk=32):
    cfg_x = RenderConfig(backend="xla", tile_list_cap=256, chunk=chunk)
    cfg_s = RenderConfig(backend="stream", chunk=chunk)
    return cfg_x, cfg_s


@pytest.mark.parametrize(
    "w,h",
    [(48, 16), (96, 64)],
    ids=["one-band-row", "multi-band-multi-block"],
)
def test_stream_forward_matches_xla(rng, w, h):
    g = make_random_scene(rng, n=400, sh_degree=1, spread=1.3, z_range=(3.0, 9.0))
    cam = _cams(w, h)
    cfg_x, cfg_s = _cfgs()
    ix = render(g, cam, cfg_x)
    s, aux = render(g, cam, cfg_s, return_aux=True)
    assert int(aux["n_pair_overflow"]) == 0
    d = np.abs(np.asarray(ix) - np.asarray(s))
    # accumulation-order rounding can flip alpha_min / termination
    # inclusion for isolated splat-pixel pairs — a real discontinuity of
    # the renderer, not an error; bound the bulk tightly and the flips
    # loosely
    assert (d > 5e-4).mean() < 0.01, (d > 5e-4).mean()
    assert d.max() < 5e-3, d.max()


def test_stream_forward_fat_splats_exact(rng):
    """Footprints spanning many tiles must match the UNCLAMPED oracle:
    exact mode splits fat splats into per-block home rows so the full
    rect renders (VERDICT round-1 Missing #1 — the span-3 ceiling)."""
    g = make_random_scene(rng, n=200, spread=1.0, z_range=(2.0, 6.0))
    g = dataclasses.replace(g, log_scales=g.log_scales + 2.0)
    cam = _cams(96, 64)
    _, cfg_s = _cfgs()
    cfg_s = dataclasses.replace(
        cfg_s, fat_max_blocks=64, fat_cap=2048
    )
    s, aux = render(g, cam, cfg_s, return_aux=True)
    assert int(aux["n_fat_overflow"]) == 0
    assert int(aux["n_band_overflow"]) == 0
    io = render(g, cam, RenderConfig(backend="oracle"))
    d = np.abs(np.asarray(io) - np.asarray(s))
    assert np.percentile(d, 99.5) < 5e-4, np.percentile(d, 99.5)
    assert d.max() < 1e-2, d.max()


def test_fat_splat_1024px_reach(rng):
    """One megasplat whose footprint covers the whole image (≙ the
    reference's 1024-px screen-axis reach, vertex.glsl.ts:173-175) —
    must match the unclamped oracle, not a 3×3-tile crop of itself."""
    import numpy as onp
    from gsjax import Gaussians

    n = 32
    means = onp.stack(
        [
            rng.uniform(-1, 1, n),
            rng.uniform(-1, 1, n),
            rng.uniform(4.0, 8.0, n),
        ],
        axis=-1,
    )
    scales = onp.full((n, 3), 0.04)
    scales[0] = 2.5  # radius ≈ 3·2.5·80/4 ≈ 150 px ≫ the 96-px image
    means[0] = (0.0, 0.0, 4.0)
    quats = rng.normal(size=(n, 4))
    quats /= onp.linalg.norm(quats, axis=-1, keepdims=True)
    sh = rng.normal(size=(n, 1, 3)) * 0.3 + 0.4
    g = Gaussians.from_activated(
        means=means, scales=scales, quats=quats,
        opacities=rng.uniform(0.3, 0.8, n), sh=sh,
    )
    cam = _cams(96, 64)
    _, cfg_s = _cfgs()
    cfg_s = dataclasses.replace(
        cfg_s, fat_max_blocks=256, fat_cap=512
    )
    s, aux = render(g, cam, cfg_s, return_aux=True)
    assert int(aux["n_fat_overflow"]) == 0
    io = render(g, cam, RenderConfig(backend="oracle"))
    d = np.abs(np.asarray(io) - np.asarray(s))
    assert d.max() < 5e-3, d.max()


def test_fat_overflow_is_counted(rng):
    g = make_random_scene(rng, n=64, spread=0.8, z_range=(2.0, 5.0))
    g = dataclasses.replace(g, log_scales=g.log_scales + 2.5)
    cam = _cams(96, 64)
    _, cfg_s = _cfgs()
    cfg_s = dataclasses.replace(
        cfg_s, fat_max_blocks=4, fat_cap=8, fat_live_cap=8
    )
    _, aux = render(g, cam, cfg_s, return_aux=True)
    assert int(aux["n_fat_overflow"]) > 0


def test_stream_grads_match_xla(rng):
    g = make_random_scene(rng, n=300, sh_degree=1, spread=1.2, z_range=(3.0, 8.0))
    cam = _cams(96, 64)
    tgt = jnp.asarray(rng.uniform(0, 1, (64, 96, 3)), jnp.float32)
    cfg_x, cfg_s = _cfgs()

    def loss(g, cfg):
        img = render(g, cam, cfg)
        return jnp.mean((img - tgt) ** 2)

    gx = jax.grad(lambda g: loss(g, cfg_x))(g)
    gs = jax.grad(lambda g: loss(g, cfg_s))(g)
    for f in ["means", "log_scales", "quats", "sh", "opacity_logits"]:
        a, b = np.asarray(getattr(gx, f)), np.asarray(getattr(gs, f))
        peak = np.abs(a).max() + 1e-12
        rel = np.abs(a - b) / peak
        # bulk must agree tightly; inclusion-threshold flips change a few
        # splats' gradients discontinuously (same property vs graphdeco)
        assert np.percentile(rel, 99) < 5e-3, (f, np.percentile(rel, 99))
        assert rel.max() < 1e-1, (f, rel.max())


def test_home_anchor_equals_rect_anchor(rng):
    """Legacy span-budget mode: both anchors enumerate the identical
    clamped (tile, depth) pair set."""
    from gsjax.render.binning import build_tile_bins
    from gsjax.render.project import project

    g = make_random_scene(rng, n=800, spread=1.5, z_range=(2.0, 9.0))
    g = dataclasses.replace(g, log_scales=g.log_scales + 1.0)
    cam = _cams(96, 64)
    cfg = RenderConfig(footprint_clamp=True)
    p = project(g, cam, cfg)
    br = build_tile_bins(p, cam, cfg, anchor="rect")
    bh = build_tile_bins(p, cam, cfg, anchor="home")
    k = cfg.tile_span**2
    np.testing.assert_array_equal(
        np.asarray(br.tile_starts), np.asarray(bh.tile_starts)
    )
    n = int(br.n_pairs)
    np.testing.assert_array_equal(
        np.asarray(br.pid_sorted[:n]) // k, np.asarray(bh.pid_sorted[:n]) // k
    )
