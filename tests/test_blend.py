"""The stream backend's Triton blend (interpret mode on CPU) against
composite.blend_padded on the same pair stream — the checks chip_smoke.py
runs on the card at bonsai scale, here at test size — and the jnp
prologue stages that replaced the layout kernels."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import make_random_scene

from gsjax import Camera, Gaussians, RenderConfig, render
from gsjax.bench import blend_check as bc

CFG = RenderConfig(backend="stream", chunk=32)


def _cam(w=64, h=48):
    return Camera.create(
        position=(0.0, 0.0, 0.0), quat=(1.0, 0.0, 0.0, 0.0),
        fx=70.0, fy=70.0, width=w, height=h,
    )


def _stream(g, cam, cfg=CFG):
    cols, pid, starts, counters = bc.frame_stream(g, cam, cfg)
    assert all(int(v) == 0 for v in counters.values()), counters
    return cols, pid, starts


@pytest.mark.parametrize("w,h", [(32, 16), (64, 48)], ids=["2x1", "4x3"])
def test_triton_blend_forward_matches_reference(rng, w, h):
    g = make_random_scene(rng, n=300, spread=1.0, z_range=(3.0, 8.0))
    cam = _cam(w, h)
    cols, pid, starts = _stream(g, cam)
    tiles_x, tiles_y = CFG.tiles_x(w), CFG.tiles_y(h)
    err = bc.compare_blend(cols, pid, starts, 0, tiles_y, tiles_x, CFG)
    assert err["pairs"] > 0
    assert err["fwd_err"] <= bc.FWD_LIMIT, err
    assert err["T_err"] <= bc.FWD_LIMIT, err


def test_triton_blend_grads_match_reference(rng):
    g = make_random_scene(rng, n=256, sh_degree=1, spread=1.0,
                          z_range=(3.0, 8.0))
    cam = _cam()
    cols, pid, starts = _stream(g, cam)
    # a band of the frame: the kernel walks only the band's segments
    err = bc.compare_blend(cols, pid, starts, 1, 2, CFG.tiles_x(64), CFG)
    assert bc.within_limits(err), err


def test_triton_blend_early_termination(rng):
    """Dense occluders: the kernel's early exit must not change results
    (image and transmittance vs the XLA backend, with a background)."""
    n = 48
    g = Gaussians.from_activated(
        means=np.concatenate(
            [rng.normal(0, 0.01, (n, 2)), np.linspace(4, 6, n)[:, None]],
            axis=1,
        ),
        scales=np.full((n, 3), 0.2),
        quats=np.tile(np.array([1.0, 0, 0, 0]), (n, 1)),
        opacities=np.full(n, 0.97),
        rgb=rng.uniform(0, 1, (n, 3)),
    )
    cam = _cam()
    bg = (0.3, 0.2, 0.1)
    cs = dataclasses.replace(CFG, background=bg)
    cx = RenderConfig(backend="xla", tile_list_cap=256, chunk=32,
                      background=bg)
    i_s, a_s = render(g, cam, cs, return_aux=True)
    i_x, a_x = render(g, cam, cx, return_aux=True)
    np.testing.assert_allclose(np.asarray(i_s), np.asarray(i_x), atol=2e-5)
    np.testing.assert_allclose(
        np.asarray(a_s["transmittance"]), np.asarray(a_x["transmittance"]),
        atol=2e-5,
    )
    # the stack saturates: most of the centre is terminated
    assert float(np.asarray(a_s["transmittance"]).min()) < 1e-3


def test_triton_blend_dead_pairs_and_empty_tiles(rng):
    """Repack pads (home row >= NH), pairs past the stream's end and empty
    tiles contribute nothing, forward or backward."""
    from gsjax.render.pallas_stream import blend_stream

    nh, tiles_x, rows = 40, 4, 2
    k = 9
    mx = rng.uniform(2, 14, nh)
    mx[7] += 32  # row 7 sits in tile 2
    cols = tuple(
        jnp.asarray(c, jnp.float32)
        for c in (
            mx, rng.uniform(2, 14, nh),
            np.full(nh, 0.05), np.zeros(nh), np.full(nh, 0.05),
            rng.uniform(0, 1, nh), rng.uniform(0, 1, nh),
            rng.uniform(0, 1, nh), np.full(nh, 0.6),
        )
    )
    # tile 0: rows 0-4, tile 1: empty, tile 2: a pad + row 7, rest empty;
    # the stream ends at 7 and its tail holds a real-looking pair id
    pid = jnp.asarray([0 * k, 1 * k, 2 * k, 3 * k, 4 * k,
                       nh * k, 7 * k + 4, 9 * k], jnp.int32)
    starts = jnp.asarray([0, 5, 5, 7, 7, 7, 7, 7, 7], jnp.int32)
    cfg = CFG

    def loss(cols):
        img, T = blend_stream(cols, pid, starts, jnp.int32(0), tiles_x,
                              rows, cfg)
        return jnp.sum(img) + jnp.sum(T), (img, T)

    (_, (img, T)), g = jax.value_and_grad(loss, has_aux=True)(cols)
    img, T = np.asarray(img), np.asarray(T)
    assert np.all(img[[1, 3, 4, 5, 6, 7]] == 0.0)
    assert np.all(T[[1, 3, 4, 5, 6, 7]] == 1.0)
    g = np.stack([np.asarray(c) for c in g])
    live = {0, 1, 2, 3, 4, 7}
    dead = [r for r in range(nh) if r not in live]
    assert np.all(g[:, dead] == 0.0)  # row 9 (tail) and the rest
    assert np.all(np.abs(g[:, sorted(live)]).max(axis=0) > 0)
    ref = bc.reference_blend(cols, pid, starts, jnp.int32(0), tiles_x, rows,
                             cfg, 32)
    np.testing.assert_allclose(img, np.asarray(ref[0]), atol=2e-5)


def test_stream_forward_f32_tight(rng):
    """f32 attributes end to end: stream vs xla agree to accumulation
    order (the stream path reads the same f32 columns)."""
    g = make_random_scene(rng, n=400, sh_degree=1, spread=1.3,
                          z_range=(3.0, 9.0))
    cam = _cam()
    ix = np.asarray(
        render(g, cam, RenderConfig(backend="xla", tile_list_cap=256,
                                    chunk=32))
    )
    s, aux = render(g, cam, CFG, return_aux=True)
    assert int(aux["n_pair_overflow"]) == 0
    assert np.abs(ix - np.asarray(s)).max() < 2e-5


def _expand_loop(home_x, home_y, win, valid, mean2d, conic, opacity,
                 ty0, band_rows, tiles_x, ts, span, alpha_min):
    """numpy per-(row, class) loop of the exact-mode pair expansion."""
    from gsjax.render.binning import INVALID_TILE

    n = home_x.shape[0]
    k = span * span
    h = span // 2
    out = np.full((k, n), int(INVALID_TILE), np.int64)
    for r in range(n):
        if not valid[r]:
            continue
        mx, my = float(mean2d[r, 0]), float(mean2d[r, 1])
        a, b, c = (float(v) for v in conic[r])
        thr = 2.0 * np.log(max(float(opacity[r]), alpha_min) / alpha_min) + 1e-3
        for cl in range(k):
            tx = int(home_x[r]) + cl % span - h
            ty = int(home_y[r]) + cl // span - h
            if not (win[r, 0] <= tx < win[r, 1] and win[r, 2] <= ty < win[r, 3]
                    and ty0 <= ty < ty0 + band_rows):
                continue
            # sampled minimum over the tile's continuous pixel rect
            s = np.linspace(0.0, ts - 1.0, 4 * (ts - 1) + 1)
            dx, dy = np.meshgrid(tx * ts + s - mx, ty * ts + s - my)
            q = a * dx * dx + 2 * b * dx * dy + c * dy * dy
            if q.min() <= thr:
                out[cl, r] = (ty - ty0) * tiles_x + tx
    return out


def test_expand_home_pairs_matches_numpy_loop(rng):
    from gsjax.render.binning import expand_home_pairs
    from gsjax.render.homesort import build_home_layout
    from gsjax.render.project import project

    g = make_random_scene(rng, n=200, spread=1.2, z_range=(2.5, 7.0))
    g = dataclasses.replace(g, log_scales=g.log_scales + 0.7)
    cam = _cam()
    p = project(g, cam, CFG)
    p, layout = build_home_layout(p, cam, CFG)
    tiles_x = CFG.tiles_x(64)
    tile2d, pid2d, dbits, nh_pad = expand_home_pairs(
        p, layout, 1, 2, tiles_x, CFG
    )
    n = p.depth.shape[0]
    got = np.asarray(tile2d)[:, :n].astype(np.int64)
    want = _expand_loop(
        np.asarray(layout.home_x), np.asarray(layout.home_y),
        np.asarray(layout.win), np.asarray(p.valid), np.asarray(p.mean2d),
        np.asarray(p.conic), np.asarray(p.opacity), 1, 2, tiles_x,
        CFG.tile_size, CFG.tile_span, CFG.alpha_min,
    )
    live_w = want != int(np.iinfo(np.int32).max)
    live_g = got != int(np.iinfo(np.int32).max)
    # the closed form is the exact minimum, a lower bound of the sampled
    # one: it keeps every pair the loop keeps, and at most a few more
    assert not np.any(live_w & ~live_g)
    assert (live_g & ~live_w).sum() <= 3
    assert np.array_equal(got[live_g], want[live_g])
    assert live_g.sum() > 50
    assert np.all(np.asarray(tile2d)[:, n:] == np.iinfo(np.int32).max)
    k = CFG.tile_span ** 2
    np.testing.assert_array_equal(
        np.asarray(pid2d),
        np.arange(nh_pad)[None, :] * k + np.arange(k)[:, None],
    )


def test_fat_repeat_matches_numpy_loop(rng):
    """Copy slots resolve to their fat parent with bit-equal attribute
    rows, and each copy's block window/home decode like a loop over the
    parent's rect blocks."""
    from gsjax.render.homesort import copy_rows, fat_parents

    n, fat_cap, span = 30, 64, 3
    n_ex = rng.integers(0, 5, n) * (rng.uniform(size=n) < 0.5)
    is_fat = n_ex > 0
    base = np.cumsum(n_ex) - n_ex
    n_copies = int(n_ex.sum())
    parent = np.asarray(
        fat_parents(jnp.asarray(is_fat), jnp.asarray(base, jnp.int32),
                    fat_cap)
    )
    want_parent = np.concatenate(
        [np.full(e, i) for i, e in enumerate(n_ex) if e]
    )
    np.testing.assert_array_equal(parent[:n_copies], want_parent)

    tiles_x, tiles_y = 20, 12
    x0 = rng.integers(0, 8, n)
    y0 = rng.integers(0, 4, n)
    sbx = rng.integers(1, 4, n)
    x1 = np.minimum(x0 + span * sbx, tiles_x)
    y1 = np.minimum(y0 + span * 3, tiles_y)
    src = np.zeros((n, 18), np.float32)
    src[:, 0] = base
    src[:, 1] = rng.uniform(0, 300, n)
    src[:, 2] = rng.uniform(0, 180, n)
    src[:, 3] = rng.uniform(1e-4, 3e-3, n)
    src[:, 4] = rng.uniform(-1e-4, 1e-4, n)
    src[:, 5] = rng.uniform(1e-4, 3e-3, n)
    src[:, 6] = rng.uniform(0.2, 0.9, n)
    src[:, 7:12] = rng.uniform(0.1, 5.0, (n, 5)).astype(np.float32)
    src[:, 12], src[:, 13], src[:, 14] = sbx, x0, y0
    src[:, 15], src[:, 16], src[:, 17] = x1, y1, n_ex
    g = jnp.asarray(src)[jnp.asarray(parent)]
    tail, hk, dep, wpa, wpb = copy_rows(
        g, n_copies, tiles_x=tiles_x, tiles_y=tiles_y, span=span, ts=16,
        alpha_min=1.0 / 255.0,
    )
    tail, hk, wpa, wpb = map(np.asarray, (tail, hk, wpa, wpb))
    cols = [1, 2, 7, 3, 4, 5, 8, 9, 10, 11, 6]
    for j in range(n_copies):
        pi = want_parent[j]
        # bit-equal parent attributes in home_gather's column order
        assert np.array_equal(tail[j, :11], src[pi, cols]), j
        b = j - base[pi] + 1
        wx0 = x0[pi] + span * (b % sbx[pi])
        wy0 = y0[pi] + span * (b // sbx[pi])
        assert wpa[j] == wx0 * 16384 + min(wx0 + span, x1[pi]), j
        assert wpb[j] == wy0 * 16384 + min(wy0 + span, y1[pi]), j
        if hk[j] < tiles_x * tiles_y:
            assert hk[j] == (min(wy0 + 1, tiles_y - 1) * tiles_x
                             + min(wx0 + 1, tiles_x - 1)), j
    assert np.all(hk[n_copies:] == tiles_x * tiles_y)


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run with GSJAX_TEST_PLATFORM=gpu -m gpu")


@pytest.mark.gpu
def test_triton_blend_on_gpu(gpu, rng):
    """phase 2 of chip_smoke.py at test size: the compiled kernels
    against blend_padded on the card."""
    g = make_random_scene(rng, n=20000, sh_degree=1, spread=1.3,
                          z_range=(3.0, 9.0))
    cam = _cam(256, 192)
    cols, pid, starts = _stream(g, cam, RenderConfig(backend="stream"))
    err = bc.compare_blend(cols, pid, starts, 2, 8, 16,
                           RenderConfig(backend="stream"))
    assert bc.within_limits(err), err
