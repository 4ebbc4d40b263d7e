"""Numerical bound on the copy-row gradient reduction at bench-scale
copy counts: a reduction by prefix differencing suffers cancellation
proportional to the running prefix (a global cumsum measured 242x
relative error on small segments at 1M copy rows with mixed
magnitudes); homesort.reduce_copy_segments' segment sum keeps each
sum's error relative to its own segment."""

import numpy as np
import jax.numpy as jnp

from gsjax.render.homesort import _home_gather_bwd


def test_copy_row_grad_reduction_1m_rows():
    rng = np.random.default_rng(0)
    n = 300_000
    lens = np.minimum(rng.poisson(1_000_000 / n, n), 255).astype(np.int64)
    base = np.concatenate([[0], np.cumsum(lens)])
    f = int(base[-1])
    seg_base = base.astype(np.int32)
    # adversarial magnitudes: lognormal spread so the global prefix walk
    # dwarfs small segments' own sums
    d_tail = rng.normal(size=(f, 3)).astype(np.float32) * rng.lognormal(
        0, 2, size=(f, 1)
    ).astype(np.float32)
    d = np.concatenate([np.zeros((n, 3), np.float32), d_tail])
    res = (
        n,
        f,
        jnp.arange(n, dtype=jnp.int32),
        (n + jnp.arange(f, dtype=jnp.int32)),
        jnp.asarray(seg_base),
    )
    dx = np.asarray(_home_gather_bwd(res, jnp.asarray(d))[0])

    ref = np.add.reduceat(d_tail.astype(np.float64), seg_base[:-1], axis=0)
    ref[lens == 0] = 0.0
    err = np.abs(dx - ref)
    rel = err / np.maximum(np.abs(ref), 1e-6)
    # a global cumsum measured max_abs ~0.03, max_rel ~242 on this exact
    # distribution; the segment sum's error is relative to each
    # segment's own magnitude
    assert err.max() < 0.02, err.max()
    assert rel.max() < 1e-2, rel.max()
    own = np.add.reduceat(np.abs(d_tail.astype(np.float64)), seg_base[:-1],
                          axis=0)
    own[lens == 0] = 1.0
    assert (err / own).max() < 1e-6, (err / own).max()


def test_copy_row_grad_reduction_exact_small():
    rng = np.random.default_rng(1)
    n, maxlen = 500, 7
    lens = rng.integers(0, maxlen, n)
    base = np.concatenate([[0], np.cumsum(lens)])
    f = int(base[-1])
    d_tail = rng.normal(size=(f, 2)).astype(np.float32)
    d = np.concatenate([np.zeros((n, 2), np.float32), d_tail])
    res = (
        n,
        f,
        jnp.arange(n, dtype=jnp.int32),
        (n + jnp.arange(f, dtype=jnp.int32)),
        jnp.asarray(base.astype(np.int32)),
    )
    dx = np.asarray(_home_gather_bwd(res, jnp.asarray(d))[0])
    ref = np.add.reduceat(d_tail.astype(np.float64), base[:-1], axis=0)
    ref[lens == 0] = 0.0
    np.testing.assert_allclose(dx, ref, rtol=1e-5, atol=1e-5)
