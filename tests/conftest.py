"""Test environment: force CPU with 8 virtual devices (the standard JAX
trick for exercising shard_map code without several GPUs — SURVEY §4).
Must run before jax is imported anywhere.

`GSJAX_TEST_PLATFORM=gpu` leaves the platform to JAX instead, for the
GPU-marked tests on a card: `GSJAX_TEST_PLATFORM=gpu pytest tests -m gpu`.
Which tests need a card is decided inside fixtures, never here."""

import os

PLATFORM = os.environ.get("GSJAX_TEST_PLATFORM", "cpu")
if PLATFORM == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if PLATFORM == "cpu":
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def make_random_scene(rng, n=64, sh_degree=0, spread=1.0, z_range=(4.0, 8.0)):
    """Random splats in front of the default camera (which looks down +z
    from the origin)."""
    from gsjax import Gaussians

    means = np.stack(
        [
            rng.uniform(-spread, spread, n),
            rng.uniform(-spread, spread, n),
            rng.uniform(*z_range, n),
        ],
        axis=-1,
    )
    scales = rng.uniform(0.02, 0.12, (n, 3))
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rng.uniform(0.3, 0.95, n)
    k = {0: 1, 1: 4, 2: 9, 3: 16}[sh_degree]
    sh = rng.normal(size=(n, k, 3)) * 0.3
    sh[:, 0, :] = rng.uniform(-0.5, 1.5, (n, 3))
    return Gaussians.from_activated(
        means=means, scales=scales, quats=quats, opacities=opac, sh=sh
    )


@pytest.fixture
def small_scene(rng):
    return make_random_scene(rng, n=64)


@pytest.fixture
def default_camera():
    from gsjax import Camera

    return Camera.create(
        position=(0.0, 0.0, 0.0),
        quat=(1.0, 0.0, 0.0, 0.0),
        fx=100.0,
        fy=100.0,
        width=64,
        height=48,
    )
