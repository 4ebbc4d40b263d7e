"""Synthetic benchmark scenes.

The environment has no network access, so the Bonsai/garden scenes named
in BASELINE.md cannot be downloaded; these generators produce scenes with
matched statistics (splat count, screen-space footprint distribution,
central clustering → high overdraw in the image center, like a captured
object scan)."""

from __future__ import annotations

import numpy as np

from gsjax.core.camera import Camera
from gsjax.core.gaussians import Gaussians


def bonsai_like(n: int = 1_200_000, seed: int = 0, sh_degree: int = 0) -> Gaussians:
    """~Bonsai-scale scene: dense central object + sparse surroundings.

    Two statistics are deliberately bounded to match a *trained* capture
    (the BASELINE workload is bonsai-7k.splat, a converged 3DGS scene):
      - the surrounding shell stays INSIDE the camera orbit radius (~4):
        real object captures are photographed from outside the
        reconstruction and training prunes floaters at the lens, so no
        splat sits at z ≈ 0 where perspective would blow its footprint
        onto hundreds of tiles;
      - the log-normal scale tail is clamped at 0.04 world units:
        densification in 3DGS training splits oversized gaussians
        (graphdeco's percent_dense threshold), so converged scenes have
        no unbounded size tail. Without these bounds the generator puts
        >48 px footprints on half the scene, which no real Bonsai
        reconstruction exhibits."""
    rng = np.random.default_rng(seed)
    n_core = int(n * 0.8)
    n_bg = n - n_core
    core = rng.normal(0.0, 0.6, (n_core, 3)) * np.array([1.0, 0.8, 1.0])
    bg_dir = rng.normal(size=(n_bg, 3))
    bg_dir /= np.linalg.norm(bg_dir, axis=-1, keepdims=True)
    bg = bg_dir * rng.uniform(1.5, 3.4, (n_bg, 1))
    means = np.concatenate([core, bg]).astype(np.float32)

    # log-normal scale distribution: mostly tiny splats, tail clamped
    # like a converged reconstruction (see docstring)
    scales = np.minimum(
        np.exp(rng.normal(-4.6, 0.8, (n, 3))), 0.04
    ).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    opac = rng.beta(2.0, 2.0, n).astype(np.float32) * 0.98 + 0.01
    k = {0: 1, 1: 4, 2: 9, 3: 16}[sh_degree]
    sh = (rng.normal(0, 0.25, (n, k, 3))).astype(np.float32)
    sh[:, 0, :] = rng.uniform(-0.8, 1.8, (n, 3))
    return Gaussians.from_activated(
        means=means, scales=scales, quats=q, opacities=opac, sh=sh
    )


def garden_like(n: int = 5_000_000, seed: int = 1, sh_degree: int = 2) -> Gaussians:
    """~garden/bicycle-scale scene (BASELINE config 4): an outdoor scan —
    ground plane + central subject + surrounding shrubbery — with the
    splat-size distribution shrunk as 1/sqrt(n/1.2M) so total splat AREA
    (hence overdraw) matches a real capture: denser reconstructions use
    proportionally smaller primitives (a 5M-splat scan of the same scene
    has ~2x smaller splats than a 1.2M one, not the same sizes 4x over)."""
    rng = np.random.default_rng(seed)
    n_ground = int(n * 0.35)
    n_core = int(n * 0.35)
    n_shrub = n - n_ground - n_core
    gx = rng.uniform(-6.0, 6.0, (n_ground, 1))
    gz = rng.uniform(-6.0, 6.0, (n_ground, 1))
    gy = rng.normal(0.9, 0.05, (n_ground, 1))
    ground = np.concatenate([gx, gy, gz], axis=1)
    core = rng.normal(0.0, 0.7, (n_core, 3)) * np.array([1.2, 0.9, 1.2])
    sd = rng.normal(size=(n_shrub, 3)) * np.array([1.0, 0.3, 1.0])
    sd /= np.linalg.norm(sd, axis=-1, keepdims=True) + 1e-9
    shrub = sd * rng.uniform(2.0, 7.0, (n_shrub, 1)) + np.array([0.0, 0.4, 0.0])
    means = np.concatenate([ground, core, shrub]).astype(np.float32)

    size_shift = -0.5 * np.log(n / 1_200_000)
    scales = np.exp(rng.normal(-4.6 + size_shift, 0.8, (n, 3))).astype(
        np.float32
    )
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    opac = rng.beta(2.0, 2.0, n).astype(np.float32) * 0.98 + 0.01
    k = {0: 1, 1: 4, 2: 9, 3: 16}[sh_degree]
    sh = (rng.normal(0, 0.25, (n, k, 3))).astype(np.float32)
    sh[:, 0, :] = rng.uniform(-0.8, 1.8, (n, 3))
    return Gaussians.from_activated(
        means=means, scales=scales, quats=q, opacities=opac, sh=sh
    )


def bench_camera(width: int = 1920, height: int = 1080) -> Camera:
    """1080p camera orbiting the synthetic object (BASELINE config 3)."""
    return Camera.look_at(
        position=(0.0, -0.6, -4.0),
        target=(0.0, 0.0, 0.0),
        fx=1600.0,
        fy=1600.0,
        width=width,
        height=height,
    )
