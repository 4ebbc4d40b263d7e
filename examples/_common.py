"""Shared example scaffolding: CPU platform, demo scene, output dir."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

# examples run on CPU (the GPU is for the benchmarks; see
# .claude/skills/verify/SKILL.md)
jax.config.update("jax_platforms", "cpu")

import numpy as np

from gsjax import Gaussians

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")


def out_path(*parts):
    os.makedirs(OUT, exist_ok=True)
    return os.path.join(OUT, *parts)


def demo_scene(n: int = 4000, sh_degree: int = 1, seed: int = 0) -> Gaussians:
    """A colorful synthetic blob cloud in front of the origin (stands in
    for bonsai-7k.splat, which needs network access)."""
    rng = np.random.default_rng(seed)
    means = rng.normal(0, 0.8, (n, 3)) * np.array([1.2, 0.8, 1.0])
    means[:, 2] += 4.0
    scales = rng.uniform(0.02, 0.1, (n, 3))
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rng.uniform(0.4, 0.95, n)
    k = {0: 1, 1: 4, 2: 9, 3: 16}[sh_degree]
    sh = rng.normal(size=(n, k, 3)) * 0.25
    # DC from position → smooth rainbow
    sh[:, 0, :] = 0.5 + 0.5 * np.tanh(means / 1.5)
    return Gaussians.from_activated(
        means=means, scales=scales, quats=quats, opacities=opac, sh=sh
    )


def load_or_demo(argv, **demo_kwargs) -> Gaussians:
    from gsjax import load_ply, load_splat

    if len(argv) > 1:
        path = argv[1]
        if path.endswith(".ply"):
            return load_ply(path)
        return load_splat(path)
    return demo_scene(**demo_kwargs)
