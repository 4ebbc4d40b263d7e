"""Banded scene store: per-SH-degree splat groups without zero padding.

The reference's quantized PLY partitions the scene into 4 groups by
active SH band count and keeps per-group coefficient buffers + a
`bandsIndices` uniform so low-band splats store and evaluate less
(/root/reference/src/loaders/PLYLoader.ts:1190-1195 and
vertex.glsl.ts:180-189). The round-1 loader zero-padded every group to
K=16 — a band-0 splat carried 192 B of dead SH (≈1 GB at 5M splats) and
paid full degree-3 evaluation.

`BandedGaussians` is the equivalent here: an ordered tuple of
`Gaussians` groups, each with its OWN K ∈ {1, 4, 9, 16}. Projection runs
per group (static shapes per group → one fused elementwise XLA kernel
each, evaluating only that group's basis functions) and concatenates the
projected splats — everything downstream (binning, blending, gradients)
is band-oblivious. Groups stay differentiable leaves, so training a
banded scene works unchanged.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from gsjax.core.gaussians import Gaussians


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["groups"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class BandedGaussians:
    """Splat groups in ascending band order (matching the quantized PLY's
    vertex_0..vertex_3 layout; empty groups are dropped). Group order is
    the scene's splat order: group i's splats precede group i+1's."""

    groups: tuple  # tuple[Gaussians, ...]

    @property
    def n(self) -> int:
        return sum(g.n for g in self.groups)

    @property
    def sh_degree(self) -> int:
        return max(g.sh_degree for g in self.groups)

    @property
    def band_counts(self) -> tuple:
        """Splats per group (≙ the reference's bandsIndices deltas)."""
        return tuple(g.n for g in self.groups)

    def to_gaussians(self) -> Gaussians:
        """Concatenate into one zero-padded Gaussians (max degree) —
        the round-1 representation, kept for export and interop."""
        out = self.groups[0].with_sh_degree(self.sh_degree)
        for g in self.groups[1:]:
            out = out.concat(g)
        return out

    @staticmethod
    def from_groups(groups) -> "BandedGaussians":
        gs = tuple(g for g in groups if g.n > 0)
        if not gs:
            raise ValueError("BandedGaussians needs at least one splat")
        return BandedGaussians(groups=gs)

    def sh_bytes(self) -> int:
        """Actual SH storage (the point of banding: no zero padding)."""
        return sum(g.sh.size * g.sh.dtype.itemsize for g in self.groups)


def project_banded(bg: BandedGaussians, cam, cfg):
    """ProjectedSplats over all groups, evaluated per band degree
    (≙ vertex.glsl.ts:180-189 branching on u_bandIndex — here each group
    is its own statically-shaped projection, so a band-0 group never
    touches the degree-3 polynomial at all)."""
    from gsjax.render.project import project

    parts = [project(g, cam, cfg) for g in bg.groups]
    if len(parts) == 1:
        return parts[0]
    return jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *parts)
