"""Scene edit operations on the Gaussians pytree.

Capability parity with the reference Scene edit ops
(/root/reference/src/core/Scene.ts):
  translate  ≙ Scene.translate (:182-195)
  rotate     ≙ Scene.rotate    (:197-257) — rotates positions about the
               origin and composes the per-splat orientation
  scale      ≙ Scene.scale     (:259-305) — uniform or per-axis scaling of
               positions and splat scales
  limit_box  ≙ Scene.limitBox  (:307-366) — soft-delete splats outside an
               AABB (here: opacity → 0, keeping shapes static under jit)
  crop_box   — hard crop (host-side, returns a smaller pytree)

The reference mutates SoA buffers and re-packs f16 textures per edit
(an O(N) CPU loop + full renderer re-init, SURVEY §3.4); here edits are
pure O(N) jnp ops on device and the covariance is recomputed inside the
next jitted render step, so no invalidation machinery is needed.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from gsjax.core.gaussians import Gaussians


def quat_multiply(q1, q2):
    """Hamilton product, (w,x,y,z) (≙ Quaternion.multiply,
    /root/reference/src/math/Quaternion.ts)."""
    w1, x1, y1, z1 = jnp.moveaxis(q1, -1, 0)
    w2, x2, y2, z2 = jnp.moveaxis(q2, -1, 0)
    return jnp.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def translate(g: Gaussians, offset) -> Gaussians:
    offset = jnp.asarray(offset, jnp.float32)
    return dataclasses.replace(g, means=g.means + offset)


def rotate(g: Gaussians, quat) -> Gaussians:
    """Rotate the whole scene by quaternion (w,x,y,z) about the origin."""
    from gsjax.core.gaussians import quat_to_rotmat

    quat = jnp.asarray(quat, jnp.float32)
    quat = quat / jnp.maximum(jnp.linalg.norm(quat), 1e-12)
    R = quat_to_rotmat(quat)
    means = jnp.matmul(g.means, R.T, precision="highest")
    quats = quat_multiply(quat[None, :], g.normalized_quats())
    return dataclasses.replace(g, means=means, quats=quats)


def scale(g: Gaussians, factor) -> Gaussians:
    """Scale the scene. Scalar factor scales positions and splat sizes
    isotropically (anisotropic scene scaling would shear rotated
    covariances, which the reference silently ignores — Scene.ts:259-305
    scales each splat axis independently of its orientation; we support
    only the well-defined isotropic case and per-axis position scaling)."""
    factor = jnp.asarray(factor, jnp.float32)
    if factor.ndim == 0:
        return dataclasses.replace(
            g,
            means=g.means * factor,
            log_scales=g.log_scales + jnp.log(factor),
        )
    return dataclasses.replace(g, means=g.means * factor)


def limit_box(g: Gaussians, xmin, xmax, ymin, ymax, zmin, zmax) -> Gaussians:
    """Soft-delete splats outside the AABB by zeroing opacity
    (≙ Scene.limitBox, Scene.ts:307-366, which drops rows). Keeps N static
    for jit; use crop_box for a hard drop."""
    if not (xmin < xmax and ymin < ymax and zmin < zmax):
        # ≙ Scene.ts:308-316 throws on inverted boxes
        raise ValueError("limit_box: min must be < max on every axis")
    m = g.means
    inside = (
        (m[:, 0] >= xmin)
        & (m[:, 0] <= xmax)
        & (m[:, 1] >= ymin)
        & (m[:, 1] <= ymax)
        & (m[:, 2] >= zmin)
        & (m[:, 2] <= zmax)
    )
    return dataclasses.replace(
        g, opacity_logits=jnp.where(inside, g.opacity_logits, -30.0)
    )


def crop_box(g: Gaussians, xmin, xmax, ymin, ymax, zmin, zmax) -> Gaussians:
    """Hard crop (host-side; result has data-dependent N)."""
    m = np.asarray(g.means)
    inside = (
        (m[:, 0] >= xmin)
        & (m[:, 0] <= xmax)
        & (m[:, 1] >= ymin)
        & (m[:, 1] <= ymax)
        & (m[:, 2] >= zmin)
        & (m[:, 2] <= zmax)
    )
    idx = np.nonzero(inside)[0]
    import jax

    return jax.tree.map(lambda x: jnp.asarray(np.asarray(x)[idx]), g)
