"""Per-splat 3D→2D projection: Σ → screen-space conic via the perspective
Jacobian, frustum cull, footprint radius, and SH color.

Capability parity with the reference's vertex shader
(/root/reference/src/renderers/webgl/shaders/vertex.glsl.ts:130-175):
view/clip transform (:136-141), Jacobian J (:148-152), cov2d = Tᵀ·Σ·T
(:154-155), +0.3 low-pass (:157-159), eigenvalue footprint (:166-175) —
but with graphdeco's exact semantics (the BASELINE correctness oracle):
clamped x/z, y/z in the Jacobian, conic = inverse(cov2d), radius =
ceil(3σ_max), pixel-space means.

Pure elementwise jnp over N splats: XLA vectorizes this onto the VPU; at
~100 flops/splat it is never the bottleneck (SURVEY §7 M1), so no Pallas
kernel is needed here.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from gsjax.core.camera import Camera
from gsjax.core.config import RenderConfig
from gsjax.core.gaussians import Gaussians
from gsjax.render.sh import eval_sh


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["mean2d", "depth", "conic", "radius", "rgb", "opacity", "valid"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class ProjectedSplats:
    """Screen-space splats.

    mean2d  [N, 2] pixel coords (pixel centers at integer coordinates)
    depth   [N]    camera-space z
    conic   [N, 3] (a, b, c): gaussian weight = exp(-0.5(a dx² + 2b dx dy + c dy²))
    radius  [N]    footprint radius in pixels (0 ⇒ culled)
    rgb     [N, 3] SH-evaluated color
    opacity [N]    activated opacity in [0, 1]
    valid   [N]    bool cull mask
    """

    mean2d: jax.Array
    depth: jax.Array
    conic: jax.Array
    radius: jax.Array
    rgb: jax.Array
    opacity: jax.Array
    valid: jax.Array


def project(
    g: Gaussians, cam: Camera, cfg: RenderConfig = RenderConfig()
) -> ProjectedSplats:
    view = cam.view_matrix()  # [4,4] world→camera
    W = view[:3, :3]
    # elementwise [N,3]·[3,3]: exact f32, no matmul precision question
    t_cam = (
        jnp.sum(g.means[:, None, :] * W[None, :, :], axis=-1) + view[:3, 3]
    )  # [N,3]
    z = t_cam[:, 2]

    in_front = z > cfg.near_cull

    tan_fovx, tan_fovy = cam.tan_half_fov()
    # clamped view-space ratios for Jacobian stability (graphdeco preprocess)
    limx, limy = 1.3 * tan_fovx, 1.3 * tan_fovy
    zc = jnp.where(in_front, z, 1.0)  # avoid div-by-zero on culled splats
    tx = jnp.clip(t_cam[:, 0] / zc, -limx, limx) * zc
    ty = jnp.clip(t_cam[:, 1] / zc, -limy, limy) * zc

    fx, fy = cam.fx, cam.fy
    inv_z = 1.0 / zc
    inv_z2 = inv_z * inv_z
    # J: 2×3 perspective Jacobian (≙ vertex.glsl.ts:148-152, graphdeco sign
    # convention: d(fx·x/z)/dz = -fx·x/z²)
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z2
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z2

    # T = J @ W  (2×3); cov2d = T Σ Tᵀ  (≙ vertex.glsl.ts:154-155).
    # Everything stays elementwise: batched 3×3 products are too small
    # for a matrix unit and would inherit the default matmul precision.
    T0 = j00[:, None] * W[0][None, :] + j02[:, None] * W[2][None, :]  # [N,3]
    T1 = j11[:, None] * W[1][None, :] + j12[:, None] * W[2][None, :]  # [N,3]

    # M = R·diag(s): Σ = M Mᵀ; fold Σ into the quadratic forms via
    # U = M with rows contracted against T: cov2d_ab = (Ta M)·(Tb M)
    R = g.rotation_matrices()  # [N, 3, 3] (elementwise from quats)
    s = g.scales  # [N, 3]
    M = R * s[:, None, :]  # [N, 3, 3] columns scaled
    # a0 = T0·M (row vector [N,3]), a1 = T1·M — elementwise sums
    a0 = jnp.sum(T0[:, :, None] * M, axis=1)  # [N, 3]
    a1 = jnp.sum(T1[:, :, None] * M, axis=1)
    c00 = jnp.sum(a0 * a0, axis=-1) + cfg.lowpass
    c01 = jnp.sum(a0 * a1, axis=-1)
    c11 = jnp.sum(a1 * a1, axis=-1) + cfg.lowpass

    det = c00 * c11 - c01 * c01
    det_ok = det > 0.0
    det_safe = jnp.where(det_ok, det, 1.0)
    inv_det = 1.0 / det_safe
    conic = jnp.stack([c11 * inv_det, -c01 * inv_det, c00 * inv_det], axis=-1)

    mid = 0.5 * (c00 + c11)
    lam1 = mid + jnp.sqrt(jnp.maximum(0.1, mid * mid - det_safe))
    radius = jnp.ceil(cfg.radius_sigma * jnp.sqrt(lam1))

    # pixel-space mean: x_px = fx·x/z + (W-1)/2  (graphdeco ndc2Pix)
    cx = (cam.width - 1.0) * 0.5
    cy = (cam.height - 1.0) * 0.5
    mean2d = jnp.stack(
        [fx * t_cam[:, 0] * inv_z + cx, fy * t_cam[:, 1] * inv_z + cy], axis=-1
    )

    # on-screen test at tile granularity happens in binning; here cull
    # splats whose footprint cannot touch the image at all.
    on_screen = (
        (mean2d[:, 0] + radius >= 0)
        & (mean2d[:, 0] - radius < cam.width)
        & (mean2d[:, 1] + radius >= 0)
        & (mean2d[:, 1] - radius < cam.height)
    )

    opacity = g.opacities
    dirs = g.means - cam.position
    # smoothed norm (see gaussians.normalized_quats): a splat exactly at
    # the camera position must not NaN the backward through 0/0
    dirs = dirs / jnp.sqrt(
        jnp.sum(dirs * dirs, axis=-1, keepdims=True) + 1e-24
    )
    rgb = eval_sh(g.sh, dirs)

    valid = in_front & det_ok & on_screen & (opacity >= cfg.alpha_min)

    return ProjectedSplats(
        mean2d=mean2d,
        depth=z,
        conic=conic,
        radius=jnp.where(valid, radius, 0.0),
        rgb=rgb,
        opacity=opacity,
        valid=valid,
    )
