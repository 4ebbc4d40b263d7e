"""The Gaussians pytree — the scene's splat store.

Capability parity with the reference's `Scene` SoA buffers
(/root/reference/src/core/Scene.ts:27-56: positions, rotations, scales,
colors, shs), redesigned as an immutable JAX pytree of *raw training
parameters* so the renderer is a pure function and the whole scene is
differentiable:

  means          [N, 3]  f32   world-space centers
  log_scales     [N, 3]  f32   log of per-axis std-dev (reference stores
                               linear scale, Scene.ts:131-133; log keeps
                               positivity under gradient steps)
  quats          [N, 4]  f32   rotation (w, x, y, z), normalized on use
                               (reference normalizes at parse,
                               PLYLoader.ts:639-646)
  sh             [N, K, 3] f32 spherical-harmonic coefficients, K in
                               {1, 4, 9, 16} (degree 0-3); channel-minor
                               like the reference's interleaved layout
                               (PLYLoader.ts:649-701). Plain RGB scenes are
                               degree 0: sh[:, 0] = (rgb - 0.5) / SH_C0.
  opacity_logits [N]     f32   logit of opacity (reference stores sigmoided
                               u8, Scene.ts:137; PLY stores the logit,
                               PLYLoader.ts:634-637)

Covariance: Σ = R S Sᵀ Rᵀ with S = diag(exp(log_scales)) — same quantity
the reference precomputes on CPU as (S·R)ᵀ(S·R) (Scene.ts:150-176), but
computed on device inside the jitted render step.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

SH_C0 = 0.28209479177387814  # ≙ PLYLoader.ts:25

_SH_K_FOR_DEGREE = {0: 1, 1: 4, 2: 9, 3: 16}


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["means", "log_scales", "quats", "sh", "opacity_logits"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class Gaussians:
    means: jax.Array
    log_scales: jax.Array
    quats: jax.Array
    sh: jax.Array
    opacity_logits: jax.Array

    @property
    def n(self) -> int:
        return self.means.shape[0]

    @property
    def sh_degree(self) -> int:
        k = self.sh.shape[1]
        return {1: 0, 4: 1, 9: 2, 16: 3}[k]

    # -- constructors -------------------------------------------------------

    @staticmethod
    def from_activated(
        means,
        scales,
        quats,
        opacities,
        rgb=None,
        sh=None,
    ) -> "Gaussians":
        """Build from activated values: linear scales, [0,1] opacities, and
        either direct RGB in [0,1] (degree-0) or SH coefficients."""
        means = jnp.asarray(means, jnp.float32)
        scales = jnp.asarray(scales, jnp.float32)
        quats = jnp.asarray(quats, jnp.float32)
        opacities = jnp.clip(jnp.asarray(opacities, jnp.float32), 1e-6, 1.0 - 1e-6)
        if sh is None:
            if rgb is None:
                raise ValueError("provide rgb or sh")
            rgb = jnp.asarray(rgb, jnp.float32)
            sh = ((rgb - 0.5) / SH_C0)[:, None, :]
        else:
            sh = jnp.asarray(sh, jnp.float32)
        return Gaussians(
            means=means,
            log_scales=jnp.log(jnp.maximum(scales, 1e-12)),
            quats=quats,
            sh=sh,
            opacity_logits=jnp.log(opacities) - jnp.log1p(-opacities),
        )

    # -- activated views ----------------------------------------------------

    @property
    def scales(self) -> jax.Array:
        return jnp.exp(self.log_scales)

    @property
    def opacities(self) -> jax.Array:
        return jax.nn.sigmoid(self.opacity_logits)

    def normalized_quats(self) -> jax.Array:
        q = self.quats
        # smoothed norm, NOT max(|q|, eps): the max-clamped norm's VJP at
        # q = 0 is 0/0 = NaN, and an all-zero quat row exists by design
        # in the lazy path's inert pad rows (render/lazy.py) — the NaN
        # then rides a zero cotangent into Adam state and poisons the
        # fold-back's block prefix sums
        return q / jnp.sqrt(jnp.sum(q * q, axis=-1, keepdims=True) + 1e-24)

    def rotation_matrices(self) -> jax.Array:
        """[N, 3, 3] rotation matrices from normalized (w,x,y,z) quats."""
        return quat_to_rotmat(self.normalized_quats())

    def covariances(self) -> jax.Array:
        """[N, 3, 3] world-space covariances Σ = R S Sᵀ Rᵀ
        (≙ Scene.ts:150-172 computed as MᵀM with M = S·R)."""
        R = self.rotation_matrices()
        S = self.scales
        M = R * S[:, None, :]  # R @ diag(S)
        # explicit f32 precision: a default-precision f32 matmul may run
        # in TF32 on the GPU, far too coarse for covariance geometry
        return jnp.matmul(M, jnp.swapaxes(M, -1, -2), precision="highest")

    # -- shape utilities ----------------------------------------------------

    def with_sh_degree(self, degree: int) -> "Gaussians":
        """Zero-pad or truncate SH coefficients to the given degree."""
        k = _SH_K_FOR_DEGREE[degree]
        cur = self.sh.shape[1]
        if cur == k:
            return self
        if cur > k:
            sh = self.sh[:, :k]
        else:
            pad = jnp.zeros((self.n, k - cur, 3), self.sh.dtype)
            sh = jnp.concatenate([self.sh, pad], axis=1)
        return dataclasses.replace(self, sh=sh)

    def pad_to(self, n: int) -> "Gaussians":
        """Pad with fully transparent splats (for static-shape batching)."""
        if n < self.n:
            raise ValueError(f"pad_to({n}) < n={self.n}")
        extra = n - self.n
        if extra == 0:
            return self

        def pad(x, fill=0.0):
            w = [(0, extra)] + [(0, 0)] * (x.ndim - 1)
            return jnp.pad(x, w, constant_values=fill)

        return Gaussians(
            means=pad(self.means),
            log_scales=pad(self.log_scales, -10.0),
            quats=pad(
                self.quats
            ).at[self.n :, 0].set(1.0),
            sh=pad(self.sh),
            opacity_logits=pad(self.opacity_logits, -30.0),
        )

    def slice(self, start: int, stop: int) -> "Gaussians":
        return jax.tree.map(lambda x: x[start:stop], self)

    def concat(self, other: "Gaussians") -> "Gaussians":
        if self.sh.shape[1] != other.sh.shape[1]:
            d = max(self.sh_degree, other.sh_degree)
            return self.with_sh_degree(d).concat(other.with_sh_degree(d))
        return jax.tree.map(lambda a, b: jnp.concatenate([a, b], 0), self, other)


def quat_to_rotmat(q: jax.Array) -> jax.Array:
    """Rotation matrices [..., 3, 3] from normalized quaternions [..., 4] in
    (w, x, y, z) order (≙ Quaternion.toRotationMatrix semantics,
    /root/reference/src/math/Matrix3.ts:67-103)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = jnp.stack(
        [
            1 - 2 * (y * y + z * z),
            2 * (x * y - w * z),
            2 * (x * z + w * y),
            2 * (x * y + w * z),
            1 - 2 * (x * x + z * z),
            2 * (y * z - w * x),
            2 * (x * z - w * y),
            2 * (y * z + w * x),
            1 - 2 * (x * x + y * y),
        ],
        axis=-1,
    )
    return r.reshape(*q.shape[:-1], 3, 3)


def rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """Inverse of quat_to_rotmat for host-side camera/scene IO
    (≙ Quaternion.fromRotationMatrix, reference Camera JSON path
    Camera.ts:120-128). Numpy, batched [..., 3, 3] -> [..., 4] (w,x,y,z)."""
    R = np.asarray(R, np.float64)
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    q = np.zeros(R.shape[:-2] + (4,), np.float64)

    c0 = tr > 0
    s = np.sqrt(np.maximum(tr + 1.0, 0)) * 2
    with np.errstate(divide="ignore", invalid="ignore"):
        q0 = np.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s], -1)
        s1 = np.sqrt(np.maximum(1.0 + m00 - m11 - m22, 0)) * 2
        q1 = np.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], -1)
        s2 = np.sqrt(np.maximum(1.0 + m11 - m00 - m22, 0)) * 2
        q2 = np.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], -1)
        s3 = np.sqrt(np.maximum(1.0 + m22 - m00 - m11, 0)) * 2
        q3 = np.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], -1)

    c1 = (m00 > m11) & (m00 > m22)
    c2 = m11 > m22
    q = np.where(c0[..., None], q0, np.where(c1[..., None], q1, np.where(c2[..., None], q2, q3)))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return q.astype(np.float32)
