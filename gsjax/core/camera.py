"""Pinhole camera.

Capability parity with the reference Camera (/root/reference/src/cameras/
Camera.ts): focal lengths fx/fy, near/far planes, pose as position +
camera-to-world rotation quaternion, view/projection matrices
(Camera.ts:32-56, 82-88), and COLMAP-style JSON import/export
(Camera.ts:95-181) — see gsjax.camera.json_io.

Conventions (graphdeco-compatible, the correctness oracle per BASELINE.md):
  - world→camera: p_cam = R_w2c @ p_world + t_w2c, camera looks down +z.
  - pixel coords: x_px = fx * x/z + (W-1)/2 (pixel centers at integers),
    matching graphdeco's ndc2Pix.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from gsjax.core.gaussians import quat_to_rotmat, rotmat_to_quat


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["position", "quat", "fx", "fy"],
    meta_fields=["width", "height", "near", "far"],
)
@dataclasses.dataclass(frozen=True)
class Camera:
    """Pose is (position, quat): camera-to-world, quat in (w,x,y,z).

    Defaults mirror the reference (Camera.ts:22-29): fx = fy = 1132,
    near = 0.01 (projection) — but rasterization culls at z < 0.2 like
    graphdeco; see RenderConfig.near_cull.
    """

    position: jax.Array  # [3]
    quat: jax.Array  # [4] (w, x, y, z), camera-to-world
    fx: jax.Array  # scalar
    fy: jax.Array  # scalar
    width: int = 800
    height: int = 600
    near: float = 0.01
    far: float = 1000.0

    @staticmethod
    def create(
        position=(0.0, 0.0, 0.0),
        quat=(1.0, 0.0, 0.0, 0.0),
        fx: float = 1132.0,
        fy: float = 1132.0,
        width: int = 800,
        height: int = 600,
        near: float = 0.01,
        far: float = 1000.0,
    ) -> "Camera":
        return Camera(
            position=jnp.asarray(position, jnp.float32),
            quat=jnp.asarray(quat, jnp.float32),
            fx=jnp.asarray(fx, jnp.float32),
            fy=jnp.asarray(fy, jnp.float32),
            width=int(width),
            height=int(height),
            near=float(near),
            far=float(far),
        )

    # -- matrices -----------------------------------------------------------

    def rotation_c2w(self) -> jax.Array:
        q = self.quat / jnp.maximum(jnp.linalg.norm(self.quat), 1e-12)
        return quat_to_rotmat(q)

    def view_matrix(self) -> jax.Array:
        """[4, 4] world→camera (≙ Camera.getViewMatrix, Camera.ts:32-56)."""
        Rc2w = self.rotation_c2w()
        Rw2c = Rc2w.T
        t = -jnp.matmul(Rw2c, self.position, precision="highest")
        m = jnp.eye(4, dtype=jnp.float32)
        m = m.at[:3, :3].set(Rw2c)
        m = m.at[:3, 3].set(t)
        return m

    def proj_matrix(self) -> jax.Array:
        """[4, 4] camera→clip, z mapped to [0,1]·w, y down in NDC
        (≙ Camera.ts:82-88 column-major projection, row-major here)."""
        n, f = self.near, self.far
        w, h = self.width, self.height
        P = jnp.zeros((4, 4), jnp.float32)
        P = P.at[0, 0].set(2.0 * self.fx / w)
        P = P.at[1, 1].set(-2.0 * self.fy / h)
        P = P.at[2, 2].set(f / (f - n))
        P = P.at[2, 3].set(-(f * n) / (f - n))
        P = P.at[3, 2].set(1.0)
        return P

    def view_proj(self) -> jax.Array:
        return jnp.matmul(
            self.proj_matrix(), self.view_matrix(), precision="highest"
        )

    def tan_half_fov(self):
        return (
            self.width / (2.0 * self.fx),
            self.height / (2.0 * self.fy),
        )

    # -- constructors -------------------------------------------------------

    @staticmethod
    def look_at(
        position,
        target,
        up=(0.0, 1.0, 0.0),
        **kwargs,
    ) -> "Camera":
        """Camera at `position` looking at `target` (+z toward target)."""
        position = np.asarray(position, np.float64)
        target = np.asarray(target, np.float64)
        up = np.asarray(up, np.float64)
        fwd = target - position
        fwd = fwd / np.linalg.norm(fwd)
        # OpenCV camera axes: z forward, y down (our projection maps +y_cam
        # to +row), x = y × z so the basis is right-handed (det = +1)
        x = np.cross(fwd, up)
        nx = np.linalg.norm(x)
        if nx < 1e-8:
            alt = np.array([1.0, 0.0, 0.0]) if abs(fwd[0]) < 0.9 else np.array([0.0, 0.0, 1.0])
            x = np.cross(fwd, alt)
            nx = np.linalg.norm(x)
        x = x / nx
        y = np.cross(fwd, x)  # = z × x, points "down" w.r.t. `up`
        Rc2w = np.stack([x, y, fwd], axis=1)
        q = rotmat_to_quat(Rc2w)
        return Camera.create(position=position, quat=q, **kwargs)

    def with_size(self, width: int, height: int) -> "Camera":
        return dataclasses.replace(self, width=int(width), height=int(height))
