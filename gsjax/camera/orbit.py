"""Headless orbit-camera trajectories.

Capability parity with OrbitControls (/root/reference/src/controls/
OrbitControls.ts): the (alpha, beta, radius, target) orbit
parameterization (:7-14) and the pose it derives per update (:264-307) —
without the browser input handling, which has no headless meaning. The damped
lerp (:268-277) becomes an explicit trajectory generator so orbits are
reproducible, jit-able camera paths (e.g. the 30-frame 1080p benchmark
orbit of BASELINE config 3).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gsjax.core.camera import Camera
from gsjax.core.gaussians import rotmat_to_quat


@dataclasses.dataclass
class OrbitCamera:
    """Orbit state: azimuth alpha, elevation beta (radians), radius,
    target point (≙ OrbitControls defaults alpha=0, beta=0, radius=5,
    OrbitControls.ts:24-32)."""

    alpha: float = 0.0
    beta: float = 0.0
    radius: float = 5.0
    target: tuple = (0.0, 0.0, 0.0)

    def camera(self, **cam_kwargs) -> Camera:
        """Pose for the current orbit state (≙ OrbitControls.update
        position math, OrbitControls.ts:279-291)."""
        t = np.asarray(self.target, np.float64)
        ca, sa = np.cos(self.alpha), np.sin(self.alpha)
        cb, sb = np.cos(self.beta), np.sin(self.beta)
        pos = t + self.radius * np.array([sa * cb, sb, ca * cb])
        return Camera.look_at(pos, t, **cam_kwargs)

    def trajectory(self, n_frames: int, alpha_end: float = 2 * np.pi, **cam_kwargs):
        """n_frames cameras sweeping alpha from the current value."""
        return [
            dataclasses.replace(
                self, alpha=self.alpha + alpha_end * i / n_frames
            ).camera(**cam_kwargs)
            for i in range(n_frames)
        ]
