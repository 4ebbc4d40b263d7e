"""gsjax — differentiable 3D Gaussian Splatting framework for the GPU.

Built from scratch in JAX/Pallas with the capabilities of the reference
browser renderer (Lanv1/gsplat.js, surveyed in SURVEY.md): .splat / .ply /
quantized-.ply ingestion, pinhole cameras with JSON import/export, scene
transforms and export, degree 0-3 spherical-harmonics color, depth-sorted
front-to-back alpha compositing — plus differentiability and multi-chip
scaling, which the reference does not have.

Public API (capability parity with /root/reference/src/index.ts:1-12):
  Camera            ≙ reference Camera (src/cameras/Camera.ts)
  Gaussians         ≙ reference Scene splat store (src/core/Scene.ts)
  load_splat/save_splat  ≙ Loader / Scene.saveToFile
  load_ply          ≙ PLYLoader (plain + full-SH + quantized)
  render            ≙ WebGLRenderer.render (forward; differentiable)
  OrbitCamera       ≙ OrbitControls (headless trajectory form)
"""

from gsjax.core.gaussians import Gaussians
from gsjax.core.banded import BandedGaussians
from gsjax.core.camera import Camera
from gsjax.core.config import RenderConfig
from gsjax.render.pipeline import render
from gsjax.render.oracle import render_oracle
from gsjax.io.splat import load_splat, save_splat
from gsjax.io.ply import load_ply
from gsjax.io.stream import load_ply_streamed, load_splat_streamed
from gsjax.core import transforms
from gsjax.render.lazy import (
    FramePlan,
    LazyTrainer,
    build_frame_plan,
    lazy_render,
)
from gsjax.camera.orbit import OrbitCamera
from gsjax.camera import controls
from gsjax.camera.json_io import camera_from_json, camera_to_json, cameras_from_json

__version__ = "0.1.0"

__all__ = [
    "Gaussians",
    "Camera",
    "RenderConfig",
    "render",
    "render_oracle",
    "load_splat",
    "save_splat",
    "load_ply",
    "load_ply_streamed",
    "load_splat_streamed",
    "transforms",
    "FramePlan",
    "LazyTrainer",
    "build_frame_plan",
    "lazy_render",
    "BandedGaussians",
    "OrbitCamera",
    "controls",
    "camera_from_json",
    "camera_to_json",
    "cameras_from_json",
]
