"""Tile-sharded rendering + one training step over an 8-device mesh —
the multi-device path (gsjax.parallel). Runs on 8 virtual CPU devices
here; the same code runs unchanged over a host's GPUs."""

import os

# must be set before jax initializes (simulate an 8-chip host on CPU)
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
).strip()

import _common  # noqa: F401  (forces CPU platform, adds repo to sys.path)
import jax
import jax.numpy as jnp
import optax
from _common import demo_scene, out_path

from gsjax import Camera, RenderConfig
from gsjax.parallel.mesh import make_mesh
from gsjax.parallel.render_sharded import make_train_step, pad_target, render_sharded
from gsjax.utils.image import write_png


def main():
    n_dev = len(jax.devices())
    mesh = make_mesh(n_dev)
    print(f"mesh: {mesh}")

    g = demo_scene(n=2000)
    cfg = RenderConfig(backend="xla", tile_list_cap=256)
    cam = Camera.look_at(
        (0.0, -1.0, -1.0), (0.0, 0.0, 4.0), fx=400.0, fy=400.0,
        width=512, height=384,
    )

    img = render_sharded(g, cam, cfg, mesh)
    write_png(out_path("sharded.png"), img[: cam.height, : cam.width])
    print(f"sharded render: {img.shape}, devices used: {n_dev}")

    opt = optax.adam(1e-3)
    step = make_train_step(cam, cfg, mesh, opt)
    target = pad_target(cfg, cam, jnp.zeros((cam.height, cam.width, 3)), n_dev)
    g1, _opt_state, loss, aux = step(g, opt.init(g), target)
    print(f"one sharded train step: loss={float(loss):.5f}")


if __name__ == "__main__":
    main()
