"""Device mesh construction for tile-sharded rendering.

The reference's entire concurrency inventory is one Web Worker
(SURVEY §2.5); this framework scales instead by SPMD over a device
mesh: image tile rows sharded across devices on the `tiles` axis, splat
parameters replicated, parameter gradients all-reduced (`psum`)
(BASELINE north star; SURVEY §5.8). The GPUs of one host are joined all
to all, so the mesh is 1-D and follows the tile rows alone.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

TILES_AXIS = "tiles"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the `tiles` axis. Multi-host: pass
    jax.devices() (the default) after jax.distributed.initialize() — the
    same program then spans hosts, collectives riding ICI within a host
    and DCN across."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (TILES_AXIS,))


def init_multihost(coordinator_address=None, num_processes=None, process_id=None):
    """Initialize the JAX multi-process runtime for a multi-host pod
    (SURVEY §5.8): after this, `jax.devices()` spans every host and
    `make_mesh()` builds one global `tiles` mesh — the same pjit program
    then runs with collectives riding NVLink within a host and the
    network across. Arguments left None fall back to JAX's cluster
    auto-detection, which needs a cluster environment; a bare machine
    must pass all three."""
    import jax

    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def band_rows_for(cfg, height: int, n_devices: int) -> int:
    """Tile rows per device; the image height must pad to
    n_devices · band_rows · tile_size."""
    tiles_y = cfg.tiles_y(height)
    return -(-tiles_y // n_devices)


def padded_height(cfg, height: int, n_devices: int) -> int:
    return band_rows_for(cfg, height, n_devices) * n_devices * cfg.tile_size


def band_rows_balanced(cfg, height: int, n_devices: int) -> int:
    """Tile rows per GROUP in balanced mode: the image splits into
    2·n_devices row groups and device d composites groups (d, d+D) —
    one from each half, so a unimodal (center-heavy) density profile
    assigns every device one dense-ish and one sparse-ish group
    (pairing d with 2D−1−d would put BOTH center groups on one device).
    This cancels most of the skew that makes equal contiguous bands
    unbalanced (the mesh runs at its slowest device)."""
    tiles_y = cfg.tiles_y(height)
    return -(-tiles_y // (2 * n_devices))


def balanced_group_order(n_devices: int):
    """Sharded row-group order: device d's shard holds groups
    [d, d + n_devices] consecutively."""
    order = []
    for d in range(n_devices):
        order += [d, d + n_devices]
    return order


def padded_height_balanced(cfg, height: int, n_devices: int) -> int:
    return (
        band_rows_balanced(cfg, height, n_devices)
        * 2 * n_devices * cfg.tile_size
    )
