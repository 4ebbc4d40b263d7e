"""Tile-sharded scaling sweep (BASELINE configs 4-5 shape).

Measures the sharded train step (render → loss → grad → psum → update)
at 1, 2, 4, 8 devices: per-step wall clock, scaling efficiency vs the
1-device run, and the per-device WORK split (max pairs binned/composited
on any one device — the quantity that actually scales 1/D).

With --platform cpu (virtual CPU devices sharing the same host cores)
total work is constant, so WALL-CLOCK cannot improve with D; the
work-split column is the scaling signal there. With --platform gpu the
same code runs over the host's GPUs, where wall clock tracks the work
split.

  python tools/bench_scaling.py [--n 200000] [--wh 960x512] [--steps 5]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--wh", default="960x512")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--platform", default="cpu", choices=["cpu", "gpu"])
    ap.add_argument("--devices", type=int, nargs="*", default=[1, 2, 4, 8])
    args = ap.parse_args()
    W, H = map(int, args.wh.split("x"))

    if args.platform == "cpu":
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags
                + f" --xla_force_host_platform_device_count={max(args.devices)}"
            ).strip()

    import jax

    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    from gsjax import RenderConfig
    from gsjax.bench.synth import bench_camera, bonsai_like
    from gsjax.parallel.mesh import TILES_AXIS, band_rows_for, make_mesh
    from gsjax.parallel.render_sharded import make_train_step, pad_target
    from gsjax.render.binning import build_tile_bins
    from gsjax.render.project import project

    cfg = RenderConfig(backend="xla", tile_list_cap=512, chunk=64)
    cam = bench_camera(width=W, height=H)
    g = bonsai_like(n=args.n, sh_degree=0)
    opt = optax.adam(1e-3)

    base_ms = None
    for d in args.devices:
        if d > len(jax.devices()):
            print(f"D={d}: skipped ({len(jax.devices())} devices available)")
            continue
        mesh = make_mesh(d)
        step = make_train_step(cam, cfg, mesh, opt)
        target = pad_target(cfg, cam, jnp.zeros((H, W, 3), jnp.float32), d)
        g1, st, loss, _aux = step(g, opt.init(g), target)
        jax.block_until_ready(loss)
        t0 = time.perf_counter()
        for _ in range(args.steps):
            g1, st, loss, _aux = step(g1, st, target)
        jax.device_get(loss)
        ms = (time.perf_counter() - t0) / args.steps * 1e3
        if base_ms is None:
            base_ms = ms

        # per-device work split: pairs binned+composited on each device
        band = band_rows_for(cfg, cam.height, d)

        def local_pairs(g):
            dd = jax.lax.axis_index(TILES_AXIS)
            p = project(g, cam, cfg)
            bins = build_tile_bins(p, cam, cfg, ty0=dd * band, band_rows=band)
            return bins.n_pairs[None]

        pairs = shard_map(
            local_pairs, mesh=mesh, in_specs=(P(),),
            out_specs=P(TILES_AXIS), check_vma=False,
        )(g)
        pairs = jax.device_get(pairs)
        total, mx = int(pairs.sum()), int(pairs.max())
        work_eff = total / (mx * d) * 100.0
        print(
            f"D={d}: {ms:8.1f} ms/step   wall-eff {base_ms / (ms * d) * 100:5.1f}%   "
            f"max-device pairs {mx} / {total} total → work-split eff {work_eff:5.1f}%"
        )


if __name__ == "__main__" and "--band-subset" not in sys.argv:
    main()


def band_subset():
    """--band-subset: single-REAL-chip demonstration of the band-sliced
    cost model (VERDICT r2 weak #3 follow-up): time fwd+bwd of ONE
    centered (= densest) tile-row band at the share a D-device mesh
    would assign, through the production stream path with
    homesort.slice_band_rows. Per-band time should approach
    fixed_layout_cost + band_share × sweep_cost — the structural 1/D.

      python tools/bench_scaling.py --band-subset [--n 1200000]
    """
    ap = argparse.ArgumentParser()
    ap.add_argument("--band-subset", action="store_true")
    ap.add_argument("--n", type=int, default=1_200_000)
    ap.add_argument("--wh", default="1920x1080")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--devices", type=int, nargs="*", default=[1, 2, 4, 8])
    args = ap.parse_args()
    W, H = map(int, args.wh.split("x"))

    import jax
    import jax.numpy as jnp

    from gsjax import RenderConfig
    from gsjax.bench.synth import bench_camera, bonsai_like
    from gsjax.parallel.render_sharded import _render_band

    from gsjax.core.autotune import derive_caps, derive_shard_caps

    cam = bench_camera(width=W, height=H)
    g = bonsai_like(n=args.n, sh_degree=0)
    # measured caps: full-image budgets once, then per-band-size worst-band
    # shard budgets (the slack heuristics either overflow on this skewed
    # scene or saturate at full scene size)
    base_cfg = derive_caps(g, cam, RenderConfig(backend="stream"))
    tiles_y = base_cfg.tiles_y(H)

    def time_band(cfg, band, ty0s, lives=None):
        """One compile (traced ty0 + rows_live), timed at each band
        origin. Returns per-origin ms and asserts every run was
        overflow-free."""
        if lives is None:
            lives = [band] * len(ty0s)

        def loss_fn(g, ty0, live, band=band):
            img, aux = _render_band(g, cam, cfg, ty0, band, live)
            ovf = (
                aux["n_pair_overflow"]
                + aux["n_band_overflow"]
                + aux["n_fat_overflow"]
            )
            return jnp.mean(img**2), ovf

        step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        out = []
        for ty0, live in zip(ty0s, lives):
            (loss, ovf), _ = step(g, jnp.int32(ty0), jnp.int32(live))
            jax.device_get(loss)
            t0 = time.perf_counter()
            for _ in range(args.steps):
                (loss, ovf), _ = step(g, jnp.int32(ty0), jnp.int32(live))
            jax.device_get(loss)
            ms = (time.perf_counter() - t0) / args.steps * 1e3
            assert int(jax.device_get(ovf)) == 0, (
                f"overflow at ty0={ty0} band={band}"
            )
            out.append(ms)
        return out

    base = None
    for d in args.devices:
        band = -(-tiles_y // d)
        ty0s = [min(i * band, tiles_y - band) for i in range(d)]
        cfg_d = (
            derive_shard_caps(g, cam, base_cfg, band) if d > 1 else base_cfg
        )
        print(f"# D={d} caps: prefilter={cfg_d.shard_prefilter_cap} "
              f"slice={cfg_d.shard_slice_cap} pairs={cfg_d.pair_cap}",
              flush=True)
        ms = time_band(cfg_d, band, ty0s)
        worst = max(ms)
        if base is None:
            base = worst
        print(
            f"D={d} contiguous (band {band}/{tiles_y} rows): "
            f"worst-device {worst:7.1f} ms  sum {sum(ms):7.1f}  "
            f"speedup {base / worst:4.2f}x (ideal {d}x, "
            f"eff {base / worst / d * 100:4.0f}%)  per-band "
            + " ".join(f"{m:.0f}" for m in ms)
        )
        if d > 1:
            # equal-CONTENT row cuts: variable owned rows, one static
            # program at band_max rows, content bounded by rows_live
            from gsjax.core.autotune import derive_row_cuts

            cuts = derive_row_cuts(g, cam, base_cfg, d)
            rows_d = [cuts[i + 1] - cuts[i] for i in range(d)]
            band_max = max(rows_d)
            bands = list(zip(cuts[:-1], rows_d))
            cfg_e = derive_shard_caps(g, cam, base_cfg, bands=bands)
            print(f"# D={d} equalized cuts={cuts} caps: "
                  f"prefilter={cfg_e.shard_prefilter_cap} "
                  f"slice={cfg_e.shard_slice_cap} pairs={cfg_e.pair_cap}",
                  flush=True)
            ems = time_band(cfg_e, band_max, cuts[:-1], rows_d)
            worst_e = max(ems)
            print(
                f"D={d} equal-content (rows {rows_d}):   "
                f"worst-device {worst_e:7.1f} ms  sum {sum(ems):7.1f}  "
                f"speedup {base / worst_e:4.2f}x (eff "
                f"{base / worst_e / d * 100:4.0f}%)  per-band "
                + " ".join(f"{m:.0f}" for m in ems),
                flush=True,
            )
        if d > 1 and "--balanced" in sys.argv:
            # balanced (i, i+d) pairing over 2d half-size groups
            gband = -(-tiles_y // (2 * d))
            gty0s = [min(i * gband, tiles_y - gband) for i in range(2 * d)]
            cfg_g = derive_shard_caps(g, cam, base_cfg, gband)
            gms = time_band(cfg_g, gband, gty0s)
            dev_ms = [gms[i] + gms[i + d] for i in range(d)]
            worst_b = max(dev_ms)
            print(
                f"D={d} balanced   (2x{gband} rows):        "
                f"worst-device {worst_b:7.1f} ms  sum {sum(gms):7.1f}  "
                f"speedup {base / worst_b:4.2f}x (eff "
                f"{base / worst_b / d * 100:4.0f}%)"
            )


if __name__ == "__main__" and "--band-subset" in sys.argv:
    band_subset()
    sys.exit(0)
