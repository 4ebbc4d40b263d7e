"""Triton blend vs the plain XLA blend inside one training step (GPU).

Times the per-frame-exact training step at the bonsai configuration
(1.2M splats, 1920×1080, orbit view 0, caps from derive_caps) twice:
with the stream backend's Triton blend, and with composite.blend_padded
fed the same pair stream (per-tile lists padded to the frame's largest
tile, so no pair is dropped). Optionally traces the Triton step and
prints the device time of each named pipeline stage.

    python tools/bench_blend.py [--steps 5] [--trace chiprun_out/trace]
"""

import argparse
import json
import os
import subprocess
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_200_000)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from gsjax import device

    devs = device.require_gpu()
    from gsjax.utils.compile_cache import enable

    enable()
    from bench import orbit_cameras, perturb
    from gsjax import RenderConfig, render
    from gsjax.bench import blend_check as bc
    from gsjax.bench.synth import bonsai_like
    from gsjax.core.autotune import derive_caps
    from gsjax.render import pallas_stream as ps
    from gsjax.render.binning import build_tile_bins
    from gsjax.render.composite import assemble_band, clipped_pair_stream
    from gsjax.render.homesort import build_home_layout
    from gsjax.render.pipeline import _project_any

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(f"# card: {card}; {devs[0].device_kind}", flush=True)

    g = bonsai_like(n=args.n, sh_degree=0)
    cam = orbit_cameras(1, args.width, args.height)[0]
    cfg = derive_caps(g, [cam], RenderConfig(backend="stream", chunk=128))
    _, _, starts, _ = bc.frame_stream(g, cam, cfg)
    s = np.asarray(starts)
    cap = bc.band_cap(s, 0, len(s) - 1, cfg.chunk)
    print(f"# frame pairs {int(s[-1])}, largest tile {int(np.diff(s).max())}"
          f" -> padded cap {cap}", flush=True)

    def render_plain(g, cam):
        p = _project_any(g, cam, cfg)
        p, layout = build_home_layout(p, cam, cfg)
        bins = build_tile_bins(p, cam, cfg, anchor="home", layout=layout)
        pid, st, _ = clipped_pair_stream(bins, cfg)
        with jax.named_scope("blend"):
            img_t, T_t = bc.reference_blend(
                ps.stream_cols(p), pid, st, bins.ty0, bins.tiles_x,
                bins.band_rows, cfg, cap,
            )
        img, _ = assemble_band(img_t, T_t, bins, cfg)
        return img[: cam.height, : cam.width]

    render_triton = lambda g, cam: render(g, cam, cfg)
    opt = optax.adam(1e-3)

    def make_step(render_fn):
        @partial(jax.jit, donate_argnums=(0, 1))
        def step(g, st, target):
            def loss_fn(g):
                return jnp.mean((render_fn(g, cam) - target) ** 2)

            loss, grads = jax.value_and_grad(loss_fn)(g)
            updates, st = opt.update(grads, st, g)
            return optax.apply_updates(g, updates), st, loss

        return step

    target = jax.jit(render_triton)(g, cam)
    g0 = perturb(g)

    variants = {"triton": make_step(render_triton),
                "plain": make_step(render_plain)}
    results = {k: [] for k in variants}

    def run(name):
        step = variants[name]
        gg = jax.tree.map(lambda x: x.copy(), g0)
        st = opt.init(gg)
        t0 = time.perf_counter()
        gg, st, loss = step(gg, st, target)
        jax.block_until_ready(loss)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(args.steps):
            gg, st, loss = step(gg, st, target)
        jax.block_until_ready((gg, loss))
        ms = (time.perf_counter() - t0) / args.steps * 1e3
        results[name].append(ms)
        print(f"# {name}: first call {first:.1f}s, step {ms:.3f} ms, "
              f"loss {float(loss):.6f}", flush=True)

    order = list(variants)
    for r in range(args.rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            run(name)

    if args.trace:
        from gsjax.bench.trace_stages import _norm, op_names, stage_times

        step = variants["triton"]
        gg = jax.tree.map(lambda x: x.copy(), g0)
        st = opt.init(gg)
        gg, st, loss = step(gg, st, target)
        jax.block_until_ready(loss)
        with jax.profiler.trace(args.trace):
            for _ in range(2):
                gg, st, loss = step(gg, st, target)
            jax.block_until_ready((gg, loss))
        hlo = step.lower(gg, st, target).compile().as_text()
        t = stage_times(args.trace, hlo)
        print(f"# trace (2 steps): window {t['window_ms']:.3f} ms, device "
              f"busy {t['busy_ms']:.3f} ms, idle share "
              f"{1 - t['busy_ms'] / max(t['window_ms'], 1e-9):.3f}")
        for k, v in sorted(t["stage_ms"].items(), key=lambda x: -x[1]):
            print(f"#   stage {k}: {v / 2:.3f} ms/step")
        names = op_names(hlo)
        for k, v in sorted(t["op_ms"].items(), key=lambda x: -x[1])[:25]:
            print(f"#   op {k[:40]}: {v / 2:.3f} ms/step "
                  f"[{names.get(_norm(k), '?')[-110:]}]")
        results["trace"] = {k: v / 2 for k, v in t["stage_ms"].items()}
    print(json.dumps({
        "card": card, "device_kind": devs[0].device_kind,
        "step_ms": results, "cap": cap, "pairs": int(s[-1]),
    }))


if __name__ == "__main__":
    main()
