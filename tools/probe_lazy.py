"""Measure the lazy path at the 1080p bench config on the real chip:
plan build (resort) cost, lazy step (fwd+bwd+adam) cost, extract/fold
costs — the rung-1+2 numbers for DESIGN.md.

  python tools/probe_lazy.py [--n 1200000] [--scene bonsai] [--steps 10]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_200_000)
    ap.add_argument("--scene", default="bonsai", choices=["bonsai", "garden"])
    ap.add_argument("--wh", default="1920x1080")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    W, H = map(int, args.wh.split("x"))

    from gsjax.utils.compile_cache import enable as _cc

    _cc()

    import jax
    import jax.numpy as jnp
    import optax

    from gsjax import RenderConfig
    from gsjax.bench.synth import bench_camera, bonsai_like, garden_like
    from gsjax.core.autotune import derive_caps
    from gsjax.render.lazy import (
        LazyTrainer,
        build_frame_plan,
        extract_home,
        make_lazy_step,
    )

    if args.scene == "garden":
        g = garden_like(n=args.n if args.n != 1_200_000 else 5_000_000)
    else:
        g = bonsai_like(n=args.n, sh_degree=0)
    cam = bench_camera(width=W, height=H)
    t0 = time.perf_counter()
    cfg = derive_caps(g, cam, RenderConfig(backend="stream"))
    print(f"autotune {time.perf_counter()-t0:.1f}s: pair_cap={cfg.pair_cap} "
          f"repack_rows={cfg.repack_rows} "
          f"fat_cap={cfg.fat_cap} live_cap={cfg.fat_live_cap}", flush=True)

    opt = optax.adam(1e-3)
    target = jnp.zeros((H, W, 3), jnp.float32)

    def sync(x):
        jax.device_get(jax.tree.leaves(x)[0].ravel()[0])

    # plan build (resort)
    t0 = time.perf_counter()
    plan = build_frame_plan(g, cam, cfg)
    sync(plan.pidx)
    print(f"plan build compile+run {time.perf_counter()-t0:.1f}s "
          f"ovf={ {k: int(v) for k, v in plan.ovf.items()} }", flush=True)
    for _ in range(2):
        t0 = time.perf_counter()
        plan = build_frame_plan(g, cam, cfg)
        sync(plan.pidx)
    print(f"plan build steady: {(time.perf_counter()-t0)*1e3:.1f} ms", flush=True)

    # extract (params + optimizer state as one packed gather)
    ex = jax.jit(extract_home)
    t0 = time.perf_counter()
    hp, hp_opt = ex((g, opt.init(g)), plan)
    sync(hp.means)
    print(f"extract compile+run {time.perf_counter()-t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    hp2, _ = ex((g, opt.init(g)), plan)
    sync(hp2.means)
    print(f"extract steady: {(time.perf_counter()-t0)*1e3:.1f} ms "
          "(params+opt)", flush=True)

    # lazy step
    step = make_lazy_step(cfg, opt)
    t0 = time.perf_counter()
    hp, hp_opt, loss = step(hp, hp_opt, target, cam, plan)
    jax.device_get(loss)
    print(f"lazy step compile+run {time.perf_counter()-t0:.1f}s "
          f"loss={float(loss):.5f}", flush=True)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        hp, hp_opt, loss = step(hp, hp_opt, target, cam, plan)
    jax.device_get(loss)
    ms = (time.perf_counter() - t0) / args.steps * 1e3
    print(f"lazy step steady: {ms:.1f} ms/step loss={float(loss):.5f}",
          flush=True)

    # steady resort cost (sync/fold + plan build + extract), isolated
    tr = LazyTrainer(g, cfg, opt)
    tr.resort(cam)
    tr.step(target, cam)
    tr.resort(cam)  # compiles fold; plan/extract warm
    tr.step(target, cam)
    t0 = time.perf_counter()
    for _ in range(3):
        tr.resort(cam)
        tr.step(target, cam)
    sync(tr.hp.means)
    rs = (time.perf_counter() - t0) / 3 * 1e3
    print(f"resort+1step steady: {rs:.1f} ms (resort ≈ {rs - ms:.1f} ms)",
          flush=True)

    # full trainer loop with resort cadence, amortized
    for K in (8, 16, 30):
        tr = LazyTrainer(g, cfg, opt)
        tr.resort(cam)  # warm compile path shared with above
        tr.step(target, cam)
        t0 = time.perf_counter()
        nst = 0
        for s in range(K):
            if s % K == 0:
                tr.resort(cam)
            loss = tr.step(target, cam)
            nst += 1
        tr.sync()
        jax.device_get(jax.tree.leaves(tr.g)[0].ravel()[0])
        ams = (time.perf_counter() - t0) / nst * 1e3
        print(f"amortized (K={K}, resort+fold each window): {ams:.1f} ms/step",
              flush=True)


if __name__ == "__main__":
    main()
