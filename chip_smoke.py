"""GPU smoke run of the training path at bonsai scale.

    python chip_smoke.py           # one GPU: phases 1-4
    python chip_smoke.py --multi   # four GPUs: the tile-sharded step only

Phases (one process owns the card; any failure exits non-zero):
  1. device — the platform must be `gpu`; prints the device and the
     card's name and power limit (nvidia-smi, no JAX);
  2. the Triton blend against blend_padded on one orbit view's real pair
     stream (the densest 8-tile-row band of the 1920×1080 frame), forward
     and gradients;
  3. three steps of the jitted per-frame-exact training step;
  4. a LazyTrainer resort and four lazy steps;
  --multi: the equalized tile-sharded train step over a 1-D mesh of 4
     GPUs, its gradients against the single-GPU gradients.

The last line of stdout is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_SPLATS = 1_200_000
WIDTH, HEIGHT = 1920, 1080
BAND_ROWS = 8
OVERFLOW_KEYS = ("n_pair_overflow", "n_band_overflow", "n_tile_overflow",
                 "n_fat_overflow", "n_clamped")


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"FAIL: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0] if out else out


def phase_device(n_expected):
    import jax

    from gsjax import device

    devs = device.require_gpu()
    check(len(devs) >= n_expected,
          f"need {n_expected} GPU(s), JAX sees {len(devs)}")
    log(f"# phase 1 device: platform={devs[0].platform} "
        f"kind={devs[0].device_kind} count={len(devs)} jax={jax.__version__}")
    card = card_line()
    log(f"# card: {card}")
    return devs, card


def scene_and_config(views=1):
    """Bonsai-scale scene, orbit view 0, caps from derive_caps."""
    from bench import orbit_cameras
    from gsjax import RenderConfig
    from gsjax.bench.synth import bonsai_like
    from gsjax.core.autotune import derive_caps

    g = bonsai_like(n=N_SPLATS, sh_degree=0)
    cams = orbit_cameras(views, WIDTH, HEIGHT)
    t0 = time.perf_counter()
    cfg = derive_caps(g, cams, RenderConfig(backend="stream", chunk=128))
    log(f"# derive_caps {time.perf_counter() - t0:.1f}s: "
        f"pair_cap={cfg.pair_cap} fat_cap={cfg.fat_cap} "
        f"live_cap={cfg.fat_live_cap} repack_rows={cfg.repack_rows}")
    return g, cams, cfg


def phase_kernel(g, cam, cfg):
    import numpy as np

    from gsjax.bench import blend_check as bc

    cols, pid, starts, counters = bc.frame_stream(g, cam, cfg)
    for k, v in counters.items():
        check(int(v) == 0, f"{k}={int(v)} in the frame prologue")
    tiles_x, tiles_y = cfg.tiles_x(cam.width), cfg.tiles_y(cam.height)
    s = np.asarray(starts)
    row0 = bc.densest_band(s, tiles_x, tiles_y, BAND_ROWS)
    t0 = time.perf_counter()
    err = bc.compare_blend(cols, pid, starts, row0, BAND_ROWS, tiles_x, cfg)
    log(f"# phase 2 kernel vs blend_padded: densest band rows "
        f"[{row0}, {row0 + BAND_ROWS}) of {tiles_y} ({err['tiles']} tiles, "
        f"{err['pairs']} of {int(s[-1])} frame pairs, padded cap "
        f"{err['cap']}); {time.perf_counter() - t0:.1f}s")
    log(f"#   forward image max|d| = {err['fwd_err']:.3e} "
        f"(limit {bc.FWD_LIMIT:.0e}); T max|d| = {err['T_err']:.3e}")
    log("#   grad max|d|/max|ref| per column = "
        + ", ".join(f"{e:.2e}" for e in err["grad_rel"])
        + f" (limit {bc.GRAD_LIMIT:.0e})")
    check(bc.within_limits(err), f"kernel vs reference out of limits: {err}")


def _overflow(aux):
    return {k: int(aux[k]) for k in OVERFLOW_KEYS if k in aux}


def phase_exact(g_train, target, cam, cfg, card):
    from functools import partial

    import jax
    import jax.numpy as jnp
    import optax

    from gsjax import render

    opt = optax.adam(1e-3)

    @partial(jax.jit, donate_argnums=(0, 1))
    def step(g, opt_state, target, cam):
        def loss_fn(g):
            img, aux = render(g, cam, cfg, return_aux=True)
            return jnp.mean((img - target) ** 2), {
                k: jnp.asarray(aux[k], jnp.int32)
                for k in OVERFLOW_KEYS if k in aux
            }

        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(g)
        updates, opt_state = opt.update(grads, opt_state, g)
        return optax.apply_updates(g, updates), opt_state, loss, aux

    opt_state = opt.init(g_train)
    t0 = time.perf_counter()
    compiled = step.lower(g_train, opt_state, target, cam).compile()
    compile_s = time.perf_counter() - t0
    losses, times = [], []
    g, st = g_train, opt_state
    for _ in range(3):
        t0 = time.perf_counter()
        g, st, loss, aux = compiled(g, st, target, cam)
        jax.block_until_ready((g, loss))
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        ovf = {k: int(v) for k, v in aux.items()}
        check(all(v == 0 for v in ovf.values()), f"overflow {ovf}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"# phase 3 exact step: compile {compile_s:.1f}s; losses "
        f"{losses}; step ms {[round(t, 3) for t in times]} on {card}; "
        f"peak_bytes_in_use={stats.get('peak_bytes_in_use')}")
    log(f"#   memory_analysis: {compiled.memory_analysis()}")
    check(all(map(math.isfinite, losses)), f"non-finite loss {losses}")
    check(losses[-1] <= losses[0], f"exact losses rose: {losses}")
    return losses[0]


def phase_lazy(g_train, target, cam, cfg, exact_loss0):
    import jax
    import optax

    from gsjax import LazyTrainer

    tr = LazyTrainer(g_train, cfg, optax.adam(1e-3))
    t0 = time.perf_counter()
    tr.resort(cam)
    ovf = _overflow(jax.device_get(tr.plan.ovf))
    check(all(v == 0 for v in ovf.values()), f"lazy plan overflow {ovf}")
    losses = [float(tr.step(target, cam)) for _ in range(4)]
    jax.block_until_ready(tr.sync())
    log(f"# phase 4 lazy: resort + 4 steps {time.perf_counter() - t0:.1f}s "
        f"(compile included); losses {losses}")
    rel = abs(losses[0] - exact_loss0) / abs(exact_loss0)
    log(f"#   first lazy loss vs exact loss: rel {rel:.2e} (limit 1e-06)")
    check(all(map(math.isfinite, losses)), f"non-finite lazy loss {losses}")
    check(rel <= 1e-6, "post-resort lazy step differs from the exact step")
    check(losses[-1] <= losses[0], f"lazy losses rose: {losses}")


def run_single():
    import jax

    from gsjax.utils.compile_cache import enable

    devs, card = phase_device(1)
    enable()
    from bench import perturb
    from gsjax import render

    g, cams, cfg = scene_and_config()
    cam = cams[0]
    phase_kernel(g, cam, cfg)
    target = jax.jit(lambda g, cam: render(g, cam, cfg))(g, cam)
    g_train = perturb(g)
    g_lazy = jax.tree.map(lambda x: x.copy(), g_train)  # exact step donates
    loss0 = phase_exact(g_train, target, cam, cfg, card)
    phase_lazy(g_lazy, target, cam, cfg, loss0)
    return devs


def run_multi(n_dev=4):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gsjax.utils.compile_cache import enable

    devs, card = phase_device(n_dev)
    enable()
    from gsjax import render
    from gsjax.core.autotune import derive_row_cuts, derive_shard_caps, measure_occupancy
    from gsjax.parallel.mesh import make_mesh
    from gsjax.parallel.render_sharded import (
        make_grad_equalized,
        make_train_step_equalized,
        pad_target_rows,
    )
    import optax
    from bench import perturb

    # the full frame renders with the single-card caps; the shard caps
    # (derive_shard_caps) size one band and would truncate a full frame
    g, cams, cfg = scene_and_config()
    cam = cams[0]
    m = measure_occupancy(g, cam, cfg)
    cuts = derive_row_cuts(g, cam, cfg, n_dev, m=m)
    bands = [(cuts[i], cuts[i + 1] - cuts[i]) for i in range(n_dev)]
    cfg_shard = derive_shard_caps(g, cam, cfg, bands=bands, m=m)
    band_max = max(r for _, r in bands)
    target, aux_t = jax.jit(
        lambda g: render(g, cam, cfg, return_aux=True)
    )(g)
    ovf = _overflow(jax.device_get(aux_t))
    check(all(v == 0 for v in ovf.values()), f"single-card overflow {ovf}")
    tgt = pad_target_rows(cfg, cam, target, band_max)
    g_train = perturb(g)
    mesh = make_mesh(n_dev)

    t0 = time.perf_counter()
    loss_s, grads_s, aux = make_grad_equalized(cam, cfg_shard, mesh, cuts)(
        g_train, tgt
    )
    jax.block_until_ready(grads_s)
    log(f"# multi: cuts {cuts}; sharded grad {time.perf_counter() - t0:.1f}s "
        f"(compile included); loss {float(loss_s)}")
    aux = {k: int(v) for k, v in aux.items()}
    log(f"#   counters {aux}")
    for k in ("n_pair_overflow", "n_band_overflow", "n_tile_overflow",
              "n_fat_overflow"):
        check(aux[k] == 0, f"{k}={aux[k]} on the sharded path")

    def loss_single(g):
        return jnp.mean((render(g, cam, cfg) - target) ** 2)

    g1 = jax.device_put(g_train, devs[0])
    loss_1, grads_1 = jax.jit(jax.value_and_grad(loss_single))(g1)
    worst = 0.0
    for f in ("means", "log_scales", "quats", "sh", "opacity_logits"):
        a = np.asarray(getattr(grads_1, f), np.float64)
        b = np.asarray(getattr(grads_s, f), np.float64)
        err = float(np.abs(a - b).max() / (np.abs(a).max() + 1e-30))
        worst = max(worst, err)
        log(f"#   grad {f}: max|d|/max|ref| = {err:.2e} (limit 1e-04)")
    log(f"#   loss sharded {float(loss_s)} vs single {float(loss_1)}")
    check(worst <= 1e-4, "sharded gradients differ from the single-GPU ones")

    opt = optax.adam(1e-3)
    step = make_train_step_equalized(cam, cfg_shard, mesh, opt, cuts)
    g2, _, loss, aux2 = step(g_train, opt.init(g_train), tgt)
    jax.block_until_ready(g2)
    t0 = time.perf_counter()
    g2, _, loss, aux2 = step(g_train, opt.init(g_train), tgt)
    jax.block_until_ready(g2)
    log(f"# multi train step: {(time.perf_counter() - t0) * 1e3:.3f} ms on "
        f"{n_dev}x {card}; loss {float(loss)}")
    check(math.isfinite(float(loss)), "non-finite sharded loss")
    return devs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-GPU tile-sharded phase")
    args = ap.parse_args()
    devs = run_multi() if args.multi else run_single()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }}))


if __name__ == "__main__":
    main()
