"""Render configuration (static under jit).

The reference scatters its knobs as inline magic constants (SURVEY.md §5.6:
texture width 2048, ×4 Σ scale, 0.3 low-pass at vertex.glsl.ts:158-159,
1.2 cull guard, exp(-4) cutoff at frag.glsl.ts:15). Here they are one
hashable config object used as a static jit argument.

Defaults are graphdeco-compatible (the BASELINE correctness oracle):
  - low-pass: cov2d diagonal += 0.3  (same constant as the reference)
  - cull: z < 0.2
  - footprint radius: ceil(3·sqrt(λ_max))
  - alpha: min(0.99, opacity·exp(power)); skip below 1/255
  - termination: stop before a splat would push transmittance below 1e-4
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    tile_size: int = 16
    # static pair-expansion budget: each splat may emit up to tile_span²
    # (tile_span × tile_span tile rect) pairs; larger footprints are clamped
    # (clamped-splat count is reported in RenderAux.n_clamped).
    tile_span: int = 3
    # per-tile list capacity for the padded-list (XLA) backend; overflow is
    # dropped far-to-near and counted in RenderAux.n_tile_overflow.
    tile_list_cap: int = 1024
    # total-pair budget for the stream backend; None = no cap
    # (tile_span² · N slots). Overflow is counted in RenderAux.
    pair_cap: int | None = None
    # pairs per compositing step: the XLA blend's scan chunk, and the
    # stream kernel's early-termination check interval
    chunk: int = 128
    near_cull: float = 0.2
    lowpass: float = 0.3
    alpha_clamp: float = 0.99
    alpha_min: float = 1.0 / 255.0
    transmittance_eps: float = 1e-4
    radius_sigma: float = 3.0
    background: tuple = (0.0, 0.0, 0.0)
    backend: str = "auto"  # oracle | xla | stream | auto
    # --- footprint semantics ---
    # False (default): EXACT graphdeco footprints. The oracle renders the
    # full radius rect (like the reference's 1024-px axes,
    # /root/reference/src/renderers/webgl/shaders/vertex.glsl.ts:173-175);
    # the stream backend covers arbitrary rects by splitting fat splats
    # into per-3×3-tile-block virtual home rows (render/homesort.py) —
    # budget overflow is counted in aux n_fat_overflow, never silent.
    # True: legacy span-budget mode — every backend clamps rects to
    # tile_span×tile_span centered on the home tile (round-1 semantics).
    footprint_clamp: bool = False
    # exact-mode budgets: span-tile blocks enumerated per fat splat
    # (fat_max_blocks), total copy-enumeration slots (fat_cap, pre
    # block-cull), and copy rows kept in the sorted layout
    # (fat_live_cap, post-cull). None = scale with the scene
    # (homesort.resolve_fat_caps): caps are static shapes, so autos
    # derive from N at trace time. Overflow counts in aux
    # n_fat_overflow.
    # per-splat block budget: must stay < 1024 (the VJP's block-bounded
    # segment reduction, homesort._home_gather_bwd); 1023 covers any
    # footprint up to a full 1080p frame (ceil(120/3)*ceil(68/3) = 920
    # blocks — garden-scale splats overflow the old 256 default)
    fat_max_blocks: int = 1023
    fat_cap: int | None = None
    fat_live_cap: int | None = None
    # --- bucket-repack pair sort (render/repack.py) ---
    # replace the global (tile, depth) lax.sort with balanced 2-D row
    # sorts + live compaction (render/repack.py). Only the
    # exact-footprint home-anchored path uses it.
    pair_repack: bool = True
    # sort-row width in lanes; rows pack whole tiles greedily to
    # repack_w - ~2.4k block-rounding slack, so a single tile's
    # candidate total (live + culled expansion slots of its 9 class
    # segments) must fit under that — overflow is counted
    repack_w: int = 32768
    # assumed average row fill (None = 13·repack_w/16) — sizes the
    # static row count R = ceil(min(repack_cap, K·NH)/Q)+1; R·W is the
    # sort volume paid, and a scene that packs worse than Q overflows
    # the grid (counted, bench-gated)
    repack_q: int | None = None
    # candidate-stream capacity (live + dead expansion slots). None =
    # the K·NH worst case — far above real occupancy for big scenes, so
    # derive_caps sizes it from a measured occupancy pre-pass
    # (core/autotune.py)
    repack_cap: int | None = None
    # direct row-count override (highest precedence): derive_caps sets
    # this from an exact greedy-packing simulation of the measured
    # per-tile candidate totals
    repack_rows: int | None = None
    # --- tile-sharded path (parallel/render_sharded.py) ---
    # static per-device budget slacks over the proportional band share:
    # splats selected by the band prefilter, and home rows kept by the
    # band slice. Density-skewed scenes (bonsai: the center band holds
    # several x its proportional share) need more; overflow is counted
    # in n_band_overflow and asserted zero in tests/dryrun
    band_prefilter_slack: float = 2.5
    band_slice_slack: float = 2.0
    # exact static overrides (autotune.derive_shard_caps measures the
    # worst band of a given size and sets these): splats kept by the
    # prefilter / home rows kept by the slice. None = the slack
    # heuristics above. On skewed scenes the heuristics either overflow
    # (slack too small) or saturate at full scene size (slack large
    # enough for the dense center band = no 1/D shrink at all)
    shard_prefilter_cap: int | None = None
    shard_slice_cap: int | None = None

    def tiles_x(self, width: int) -> int:
        return -(-width // self.tile_size)

    def tiles_y(self, height: int) -> int:
        return -(-height // self.tile_size)
