"""Device time per pipeline stage from a `jax.profiler` trace.

The render pipeline names its stages with `jax.named_scope` (project,
home_layout, fat_repeat, binning, pair_expansion, blend). XLA keeps the
scope path in each HLO instruction's `op_name` metadata; the trace's
GPU events carry the instruction (kernel) name. `stage_times` joins the
two through the compiled step's HLO text and sums device durations per
stage, and reports the device's busy time (union of event intervals)
over the traced window.
"""

from __future__ import annotations

import glob
import os
import re
from collections import defaultdict

STAGES = ("project", "home_layout", "fat_repeat", "binning",
          "pair_expansion", "blend")

_INSTR = re.compile(
    r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name="([^"]*)"', re.M
)


def _norm(name: str) -> str:
    return re.sub(r"[.\-]", "_", name)


def op_names(hlo_text: str) -> dict:
    """{instruction name (dots as underscores): op_name metadata}."""
    return {_norm(m.group(1)): m.group(2) for m in _INSTR.finditer(hlo_text)}


def _xplane(trace_dir: str) -> str:
    paths = sorted(
        glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True)
    )
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    return paths[-1]


def device_events(trace_dir: str):
    """[(name, start_ns, duration_ns)] of every event on the GPU planes."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(_xplane(trace_dir))
    out = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                out.append((ev.name, ev.start_ns, ev.duration_ns))
    return out


def _union_ns(intervals):
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def stage_times(trace_dir: str, hlo_text: str = "", stages=STAGES):
    """Returns {"stage_ms": {stage: summed device ms}, "op_ms": {event
    name: ms}, "busy_ms": union of device intervals, "window_ms": first
    start to last end}. An event belongs to a stage when its op_name
    path has the scope as a component; nested scopes count toward each
    enclosing stage."""
    names = op_names(hlo_text)
    per_stage = defaultdict(float)
    per_op = defaultdict(float)
    spans = []
    for name, start, dur in device_events(trace_dir):
        ms = dur / 1e6
        per_op[name] += ms
        spans.append((start, start + dur))
        path = names.get(_norm(name), "")
        for s in stages:
            # a scope is a path component, possibly wrapped by a
            # transformation ("jvp(blend)"); a Pallas kernel's event is
            # named after the kernel ("blend_fwd")
            if re.search(rf"(^|[/(]){s}($|[)/])", path) or name.startswith(
                s + "_"
            ):
                per_stage[s] += ms
    window = (max(e for _, e in spans) - min(s for s, _ in spans)) if spans else 0
    return {
        "stage_ms": dict(per_stage),
        "op_ms": dict(per_op),
        "busy_ms": _union_ns(spans) / 1e6,
        "window_ms": window / 1e6,
    }
