"""Spherical-harmonics color evaluation, degree 0-3.

Capability parity with the reference's GLSL SH evaluator
(/root/reference/src/renderers/webgl/shaders/vertex.glsl.ts:57-104
`eval_sh_rgb` and its use at :187-204), using the standard real-SH
constants shared by the reference and graphdeco. Colors are
`max(Σ coeffs·basis + 0.5, 0)` — the same clamp both apply
(vertex.glsl.ts:102-103; the reference additionally min-clamps to 1,
graphdeco does not: we follow graphdeco, the correctness oracle, and
clamp only below at 0).

Mixed per-splat degrees (the reference's quantized band partitioning,
u_bandIndex, vertex.glsl.ts:180-189) are represented by zero-padded
higher-order coefficients, which contribute exactly zero — no separate
band logic needed.
"""

from __future__ import annotations

import jax.numpy as jnp

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def sh_basis(dirs: jnp.ndarray, k: int) -> jnp.ndarray:
    """Real SH basis values [..., k] for unit directions [..., 3].

    k ∈ {1, 4, 9, 16}; ordering matches graphdeco / the reference's
    coefficient layout (vertex.glsl.ts:62-100).
    """
    out = [jnp.full(dirs.shape[:-1], SH_C0, dirs.dtype)]
    if k > 1:
        x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if k > 4:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    if k > 9:
        out += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    return jnp.stack(out, axis=-1)


def eval_sh(sh: jnp.ndarray, dirs: jnp.ndarray) -> jnp.ndarray:
    """Evaluate SH colors.

    sh:   [..., K, 3] coefficients (K ∈ {1,4,9,16})
    dirs: [..., 3] unit view directions (splat center − camera position,
          normalized; the reference computes this per-vertex via an
          inverse(view) — vertex.glsl.ts:199-200 — we use the camera
          position directly, the intended semantics per SURVEY §2.4).
    returns [..., 3] colors, clamped at 0 after the +0.5 offset.
    """
    k = sh.shape[-2]
    basis = sh_basis(dirs, k)  # [..., K]
    # elementwise contraction (exact f32; an einsum would inherit the
    # default matmul precision)
    rgb = jnp.sum(basis[..., :, None] * sh, axis=-2) + 0.5
    return jnp.maximum(rgb, 0.0)
