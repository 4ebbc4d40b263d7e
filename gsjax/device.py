"""The one place that reads the platform.

gsjax runs on an NVIDIA GPU. Its Pallas kernels compile through Triton
there; on the CPU (tests and the CPU examples) they run in the Pallas
interpreter. Every other platform is refused.
"""

from __future__ import annotations

import jax
from jax.experimental import pallas as pl


def platform() -> str:
    p = jax.default_backend()
    if p not in ("gpu", "cpu"):
        raise RuntimeError(
            f"unsupported platform {p!r}: gsjax runs on an NVIDIA GPU "
            "(or on the CPU, for tests)"
        )
    return p


def interpret() -> bool:
    """Pallas interpret mode: on the CPU only."""
    return platform() == "cpu"


def resolve_backend(backend: str) -> str:
    """`auto` → the Triton `stream` blend on the GPU, plain `xla` on the
    CPU (the interpreter is for tests, not a deployment)."""
    if backend != "auto":
        return backend
    return "stream" if platform() == "gpu" else "xla"


def require_gpu():
    """Exit-worthy guard for measurement entry points: no GPU, no run."""
    if platform() != "gpu":
        raise RuntimeError(
            f"no GPU found (JAX platform {jax.default_backend()!r}); "
            "this entry point measures the GPU and has no CPU fallback"
        )
    return jax.devices()


def pallas_call(kernel, *, num_warps: int, num_stages: int = 1, **kw):
    """`pl.pallas_call` on the Triton route, interpreted on the CPU."""
    from jax.experimental.pallas import triton as pltriton

    return pl.pallas_call(
        kernel,
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        interpret=interpret(),
        **kw,
    )
