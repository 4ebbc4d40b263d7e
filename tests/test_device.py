"""The one module that reads the platform, the compile cache's location,
and the GPU-only entry points refusing the CPU."""

import os
import shutil
import subprocess
import sys

import pytest

from gsjax import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_auto_backend_is_xla_on_cpu():
    assert device.platform() == "cpu"
    assert device.interpret()
    assert device.resolve_backend("auto") == "xla"
    assert device.resolve_backend("stream") == "stream"


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        device.require_gpu()


def _run(args, cwd=REPO, env=None, timeout=300):
    e = dict(os.environ)
    e.update(env or {})
    return subprocess.run(
        [sys.executable] + args, cwd=cwd, env=e, capture_output=True,
        text=True, timeout=timeout,
    )


def test_compile_cache_honours_env(tmp_path):
    code = (
        "import jax; from gsjax.utils.compile_cache import enable;"
        "p = enable(0.0); jax.jit(lambda x: x * 2 + 1)(1.0).block_until_ready();"
        "print(p)"
    )
    r = _run(["-c", code], env={"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == str(tmp_path)
    assert any(tmp_path.iterdir()), "nothing was cached in the env directory"


def test_compile_cache_default_is_in_checkout():
    code = (
        "import jax; from gsjax.utils.compile_cache import enable;"
        "enable(); print(jax.config.jax_compilation_cache_dir)"
    )
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == os.path.join(REPO, ".jax_cache")


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_entry_points_fail_on_cpu(script):
    r = _run([script], env={"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert "no GPU found" in r.stderr
    assert '"ok": true' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], cwd=tmp_path, env={"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_trace_stage_names_and_busy_union():
    from gsjax.bench import trace_stages as ts

    hlo = (
        'ENTRY %main {\n'
        '  %loop_add_fusion.3 = f32[8] fusion(%a), kind=kLoop, '
        'metadata={op_name="jit(step)/jvp(loss)/blend/mul" source_line=3}\n'
        '  ROOT sort.1 = s32[8] sort(%b), metadata={op_name='
        '"jit(step)/home_layout/fat_repeat/sort"}\n'
        '}\n'
    )
    names = ts.op_names(hlo)
    assert names["loop_add_fusion_3"].endswith("/blend/mul")
    assert ts.re.search(r"(^|[/(])blend($|[)/])", "jit(f)/transpose(jvp(blend))/x")
    assert "/fat_repeat/" in names["sort_1"]
    assert ts._union_ns([(0, 10), (5, 20), (30, 40)]) == 30
