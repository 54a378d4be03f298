"""Process set-up: the compile-cache rule, the GPU check of the
measurement scripts, chip_smoke.py's contract line, and the timing
helper."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest

from optix_renderer_tpu.utils import device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

_PRINT_CACHE = ("from optix_renderer_tpu.utils.device import enable_compile_cache; "
                "import jax; d = enable_compile_cache(); "
                "print(d, jax.config.jax_compilation_cache_dir)")


def _cache_dir_in_child(env_dir):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run([sys.executable, "-c", _PRINT_CACHE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    return out.stdout.split()


def test_compile_cache_env_var_wins(tmp_path):
    d = str(tmp_path / "cache")
    assert _cache_dir_in_child(d) == [d, d]


def test_compile_cache_default_is_fixed_in_checkout(tmp_path):
    first = _cache_dir_in_child(None)
    second = _cache_dir_in_child(None)
    want = os.path.join(REPO, ".jax_cache")
    assert first == second == [want, want]


def _fake(platform, kind="NVIDIA H100 80GB HBM3"):
    return SimpleNamespace(platform=platform, device_kind=kind)


def test_require_gpus_rejects_cpu_devices():
    with pytest.raises(RuntimeError, match="need 1 GPU"):
        device.require_gpus(1)  # the suite runs on CPU devices
    with pytest.raises(RuntimeError, match="need 4 GPU"):
        device.require_gpus(4, devices=[_fake("gpu")] * 3)
    assert len(device.require_gpus(4, devices=[_fake("gpu")] * 4)) == 4


def test_contract_line_format():
    line = chip_smoke.contract_line([_fake("gpu")])
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line
    four = json.loads(chip_smoke.contract_line([_fake("gpu")] * 4))
    assert four["device"]["count"] == 4


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "GPU" in out.stderr


def test_compare_hits_accepts_ties_and_rejects_misses():
    import numpy as np

    n = 20000
    t = np.linspace(1.0, 500.0, n).astype(np.float32)
    ids = np.arange(n)
    ids[::2] = -1  # misses
    tie = ids.copy()
    tie[1] = 7  # another triangle at the same t: a tie
    chip_smoke.compare_hits(t, tie, t, ids, "tie")
    with pytest.raises(RuntimeError):
        chip_smoke.compare_hits(t * 1.01, ids, t, ids, "t off")
    extra = ids.copy()
    extra[0] = 3
    with pytest.raises(RuntimeError):
        chip_smoke.compare_hits(t, extra, t, ids, "extra hit")


def test_dryrun_multichip_raises_without_enough_devices():
    import __graft_entry__ as g

    with pytest.raises(RuntimeError, match="only"):
        g.dryrun_multichip(len(jax.devices()) + 1)


def test_timeit_returns_both_times_and_result():
    from optix_renderer_tpu.utils.timing import timeit

    f = jax.jit(lambda x: x * 2.0)
    res, out = timeit(f, jnp.ones(4), iters=3, warmup=1)
    assert set(res) == {"cold_s", "amortized_s"}
    assert res["cold_s"] >= 0.0 and res["amortized_s"] >= 0.0
    assert float(out[0]) == 2.0
