"""Device-facing configuration: the compile-cache location, device memory
limits, and the single-device plane addressing limit."""

import os
import subprocess
import sys

import pytest

import jax

from commet_tpu.core import kernels
from commet_tpu.parallel import sharded

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CACHE_PROBE = """
import jax, jax.numpy as jnp
from commet_tpu.config import enable_compile_cache
print(enable_compile_cache())
print(jax.config.jax_compilation_cache_dir)
if {compile_one}:
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.jit(lambda x: x * 3 + 1)(jnp.arange(8)).block_until_ready()
"""


def _probe_cache(tmp_path, env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run(
        [sys.executable, "-c",
         CACHE_PROBE.format(compile_one=env_dir is not None)],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=300, check=True)
    return out.stdout.split()


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_location(tmp_path, from_env):
    """JAX_COMPILATION_CACHE_DIR is honoured as the only cache directory;
    without it the cache is the fixed <checkout>/.jax_cache, whatever the
    working directory."""
    if from_env:
        want = str(tmp_path / "x")
        returned, configured = _probe_cache(tmp_path, want)
        assert returned == configured == want
        assert os.listdir(want), "nothing was cached in the env directory"
    else:
        want = os.path.join(REPO, ".jax_cache")
        returned, configured = _probe_cache(tmp_path, None)
        assert returned == configured == want


class _FakeDevice:
    platform = "gpu"
    device_kind = "fake"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats", [None, {}, {"bytes_limit": 0}])
def test_device_hbm_bytes_raises_without_a_limit(monkeypatch, stats):
    """A device that reports no memory limit gets no guessed size."""
    monkeypatch.setattr(jax, "local_devices", lambda: [_FakeDevice(stats)])
    with pytest.raises(RuntimeError, match="reports no memory limit"):
        sharded.device_hbm_bytes()


def test_device_hbm_bytes_reads_the_limit(monkeypatch):
    monkeypatch.setattr(jax, "local_devices", lambda: [
        _FakeDevice({"bytes_limit": 60 << 30, "bytes_in_use": 1})])
    assert sharded.device_hbm_bytes() == 60 << 30
    # 4 GiB of k=33 planes fit half of 60 GiB; 16 GiB at k=35 would too,
    # but k > 34 is beyond the int32 flat plane index of one device
    assert sharded.dp_fits(33)
    assert not sharded.dp_fits(35)
    assert not sharded.dp_fits(35, hbm_bytes=1 << 50)


def test_cpu_backend_reports_no_limit():
    """The CPU backend has no device memory limit: the memory probe
    raises, and the callers that size resident data say so instead."""
    with pytest.raises(RuntimeError):
        sharded.device_hbm_bytes()
    # replicated planes share host memory: every copy must fit half of it
    assert sharded.dp_fits(20, n_devices=8)
    assert not sharded.dp_fits(34, n_devices=1 << 20)
    assert not sharded.dp_fits(40)
    from commet_tpu.cli.commet import planes_budget
    from commet_tpu.engine.engine import Engine
    assert planes_budget() == float("inf")
    assert Engine(k=15, t=2).resident_budget() == float("inf")


@pytest.mark.parametrize("k", [35, 36, 40])
def test_alloc_planes_refuses_k_beyond_one_device(k):
    """4 * 2^(k-5) plane words overflow the probes' int32 flat index from
    k = 35 on: one device refuses instead of reading wrong words."""
    with pytest.raises(ValueError, match=f"k={k} > 34"):
        kernels.alloc_planes(k)


def test_single_device_k_limit_is_the_int32_index_limit():
    k = kernels.MAX_SINGLE_DEVICE_K
    assert 4 * kernels.plane_words(k) - 1 <= 2**31 - 1
    assert 4 * kernels.plane_words(k + 1) - 1 > 2**31 - 1


@pytest.mark.parametrize("k,n_dev,mode", [(33, 2, "dp"), (35, 2, "plane"),
                                          (36, 4, "plane")])
def test_engine_mesh_mode_beyond_one_device_k(k, n_dev, mode):
    """Without an explicit mode the engine replicates planes only up to
    the single-device limit; larger k shards the planes over the mesh."""
    from commet_tpu.engine.engine import Engine
    eng = Engine(k=k, t=2, batch=4096, mesh=sharded.make_mesh(n_dev))
    assert eng.mesh_mode == mode


def test_plane_mode_refuses_an_overflowing_local_index():
    """k=36 over 2 devices leaves 2^30 words per plane per device: the
    4-plane local index would overflow int32."""
    from commet_tpu.engine.engine import Engine
    with pytest.raises(ValueError, match="int32 local plane index"):
        Engine(k=36, t=2, batch=4096, mesh=sharded.make_mesh(2))
