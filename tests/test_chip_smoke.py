"""The GPU smoke script's host-side machinery, on the CPU: its refusal to
report without a GPU and its host reference."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from commet_tpu.core import kernels
from commet_tpu.native import parser as native

from oracle import index_reads, search_read

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("alone", [False, True])
def test_smoke_fails_without_gpu(tmp_path, alone):
    """No accelerator (or no repository beside the script): a non-zero
    exit and no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        shutil.copy(script, tmp_path)
        script = str(tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PATH=os.path.dirname(sys.executable))  # no nvidia-smi
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, script, "--scale", "0.0001"],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_host_planes_match_the_reference_bloom():
    """The smoke's reference: the native host planes read through
    HostPlanes classify exactly like the transcribed reference Bloom."""
    k, t = 15, 2
    rng = np.random.default_rng(12)
    lut = np.frombuffer(b"ACGTN", np.uint8)
    idx = rng.integers(0, 4, size=(40, 60)).astype(np.uint8)
    idx[rng.random(idx.shape) < 0.03] = 4
    qry = rng.integers(0, 4, size=(80, 60)).astype(np.uint8)
    qry[::2, 10:40] = idx[rng.integers(0, 40, size=40), 5:35]
    planes = np.zeros(4 * kernels.plane_words(k), np.uint32)
    offsets = np.arange(len(idx) + 1, dtype=np.int64) * idx.shape[1]
    native.build_planes_into(planes, idx.reshape(-1), offsets,
                             np.full(len(idx), idx.shape[1], np.int32),
                             np.arange(len(idx)), k)
    host = chip_smoke.HostPlanes(planes, k)
    bloom = index_reads([lut[r].tobytes().decode() for r in idx], k)
    got = [search_read(host, lut[r].tobytes().decode(), k, t) for r in qry]
    want = [search_read(bloom, lut[r].tobytes().decode(), k, t) for r in qry]
    assert got == want
    assert any(want)
