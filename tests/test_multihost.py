"""Multi-host execution in simulation: two local processes joined through
jax.distributed (CPU backend) run the strided commet rounds over a shared
output directory, then commet_analysis aggregates — the multi-host equivalent
of the reference's SGE partitioning (Commet.py:204-236,580-586).

The fast test byte-compares the 2-process CSVs against a 1-process run of
the same data; the slow test anchors the same path to the checked-in ABCDE
goldens (transitively covered by test_pipeline_golden otherwise).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from commet_tpu.cli import commet_analysis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_ABCDE = os.path.join(os.path.dirname(__file__), "golden", "abcde")
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
MATRICES = ("matrix_plain.csv", "matrix_percentage.csv",
            "matrix_normalized.csv")


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_ranks(fof, out, extra_args, nprocs=2, timeout=900):
    port = free_port()
    procs = []
    for r in range(nprocs):
        env = dict(os.environ)
        env.update({
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=1",
            "COMMET_TPU_COORDINATOR": f"localhost:{port}",
            "COMMET_TPU_NUM_PROCESSES": str(nprocs),
            "COMMET_TPU_PROCESS_ID": str(r),
            "COMMET_TPU_STREAM": "0",
        })
        env.pop("PYTHONPATH", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "commet_tpu.cli.commet", fof,
             "-o", out, "--no-plots"] + extra_args,
            cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    for p in procs:
        stdout, _ = p.communicate(timeout=timeout)
        outs.append(stdout.decode())
    for p, text in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{text[-3000:]}"
    return outs


def write_fasta(path, rng, n=80, length=90):
    with open(path, "wb") as f:
        for i in range(n):
            f.write(b">r%d\n%s\n" % (i, bytes(rng.choice(BASES, size=length))))


def test_two_process_strided_rounds_match_single(tmp_path):
    rng = np.random.default_rng(5)
    files = []
    for s in range(3):
        p = str(tmp_path / f"set{s}.fa")
        write_fasta(p, rng)
        files.append(p)
    fof = str(tmp_path / "fof.txt")
    with open(fof, "w") as f:
        for s, p in enumerate(files):
            f.write(f"set{s}: {p}\n")

    out2 = str(tmp_path / "out2") + "/"
    os.makedirs(out2)
    outs = launch_ranks(fof, out2, ["-k", "15"])
    assert any("rank 0/2" in o for o in outs)
    assert any("rank 1/2" in o for o in outs)
    # deferred aggregation (reference Commet_analysis.py flow)
    rc = commet_analysis.main([fof, "-o", out2, "--no-plots"])
    assert rc == 0

    from commet_tpu.cli import commet as commet_cli
    out1 = str(tmp_path / "out1") + "/"
    os.makedirs(out1)
    rc = commet_cli.main([fof, "-k", "15", "-o", out1, "--no-plots"])
    assert rc == 0

    for m in MATRICES:
        with open(out1 + m, "rb") as f1, open(out2 + m, "rb") as f2:
            assert f1.read() == f2.read(), f"{m} differs across process counts"


@pytest.mark.slow
def test_two_process_abcde_matches_golden(tmp_path):
    if not os.path.isdir("/root/reference/ABCDE_bench"):
        pytest.skip("reference dataset not available")
    out = str(tmp_path / "out") + "/"
    os.makedirs(out)
    fof = str(tmp_path / "fof.txt")
    with open(fof, "w") as f:
        for name, paths in (("set1", ["A.fa"]), ("set2", ["B.fa", "C.fa"]),
                            ("set3", ["D.fa"])):
            full = ["/root/reference/ABCDE_bench/" + p for p in paths]
            f.write(f"{name}: " + " ; ".join(full) + "\n")
    launch_ranks(fof, out, ["-k", "32"], timeout=3600)
    rc = commet_analysis.main([fof, "-o", out, "--no-plots"])
    assert rc == 0
    for m in MATRICES:
        with open(out + m, "rb") as got, \
                open(os.path.join(GOLDEN_ABCDE, m), "rb") as want:
            assert got.read() == want.read(), f"{m} differs from golden"
