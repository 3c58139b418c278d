"""--jobs resume semantics: completed pairs are skipped on re-run (marker +
outputs done_check wired from cli/commet.py into the JobGraph), and deleting
one pair's markers recomputes only that pair."""

import os
import time

import numpy as np

from commet_tpu.cli import commet as commet_cli

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def write_fasta(path, rng, n=60, length=90):
    with open(path, "wb") as f:
        for i in range(n):
            f.write(b">r%d\n%s\n" % (i, bytes(rng.choice(BASES, size=length))))


def setup_pipeline(tmp_path):
    rng = np.random.default_rng(3)
    files = []
    for s in range(3):
        p = str(tmp_path / f"set{s}.fa")
        write_fasta(p, rng)
        files.append(p)
    fof = str(tmp_path / "fof.txt")
    with open(fof, "w") as f:
        for s, p in enumerate(files):
            f.write(f"set{s}: {p}\n")
    out = str(tmp_path / "out") + "/"
    return fof, out


def run(fof, out):
    rc = commet_cli.main([fof, "-k", "15", "--jobs", "2", "-o", out,
                          "--no-plots"])
    assert rc == 0


def log_mtimes(out):
    return {f: os.stat(os.path.join(out, f)).st_mtime_ns
            for f in os.listdir(out) if f.endswith(".log")}


def test_jobs_resume_skips_completed_pairs(tmp_path):
    fof, out = setup_pipeline(tmp_path)
    run(fof, out)
    assert os.path.exists(os.path.join(out, ".job_all_in_0.done"))
    m1 = log_mtimes(out)
    assert m1, "pipeline must produce per-pair logs"

    # full re-run: every pair job is skipped, no log rewritten
    time.sleep(0.05)
    run(fof, out)
    assert log_mtimes(out) == m1

    # delete one pair's markers: exactly that pair recomputes
    os.remove(os.path.join(out, ".job_0_in_2.done"))
    os.remove(os.path.join(out, ".job_2_in_0.done"))
    time.sleep(0.05)
    run(fof, out)
    m2 = log_mtimes(out)
    changed = {f for f in m1 if m2[f] != m1[f]}
    assert changed == {"set0_in_set2.log", "set2_in_set0.log"}, changed
    # recomputation reproduced the same matrices
    with open(os.path.join(out, "matrix_plain.csv")) as f:
        assert "set0" in f.read()
