"""Amortized multi-index engine path (Engine.build_resident +
search_multi_set): one sorted query stream serving several resident
indexes must produce byte-identical tags, counters, and .bv files to the
pairwise index_and_search path (reference Commet.py:186-240 step-0
semantics, src/index_and_search.cpp:255-277 partitioning)."""

import os

import numpy as np
import pytest

import commet_tpu.engine.engine as engine_mod
from commet_tpu.engine.engine import Engine
from commet_tpu.io.reads import ReadSet

from test_engine_stream import write_fasta

K = 15
T = 2


def _mk(tmp_path, rng, n_idx_sets=3, n_idx=80, n_qry=150, length=90):
    donors_all = []
    idx_sets = []
    for s in range(n_idx_sets):
        fa = str(tmp_path / f"idx{s}.fa")
        donors = write_fasta(fa, rng, n_idx, length)
        donors_all.append(donors)
        rs = ReadSet(f"I{s}")
        rs.add_file(fa)
        idx_sets.append(rs)
    qry_fa = str(tmp_path / "qry.fa")
    write_fasta(qry_fa, rng, n_qry, length, donors=donors_all[0])
    return idx_sets, qry_fa


@pytest.mark.parametrize("max_kmer", [None, 900])
def test_multi_matches_pairwise(tmp_path, monkeypatch, max_kmer):
    """Tags/counters/bv bytes equal the pairwise engine, including the
    multi-partition case (small max_kmer forces several partitions and
    exercises per-partition OR + the searched-in-last-partition counter)."""
    rng = np.random.default_rng(91)
    monkeypatch.setenv("COMMET_TPU_STREAM", "force")
    idx_sets, qry_fa = _mk(tmp_path, rng)

    eng = Engine(k=K, t=T, batch=64, max_kmer=max_kmer)
    assert eng.stream
    residents = [eng.build_resident(rs) for rs in idx_sets]
    assert all(r is not None for r in residents)
    if max_kmer is not None:
        assert any(len(r.partitions) > 1 for r in residents)

    out_multi = tmp_path / "multi"
    out_pair = tmp_path / "pair"
    os.makedirs(out_multi)
    os.makedirs(out_pair)

    rs_q = ReadSet("Q")
    rs_q.add_file(qry_fa)
    got = eng.search_multi_set(rs_q, residents, out_dir=str(out_multi),
                               log_dir=str(out_multi))

    for rs in idx_sets:
        eng2 = Engine(k=K, t=T, batch=64, max_kmer=max_kmer)
        rs_q2 = ReadSet("Q")
        rs_q2.add_file(qry_fa)
        want = eng2.index_and_search(rs, [rs_q2], out_dir=str(out_pair),
                                     log_dir=str(out_pair))["Q"]
        g = got[rs.name]
        for key in ("indexed", "searched", "shared"):
            assert g[key] == want[key], (rs.name, key, g, want)
        name = os.path.basename(qry_fa) + "_in_" + rs.name + ".bv"
        with open(out_multi / name, "rb") as f1, \
                open(out_pair / name, "rb") as f2:
            assert f1.read() == f2.read(), name
        # counters line of the log must match the pairwise path
        with open(out_multi / f"Q_in_{rs.name}.log") as f:
            got_line = f.read().splitlines()[-1]
        with open(out_pair / f"Q_in_{rs.name}.log") as f:
            want_line = f.read().splitlines()[-1]
        assert got_line == want_line


def test_multi_grouping_spans_many_slots(tmp_path, monkeypatch):
    """max_slots grouping: forcing one-slot groups must not change tags."""
    rng = np.random.default_rng(17)
    monkeypatch.setenv("COMMET_TPU_STREAM", "force")
    idx_sets, qry_fa = _mk(tmp_path, rng, n_idx_sets=4, n_idx=40, n_qry=80)
    eng = Engine(k=K, t=T, batch=64)
    residents = [eng.build_resident(rs) for rs in idx_sets]

    def run(max_slots):
        rs_q = ReadSet("Q")
        rs_q.add_file(qry_fa)
        return eng.search_multi_set(rs_q, residents, save=False,
                                    max_slots=max_slots)

    a, b = run(32), run(1)
    for name in a:
        assert a[name] == {**b[name], "search_time": a[name]["search_time"],
                           "total_time": a[name]["total_time"]}


def test_driver_amortized_matches_classic(tmp_path, monkeypatch):
    """Full driver: the amortized schedule (resident indexes + transposed
    step 0 + pairwise refinement) must produce byte-identical .bv files and
    CSV matrices to the classic per-round schedule."""
    from commet_tpu.cli import commet as commet_cli

    rng = np.random.default_rng(2024)
    monkeypatch.setenv("COMMET_TPU_STREAM", "force")
    donors = None
    fofs = []
    for s in range(3):
        fa = str(tmp_path / f"set{s}.fa")
        d = write_fasta(fa, rng, 60, 90, donors=donors)
        donors = donors or d
        fofs.append(f"S{s}: {fa}")
    fof = tmp_path / "fof.txt"
    fof.write_text("\n".join(fofs) + "\n")

    outs = {}
    for mode, flag in (("amortized", "1"), ("classic", "0")):
        monkeypatch.setenv("COMMET_TPU_MULTI", flag)
        out = str(tmp_path / mode) + "/"
        rc = commet_cli.main([str(fof), "-k", str(K), "-t", str(T),
                              "-o", out, "--no-plots"])
        assert rc == 0
        outs[mode] = out
    names = sorted(n for n in os.listdir(outs["classic"])
                   if n.endswith(".bv") or n.endswith(".csv"))
    assert any(n.endswith(".bv") for n in names)
    for n in names:
        with open(outs["amortized"] + n, "rb") as f1, \
                open(outs["classic"] + n, "rb") as f2:
            assert f1.read() == f2.read(), n


def test_build_resident_refuses_unservable(tmp_path, monkeypatch):
    """Wide keys / stream-off / budget-exceeded configurations return None
    (callers fall back to the pairwise path)."""
    rng = np.random.default_rng(3)
    monkeypatch.setenv("COMMET_TPU_STREAM", "force")
    idx_sets, _ = _mk(tmp_path, rng, n_idx_sets=1)
    eng35 = Engine(k=35, t=T, batch=64)  # beyond the 34-bit stream domain
    assert eng35.build_resident(idx_sets[0]) is None
    # k=33 (wide keys) IS servable since round 4
    eng33 = Engine(k=33, t=T, batch=64)
    r33 = eng33.build_resident(idx_sets[0])
    assert r33 is not None and r33.partitions[0].ihib is not None

    monkeypatch.setenv("COMMET_TPU_RESIDENT_BUDGET", "10")
    eng = Engine(k=K, t=T, batch=64)
    assert eng.build_resident(idx_sets[0]) is None
    monkeypatch.delenv("COMMET_TPU_RESIDENT_BUDGET")

    monkeypatch.setenv("COMMET_TPU_STREAM", "0")
    eng_off = Engine(k=K, t=T, batch=64)
    assert eng_off.build_resident(idx_sets[0]) is None


def test_multi_long_reads_fall_back(tmp_path, monkeypatch):
    """A query read too long for the stream batch geometry (> 2^30 window
    keys at the minimum 2048-read batch) makes search_multi_set return
    None instead of raising, so the driver can fall back to the classic
    pairwise schedule."""
    rng = np.random.default_rng(7)
    monkeypatch.setenv("COMMET_TPU_STREAM", "force")
    idx_sets, _ = _mk(tmp_path, rng, n_idx_sets=1)
    eng = Engine(k=K, t=T, batch=64)
    r = eng.build_resident(idx_sets[0])
    assert r is not None

    # one ~300kb read: wmax ~ 3e5 > 2^30 / (2048 * 2)
    long_fa = str(tmp_path / "long.fa")
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    seq = lut[rng.integers(0, 4, size=300_000)].tobytes()
    with open(long_fa, "wb") as f:
        f.write(b">long\n" + seq + b"\n")
    rs_q = ReadSet("QL")
    rs_q.add_file(long_fa)
    assert eng.search_multi_set(rs_q, [r], save=False) is None

    # budget pre-check: a remaining-budget argument below the estimated
    # footprint refuses before any device allocation
    assert eng.build_resident(idx_sets[0], budget=10.0) is None


@pytest.mark.parametrize("max_kmer", [None, 900])
def test_planes_multi_matches_pairwise(tmp_path, monkeypatch, max_kmer):
    """The HIGH-FILL amortized path (resident dense planes + shared-batch
    cascade, Engine.search_multi_set_planes) must match the pairwise
    engine's tags/counters/bv bytes, including multi-partition indexes."""
    rng = np.random.default_rng(55)
    monkeypatch.setenv("COMMET_TPU_STREAM", "0")  # the high-fill regime
    idx_sets, qry_fa = _mk(tmp_path, rng)

    eng = Engine(k=K, t=T, batch=64, max_kmer=max_kmer)
    residents = [eng.build_resident_planes(rs) for rs in idx_sets]
    assert all(r is not None for r in residents)
    if max_kmer is not None:
        assert any(len(r.partitions) > 1 for r in residents)

    out_multi = tmp_path / "multi"
    out_pair = tmp_path / "pair"
    os.makedirs(out_multi)
    os.makedirs(out_pair)

    rs_q = ReadSet("Q")
    rs_q.add_file(qry_fa)
    got = eng.search_multi_set_planes(rs_q, residents,
                                      out_dir=str(out_multi),
                                      log_dir=str(out_multi))

    for rs in idx_sets:
        eng2 = Engine(k=K, t=T, batch=64, max_kmer=max_kmer)
        rs_q2 = ReadSet("Q")
        rs_q2.add_file(qry_fa)
        want = eng2.index_and_search(rs, [rs_q2], out_dir=str(out_pair),
                                     log_dir=str(out_pair))["Q"]
        g = got[rs.name]
        for key in ("indexed", "searched", "shared"):
            assert g[key] == want[key], (rs.name, key, g, want)
        name = os.path.basename(qry_fa) + "_in_" + rs.name + ".bv"
        with open(out_multi / name, "rb") as f1, \
                open(out_pair / name, "rb") as f2:
            assert f1.read() == f2.read(), name
    assert got["I0"]["shared"] > 0


def test_planes_multi_budget_and_k33(tmp_path, monkeypatch):
    """build_resident_planes refuses when the planes exceed the budget;
    k=33 wide keys are servable (4-plane addressing covers k <= 36)."""
    rng = np.random.default_rng(6)
    monkeypatch.setenv("COMMET_TPU_STREAM", "0")
    idx_sets, qry_fa = _mk(tmp_path, rng, n_idx_sets=2, n_idx=30, n_qry=40,
                           length=110)
    eng = Engine(k=K, t=T, batch=64)
    assert eng.build_resident_planes(idx_sets[0], budget=10.0) is None

    eng33 = Engine(k=33, t=T, batch=64)
    residents = [eng33.build_resident_planes(rs) for rs in idx_sets]
    assert all(r is not None for r in residents)
    rs_q = ReadSet("Q")
    rs_q.add_file(qry_fa)
    got = eng33.search_multi_set_planes(rs_q, residents, save=False)
    eng2 = Engine(k=33, t=T, batch=64)
    rs_q2 = ReadSet("Q")
    rs_q2.add_file(qry_fa)
    want = eng2.index_and_search(idx_sets[0], [rs_q2], save=False)["Q"]
    for key in ("indexed", "searched", "shared"):
        assert got["I0"][key] == want[key], key


def test_driver_plane_cohorts_matches_classic(tmp_path, monkeypatch):
    """Full driver with the stream disabled (the high-fill situation):
    the plane-cohort schedule must produce byte-identical .bv files and
    CSV matrices to the classic per-round schedule."""
    from commet_tpu.cli import commet as commet_cli

    rng = np.random.default_rng(707)
    monkeypatch.setenv("COMMET_TPU_STREAM", "0")
    donors = None
    fofs = []
    for s in range(3):
        fa = str(tmp_path / f"set{s}.fa")
        d = write_fasta(fa, rng, 60, 90, donors=donors)
        donors = donors or d
        fofs.append(f"S{s}: {fa}")
    fof = tmp_path / "fof.txt"
    fof.write_text("\n".join(fofs) + "\n")

    outs = {}
    for mode, flag in (("cohort", "force"), ("classic", "")):
        monkeypatch.setenv("COMMET_TPU_PLANE_COHORTS", flag)
        monkeypatch.setenv("COMMET_TPU_MULTI", "1" if flag else "0")
        out = str(tmp_path / mode) + "/"
        rc = commet_cli.main([str(fof), "-k", str(K), "-t", str(T),
                              "-o", out, "--no-plots"])
        assert rc == 0
        outs[mode] = out
    names = sorted(n for n in os.listdir(outs["classic"])
                   if n.endswith(".bv") or n.endswith(".csv"))
    assert any(n.endswith(".bv") for n in names)
    for n in names:
        with open(outs["cohort"] + n, "rb") as f1, \
                open(outs["classic"] + n, "rb") as f2:
            assert f1.read() == f2.read(), n


def test_multi_wide_matches_pairwise(tmp_path, monkeypatch):
    """k=33 (the reference default) amortized engine path: wide-key joins
    carry the packed hi-bit streams; the tiny AMBIG residue resolves
    through the host-side exact uint64 sets (no per-index bit planes).
    Tags/counters/bvs must equal the pairwise path byte for byte."""
    rng = np.random.default_rng(3131)
    monkeypatch.setenv("COMMET_TPU_STREAM", "force")
    k33 = 33
    idx_sets = []
    donors = None
    for s in range(2):
        fa = str(tmp_path / f"idx{s}.fa")
        d = write_fasta(fa, rng, 50, 110, k=k33)
        donors = donors or d
        rs = ReadSet(f"I{s}")
        rs.add_file(fa)
        idx_sets.append(rs)
    qry_fa = str(tmp_path / "qry.fa")
    write_fasta(qry_fa, rng, 90, 110, donors=donors, k=k33)

    eng = Engine(k=k33, t=T, batch=64)
    residents = [eng.build_resident(rs) for rs in idx_sets]
    assert all(r is not None for r in residents)

    out_multi = tmp_path / "m"
    out_pair = tmp_path / "p"
    os.makedirs(out_multi)
    os.makedirs(out_pair)
    rs_q = ReadSet("Q")
    rs_q.add_file(qry_fa)
    got = eng.search_multi_set(rs_q, residents, out_dir=str(out_multi),
                               log_dir=str(out_multi))
    for rs in idx_sets:
        eng2 = Engine(k=k33, t=T, batch=64)
        rs_q2 = ReadSet("Q")
        rs_q2.add_file(qry_fa)
        want = eng2.index_and_search(rs, [rs_q2], out_dir=str(out_pair),
                                     log_dir=str(out_pair))["Q"]
        for key in ("indexed", "searched", "shared"):
            assert got[rs.name][key] == want[key], (rs.name, key)
        name = os.path.basename(qry_fa) + "_in_" + rs.name + ".bv"
        with open(out_multi / name, "rb") as f1, \
                open(out_pair / name, "rb") as f2:
            assert f1.read() == f2.read(), name
    assert got["I0"]["shared"] > 0
