"""Engine-level integration tests for the sorted-join stream probe:
COMMET_TPU_STREAM=force runs the real engine flow (key collection during
build, finalize, streamed cascade, fallback rounds) on CPU, and a broken
join must raise out of the engine instead of being hidden."""

import numpy as np
import pytest

from commet_tpu.engine.engine import Engine
from commet_tpu.io.reads import ReadSet

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
K = 15
T = 2


def write_fasta(path, rng, n, length, donors=None, k=K):
    """Random fasta; when ``donors`` is given, implant a 2k fragment from a
    donor read into every other read (tagged at t=2)."""
    seqs = [bytes(rng.choice(BASES, size=length)) for _ in range(n)]
    if donors is not None:
        for i in range(0, n, 2):
            d = donors[int(rng.integers(len(donors)))]
            start = int(rng.integers(0, len(d) - 2 * k + 1))
            frag = d[start : start + 2 * k]
            pos = int(rng.integers(0, length - 2 * k + 1))
            seqs[i] = seqs[i][:pos] + frag + seqs[i][pos + 2 * k :]
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(b">r%d\n%s\n" % (i, s))
    return seqs


def make_sets(tmp_path, rng):
    idx_fa = str(tmp_path / "idx.fa")
    qry_fa = str(tmp_path / "qry.fa")
    donors = write_fasta(idx_fa, rng, 120, 90)
    write_fasta(qry_fa, rng, 160, 90, donors=donors)
    rs_i = ReadSet("I")
    rs_i.add_file(idx_fa)
    rs_q = ReadSet("Q")
    rs_q.add_file(qry_fa)
    return rs_i, rs_q


def test_engine_forced_stream_matches_gather(tmp_path, monkeypatch):
    from commet_tpu.core import stream as stream_mod

    rng = np.random.default_rng(7)
    rs_i, rs_q = make_sets(tmp_path, rng)

    monkeypatch.setenv("COMMET_TPU_STREAM", "force")
    calls = {"n": 0}
    real = stream_mod.probe_multi_stream_clean

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(stream_mod, "probe_multi_stream_clean", counting)
    eng = Engine(k=K, t=T, batch=2048)
    assert eng.stream, "forced stream engine must stream on CPU"
    got = eng.index_and_search(rs_i, [rs_q], save=False)
    assert calls["n"] > 0, "stream probe was never invoked (gate bug?)"

    rs_i2, rs_q2 = make_sets(tmp_path, np.random.default_rng(7))
    monkeypatch.setenv("COMMET_TPU_STREAM", "0")
    eng0 = Engine(k=K, t=T, batch=2048)
    assert not eng0.stream
    want = eng0.index_and_search(rs_i2, [rs_q2], save=False)

    assert got["Q"]["shared"] == want["Q"]["shared"]
    assert got["Q"]["shared"] > 0  # implanted fragments must be found
    got_bv = np.asarray(rs_q.result_bvs[0].data)
    want_bv = np.asarray(rs_q2.result_bvs[0].data)
    np.testing.assert_array_equal(got_bv, want_bv)


def test_stream_mode_builds_no_planes(tmp_path, monkeypatch):
    """Stream-serving partitions must never touch the bit planes: poison
    every plane-building entry point and run the full engine flow."""
    from commet_tpu.core import kernels

    def boom(*a, **k):
        raise AssertionError("bit planes built in stream mode")

    monkeypatch.setenv("COMMET_TPU_STREAM", "force")
    monkeypatch.setattr(kernels, "alloc_planes", boom)
    monkeypatch.setattr(kernels, "build_chunk", boom)
    monkeypatch.setattr(kernels, "build_chunk_packed", boom)

    rng = np.random.default_rng(31)
    rs_i, rs_q = make_sets(tmp_path, rng)
    eng = Engine(k=K, t=T, batch=2048)
    got = eng.index_and_search(rs_i, [rs_q], save=False)
    assert got["Q"]["shared"] > 0


def test_three_pass_forced_stream_matches(tmp_path, monkeypatch):
    """compare_reads (the 3-pass refinement with apply_bv narrowing between
    passes) must produce identical .bv bytes with the stream forced on."""
    from commet_tpu.cli import compare_reads as cr_cli

    rng = np.random.default_rng(23)
    idx_fa = str(tmp_path / "a.fa")
    qry_fa = str(tmp_path / "b.fa")
    donors = write_fasta(idx_fa, rng, 90, 80)
    write_fasta(qry_fa, rng, 110, 80, donors=donors)
    fof_a = tmp_path / "a.txt"
    fof_b = tmp_path / "b.txt"
    fof_a.write_text(f"A: {idx_fa}\n")
    fof_b.write_text(f"B: {qry_fa}\n")

    outs = {}
    for mode in ("force", "0"):
        monkeypatch.setenv("COMMET_TPU_STREAM", mode)
        out = str(tmp_path / f"out_{mode}")
        rc = cr_cli.main(["-i", str(fof_a), "-s", str(fof_b),
                          "-k", str(K), "-t", str(T), "-o", out, "-l", out])
        assert rc == 0
        blobs = {}
        for name in ("a.fa_in_B.bv", "b.fa_in_A.bv"):
            with open(f"{out}/{name}", "rb") as f:
                blobs[name] = f.read()
        outs[mode] = blobs
    assert outs["force"] == outs["0"]


def test_long_read_geometry_falls_back_exact(tmp_path, monkeypatch):
    """When the batch's window-key volume cannot fit the stream batch
    even at the minimum batch size (multi-kb reads), the engine must route
    the whole search through the exact probe instead of tripping the
    stream's capacity assert (code-review finding). Simulated by shrinking
    the shared capacity constant."""
    from commet_tpu.core import stream as stream_mod

    monkeypatch.setenv("COMMET_TPU_STREAM", "force")
    monkeypatch.setattr(stream_mod, "MAX_UNSORT_KEYS", 40_000)
    calls = {"n": 0}
    real = stream_mod.probe_multi_stream_clean

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(stream_mod, "probe_multi_stream_clean", counting)

    rng = np.random.default_rng(41)
    rs_i, rs_q = make_sets(tmp_path, rng)
    eng = Engine(k=K, t=T, batch=2048)
    assert eng.stream
    got = eng.index_and_search(rs_i, [rs_q], save=False)
    assert calls["n"] == 0, "stream probe must not run past its capacity"
    assert got["Q"]["shared"] > 0

    rs_i2, rs_q2 = make_sets(tmp_path, np.random.default_rng(41))
    monkeypatch.setenv("COMMET_TPU_STREAM", "0")
    eng0 = Engine(k=K, t=T, batch=2048)
    want = eng0.index_and_search(rs_i2, [rs_q2], save=False)
    assert got["Q"]["shared"] == want["Q"]["shared"]


def test_engine_forced_stream_k33_matches_oracle(tmp_path, monkeypatch):
    """k=33 (the reference default): wide-key streamed round 1 + plane
    fallback must reproduce the reference oracle's tags exactly."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from oracle import index_reads, search_read

    k = 33
    rng = np.random.default_rng(77)
    idx_fa = str(tmp_path / "i33.fa")
    qry_fa = str(tmp_path / "q33.fa")
    donors = write_fasta(idx_fa, rng, 60, 110)
    write_fasta(qry_fa, rng, 80, 110, donors=donors, k=k)

    monkeypatch.setenv("COMMET_TPU_STREAM", "force")
    rs_i = ReadSet("I")
    rs_i.add_file(idx_fa)
    rs_q = ReadSet("Q")
    rs_q.add_file(qry_fa)
    eng = Engine(k=k, t=T, batch=2048)
    assert eng.stream
    got = eng.index_and_search(rs_i, [rs_q], save=False)

    with open(idx_fa) as f:
        idx_seqs = [l.strip() for l in f if not l.startswith(">")]
    with open(qry_fa) as f:
        qry_seqs = [l.strip() for l in f if not l.startswith(">")]
    bloom = index_reads(idx_seqs, k)
    expected = np.array([search_read(bloom, s, k, T) for s in qry_seqs])
    assert got["Q"]["shared"] == int(expected.sum()) > 0
    got_tags = np.unpackbits(np.asarray(rs_q.result_bvs[0].data),
                             bitorder="little")[: len(qry_seqs)]
    np.testing.assert_array_equal(got_tags.astype(bool), expected)


def test_dp_mesh_forced_stream_matches(tmp_path, monkeypatch):
    """DP mesh mode with the stream forced: every chip streams its batch
    shard against the replicated StreamIndex; tags must equal the
    single-chip stream engine's byte for byte."""
    import jax

    from commet_tpu.parallel import sharded

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = sharded.make_mesh(8)

    monkeypatch.setenv("COMMET_TPU_STREAM", "force")
    rng = np.random.default_rng(19)
    rs_i, rs_q = make_sets(tmp_path, rng)
    eng = Engine(k=K, t=T, batch=2048, mesh=mesh, mesh_mode="dp")
    assert eng.stream
    got = eng.index_and_search(rs_i, [rs_q], save=False)

    rs_i1, rs_q1 = make_sets(tmp_path, np.random.default_rng(19))
    eng1 = Engine(k=K, t=T, batch=2048)
    want = eng1.index_and_search(rs_i1, [rs_q1], save=False)
    assert got["Q"]["shared"] == want["Q"]["shared"] > 0
    np.testing.assert_array_equal(np.asarray(rs_q.result_bvs[0].data),
                                  np.asarray(rs_q1.result_bvs[0].data))


def test_dp_mesh_wide_stream_matches(tmp_path, monkeypatch):
    """k=33 (the reference default) DP stream: the packed hi-bit stream
    replicates alongside the join planes; multi-chip tags must equal the
    single-chip engine's byte for byte."""
    import jax

    from commet_tpu.parallel import sharded

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    # two devices: each holds a replica of the 4 GiB k=33 fallback planes,
    # and on the CPU backend every replica is a separate host buffer
    mesh = sharded.make_mesh(2)

    monkeypatch.setenv("COMMET_TPU_STREAM", "force")
    k33 = 33
    rng = np.random.default_rng(23)
    idx_fa = str(tmp_path / "idx.fa")
    qry_fa = str(tmp_path / "qry.fa")
    donors = write_fasta(idx_fa, rng, 100, 120, k=k33)
    write_fasta(qry_fa, rng, 144, 120, donors=donors, k=k33)

    def mkset(name, f):
        rs = ReadSet(name)
        rs.add_file(f)
        return rs

    eng = Engine(k=k33, t=T, batch=2048, mesh=mesh, mesh_mode="dp")
    assert eng.stream, "wide-key DP stream must be on when forced"
    rs_q = mkset("Q", qry_fa)
    got = eng.index_and_search(mkset("I", idx_fa), [rs_q], save=False)

    eng1 = Engine(k=k33, t=T, batch=2048)
    rs_q1 = mkset("Q", qry_fa)
    want = eng1.index_and_search(mkset("I", idx_fa), [rs_q1], save=False)
    assert got["Q"]["shared"] == want["Q"]["shared"] > 0
    np.testing.assert_array_equal(np.asarray(rs_q.result_bvs[0].data),
                                  np.asarray(rs_q1.result_bvs[0].data))


def test_dp_mesh_dirty_batches_stream(tmp_path, monkeypatch):
    """Reads with N bases under DP: dirty batches route through the packed
    DP stream wrapper (validity plane shipped) + the fallback; tags equal
    single-chip."""
    import jax

    from commet_tpu.parallel import sharded

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = sharded.make_mesh(8)

    monkeypatch.setenv("COMMET_TPU_STREAM", "force")
    rng = np.random.default_rng(29)
    idx_fa = str(tmp_path / "idx.fa")
    qry_fa = str(tmp_path / "qry.fa")
    donors = write_fasta(idx_fa, rng, 120, 90)
    seqs = write_fasta(qry_fa, rng, 160, 90, donors=donors)
    # poison some query reads with N (dirty batches)
    with open(qry_fa, "wb") as f:
        for i, s in enumerate(seqs):
            if i % 5 == 1:
                s = s[:40] + b"N" + s[41:]
            f.write(b">r%d\n%s\n" % (i, s))

    def mkset(name, fpath):
        rs = ReadSet(name)
        rs.add_file(fpath)
        return rs

    eng = Engine(k=K, t=T, batch=2048, mesh=mesh, mesh_mode="dp")
    rs_q = mkset("Q", qry_fa)
    got = eng.index_and_search(mkset("I", idx_fa), [rs_q], save=False)
    eng1 = Engine(k=K, t=T, batch=2048)
    rs_q1 = mkset("Q", qry_fa)
    want = eng1.index_and_search(mkset("I", idx_fa), [rs_q1], save=False)
    assert got["Q"]["shared"] == want["Q"]["shared"] > 0
    np.testing.assert_array_equal(np.asarray(rs_q.result_bvs[0].data),
                                  np.asarray(rs_q1.result_bvs[0].data))


def test_poisoned_stream_falls_back(tmp_path, monkeypatch):
    """A broken join must raise out of the engine: the stream path either
    works or fails loudly, and nothing falls back behind the caller's back
    (an engine that silently dropped to the gather cascade would hide a
    device path that never ran)."""
    from commet_tpu.core import stream as stream_mod

    def boom(*a, **k):
        raise NameError("name 'wmin' is not defined")

    # the engine's entry points into the join (the jitted probes may
    # already be compiled in this process, so the join itself would not
    # be traced again)
    for name in ("probe_multi_stream_clean", "probe_multi_stream_packed"):
        monkeypatch.setattr(stream_mod, name, boom)
    monkeypatch.setenv("COMMET_TPU_STREAM", "force")

    rng = np.random.default_rng(11)
    rs_i, rs_q = make_sets(tmp_path, rng)
    eng = Engine(k=K, t=T, batch=2048)
    assert eng.stream
    with pytest.raises(NameError, match="wmin"):
        eng.index_and_search(rs_i, [rs_q], save=False)
