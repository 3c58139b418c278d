"""Multi-device sharded execution must match single-device kernels exactly,
on an 8-way virtual CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from commet_tpu.core import kernels
from commet_tpu.parallel import sharded
from util import ensure_refbuild, slice_fasta as _slice_fasta


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return sharded.make_mesh(8)


@pytest.mark.parametrize("k", [15, 18])
def test_sharded_matches_single(mesh, k):
    t = 2
    rng = np.random.default_rng(5)
    n, lpad = 64, 96
    # ~10% invalid to exercise run resets
    idx_codes = rng.integers(0, 4, size=(n, lpad)).astype(np.int32)
    qry_codes = rng.integers(0, 4, size=(n, lpad)).astype(np.int32)
    qry_codes[rng.random(size=qry_codes.shape) < 0.05] = 4
    qry_codes[: n // 2, 20 : 20 + 2 * k] = idx_codes[: n // 2, 8 : 8 + 2 * k]

    # single-device reference
    p1 = kernels.build_chunk(kernels.alloc_planes(k), jnp.asarray(idx_codes), k)
    tag1, _ = kernels.search_batch(p1, jnp.asarray(qry_codes), k, t)

    # sharded
    planes = sharded.alloc_planes_sharded(k, mesh)
    build_fn, search_fn = sharded.build_search_step(mesh, k, t)
    planes = build_fn(planes, jnp.asarray(idx_codes))
    tag8 = search_fn(planes, jnp.asarray(qry_codes))

    assert (np.asarray(tag8) == np.asarray(tag1)).all()
    # plane contents identical too (concatenated shards == flat planes)
    flat8 = np.asarray(planes).reshape(-1)
    assert (flat8 == np.asarray(p1)).all()


def test_sharded_engine_matches_golden(mesh, tmp_path):
    """The full engine in multi-chip (plane-sharded) mode must reproduce the
    reference binary bit-for-bit on a k=15 MULTI-partition workload. Sliced
    to 600/400 reads (still ~15 max_kmer partitions at k=15 - the partition
    cursor, dropped-boundary-read and found-read-skipping semantics are all
    exercised); the golden is generated live by the reference binary."""
    import os
    import subprocess

    from commet_tpu.engine.engine import Engine
    from commet_tpu.io.reads import ReadSet

    a_fa = str(tmp_path / "A600.fa")
    b_fa = str(tmp_path / "B400.fa")
    _slice_fasta("/root/reference/ABCDE_bench/A.fa", a_fa, 600)
    _slice_fasta("/root/reference/ABCDE_bench/B.fa", b_fa, 400)

    index_set = ReadSet("A")
    index_set.add_file(a_fa)
    query = ReadSet("B")
    query.add_file(b_fa)

    eng = Engine(k=15, t=2, batch=4096, mesh=mesh, mesh_mode="plane")
    # ~96 kmers/read vs max_kmer=3814 at k=15: genuinely multi-partition
    assert len(eng.partitions(np.full(600, 96, dtype=np.int64))) > 5
    out = str(tmp_path)
    eng.index_and_search(index_set, [query], out_dir=out, log_dir=out)

    ref_bin = ensure_refbuild()
    if ref_bin is None:
        pytest.skip("/root/reference not available")
    fof_i = tmp_path / "i.txt"
    fof_s = tmp_path / "s.txt"
    fof_i.write_text(f"A: {a_fa}\n")
    fof_s.write_text(f"B: {b_fa}\n")
    refout = str(tmp_path / "refout")
    subprocess.run([ref_bin, "-i", str(fof_i), "-s", str(fof_s),
                    "-k", "15", "-t", "2", "-o", refout, "-l", refout],
                   check=True, capture_output=True)
    with open(os.path.join(out, "B400.fa_in_A.bv"), "rb") as f1, \
         open(os.path.join(refout, "B400.fa_in_A.bv"), "rb") as f2:
        assert f1.read() == f2.read()


def test_dryrun_multichip():
    import __graft_entry__
    __graft_entry__.dryrun_multichip(8)


def test_entry_compiles():
    import __graft_entry__
    fn, args = __graft_entry__.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (args[1].shape[0],)


@pytest.mark.parametrize("k", [15, 18])
def test_dp_mode_matches_single(mesh, k):
    """DP mesh mode (planes replicated, batch sharded, GSPMD-partitioned
    cascade kernels) must match the single-device kernels exactly."""
    t = 2
    rng = np.random.default_rng(7)
    n, lpad = 64, 96
    idx_codes = rng.integers(0, 4, size=(n, lpad)).astype(np.int32)
    qry_codes = rng.integers(0, 4, size=(n, lpad)).astype(np.int32)
    qry_codes[rng.random(size=qry_codes.shape) < 0.05] = 4
    qry_codes[: n // 2, 20 : 20 + 2 * k] = idx_codes[: n // 2, 8 : 8 + 2 * k]

    p1 = kernels.build_chunk(kernels.alloc_planes(k), jnp.asarray(idx_codes), k)
    tag1, _ = kernels.search_batch(p1, jnp.asarray(qry_codes), k, t)

    rep, bsh = sharded.dp_shardings(mesh)
    planes = jax.device_put(
        np.zeros(4 * kernels.plane_words(k), dtype=np.uint32), rep)
    planes = kernels.build_chunk(planes, jax.device_put(idx_codes, rep), k)
    assert (np.asarray(planes) == np.asarray(p1)).all()
    v = np.asarray(kernels.probe_cascade2(
        planes, jax.device_put(qry_codes, bsh), k, t, 4, lpad - k + 1))
    tags = v == kernels.VERDICT_TAGGED
    amb = np.nonzero(v == kernels.VERDICT_AMBIG)[0]
    if len(amb):
        got, _ = kernels.search_batch(planes, jnp.asarray(qry_codes[amb]), k, t)
        tags[amb] = np.asarray(got)
    assert (tags == np.asarray(tag1)).all()


def test_engine_dp_mode_counters(mesh, tmp_path):
    """Engine in DP mesh mode must reproduce single-chip counters (sliced
    multi-partition k=15 workload, see test_sharded_engine_matches_golden)."""
    from commet_tpu.engine.engine import Engine
    from commet_tpu.io.reads import ReadSet

    a_fa = str(tmp_path / "A600.fa")
    b_fa = str(tmp_path / "B400.fa")
    _slice_fasta("/root/reference/ABCDE_bench/A.fa", a_fa, 600)
    _slice_fasta("/root/reference/ABCDE_bench/B.fa", b_fa, 400)

    def mkset(name, f):
        rs = ReadSet(name)
        rs.add_file(f)
        return rs

    k, t = 15, 2
    e_dp = Engine(k=k, t=t, batch=2048, mesh=mesh)
    assert e_dp.mesh_mode == "dp"
    e_1 = Engine(k=k, t=t, batch=2048)
    c_dp = e_dp.index_and_search(mkset("A", a_fa), [mkset("B", b_fa)],
                                 save=False)
    c_1 = e_1.index_and_search(mkset("A", a_fa), [mkset("B", b_fa)],
                               save=False)
    assert c_1["B"]["shared"] > 0
    for key in ("indexed", "searched", "shared"):
        assert c_dp["B"][key] == c_1["B"][key]


def test_sharded_stream_index_matches_single(mesh):
    """Key-range-sharded StreamIndex: each device owns a contiguous key
    range of the sorted join columns + exact sets; the pmax-merged
    verdicts must equal the single-device verdicts, and with the psum-OR
    exact fallback reproduce the single-device final tags exactly."""
    from commet_tpu.core import stream

    k, t = 15, 2
    rng = np.random.default_rng(4321)
    n_idx, n_qry, length = 90, 128, 64
    idx = rng.integers(0, 4, size=(n_idx, length)).astype(np.int32)
    qry = rng.integers(0, 4, size=(n_qry, length)).astype(np.int32)
    # implant shared fragments into half the queries
    half = n_qry // 2
    frag = 2 * k
    dn = idx[rng.integers(0, n_idx, size=half)]
    ds = rng.integers(0, length - frag + 1, size=half)
    qs = rng.integers(0, length - frag + 1, size=half)
    rows = np.arange(half)[:, None]
    cols = np.arange(frag)
    qry[rows, qs[:, None] + cols] = dn[rows, ds[:, None] + cols]

    ka, kb, hib, flags, cnt = stream.chunk_index_keys_codes(
        jnp.asarray(idx), k)
    sx = stream.finalize_index([ka], [kb], [hib], [flags], [int(cnt)])
    wmax = length - k + 1

    # single-device reference result (verdicts + exact fallback)
    v1 = np.asarray(stream.probe_cascade2_stream_codes(
        sx.ika, sx.ikb, sx.mi, jnp.asarray(qry), k, t, wmax))
    tags_want = v1 == kernels.VERDICT_TAGGED
    amb1 = np.nonzero(v1 == kernels.VERDICT_AMBIG)[0]
    qc2, qvd = kernels.pack_codes_np(qry.astype(np.uint8))
    if len(amb1):
        got = np.asarray(stream.probe_exact_sets(
            sx.sa, sx.sb, sx.sc, sx.sd, sx.mi, jnp.asarray(qc2[amb1]),
            jnp.asarray(qvd[amb1]), length, k, t, wmax))
        tags_want[amb1] = got

    # sharded: forced-small slices across the 8-device mesh
    shards = sharded.shard_stream_index(sx, 8)
    assert int(shards["mi_loc"].sum()) == int(sx.mi)
    step = sharded.sharded_stream_step(mesh, length, k, t, wmax)
    lens = jnp.full((n_qry,), length, jnp.int32)
    c2only = kernels.pack_codes2_np(qry.astype(np.uint8))
    v8 = np.asarray(step(shards["ika"], shards["ikb"], shards["mi_loc"],
                         jnp.asarray(c2only), lens))
    tags = v8 == kernels.VERDICT_TAGGED
    amb = np.nonzero(v8 == kernels.VERDICT_AMBIG)[0]
    # each shard's verdicts are exact for its slice, so the max-merge
    # reproduces the single-device verdicts
    np.testing.assert_array_equal(v8, v1)
    if len(amb):
        ex = sharded.sharded_exact_step(mesh, length, k, t, wmax)
        got = np.asarray(ex(shards["sets"], shards["set_mi"],
                            jnp.asarray(qc2[amb]), jnp.asarray(qvd[amb])))
        tags[amb] = got
    np.testing.assert_array_equal(tags, tags_want)
    assert tags.sum() > 0
