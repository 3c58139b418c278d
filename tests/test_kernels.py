"""Property tests: device kernels vs the literal C++-transcription oracle."""

import numpy as np
import pytest

import jax.numpy as jnp

from commet_tpu.core import kernels
from commet_tpu.io.reads import CODE_LUT

from oracle import BloomOracle, count_kmers_read, index_reads, search_read

BASES = np.frombuffer(b"ACGTNacgtn", dtype=np.uint8)


def random_seqs(rng, n, lmin, lmax, n_frac=0.05):
    seqs = []
    for _ in range(n):
        ln = int(rng.integers(lmin, lmax + 1))
        probs = np.full(10, (1 - n_frac) / 8)
        probs[4] = probs[9] = n_frac / 2
        seqs.append(bytes(rng.choice(BASES, size=ln, p=probs)))
    return seqs


def encode(seqs, lpad):
    out = np.full((len(seqs), lpad), kernels.INVALID_CODE, dtype=np.uint8)
    for i, s in enumerate(seqs):
        arr = CODE_LUT[np.frombuffer(s, dtype=np.uint8)]
        out[i, : len(s)] = arr[:lpad]
    return out.astype(np.int32)


@pytest.mark.parametrize("k", [8, 15, 21, 31, 32, 33])
@pytest.mark.parametrize("t", [1, 2, 3])
def test_search_matches_oracle(k, t):
    rng = np.random.default_rng(1234 + k * 10 + t)
    idx_seqs = random_seqs(rng, 30, k, 3 * k + 10)
    qry_seqs = random_seqs(rng, 60, k - 2, 3 * k + 10)
    # make half the queries contain real index k-mers (fwd and rc)
    for i in range(0, len(qry_seqs), 2):
        donor = idx_seqs[int(rng.integers(len(idx_seqs)))].decode()
        if len(donor) >= k:
            start = int(rng.integers(0, len(donor) - k + 1))
            frag = donor[start : start + k]
            if rng.random() < 0.5:
                comp = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N",
                        "a": "t", "c": "g", "g": "c", "t": "a", "n": "n"}
                frag = "".join(comp[c] for c in reversed(frag))
            q = qry_seqs[i].decode()
            pos = int(rng.integers(0, max(1, len(q) - k + 1)))
            qry_seqs[i] = (q[:pos] + frag + q[pos + k :]).encode()

    bloom = index_reads([s.decode() for s in idx_seqs], k)
    expected = np.array(
        [search_read(bloom, s.decode(), k, t) for s in qry_seqs])

    lpad = max(max(len(s) for s in qry_seqs), k)
    planes = kernels.alloc_planes(k)
    planes = kernels.build_chunk(planes, jnp.asarray(encode(idx_seqs, lpad)), k)
    qcodes = jnp.asarray(encode(qry_seqs, lpad))
    tagged, _ = kernels.search_batch(planes, qcodes, k, t)
    got = np.asarray(tagged)
    assert (got == expected).all(), np.nonzero(got != expected)
    # split-strand kernels must union to the same result
    f = np.asarray(kernels.search_batch_fwd(planes, qcodes, k, t))
    r = np.asarray(kernels.search_batch_rc(planes, qcodes, k, t))
    assert ((f | r) == expected).all()


@pytest.mark.parametrize("k", [8, 32, 33])
def test_count_kmers(k):
    rng = np.random.default_rng(99 + k)
    seqs = random_seqs(rng, 40, 1, 4 * k, n_frac=0.1)
    lpad = max(max(len(s) for s in seqs), k)
    got = np.asarray(kernels.count_kmers(jnp.asarray(encode(seqs, lpad)), k))
    expected = [count_kmers_read(s.decode(), k) for s in seqs]
    assert got.tolist() == expected


def test_build_is_scatter_or():
    """Building twice (duplicate feeds) must be idempotent."""
    k = 15
    rng = np.random.default_rng(7)
    seqs = random_seqs(rng, 20, k, 60)
    lpad = 60
    codes = jnp.asarray(encode(seqs, lpad))
    p1 = kernels.build_chunk(kernels.alloc_planes(k), codes, k)
    p1 = np.asarray(p1)
    p2 = kernels.build_chunk(jnp.asarray(p1), codes, k)
    assert (np.asarray(p2) == p1).all()


@pytest.mark.parametrize("k,t,V", [(32, 2, 2), (33, 2, 4), (15, 3, 4),
                                   (12, 2, 4)])
def test_cascade_matches_full(k, t, V):
    """The cascade probe (plane-A prefilter + targeted verify + exact
    fallback) composed per the engine's flow must reproduce the full probe's
    tags exactly — including at saturated fills (k=12) where most selection
    goes ambiguous."""
    rng = np.random.default_rng(1234 + k * 10 + t)
    L = 90
    idx_seqs = random_seqs(rng, 150, k, L, n_frac=0.0)
    qry_seqs = random_seqs(rng, 300, k, L, n_frac=0.05)
    # implant fwd and rc fragments of marginal lengths
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    for i in range(120):
        fl = int(rng.integers(k, min(2 * k + 6, L - 1)))
        d = idx_seqs[int(rng.integers(len(idx_seqs)))]
        if len(d) < fl:
            continue
        ds = int(rng.integers(0, len(d) - fl + 1))
        frag = d[ds : ds + fl]
        if i % 2:
            frag = frag.translate(comp)[::-1]
        q = qry_seqs[i]
        if len(q) <= fl:
            qry_seqs[i] = frag
        else:
            pos = int(rng.integers(0, len(q) - fl))
            qry_seqs[i] = q[:pos] + frag + q[pos + fl :]

    lpad = max(max(len(s) for s in qry_seqs), k)
    planes = kernels.alloc_planes(k)
    planes = kernels.build_chunk(planes, jnp.asarray(encode(idx_seqs, lpad)), k)
    qcodes = encode(qry_seqs, lpad)
    expected, _ = kernels.search_batch(planes, jnp.asarray(qcodes), k, t)
    expected = np.asarray(expected)

    tags = np.zeros(len(qry_seqs), dtype=bool)
    undec = np.arange(len(qry_seqs))
    for strand in ("fwd", "rc"):
        if not len(undec):
            break
        v = np.asarray(kernels.probe_cascade(
            planes, jnp.asarray(qcodes[undec]), k, t, V, strand))
        tags[undec[v == kernels.VERDICT_TAGGED]] = True
        amb = undec[v == kernels.VERDICT_AMBIG]
        if len(amb):
            fn = (kernels.search_batch_fwd if strand == "fwd"
                  else kernels.search_batch_rc)
            got = np.asarray(fn(planes, jnp.asarray(qcodes[amb]), k, t))
            tags[amb] |= got
        undec = undec[~tags[undec]]
    assert (tags == expected).all(), np.nonzero(tags != expected)

    # fused both-strand cascade + full fallback must agree too
    v2 = np.asarray(kernels.probe_cascade2(
        planes, jnp.asarray(qcodes), k, t, V,
        max(1, max(len(s) for s in qry_seqs) - k + 1)))
    tags2 = v2 == kernels.VERDICT_TAGGED
    amb2 = np.nonzero(v2 == kernels.VERDICT_AMBIG)[0]
    if len(amb2):
        got, _ = kernels.search_batch(planes, jnp.asarray(qcodes[amb2]), k, t)
        tags2[amb2] = np.asarray(got)
    assert (tags2 == expected).all(), np.nonzero(tags2 != expected)


@pytest.mark.parametrize("k,L", [(8, 40), (15, 110), (31, 128), (32, 110),
                                 (33, 128), (36, 200)])
def test_window_keys_matches_window_scan(k, L):
    """The gather-free funnel-extraction key generator must agree with the
    sequential-scan reference implementation at every complete window."""
    if L < k:
        pytest.skip("read shorter than k")
    rng = np.random.default_rng(42 + k)
    codes = rng.integers(0, 5, size=(7, L)).astype(np.int32)  # incl invalid
    codes[0] = rng.integers(0, 4, size=L)  # one clean row
    s = kernels.window_scan(jnp.asarray(codes), k)
    wk = kernels.window_keys(jnp.asarray(codes), k)
    sl = slice(k - 1, None)
    ok_old = np.asarray(s["ok"][:, sl])
    ok_new = np.asarray(wk["ok"])
    assert ok_old.shape == ok_new.shape == (7, L - k + 1)
    assert (ok_old == ok_new).all()
    for nm in ("fa_lo", "fa_hi", "fb_lo", "fb_hi",
               "ra_lo", "ra_hi", "rb_lo", "rb_hi"):
        old = np.asarray(s[nm][:, sl])
        new = np.asarray(wk[nm])
        assert (old[ok_old] == new[ok_old]).all(), nm
    # wmax trimming is a pure prefix
    wk2 = kernels.window_keys(jnp.asarray(codes), k, wmax=5)
    assert (np.asarray(wk2["ok"]) == ok_new[:, :5]).all()


@pytest.mark.parametrize("t", [1, 2, 3, 5, 9])
def test_greedy_fast_matches_scan(t):
    rng = np.random.default_rng(t)
    k = 13
    mem = rng.random((40, 97)) < 0.2
    a = np.asarray(kernels._greedy_count(jnp.asarray(mem), jnp.asarray(mem),
                                         k, t))
    b = np.asarray(kernels._greedy_count_fast(jnp.asarray(mem), k, t))
    assert (a == b).all()


@pytest.mark.parametrize("k", [15, 32, 33])
def test_bulk_build_matches_build_chunk(k):
    """The bulk sorted-scatter build (bulk_plane_sorted + bulk_scatter_set
    + bulk_or_plane, the high-fill device build path) must produce planes
    bit-identical to build_chunk, including multi-chunk flushes through
    the scratch-plane OR and invalid-base window resets."""
    from commet_tpu.core import stream as _stream

    rng = np.random.default_rng(11)
    n, lpad = 96, 64
    codes_np = rng.integers(0, 4, size=(n, lpad)).astype(np.int32)
    codes_np[rng.random(size=codes_np.shape) < 0.03] = 4  # invalid bases
    codes = jnp.asarray(codes_np)
    want = np.asarray(kernels.build_chunk(kernels.alloc_planes(k), codes, k))

    wide = k > 32
    w = kernels.plane_words(k)
    planes = kernels.alloc_planes(k)
    # two flushes (rows split) exercise cross-chunk accumulation
    for rows in (slice(0, 40), slice(40, n)):
        ka, kb, hib, fl, _cnt = _stream.chunk_index_keys_codes(
            codes[rows], k)
        for p in range(4):
            word, or_mask = kernels.bulk_plane_sorted(
                ka, kb, hib if wide else fl, fl, k, p, wide)
            scratch = kernels.bulk_scatter_set(
                jnp.zeros(w, jnp.uint32), word, or_mask)
            planes = kernels.bulk_or_plane(planes, scratch, p * w, w)
    assert (np.asarray(planes) == want).all()


def test_engine_bulk_build_matches(tmp_path):
    """Engine._build_planes_bulk (COMMET_TPU_BULK_BUILD=force on CPU) ==
    the classic engine build, end-to-end through gather_packed batching."""
    import os

    from commet_tpu.engine.engine import Engine, EncodedSet
    from commet_tpu.io.reads import ReadSet

    rng = np.random.default_rng(12)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    fa = str(tmp_path / "i.fa")
    with open(fa, "wb") as f:
        for i in range(300):
            s = lut[rng.integers(0, 4, size=70)].tobytes()
            f.write(b">r%d\n%s\n" % (i, s))
    rs = ReadSet("I")
    rs.add_file(fa)
    k = 21
    eng = Engine(k=k, t=2, batch=64)
    enc = EncodedSet(rs)
    elig = rs.eligible()
    want = np.asarray(kernels.build_chunk(
        kernels.alloc_planes(k),
        jnp.asarray(enc.gather_batch(elig, 70), jnp.int32), k))
    os.environ["COMMET_TPU_BULK_CHUNK"] = "8192"  # force many chunks
    try:
        got = np.asarray(eng._build_planes_bulk(
            kernels.alloc_planes(k), enc, elig))
    finally:
        del os.environ["COMMET_TPU_BULK_CHUNK"]
    assert (got == want).all()
