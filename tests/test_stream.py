"""Sorted-set join streaming probe (core/stream.py) vs the oracle, the
gather cascade and a brute-force set lookup."""

import numpy as np
import pytest

import jax.numpy as jnp

from commet_tpu.core import kernels, stream
from commet_tpu.io.reads import CODE_LUT

from oracle import index_reads, search_read

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


def implant(rng, idx_seqs, qry_seqs, k):
    comp = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N",
            "a": "t", "c": "g", "g": "c", "t": "a", "n": "n"}
    for i in range(0, len(qry_seqs), 2):
        donor = idx_seqs[int(rng.integers(len(idx_seqs)))].decode()
        if len(donor) < k:
            continue
        start = int(rng.integers(0, len(donor) - k + 1))
        frag = donor[start : start + k]
        if rng.random() < 0.5:
            frag = "".join(comp[c] for c in reversed(frag))
        q = qry_seqs[i].decode()
        pos = int(rng.integers(0, max(1, len(q) - k + 1)))
        qry_seqs[i] = (q[:pos] + frag + q[pos + k :]).encode()


def build_all(idx_codes, k):
    """Planes + the sorted (keya, keyb) index planes from the same data."""
    planes = kernels.alloc_planes(k)
    planes = kernels.build_chunk(planes, jnp.asarray(idx_codes), k)
    ka, kb, hib, flags, cnt = stream.chunk_index_keys_codes(
        jnp.asarray(idx_codes), k)
    ika, ikb, ihib, mi = stream.finalize_index_keys(
        [ka], [kb], [hib], [flags], [int(cnt)], wide=k > 32)
    return planes, ika, ikb, ihib, mi


def exact_key_sets(idx_codes, k):
    """keya set and (keya, keyb) pair set of the index's valid forward
    windows (numpy oracle for the join verdicts)."""
    wk = kernels.window_keys(jnp.asarray(idx_codes), k, "fwd")
    ok = np.asarray(wk["ok"]).reshape(-1)
    fa = np.asarray(wk["fa_lo"]).reshape(-1)[ok]
    fb = np.asarray(wk["fb_lo"]).reshape(-1)[ok]
    return set(fa.tolist()), set(zip(fa.tolist(), fb.tolist()))


@pytest.mark.parametrize("k", [15, 21, 31, 32])
@pytest.mark.parametrize("t", [1, 2, 3])
def test_join_membership_matches_plane_gather(k, t):
    rng = np.random.default_rng(99 + k * 10 + t)
    idx_seqs = random_seqs(rng, 25, k, 3 * k + 8)
    qry_seqs = random_seqs(rng, 40, k - 1, 3 * k + 8)
    implant(rng, idx_seqs, qry_seqs, k)
    lpad = max(max(len(s) for s in qry_seqs), k)
    idx_codes = encode(idx_seqs, max(max(len(s) for s in idx_seqs), k))
    planes, ika, ikb, ihib, mi = build_all(idx_codes, k)
    aset, pairset = exact_key_sets(idx_codes, k)

    codes = jnp.asarray(encode(qry_seqs, lpad))
    wk = kernels.window_keys(codes, k, "both")
    mem = stream._membership_stream(ika, ikb, mi, wk, ihib=ihib)
    ok = np.asarray(wk["ok"])
    mem = np.asarray(mem)
    # exact plane-A membership for comparison (plane A stores exactly the
    # keya set: injective key->bit map)
    wA, mA = kernels._plane_addr(wk["fa_lo"], wk["fa_hi"], k)
    exp_f = np.asarray(kernels._test_plane(planes, 0, wA, mA, k)) & ok
    wA, mA = kernels._plane_addr(wk["ra_lo"], wk["ra_hi"], k)
    exp_r = np.asarray(kernels._test_plane(planes, 0, wA, mA, k)) & ok
    got_f, got_r = mem[:, 0], mem[:, 1]
    assert ok.any()
    # keya membership (CAND or CONF) must equal the plane-A gather verdict
    np.testing.assert_array_equal(
        np.isin(got_f, (stream.CAND, stream.CONF)) & ok, exp_f)
    np.testing.assert_array_equal(
        np.isin(got_r, (stream.CAND, stream.CONF)) & ok, exp_r)
    # CONF windows are exactly the (keya, keyb) pairs of the index
    for strand, pref in ((0, "f"), (1, "r")):
        got = mem[:, strand]
        fa = np.asarray(wk[pref + "a_lo"])
        fb = np.asarray(wk[pref + "b_lo"])
        conf = (got == stream.CONF) & ok
        assert conf.any() or strand == 1
        for r, c in np.argwhere(ok):
            assert conf[r, c] == ((int(fa[r, c]), int(fb[r, c])) in pairset)


@pytest.mark.parametrize("k", [15, 31, 32])
@pytest.mark.parametrize("t", [1, 2])
def test_stream_cascade_matches_oracle(k, t):
    rng = np.random.default_rng(4242 + k * 10 + t)
    idx_seqs = random_seqs(rng, 30, k, 3 * k + 10)
    qry_seqs = random_seqs(rng, 60, k - 2, 3 * k + 10)
    implant(rng, idx_seqs, qry_seqs, k)
    bloom = index_reads([s.decode() for s in idx_seqs], k)
    expected = np.array(
        [search_read(bloom, s.decode(), k, t) for s in qry_seqs])

    lpad = max(max(len(s) for s in qry_seqs), k)
    idx_codes = encode(idx_seqs, max(max(len(s) for s in idx_seqs), k))
    planes, ika, ikb, ihib, mi = build_all(idx_codes, k)
    codes = jnp.asarray(encode(qry_seqs, lpad))

    verdict = np.asarray(stream.probe_cascade2_stream_codes(
        ika, ikb, mi, codes, k, t, ihib=ihib))
    tags = verdict == kernels.VERDICT_TAGGED
    amb = verdict == kernels.VERDICT_AMBIG
    # sound where decided; ambiguous rows must be resolvable by the
    # exact probe (and not contradict it)
    full, _ = kernels.search_batch(planes, codes, k, t)
    full = np.asarray(full)
    np.testing.assert_array_equal(tags[~amb], full[~amb])
    np.testing.assert_array_equal(np.where(amb, full, tags), expected)
    # the stream must decide the bulk of the reads on its own
    assert amb.mean() < 0.5


@pytest.mark.parametrize("k", [33, 34])
@pytest.mark.parametrize("t", [1, 2])
def test_wide_stream_matches_oracle(k, t):
    """k > 32: hi key bits ride packed side streams; verdicts must stay
    sound vs the reference oracle (no planes -- they'd be 4-8 GiB)."""
    rng = np.random.default_rng(7700 + k * 10 + t)
    idx_seqs = random_seqs(rng, 25, k, 3 * k + 12)
    qry_seqs = random_seqs(rng, 50, k - 2, 3 * k + 12)
    implant(rng, idx_seqs, qry_seqs, k)
    bloom = index_reads([s.decode() for s in idx_seqs], k)
    expected = np.array(
        [search_read(bloom, s.decode(), k, t) for s in qry_seqs])

    lpad = max(max(len(s) for s in qry_seqs), k)
    idx_codes = encode(idx_seqs, max(max(len(s) for s in idx_seqs), k))
    ka, kb, hib, flags, cnt = stream.chunk_index_keys_codes(
        jnp.asarray(idx_codes), k)
    ika, ikb, ihib, mi = stream.finalize_index_keys(
        [ka], [kb], [hib], [flags], [int(cnt)], wide=True)
    assert ihib is not None
    codes = jnp.asarray(encode(qry_seqs, lpad))
    verdict = np.asarray(stream.probe_cascade2_stream_codes(
        ika, ikb, mi, codes, k, t, ihib=ihib))
    tags = verdict == kernels.VERDICT_TAGGED
    amb = verdict == kernels.VERDICT_AMBIG
    np.testing.assert_array_equal(tags[~amb], expected[~amb])
    if t == 1:  # single implanted k-mers tag at t=1
        assert tags.any()
    assert amb.mean() < 0.5


def test_wide_straddling_run_never_nonmem():
    """Soundness regression: for k > 32 an equal-a_lo run whose entries
    carry DIFFERENT hi bits must never yield NONMEM for a query matching
    any part of the run (an earlier join that bracketed only the low word
    returned NONMEM here: silent wrong UNTAGGED at k=33). The plain join
    decides on the full key, so it is exact on every part of the run."""
    n = 1024
    lo = np.empty(n, np.uint32)
    lo[:500] = np.arange(500)
    lo[500:531] = 500  # equal-lo run ...
    lo[531:] = np.arange(600, 600 + n - 531)
    hib = np.zeros(n, np.uint32)
    hib[512:531] = 0x0100  # ... whose tail has other hi bits
    kb = np.full(n, 7, np.uint32)
    perm = np.random.default_rng(5).permutation(n)  # finalize sorts
    ika, ikb, ihib, mi = stream.finalize_index_keys(
        [jnp.asarray(lo[perm])], [jnp.asarray(kb[perm])],
        [jnp.asarray(hib[perm])], [jnp.zeros(n, jnp.uint32)], [n],
        wide=True)

    def verdict(qh, qb):
        got = stream.join_membership(
            ika, ikb, mi, jnp.asarray([500], jnp.uint32),
            jnp.asarray([qb], jnp.uint32), ihib=ihib,
            qh=jnp.asarray([qh], jnp.uint32))
        return int(np.asarray(got)[0])

    # the key IS in the index (the run's tail); NONMEM would be wrong
    assert verdict(0x0100, 7) == stream.CONF
    assert verdict(0x0000, 7) == stream.CONF  # and the run's head
    # full keya present, pair absent -> CAND on either part
    assert verdict(0x0100, 8) == stream.CAND
    assert verdict(0x0101, 7) == stream.CAND  # b_hi differs
    # low word present but a_hi=2 never indexed: the full keya is absent
    assert verdict(0x0200, 7) == stream.NONMEM


@pytest.mark.parametrize("k", [15, 31, 32])
def test_probe_exact_sets_matches_plane_probe(k):
    """probe_exact_sets (sorted-set membership of all four derived keys,
    the planeless fallback) must equal the full 4-plane gather probe."""
    t = 2
    rng = np.random.default_rng(808 + k)
    idx_seqs = random_seqs(rng, 30, k, 3 * k + 10)
    qry_seqs = random_seqs(rng, 80, k - 2, 3 * k + 10)
    implant(rng, idx_seqs, qry_seqs, k)
    lpad = max(max(len(s) for s in qry_seqs), k)
    idx_codes = encode(idx_seqs, max(max(len(s) for s in idx_seqs), k))

    planes = kernels.alloc_planes(k)
    planes = kernels.build_chunk(planes, jnp.asarray(idx_codes), k)
    ka, kb, hib, flags, cnt = stream.chunk_index_keys_codes(
        jnp.asarray(idx_codes), k)
    sx = stream.finalize_index([ka], [kb], [hib], [flags], [int(cnt)])

    qcodes = encode(qry_seqs, lpad).astype(np.uint8)
    c2, vd = kernels.pack_codes_np(qcodes)
    for tt in (1, 2):
        got = np.asarray(stream.probe_exact_sets(
            sx.sa, sx.sb, sx.sc, sx.sd, sx.mi, jnp.asarray(c2),
            jnp.asarray(vd), lpad, k, tt))
        want, _ = kernels.search_batch(planes,
                                       jnp.asarray(qcodes, jnp.int32),
                                       k, tt)
        np.testing.assert_array_equal(got, np.asarray(want))
        if tt == 1:  # single implanted k-mers: must tag at t=1
            assert got.any()


def test_finalize_index_keys_sentinel_ties():
    """A real keya equal to 0xFFFFFFFF must stay inside the valid prefix."""
    keys = jnp.asarray([5, 0xFFFFFFFF, 7], dtype=jnp.uint32)
    keysb = jnp.asarray([50, 51, 70], dtype=jnp.uint32)
    flags = jnp.asarray([0, 0, 0], dtype=jnp.uint32)
    ika, ikb, _ihib, mi = stream.finalize_index_keys(
        [keys], [keysb], None, [flags], [3])
    flat = np.asarray(ika)
    assert int(mi) == 3
    assert flat[2] == 0xFFFFFFFF  # sorted: 5, 7, real-0xFFFFFFFF, pads...
    qa = np.array([5, 6, 0xFFFFFFFF, 0], dtype=np.uint32)
    qb = np.array([50, 0, 51, 0], dtype=np.uint32)
    got = np.asarray(stream.join_membership(
        ika, ikb, mi, jnp.asarray(qa), jnp.asarray(qb)))
    assert got.tolist() == [stream.CONF, stream.NONMEM, stream.CONF,
                            stream.NONMEM]
    # keya present but keyb mismatch -> CAND (possible cross-k-mer FP)
    qb2 = np.where(qa == 5, 999, qb).astype(np.uint32)
    got2 = np.asarray(stream.join_membership(
        ika, ikb, mi, jnp.asarray(qa), jnp.asarray(qb2)))
    assert got2[0] == stream.CAND
    # a padding-like query (SENTINEL keyb) must not match the padding
    got3 = np.asarray(stream.join_membership(
        ika, ikb, mi, jnp.asarray([0xFFFFFFFF], jnp.uint32),
        jnp.asarray([0xFFFFFFFF], jnp.uint32)))
    assert got3[0] == stream.CAND


@pytest.mark.parametrize("k", [15, 32, 33])
@pytest.mark.parametrize("n_s", [1, 3, 17])
def test_probe_multi_matches_single(k, n_s):
    """The amortized multi-index probe (one sort + one unsort scatter for S
    index partitions) must give exactly the per-index verdicts of the
    single-index probe at the same join geometry — including S > 15, which
    spans multiple packed verdict words."""
    t = 2
    rng = np.random.default_rng(31000 + k * 100 + n_s)
    wide = k > 32
    idxs = []
    for s in range(n_s):
        idx_seqs = random_seqs(rng, 12, k, 3 * k + 8)
        idx_codes = encode(idx_seqs, max(max(len(x) for x in idx_seqs), k))
        ka, kb, hib, flags, cnt = stream.chunk_index_keys_codes(
            jnp.asarray(idx_codes), k)
        ika, ikb, ihib, mi = stream.finalize_index_keys(
            [ka], [kb], [hib], [flags], [int(cnt)], wide=wide)
        idxs.append((ika, ikb, mi, idx_seqs, ihib))
    qry_seqs = random_seqs(rng, 40, k - 1, 3 * k + 8)
    implant(rng, idxs[0][3], qry_seqs, k)
    lpad = max(max(len(s) for s in qry_seqs), k)
    codes = jnp.asarray(encode(qry_seqs, lpad))

    got = np.asarray(stream.probe_multi_stream_codes(
        tuple(x[0] for x in idxs), tuple(x[1] for x in idxs),
        tuple(x[2] for x in idxs), codes, k, t,
        ihibs=tuple(x[4] for x in idxs) if wide else None))
    assert got.shape == (n_s, len(qry_seqs))
    for s, (ika, ikb, mi, _seqs, ihib) in enumerate(idxs):
        want = np.asarray(stream.probe_cascade2_stream_codes(
            ika, ikb, mi, codes, k, t, ihib=ihib))
        np.testing.assert_array_equal(got[s], want, err_msg=f"index {s}")


def test_probe_multi_packed_dirty_batch():
    """Dirty batches (internal N bases) through the packed multi probe."""
    k, t, n_s = 21, 2, 2
    rng = np.random.default_rng(555)
    idxs = []
    for s in range(n_s):
        idx_seqs = random_seqs(rng, 15, k, 3 * k + 8, n_frac=0.1)
        idx_codes = encode(idx_seqs, max(max(len(x) for x in idx_seqs), k))
        ka, kb, hib, flags, cnt = stream.chunk_index_keys_codes(
            jnp.asarray(idx_codes), k)
        ika, ikb, _hib, mi = stream.finalize_index_keys(
            [ka], [kb], None, [flags], [int(cnt)])
        idxs.append((ika, ikb, mi))
    qry_seqs = random_seqs(rng, 30, k - 1, 3 * k + 8, n_frac=0.15)
    lpad = max(max(len(s) for s in qry_seqs), k)
    qcodes = encode(qry_seqs, lpad).astype(np.uint8)
    c2, vd = kernels.pack_codes_np(qcodes)
    got = np.asarray(stream.probe_multi_stream_packed(
        tuple(x[0] for x in idxs), tuple(x[1] for x in idxs),
        tuple(x[2] for x in idxs), jnp.asarray(c2), jnp.asarray(vd), lpad,
        k, t))
    for s, (ika, ikb, mi) in enumerate(idxs):
        want = np.asarray(stream.probe_cascade2_stream_packed(
            ika, ikb, mi, jnp.asarray(c2), jnp.asarray(vd), lpad, k, t))
        np.testing.assert_array_equal(got[s], want, err_msg=f"index {s}")


def test_join_membership_empty_index():
    keys = jnp.zeros((0,), jnp.uint32)
    flags = jnp.zeros((0,), jnp.uint32)
    ika, ikb, _ihib, mi = stream.finalize_index_keys(
        [keys], [keys], None, [flags], [0])
    q = jnp.asarray(np.arange(512, dtype=np.uint32))
    got = np.asarray(stream.join_membership(ika, ikb, mi, q, q))
    assert (got == stream.NONMEM).all()


def _brute_force_verdicts(ia, ib, ih, qa, qb, qh):
    """Plain Python set lookup of the join's verdict alphabet."""
    wide = ih is not None
    if wide:
        keya = {(int(a), int(h) >> 8) for a, h in zip(ia, ih)}
        pairs = {(int(a), int(h), int(b)) for a, h, b in zip(ia, ih, ib)}
    else:
        keya = {int(a) for a in ia}
        pairs = {(int(a), int(b)) for a, b in zip(ia, ib)}
    out = []
    for i in range(len(qa)):
        if wide:
            ka = (int(qa[i]), int(qh[i]) >> 8)
            pair = (int(qa[i]), int(qh[i]), int(qb[i]))
        else:
            ka, pair = int(qa[i]), (int(qa[i]), int(qb[i]))
        out.append(stream.CONF if pair in pairs else
                   stream.CAND if ka in keya else stream.NONMEM)
    return np.array(out, np.int8)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("n_index", [0, 1, 37, 3000])
def test_join_matches_brute_force(wide, n_index):
    """The plain join against a brute-force set lookup: long equal-keya
    runs, SENTINEL values in every column, invalid (flagged) windows and
    padding, queries drawn from present pairs, present keya with other
    keyb (and other hi bits), and absent keys."""
    rng = np.random.default_rng(1000 * wide + n_index)
    sent = np.uint32(0xFFFFFFFF)
    # few distinct keya values -> long runs; SENTINEL among them
    ka_pool = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, sent], np.uint32)
    ia = rng.choice(ka_pool, size=n_index).astype(np.uint32)
    ib = rng.integers(0, 50, size=n_index).astype(np.uint32)
    ib[rng.random(n_index) < 0.1] = sent
    ih = (rng.integers(0, 4, size=n_index).astype(np.uint32) << 8) \
        | rng.integers(0, 4, size=n_index).astype(np.uint32) if wide \
        else None
    # invalid windows ride along as SENTINEL-keyed, flagged entries
    n_bad = n_index // 5
    fa = np.concatenate([ia, np.full(n_bad, sent, np.uint32)])
    fb = np.concatenate([ib, np.full(n_bad, sent, np.uint32)])
    fh = (np.concatenate([ih, np.full(n_bad, sent, np.uint32)]) if wide
          else None)
    flags = np.concatenate([np.zeros(n_index, np.uint32),
                            np.ones(n_bad, np.uint32)])
    perm = rng.permutation(len(fa))
    ika, ikb, ihib, mi = stream.finalize_index_keys(
        [jnp.asarray(fa[perm])], [jnp.asarray(fb[perm])],
        [jnp.asarray(fh[perm])] if wide else None,
        [jnp.asarray(flags[perm])], [n_index], wide=wide)
    assert int(mi) == n_index

    m = 600
    pick = rng.integers(0, max(n_index, 1), size=m)
    present = n_index > 0
    qa = np.where(present, ia[pick] if present else 0,
                  rng.choice(ka_pool, size=m)).astype(np.uint32)
    qb = (ib[pick] if present else np.zeros(m, np.uint32)).copy()
    qh = (ih[pick].copy() if present else np.zeros(m, np.uint32)) if wide \
        else None
    r = rng.random(m)
    qb[r < 0.3] = rng.integers(0, 60, size=int((r < 0.3).sum()))
    qa[r > 0.8] = rng.integers(0, 2**32, size=int((r > 0.8).sum()),
                               dtype=np.uint32)
    qb[r > 0.9] = sent
    qa[(r > 0.9) & (r < 0.95)] = sent
    if wide:
        flip = rng.random(m) < 0.3
        qh[flip] = (rng.integers(0, 4, size=int(flip.sum())) << 8) \
            | rng.integers(0, 4, size=int(flip.sum()))
        qh[(r > 0.95)] = sent  # hi bits no real window carries
    got = np.asarray(stream.join_membership(
        ika, ikb, mi, jnp.asarray(qa), jnp.asarray(qb), ihib=ihib,
        qh=jnp.asarray(qh) if wide else None))
    want = _brute_force_verdicts(ia, ib, ih, qa, qb, qh)
    np.testing.assert_array_equal(got, want)
    if n_index > 100:  # every verdict occurs
        assert set(np.unique(got).tolist()) == {stream.NONMEM, stream.CAND,
                                                stream.CONF}
