"""Sorted-set membership: the planeless probe for low-fill partitions.

Why
---
The reference probes its bit-planes with one random byte load per k-mer
per plane (include/bloom_filter.h:124-131). A low-fill partition's dense
planes are mostly zeros, so this module keeps the partition as the sorted
multiset of its forward window keys instead, and answers membership with a
binary search:

  - the index side is the multiset of (keya, keyb) pairs fed into the
    planes, sorted lexicographically (for k > 32 the packed hi bits sit
    between keya and keyb in the order). Because (keya, keyb) IS the exact
    2-bit k-mer code (include/hash_key.h:65-91), a pair match is exact
    k-mer membership, which implies membership in all four reference
    planes (every plane was fed from this pair);
  - every query (window, strand) key runs one lexicographic lower-bound
    search over the index (``join_membership``). When one batch is joined
    against several indexes, its query side is sorted once first, so
    neighbouring searches touch neighbouring index entries, and the
    verdicts return to window order through one permutation scatter.

Per (window, strand) key the join returns one of three verdicts:
  0 NONMEM : keya provably absent from the index
  1 CAND   : keya present, exact pair absent -- a potential cross-k-mer
             Bloom false positive (all 4 planes may still hit)
  2 CONF   : exact (keya, keyb) match -- all four planes hit, guaranteed

Soundness: CONF implies reference-plane membership; NONMEM implies
non-membership of plane A, hence of the 4-plane test; CAND windows are
counted only in the upper greedy bound. Reads whose tag decision depends
on CAND windows come out AMBIG and fall back to an exact probe, so final
tags stay bit-identical to the reference.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

SENTINEL = np.uint32(0xFFFFFFFF)
# window keys one probe batch may carry: positions stay far inside int32
# and the batch's sort operands inside device memory (the engine clamps
# batch sizes against this; see Engine._search_stream_only)
MAX_UNSORT_KEYS = 1 << 30
NONMEM = 0
CAND = 1
CONF = 2


def _padded_len(n: int) -> int:
    """Index length rounded up to 1/8-octave steps (at least 2048): index
    arrays of similar size share one shape, hence one compiled probe, for
    at most 12.5% padding."""
    n = max(n, 2048)
    step = 1 << (n.bit_length() - 4)
    return -(-n // step) * step


# --------------------------------------------------------------------------
# The sorted join
# --------------------------------------------------------------------------

def _lex_less(cols, qcols):
    """Elementwise lexicographic (c0, c1, ...) < (q0, q1, ...)."""
    less = cols[-1] < qcols[-1]
    for c, q in zip(cols[-2::-1], qcols[-2::-1]):
        less = (c < q) | ((c == q) & less)
    return less


@jax.jit
def join_membership(ika: jax.Array, ikb: jax.Array, mi: jax.Array,
                    qa: jax.Array, qb: jax.Array, ihib=None,
                    qh=None) -> jax.Array:
    """Verdicts for query key pairs against the sorted index pairs.

    ika/ikb[/ihib]: [N] uint32 index columns, lexicographically ascending
          by (keya[, hib], keyb) over the valid prefix [0, mi); entries at
          positions >= mi are padding (see finalize_index_keys).
    mi:   scalar int32 array, number of valid index entries.
    qa/qb[/qh]: [M] uint32 query columns, in any order.

    A lexicographic lower bound ``pos`` of the full query tuple decides
    both verdicts: the pair is present iff entry ``pos`` equals it, and
    since equal keya values form one contiguous run, keya is present iff
    entry ``pos`` or entry ``pos - 1`` carries it. For k > 32 the full
    keya is (a_lo, hib >> 8) and the pair adds (hib & 0xFF, b_lo).

    Returns [M] int8 verdicts: NONMEM/CAND/CONF.
    """
    with jax.named_scope("join"):
        return _join(ika, ikb, mi, qa, qb, ihib, qh)


def _join(ika, ikb, mi, qa, qb, ihib, qh):
    n = ika.shape[0]
    wide = ihib is not None
    cols = (ika, ihib, ikb) if wide else (ika, ikb)
    qcols = (qa, qh, qb) if wide else (qa, qb)

    def step(_, bounds):
        lo, hi = bounds
        mid = lo + ((hi - lo) >> 1)
        at = jnp.minimum(mid, n - 1)
        right = _lex_less(tuple(c[at] for c in cols), qcols)
        active = lo < hi
        return (jnp.where(active & right, mid + 1, lo),
                jnp.where(active & ~right, mid, hi))

    lo0 = jnp.zeros(qa.shape, jnp.int32)
    hi0 = jnp.broadcast_to(mi.astype(jnp.int32), qa.shape)
    pos, _ = jax.lax.fori_loop(0, n.bit_length(), step, (lo0, hi0))

    at = tuple(c[jnp.minimum(pos, n - 1)] for c in cols)
    before = tuple(c[jnp.maximum(pos - 1, 0)] for c in cols)

    def keya_match(e):
        hit = e[0] == qa
        if wide:
            hit &= (e[1] >> 8) == (qh >> 8)
        return hit

    inside = pos < mi
    conf = inside
    for e, q in zip(at, qcols):
        conf &= e == q
    cand = (inside & keya_match(at)) | ((pos > 0) & keya_match(before))
    return jnp.where(conf, jnp.int8(CONF),
                     jnp.where(cand, jnp.int8(CAND), jnp.int8(NONMEM)))


# --------------------------------------------------------------------------
# Index-side helpers: collect sorted (keya, keyb) sets per partition
# --------------------------------------------------------------------------

def _index_chunk_from_wk(wk, k: int):
    ok = wk["ok"]
    keys = jnp.where(ok, wk["fa_lo"], SENTINEL).reshape(-1)
    keysb = jnp.where(ok, wk["fb_lo"], SENTINEL).reshape(-1)
    if k > 32:  # hi bits (<= 2 each for k <= 34) packed into one stream
        hib = (wk["fa_hi"] << 8) | wk["fb_hi"]
        hib = jnp.where(ok, hib, SENTINEL).reshape(-1)
    else:
        hib = None  # narrow keys: no hi stream (finalize ignores it)
    flags = jnp.where(ok, jnp.uint32(0), jnp.uint32(1)).reshape(-1)
    return keys, keysb, hib, flags, ok.sum(dtype=jnp.int32)


@functools.partial(jax.jit, static_argnames=("length", "k", "wmax"))
def chunk_index_keys(codes2, valid, length: int, k: int, wmax=None):
    """Per-batch forward-strand (keya, keyb[, hi-bit]) values (uint32)
    with invalid windows mapped to SENTINEL, plus the count of valid
    windows. Feeds finalize_index_keys."""
    assert k <= 34, f"streaming join supports k <= 34, got {k}"
    from commet_tpu.core import kernels
    codes = kernels.unpack_codes(codes2, valid, length)
    wk = kernels.window_keys(codes, k, "fwd", wmax)
    return _index_chunk_from_wk(wk, k)


@functools.partial(jax.jit, static_argnames=("length", "k", "wmax"))
def chunk_index_keys_clean(codes2, lengths, length: int, k: int, wmax=None):
    """chunk_index_keys for N-free batches: validity is position < length,
    so only the 2-bit code plane + lengths are uploaded — 3x less
    host->device transfer than the validity-plane form."""
    assert k <= 34, f"streaming join supports k <= 34, got {k}"
    from commet_tpu.core import kernels
    codes = kernels.unpack_codes_clean(codes2, lengths, length)
    wk = kernels.window_keys(codes, k, "fwd", wmax)
    return _index_chunk_from_wk(wk, k)


@functools.partial(jax.jit, static_argnames=("k", "wmax"))
def chunk_index_keys_codes(codes, k: int, wmax=None):
    """chunk_index_keys for plain int32 codes batches (CPU path)."""
    assert k <= 34, f"streaming join supports k <= 34, got {k}"
    from commet_tpu.core import kernels
    wk = kernels.window_keys(codes, k, "fwd", wmax)
    return _index_chunk_from_wk(wk, k)


def finalize_index_keys(key_chunks, keyb_chunks, hib_chunks, flag_chunks,
                        counts, wide: bool = False):
    """Sort the collected (keya, keyb[, hib]) chunks into the join's
    index columns.

    Sort keys are (keya, [hib,] keyb, flag): valid windows sort before the
    SENTINEL-flagged invalid ones even when a *real* key equals
    0xFFFFFFFF in every column, so the first ``mi`` entries are exactly
    the valid multiset in lexicographic order. Padding up to
    ``_padded_len`` is SENTINEL with flag 1. Returns
    (ika, ikb, ihib|None, mi), each column [N] uint32.
    """
    keys = jnp.concatenate(key_chunks)
    keysb = jnp.concatenate(keyb_chunks)
    flags = jnp.concatenate(flag_chunks)
    mi = int(sum(int(c) for c in counts))
    operands = [keys]
    if wide:
        operands.append(jnp.concatenate(hib_chunks))
    operands += [keysb, flags]
    pad = _padded_len(keys.shape[0]) - keys.shape[0]
    if pad:
        fills = [SENTINEL] * (len(operands) - 1) + [np.uint32(1)]
        operands = [jnp.concatenate([op, jnp.full((pad,), fill, jnp.uint32)])
                    for op, fill in zip(operands, fills)]
    out = jax.lax.sort(operands, num_keys=len(operands))
    if wide:
        ika, ihib, ikb = out[0], out[1], out[2]
    else:
        (ika, ikb), ihib = out[:2], None
    return ika, ikb, ihib, jnp.asarray(mi, jnp.int32)


class StreamIndex:
    """A partition's complete membership structure for the planeless
    stream mode: the sorted join columns plus the four sorted value sets
    of the reference's planes A/B/C/D. Since the reference plane p
    contains exactly the set of key-p values fed into it (injective
    key->bit map, include/bloom_filter.h:63-70), sorted-set membership of
    all four derived keys IS the reference's 4-plane Bloom test --
    fallback verdicts need no bit planes at all."""

    __slots__ = ("ika", "ikb", "ihib", "mi", "sa", "sb", "sc", "sd")

    def __init__(self, ika, ikb, ihib, mi, sa, sb, sc, sd):
        self.ika, self.ikb, self.ihib, self.mi = ika, ikb, ihib, mi
        self.sa, self.sb, self.sc, self.sd = sa, sb, sc, sd


def _sorted_set(vals, flags):
    v, _ = jax.lax.sort([vals, flags], num_keys=2)
    return v


def finalize_index(key_chunks, keyb_chunks, hib_chunks, flag_chunks,
                   counts, wide: bool = False) -> StreamIndex:
    """finalize_index_keys + (for k <= 32) the four sorted plane-value
    sets. For wide keys (k in 33..34) the exact-fallback sets are skipped
    (values exceed 32-bit lanes); the caller keeps the bit planes for the
    fallback instead."""
    ika, ikb, ihib, mi = finalize_index_keys(
        key_chunks, keyb_chunks, hib_chunks, flag_chunks, counts, wide)
    if wide:
        return StreamIndex(ika, ikb, ihib, mi, None, None, None, None)
    a = jnp.concatenate(key_chunks)
    b = jnp.concatenate(keyb_chunks)
    flags = jnp.concatenate(flag_chunks)
    invalid = flags == 1
    c = jnp.where(invalid, SENTINEL, a ^ b)
    d = jnp.where(invalid, SENTINEL, a | b)
    sa = ika  # keya-major sorted with the valid prefix first
    return StreamIndex(ika, ikb, None, mi, sa,
                       _sorted_set(b, flags), _sorted_set(c, flags),
                       _sorted_set(d, flags))


def _in_sorted(arr, mi, q):
    """Membership of q (any shape, uint32) in the valid prefix [0, mi) of
    the ascending array ``arr`` (padded with SENTINEL; real SENTINEL
    values sort before padding, see finalize_index_keys)."""
    n = arr.shape[0]
    pos = jnp.searchsorted(arr, q).astype(jnp.int32)
    hit = jnp.take(arr, jnp.clip(pos, 0, n - 1), axis=0) == q
    return hit & (pos < mi)


@functools.partial(jax.jit, static_argnames=("length", "k", "t", "wmax"))
def probe_exact_sets(sa, sb, sc, sd, mi, codes2, valid, length: int,
                     k: int, t: int, wmax=None):
    """Exact reference-Bloom classification via the four sorted value
    sets (no bit planes): member = a in A and b in B and a^b in C and
    a|b in D per window; greedy non-overlap count per strand; tagged when
    either strand reaches t (search_reads.h:34-87 semantics). This is the
    stream mode's fallback for AMBIG reads -- bit-exact and plane-free."""
    from commet_tpu.core import kernels
    codes = kernels.unpack_codes(codes2, valid, length)
    wk = kernels.window_keys(codes, k, "both", wmax)
    ok = wk["ok"]
    tagged = jnp.zeros(ok.shape[0], dtype=bool)
    for p in ("f", "r"):
        a = wk[p + "a_lo"]
        b = wk[p + "b_lo"]
        member = (_in_sorted(sa, mi, a) & _in_sorted(sb, mi, b)
                  & _in_sorted(sc, mi, a ^ b) & _in_sorted(sd, mi, a | b)
                  & ok)
        tagged = tagged | kernels.greedy_ge(member, k, t)
    return tagged


# --------------------------------------------------------------------------
# The streamed probe: exact verdicts via sort + join + unsort + greedy
# bounds. Plane gathers only happen in the caller's AMBIG fallback (reads
# whose decision hangs on potential cross-k-mer Bloom false positives).
# --------------------------------------------------------------------------

def _query_streams(wk, wide: bool):
    """Both strands' window keys flattened to [B*2*W] in (read, strand,
    window) order: [keya, keyb] (+ packed hib for wide keys)."""
    ok = wk["ok"]

    def both(f, r):
        return jnp.stack([jnp.where(ok, f, 0), jnp.where(ok, r, 0)],
                         axis=1).reshape(-1)

    streams = [both(wk["fa_lo"], wk["ra_lo"]), both(wk["fb_lo"], wk["rb_lo"])]
    if wide:
        streams.append(both((wk["fa_hi"] << 8) | wk["fb_hi"],
                            (wk["ra_hi"] << 8) | wk["rb_hi"]))
    return streams


def _sort_queries(wk, wide: bool):
    """Sort the query streams by keya, carrying each key's original
    position as payload. Returns (qa, qb, qh|None, positions, m)."""
    streams = _query_streams(wk, wide)
    m = streams[0].shape[0]
    # callers size batches so this never binds (see Engine.stream_batch)
    assert m <= MAX_UNSORT_KEYS, (
        f"stream batch too large: {m} window keys > 2^30; reduce the "
        f"query batch size")
    pay = jnp.arange(m, dtype=jnp.int32)
    with jax.named_scope("query_sort"):
        out = jax.lax.sort(streams + [pay], num_keys=1)
    qh = out[2] if wide else None
    return out[0], out[1], qh, out[-1], m


def _unsort(pos, vals):
    """vals [M] in query-sorted order -> original order (positions from
    _sort_queries): one unique-index scatter."""
    with jax.named_scope("unsort"):
        return jnp.zeros_like(vals).at[pos].set(vals, unique_indices=True)


def _membership_stream(ika, ikb, mi, wk, ihib=None):
    """Joined verdicts for every (read, strand, window) key pair.

    Returns mem [B, 2, W] int8 (NONMEM/CAND/CONF). One index joins the
    queries in window order: on an H100 that was faster than sorting them
    first (PERF.md); a sort pays only when it serves several indexes
    (_membership_stream_multi).
    """
    b, w = wk["ok"].shape
    qs = _query_streams(wk, ihib is not None)
    qh = qs[2] if ihib is not None else None
    mem = join_membership(ika, ikb, mi, qs[0], qs[1], ihib=ihib, qh=qh)
    return mem.reshape(b, 2, w)


def _verdicts(ok, mems, k: int, t: int):
    """TAGGED/UNTAGGED/AMBIG from joined window verdicts, zero gathers,
    batched over S verdict planes: mems [S, B, 2, W], ok [B, W].

    CONF windows are guaranteed reference-plane members; CAND windows may
    or may not be. greedy(conf) >= t proves tagged; greedy(conf|cand) < t
    proves untagged; anything else is AMBIG for the exact fallback (same
    sandwich argument as kernels._strand_cascade). The greedy scans run
    once on [S*B, W]. Returns [S, B] int8."""
    from commet_tpu.core import kernels
    s, b, _, w = mems.shape
    okx = jnp.broadcast_to(ok[None], (s, b, w)).reshape(s * b, w)
    tagged = None
    untagged = None
    for st in range(2):
        mem = mems[:, :, st, :].reshape(s * b, w)
        conf = (mem == CONF) & okx
        maybe = (mem == CAND) & okx
        tag_s = kernels.greedy_ge(conf, k, t)
        untag_s = ~kernels.greedy_ge(conf | maybe, k, t)
        tagged = tag_s if tagged is None else (tagged | tag_s)
        untagged = untag_s if untagged is None else (untagged & untag_s)
    v = jnp.where(tagged, jnp.int8(kernels.VERDICT_TAGGED),
                  jnp.where(untagged, jnp.int8(kernels.VERDICT_UNTAGGED),
                            jnp.int8(kernels.VERDICT_AMBIG)))
    return v.reshape(s, b)


def _stream_verdict(wk, mem, k: int, t: int):
    """_verdicts for one index: mem [B, 2, W] -> [B] int8."""
    return _verdicts(wk["ok"], mem[None], k, t)[0]


def _check_wide(k, ihib):
    assert k <= 34, f"streaming join supports k <= 34, got {k}"
    assert (ihib is not None) == (k > 32), \
        "k > 32 requires the packed hi-bit index column (and k <= 32 must " \
        "not pass one)"


# --------------------------------------------------------------------------
# Multi-index amortized probe: ONE query sort + ONE unsort scatter serve S
# resident index partitions (the all-vs-all driver's step-0 schedule reuses
# each query set against every earlier index set, reference Commet.py:186-240
# -- the sort/unsort cost amortizes by S). Sorted queries make neighbouring
# searches touch neighbouring index entries: on an H100 at S=3 the sorted
# probe took 0.68x the time of three joins in window order, at S=1 1.18x
# (PERF.md), so one index skips the sort.
# --------------------------------------------------------------------------

def _membership_stream_multi(idxs, wk):
    """Joined verdicts for every (index, read, strand, window) tuple from
    ONE sorted query stream. idxs: sequence of (ika, ikb, mi, ihib)
    4-tuples — ihib None for narrow keys (k <= 32), the packed hi-bit
    column for wide keys (k = 33/34, the reference default).
    Returns mems [S, B, 2, W] int32.

    The unsort scatters ceil(S/15) packed uint32 words (15 x 2-bit
    verdicts each) instead of S verdict vectors."""
    if len(idxs) == 1:
        ika, ikb, mi, ihib = idxs[0]
        return _membership_stream(ika, ikb, mi, wk, ihib)[None].astype(
            jnp.int32)
    b, w = wk["ok"].shape
    qa, qb, qh, pos, m = _sort_queries(wk, idxs[0][3] is not None)
    n_s = len(idxs)
    words = []
    for base in range(0, n_s, 15):
        packed = jnp.zeros(m, jnp.uint32)
        for off, (ika, ikb, mi, ihib) in enumerate(idxs[base : base + 15]):
            mem = join_membership(ika, ikb, mi, qa, qb, ihib=ihib, qh=qh)
            packed = packed | (mem.astype(jnp.uint32) << (2 * off))
        words.append(_unsort(pos, packed))
    planes = []
    for wi, word in enumerate(words):
        vp = word.reshape(1, b, 2, w).astype(jnp.int32)
        for off in range(min(15, n_s - 15 * wi)):
            planes.append((vp >> (2 * off)) & 3)
    return jnp.concatenate(planes, axis=0)  # [S, B, 2, W]


def _probe_multi_impl(ikas, ikbs, mis, codes, k, t, wmax, ihibs=None):
    from commet_tpu.core import kernels
    wk = kernels.window_keys(codes, k, "both", wmax)
    if ihibs is None:
        ihibs = (None,) * len(ikas)
    idxs = list(zip(ikas, ikbs, mis, ihibs))
    mems = _membership_stream_multi(idxs, wk)
    return _verdicts(wk["ok"], mems, k, t)


@functools.partial(jax.jit, static_argnames=("length", "k", "t", "wmax"))
def probe_multi_stream_clean(ikas, ikbs, mis, codes2, lengths, length: int,
                             k: int, t: int, wmax=None, ihibs=None):
    """Amortized S-index streamed probe for N-free batches: one query sort
    + one unsort scatter serve every (index, partition) in ikas/ikbs/mis
    (tuples of join columns). Returns [S, B] int8 verdicts with the same
    semantics as probe_cascade2_stream per index."""
    assert k <= 34, f"multi-index streaming supports k <= 34, got {k}"
    from commet_tpu.core import kernels
    codes = kernels.unpack_codes_clean(codes2, lengths, length)
    return _probe_multi_impl(ikas, ikbs, mis, codes, k, t, wmax, ihibs)


@functools.partial(jax.jit, static_argnames=("length", "k", "t", "wmax"))
def probe_multi_stream_packed(ikas, ikbs, mis, codes2, valid, length: int,
                              k: int, t: int, wmax=None, ihibs=None):
    """probe_multi_stream_clean for dirty batches (full validity plane)."""
    assert k <= 34, f"multi-index streaming supports k <= 34, got {k}"
    from commet_tpu.core import kernels
    codes = kernels.unpack_codes(codes2, valid, length)
    return _probe_multi_impl(ikas, ikbs, mis, codes, k, t, wmax, ihibs)


@functools.partial(jax.jit, static_argnames=("k", "t", "wmax"))
def probe_multi_stream_codes(ikas, ikbs, mis, codes, k: int, t: int,
                             wmax=None, ihibs=None):
    """probe_multi_stream for plain int32 code batches (CPU/tests)."""
    assert k <= 34, f"multi-index streaming supports k <= 34, got {k}"
    return _probe_multi_impl(ikas, ikbs, mis, codes, k, t, wmax, ihibs)


@functools.partial(jax.jit, static_argnames=("length", "k", "t", "wmax"))
def probe_cascade2_stream(ika, ikb, mi, codes2, lengths, length: int,
                          k: int, t: int, wmax=None, ihib=None):
    """Fused both-strand streamed probe: exact TAGGED/UNTAGGED verdicts
    from the sorted join alone (no plane gathers); AMBIG rows are the
    caller's exact-fallback residue. Verdict semantics identical to
    kernels.probe_cascade2_clean."""
    _check_wide(k, ihib)
    from commet_tpu.core import kernels
    codes = kernels.unpack_codes_clean(codes2, lengths, length)
    wk = kernels.window_keys(codes, k, "both", wmax)
    return _stream_verdict(wk, _membership_stream(ika, ikb, mi, wk, ihib),
                           k, t)


@functools.partial(jax.jit, static_argnames=("k", "t", "wmax"))
def probe_cascade2_stream_codes(ika, ikb, mi, codes, k: int, t: int,
                                wmax=None, ihib=None):
    """probe_cascade2_stream for plain int32 code batches (CPU/tests)."""
    _check_wide(k, ihib)
    from commet_tpu.core import kernels
    wk = kernels.window_keys(codes, k, "both", wmax)
    return _stream_verdict(wk, _membership_stream(ika, ikb, mi, wk, ihib),
                           k, t)


@functools.partial(jax.jit, static_argnames=("length", "k", "t", "wmax"))
def probe_cascade2_stream_packed(ika, ikb, mi, codes2, valid, length: int,
                                 k: int, t: int, wmax=None, ihib=None):
    """probe_cascade2_stream for dirty batches (reads with non-ACGT bases
    ship the full 1-bit validity plane; window_keys resets runs exactly
    like the reference's hash.clear())."""
    _check_wide(k, ihib)
    from commet_tpu.core import kernels
    codes = kernels.unpack_codes(codes2, valid, length)
    wk = kernels.window_keys(codes, k, "both", wmax)
    return _stream_verdict(wk, _membership_stream(ika, ikb, mi, wk, ihib),
                           k, t)
