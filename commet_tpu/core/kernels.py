"""Device kernels: rolling k-mer keys, membership-plane build/probe, greedy
non-overlapping hit counting.

Design notes
------------
The reference's "Bloom filter" (include/bloom_filter.h) maps each of 4
projection keys *injectively* to one bit (byte = key>>1, bit = parity x
plane), so it is exactly 4 independent set-membership bitmaps, not a lossy
Bloom filter. Any per-plane injective bit layout therefore yields
bit-identical classification results. Here each plane p is a dense bitmap of
2^k bits living in device memory as uint32 words; key value v maps to word v>>5, bit
v&31. Probing is a vectorized gather + bit-test ANDed across the 4 planes;
building is sort -> segmented-OR -> presence-filtered scatter-add, which is
mathematically a scatter-OR but safe for XLA's scatter-add lowering.

Key semantics (bit-exact vs reference include/hash_key.h:65-125):
  keya bit: G/T -> 1, keyb bit: C/T -> 1  => (keya,keyb) = 2-bit base code,
  keyc = keya XOR keyb, keyd = keya OR keyb (derived bitwise).
Forward keys append at LSB (left shift), reverse-complement keys prepend at
bit k-1 (right shift) while scanning the read left-to-right. Keys are
(hi, lo) uint32 pairs to support k > 32 without 64-bit lanes.

Search semantics (bit-exact vs reference include/search_reads.h:34-87):
non-overlapping hits counted greedily left-to-right (hash cleared after each
hit), forward strand first, reverse-complement only decides tagging when the
forward count is below t; an invalid (non-ACGT) base resets the window.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

INVALID_CODE = 4


def plane_words(k: int) -> int:
    """uint32 words per membership plane (2^k bits)."""
    return max(1, 1 << (k - 5)) if k >= 5 else 1


# Largest k whose 4 flat planes one device can address: the probes index
# the flat [4 * 2^(k-5)] word array with int32, and 4 * 2^(k-5) <= 2^31
# holds up to k = 34 (8 GiB of planes). Larger k needs the plane-sharded
# mesh mode (parallel/sharded.py), which addresses per-device word ranges.
MAX_SINGLE_DEVICE_K = 34


def alloc_planes(k: int):
    """Allocate the 4 flat membership planes as one [4 * plane_words] array."""
    if k > MAX_SINGLE_DEVICE_K:
        raise ValueError(
            f"k={k} > {MAX_SINGLE_DEVICE_K} unsupported on one device: its "
            f"4 planes hold 4 * 2^{k - 5} uint32 words, beyond the int32 "
            "flat plane index; run with a plane-sharded mesh (--devices)")
    return jnp.zeros(4 * plane_words(k), dtype=jnp.uint32)


# --------------------------------------------------------------------------
# Packed transport (host->device): 2-bit base codes + 1-bit validity.
# Reads travel packed (~3.5x smaller than byte codes) and unpack on device
# with pure vector ops. Whether the packing pays for itself on the GPU's
# host link is unmeasured.
# --------------------------------------------------------------------------

def pack_codes_np(codes_u8: np.ndarray):
    """Host-side pack: [N, L] uint8 codes (0..3 valid, 4 invalid) ->
    (codes2 [N, ceil(L/16)] uint32, valid [N, ceil(L/32)] uint32)."""
    n, length = codes_u8.shape
    w16 = -(-length // 16)
    w32 = -(-length // 32)
    c = np.zeros((n, w16 * 16), dtype=np.uint32)
    c[:, :length] = np.where(codes_u8 < 4, codes_u8, 0).astype(np.uint32)
    shifts = (np.arange(16, dtype=np.uint32) * 2)[None, None, :]
    codes2 = np.bitwise_or.reduce(c.reshape(n, w16, 16) << shifts, axis=2)
    v = np.zeros((n, w32 * 32), dtype=np.uint32)
    v[:, :length] = (codes_u8 < 4).astype(np.uint32)
    vshifts = np.arange(32, dtype=np.uint32)[None, None, :]
    valid = np.bitwise_or.reduce(v.reshape(n, w32, 32) << vshifts, axis=2)
    return codes2, valid


def pack_codes2_np(codes_u8: np.ndarray) -> np.ndarray:
    """Host-side pack of the 2-bit code plane only (for N-free batches that
    ship lengths instead of a validity plane)."""
    n, length = codes_u8.shape
    w16 = -(-length // 16)
    c = np.zeros((n, w16 * 16), dtype=np.uint32)
    c[:, :length] = np.where(codes_u8 < 4, codes_u8, 0).astype(np.uint32)
    shifts = (np.arange(16, dtype=np.uint32) * 2)[None, None, :]
    return np.bitwise_or.reduce(c.reshape(n, w16, 16) << shifts, axis=2)


def unpack_codes(codes2: jax.Array, valid: jax.Array, length: int):
    """Device-side unpack back to [N, L] int32 codes (4 = invalid).
    Regular bit-slicing - reshapes and shifts only, no gathers."""
    n = codes2.shape[0]
    shifts = (jnp.arange(16, dtype=jnp.uint32) * 2)[None, None, :]
    c = ((codes2[:, :, None] >> shifts) & 3).reshape(n, -1)[:, :length]
    vshifts = jnp.arange(32, dtype=jnp.uint32)[None, None, :]
    v = ((valid[:, :, None] >> vshifts) & 1).reshape(n, -1)[:, :length]
    return jnp.where(v == 1, c, INVALID_CODE).astype(jnp.int32)


# --------------------------------------------------------------------------
# Rolling window keys
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("k", "strand"))
def window_scan(codes: jax.Array, k: int, strand: str = "both"):
    """Compute per-position rolling keys for every window of length k.

    codes: [N, L] int32 with values 0..3 (A,C,G,T) or 4 (invalid).
    Returns dict of [N, L] arrays: fa/fb lo+hi forward keys, ra/rb lo+hi
    reverse-complement keys, and ok (bool: window of the k bases ending at
    this position is complete & fully valid). ``strand`` ('both'|'fwd'|'rc')
    drops the unused key carries for cheaper single-strand scans.
    """
    n, length = codes.shape
    codes_t = codes.T.astype(jnp.int32)  # [L, N]

    u32 = jnp.uint32
    # derive the zero carry from the data so the scan carry keeps the same
    # varying-axes type under shard_map (constant-folded by XLA otherwise)
    zero = (codes_t[0] * 0).astype(u32)
    hi_mask = u32((1 << (k - 32)) - 1) if k > 32 else u32(0)
    lo_mask = u32((1 << k) - 1) if k < 32 else u32(0xFFFFFFFF)

    do_fwd = strand in ("both", "fwd")
    do_rc = strand in ("both", "rc")
    fwd_names = ("fa_lo", "fa_hi", "fb_lo", "fb_hi")
    rc_names = ("ra_lo", "ra_hi", "rb_lo", "rb_hi")
    names = (fwd_names if do_fwd else ()) + (rc_names if do_rc else ())

    def step(carry, c):
        run = carry[-1]
        keys = dict(zip(names, carry[:-1]))
        valid = c < INVALID_CODE
        cc = jnp.where(valid, c, 0)
        new = {}
        if do_fwd:
            ba = ((cc >> 1) & 1).astype(u32)
            bb = (cc & 1).astype(u32)
            if k <= 32:
                new["fa_lo"] = ((keys["fa_lo"] << 1) | ba) & lo_mask
                new["fb_lo"] = ((keys["fb_lo"] << 1) | bb) & lo_mask
                new["fa_hi"] = keys["fa_hi"]
                new["fb_hi"] = keys["fb_hi"]
            else:
                new["fa_hi"] = ((keys["fa_hi"] << 1)
                                | (keys["fa_lo"] >> 31)) & hi_mask
                new["fb_hi"] = ((keys["fb_hi"] << 1)
                                | (keys["fb_lo"] >> 31)) & hi_mask
                new["fa_lo"] = keys["fa_lo"] << 1 | ba
                new["fb_lo"] = keys["fb_lo"] << 1 | bb
        if do_rc:
            comp = 3 - cc
            rba = ((comp >> 1) & 1).astype(u32)
            rbb = (comp & 1).astype(u32)
            if k <= 32:
                new["ra_lo"] = (keys["ra_lo"] >> 1) | (rba << (k - 1))
                new["rb_lo"] = (keys["rb_lo"] >> 1) | (rbb << (k - 1))
                new["ra_hi"] = keys["ra_hi"]
                new["rb_hi"] = keys["rb_hi"]
            else:
                new["ra_lo"] = (keys["ra_lo"] >> 1) | ((keys["ra_hi"] & 1) << 31)
                new["rb_lo"] = (keys["rb_lo"] >> 1) | ((keys["rb_hi"] & 1) << 31)
                new["ra_hi"] = (keys["ra_hi"] >> 1) | (rba << (k - 33))
                new["rb_hi"] = (keys["rb_hi"] >> 1) | (rbb << (k - 33))

        nrun = jnp.where(valid, run + 1, 0)
        carry = tuple(jnp.where(valid, new[nm], 0) for nm in names) + (nrun,)
        ok = nrun >= k
        out = carry[:-1] + (ok,)
        return carry, out

    init = (zero,) * len(names) + (zero.astype(jnp.int32),)
    _, outs = jax.lax.scan(step, init, codes_t)
    return {nm: o.T for nm, o in zip(names + ("ok",), outs)}  # each [N, L]


# --------------------------------------------------------------------------
# Gather-free rolling keys: funnel extraction over packed bit planes
#
# window_scan (above) is a lax.scan with L sequential steps — correct but
# latency-bound (each step is a tiny vector op). window_keys computes
# the identical per-window keys with pure vector ops: pack the a/b/validity
# bit planes into MSB-first uint32 words, then every window's key is a
# 32-bit "funnel shift" of two adjacent words. Reverse-complement keys are
# the same extraction over the reversed complemented planes (the rc key's
# bit d is the complement of the base at window offset d — see
# include/hash_key.h:99-125).
# --------------------------------------------------------------------------


def _pack_bits_msb(bits, L32: int):
    """[B, L32] 0/1 ints -> [B, L32/32 + 1] uint32, MSB-first per word, one
    zero pad word appended (L32 must be a multiple of 32)."""
    b = bits.shape[0]
    sh = (jnp.uint32(31) - jnp.arange(32, dtype=jnp.uint32))[None, None, :]
    w = (bits.astype(jnp.uint32).reshape(b, L32 // 32, 32) << sh).sum(
        axis=2, dtype=jnp.uint32)  # disjoint bits: sum == OR
    return jnp.concatenate([w, jnp.zeros((b, 1), jnp.uint32)], axis=1)


def _extract_all(words, L32: int):
    """ext[:, j] = bits j..j+31 (MSB-first) of the packed stream, for every
    j in [0, L32). Pure shifts over repeated words — no gathers."""
    w0 = jnp.repeat(words[:, :-1], 32, axis=1)
    w1 = jnp.repeat(words[:, 1:], 32, axis=1)
    off = jnp.tile(jnp.arange(32, dtype=jnp.uint32), L32 // 32)[None, :]
    return jnp.where(off == 0, w0,
                     (w0 << off) | (w1 >> (jnp.uint32(32) - off)))


def window_keys(codes, k: int, strand: str = "both", wmax=None):
    """Per-window rolling keys for windows ENDING at positions k-1 .. k-1+W-1
    (W = wmax or L-k+1), as [B, W] arrays: fa/fb/ra/rb lo+hi and ok.
    Bit-identical to window_scan restricted to that slice (where ok holds;
    incomplete windows carry unspecified key bits but ok=False)."""
    b, L = codes.shape
    W = max(1, (L - k + 1) if wmax is None else wmax)
    L32 = -(-max(L, k - 1 + W) // 32) * 32
    pad = L32 - L
    if pad:
        codes = jnp.pad(codes, ((0, 0), (0, pad)),
                        constant_values=INVALID_CODE)
    valid = (codes < INVALID_CODE).astype(jnp.uint32)
    abit = ((codes >> 1) & 1).astype(jnp.uint32) * valid
    bbit = (codes & 1).astype(jnp.uint32) * valid

    ext_v = _extract_all(_pack_bits_msb(valid, L32), L32)
    full = jnp.uint32(0xFFFFFFFF)
    if k <= 32:
        vmask = full if k == 32 else jnp.uint32(((1 << k) - 1) << (32 - k))
        ok = (ext_v[:, :W] & vmask) == vmask
    else:
        ok = (ext_v[:, :W] == full) & (ext_v[:, k - 32 : k - 32 + W] == full)
    out = {"ok": ok}

    def fwd_key(plane_bits):
        ext = _extract_all(_pack_bits_msb(plane_bits, L32), L32)
        if k <= 32:
            return ext[:, :W] >> jnp.uint32(32 - k), jnp.zeros_like(ext[:, :W])
        return ext[:, k - 32 : k - 32 + W], ext[:, :W] >> jnp.uint32(64 - k)

    def rc_key(plane_bits):
        # rc sequence = complement bits reversed; window ending at i maps to
        # forward position L32-1-i in the reversed stream
        rbits = jnp.flip(1 - plane_bits, axis=1)
        ext = _extract_all(_pack_bits_msb(rbits, L32), L32)
        # window ending at i=k-1+m -> start p0 = L32-k-m: slice then flip
        lo_sl = jnp.flip(ext[:, L32 - k - W + 1 : L32 - k + 1], axis=1)
        if k <= 32:
            return lo_sl >> jnp.uint32(32 - k), jnp.zeros_like(lo_sl)
        hi_sl = lo_sl
        lo2 = jnp.flip(ext[:, L32 - 32 - W + 1 : L32 - 32 + 1], axis=1)
        return lo2, hi_sl >> jnp.uint32(64 - k)

    if strand in ("both", "fwd"):
        out["fa_lo"], out["fa_hi"] = fwd_key(abit)
        out["fb_lo"], out["fb_hi"] = fwd_key(bbit)
    if strand in ("both", "rc"):
        out["ra_lo"], out["ra_hi"] = rc_key(abit)
        out["rb_lo"], out["rb_hi"] = rc_key(bbit)
    return out


def _greedy_count_fast(member, k: int, t: int):
    """Greedy non-overlapping hit count capped at t, without a sequential
    scan: suffix-min "next hit at or after i" table (log-depth associative
    scan) + t unrolled pointer jumps. Equals _greedy_count(member, member)."""
    b, W = member.shape
    inf = jnp.int32(W + k + 2)
    pos = jnp.arange(W, dtype=jnp.int32)[None, :]
    hitpos = jnp.where(member, pos, inf)
    nxt = jax.lax.associative_scan(jnp.minimum, hitpos, reverse=True, axis=1)
    cnt = jnp.zeros((b,), jnp.int32)
    cur = nxt[:, 0]
    for m in range(t):
        found = cur < W
        cnt = cnt + found.astype(jnp.int32)
        if m == t - 1:
            break
        idx = jnp.clip(cur + k, 0, W - 1)
        nxt_val = jnp.take_along_axis(nxt, idx[:, None], axis=1)[:, 0]
        cur = jnp.where(found & (cur + k < W), nxt_val, inf)
    return cnt


# t above which the unrolled-jump greedy stops paying off
_GREEDY_FAST_MAX_T = 16


def _greedy(member, k: int, t: int):
    if t <= _GREEDY_FAST_MAX_T:
        return _greedy_count_fast(member, k, t)
    return _greedy_count(member, member, k, t)


def greedy_ge(member, k: int, t: int):
    """greedy(member) >= t as pure reductions for the common small t.

    t=1: any hit. t=2 (the reference default, index_and_search.cpp:72):
    the greedy non-overlap count reaches 2 iff two hits >= k apart exist,
    iff (max hit pos - min hit pos) >= k — two masked min/max reductions
    replace the log-depth scan + pointer jumps of _greedy_count_fast.
    Larger t falls back to the counting scan."""
    if t <= 0:
        return jnp.ones(member.shape[:-1], dtype=bool)
    if t == 1:
        return member.any(axis=-1)
    if t == 2:
        w = member.shape[-1]
        pos = jnp.arange(w, dtype=jnp.int32)
        minp = jnp.min(jnp.where(member, pos, w + k), axis=-1)
        maxp = jnp.max(jnp.where(member, pos, -(k + 1)), axis=-1)
        return (maxp - minp) >= k
    return _greedy(member, k, t) >= t


def _plane_addr(lo, hi, k: int):
    """key value -> (word index, bit mask) in its 2^k-bit plane."""
    if k <= 32:
        word = lo >> 5 if k >= 5 else jnp.zeros_like(lo)
    else:
        word = (lo >> 5) | (hi << 27)
    mask = jnp.uint32(1) << (lo & 31)
    return word, mask


def _four_plane_addrs(a_lo, a_hi, b_lo, b_hi, k: int):
    """Derive the 4 plane addresses from the a/b key pair
    (keyc = a^b, keyd = a|b, reference include/bloom_filter.h:37-43)."""
    c_lo, c_hi = a_lo ^ b_lo, a_hi ^ b_hi
    d_lo, d_hi = a_lo | b_lo, a_hi | b_hi
    words, masks = [], []
    for lo, hi in ((a_lo, a_hi), (b_lo, b_hi), (c_lo, c_hi), (d_lo, d_hi)):
        w, m = _plane_addr(lo, hi, k)
        words.append(w)
        masks.append(m)
    return jnp.stack(words), jnp.stack(masks)  # [4, ...]


# --------------------------------------------------------------------------
# Probe
# --------------------------------------------------------------------------

def _membership(planes, words, masks, k: int):
    """AND of the 4 plane bit-tests. planes: [4*W] uint32, words/masks [4,...]."""
    w = plane_words(k)
    offs = (jnp.arange(4, dtype=jnp.uint32) * jnp.uint32(w)).reshape(
        (4,) + (1,) * (words.ndim - 1))
    flat_idx = words + offs
    got = jnp.take(planes, flat_idx.astype(jnp.int32), axis=0)
    hit = (got & masks) != 0
    return hit.all(axis=0)


def _greedy_count(member, ok, k: int, t: int):
    """Greedy left-to-right non-overlapping hit count, capped at t.

    Equivalent to the reference inner loop (search_reads.h:49-63): a hit at
    window-end i clears the hash so the next countable window ends >= i+k;
    count stops mattering at t (early exit there, cap here).
    """
    n, length = member.shape
    mem_t = member.T
    ok_t = ok.T

    def step(carry, x):
        cnt, allow = carry
        m, o, i = x
        hit = m & o & (i >= allow) & (cnt < t)
        cnt = cnt + hit.astype(jnp.int32)
        allow = jnp.where(hit, i + k, allow)
        return (cnt, allow), None

    idx = jnp.arange(length, dtype=jnp.int32)
    zero = mem_t[0].astype(jnp.int32) * 0  # data-derived for shard_map vma
    init = (zero, zero)
    (cnt, _), _ = jax.lax.scan(
        step, init,
        (mem_t, ok_t, idx))
    return cnt


def _strand_count(planes, wk, prefix: str, k: int, t: int):
    """Membership + greedy count for one strand over pre-sliced window
    keys (window_keys output)."""
    ok = wk["ok"]
    words, masks = _four_plane_addrs(
        wk[prefix + "a_lo"], wk[prefix + "a_hi"],
        wk[prefix + "b_lo"], wk[prefix + "b_hi"], k)
    mem = _membership(planes, words, masks, k)
    return _greedy(mem & ok, k, t)


def _strand_ge(planes, wk, prefix: str, k: int, t: int):
    """Membership + (greedy count >= t) for one strand (reduction fast
    path for t <= 2, see greedy_ge)."""
    ok = wk["ok"]
    words, masks = _four_plane_addrs(
        wk[prefix + "a_lo"], wk[prefix + "a_hi"],
        wk[prefix + "b_lo"], wk[prefix + "b_hi"], k)
    mem = _membership(planes, words, masks, k)
    return greedy_ge(mem & ok, k, t)


@functools.partial(jax.jit, static_argnames=("k", "t", "wmax"))
def search_batch(planes: jax.Array, codes: jax.Array, k: int, t: int,
                 wmax=None):
    """Classify each read: does it share >= t non-overlapping k-mers with the
    indexed set (forward or reverse-complement strand)?

    Returns (tagged [N] bool, found_fwd [N] bool) - found_fwd only feeds
    logging parity.
    """
    wk = window_keys(codes, k, "both", wmax)
    found_f = _strand_ge(planes, wk, "f", k, t)
    tagged = found_f | _strand_ge(planes, wk, "r", k, t)
    return tagged, found_f


@functools.partial(jax.jit, static_argnames=("k", "t", "wmax"))
def search_batch_fwd(planes: jax.Array, codes: jax.Array, k: int, t: int,
                     wmax=None):
    """Forward-strand-only classification. The reference only consults the
    reverse strand when the forward scan failed (search_reads.h:64-83), so
    the streaming engine runs this pass on everything and the rc pass only
    on the fwd-untagged remainder (exact same final tags)."""
    wk = window_keys(codes, k, "fwd", wmax)
    return _strand_ge(planes, wk, "f", k, t)


@functools.partial(jax.jit, static_argnames=("k", "t", "wmax"))
def search_batch_rc(planes: jax.Array, codes: jax.Array, k: int, t: int,
                    wmax=None):
    """Reverse-complement-strand-only classification."""
    wk = window_keys(codes, k, "rc", wmax)
    return _strand_ge(planes, wk, "r", k, t)


@functools.partial(jax.jit, static_argnames=("length", "k", "t", "wmax"))
def search_batch_fwd_packed(planes, codes2, valid, length: int, k: int,
                            t: int, wmax=None):
    codes = unpack_codes(codes2, valid, length)
    wk = window_keys(codes, k, "fwd", wmax)
    return _strand_ge(planes, wk, "f", k, t)


@functools.partial(jax.jit, static_argnames=("length", "k", "t", "wmax"))
def search_batch_rc_packed(planes, codes2, valid, length: int, k: int,
                           t: int, wmax=None):
    codes = unpack_codes(codes2, valid, length)
    wk = window_keys(codes, k, "rc", wmax)
    return _strand_ge(planes, wk, "r", k, t)


# --------------------------------------------------------------------------
# Cascade probe (two-phase, fused)
#
# The full probe spends 4 plane gathers per window. The cascade tests only
# plane A
# for every window, then verifies planes B/C/D on at most 2V selected A-hit
# positions per read (the V leftmost and V rightmost hits), and returns an
# exact verdict where possible:
#   TAGGED   - >= t non-overlapping *confirmed* (all-4-plane) hits exist;
#   UNTAGGED - even counting every unverified A-hit as a hit, the greedy
#              non-overlapping upper bound stays < t;
#   AMBIG    - neither; the caller re-runs these (rare) reads through the
#              exact full kernel.
# All three outcomes are sound, so the cascade composes into a bit-exact
# replacement for search_reads.h:34-87 at a fraction of the gather volume.
# --------------------------------------------------------------------------

VERDICT_UNTAGGED = 0
VERDICT_AMBIG = 1
VERDICT_TAGGED = 2


def _test_plane(planes, plane: int, words, masks, k: int):
    """Single-plane bit test (cf. _membership which tests all 4)."""
    w = plane_words(k)
    idx = (words + jnp.uint32(plane * w)).astype(jnp.int32)
    got = jnp.take(planes, idx, axis=0)
    return (got & masks) != 0


def _strand_cascade(planes, wk, p: str, k: int, t: int, V: int, memA=None):
    """One strand's cascade over pre-sliced window keys: returns
    (confirmed_count >= t, upper_bound < t), i.e. (definitely tagged,
    definitely untagged) boolean vectors.

    memA: optional precomputed plane-A membership [B, W] bool (already
    ok-masked) — supplied by the sorted-join streaming path
    (core/stream.py) to skip the per-window plane gathers."""
    ok = wk["ok"]
    a_lo, a_hi = wk[p + "a_lo"], wk[p + "a_hi"]
    b_lo, b_hi = wk[p + "b_lo"], wk[p + "b_hi"]

    if memA is None:
        wA, mA = _plane_addr(a_lo, a_hi, k)
        memA = _test_plane(planes, 0, wA, mA, k) & ok

    # select the V leftmost + V rightmost A-hit positions. When a row has
    # <= 2V hits the selection covers ALL of them (rank_l + rank_r =
    # total + 1 for any hit, so rank_l > V and rank_r > V imply total > 2V).
    m = memA.astype(jnp.int32)
    rank_l = jnp.cumsum(m, axis=1)
    total = rank_l[:, -1:]
    rank_r = total - rank_l + m
    s2 = 2 * V
    slotof = jnp.where(rank_l <= V, rank_l - 1, 2 * V - rank_r)
    slotof = jnp.where(memA & ((rank_l <= V) | (rank_r <= V)), slotof, s2)
    sel = slotof < s2

    # positions per slot: 2V small reductions (slots are unique per row)
    pos = jnp.arange(memA.shape[1], dtype=jnp.int32)[None, :]
    posbuf = jnp.stack(
        [jnp.sum(jnp.where(slotof == s, pos, 0), axis=1, dtype=jnp.int32)
         for s in range(s2)], axis=1)  # [B, 2V]
    iota_s = jnp.arange(s2, dtype=jnp.int32)[None, :]
    occupied = jnp.where(iota_s < V, iota_s < total,
                         (s2 - iota_s) <= total)  # [B, 2V]

    # keys at the selected positions: one row-gather over a stacked last axis
    parts = [a_lo, b_lo] + ([a_hi, b_hi] if k > 32 else [])
    keys = jnp.stack(parts, axis=-1)  # [B, Wp, C]
    selk = jnp.take_along_axis(keys, posbuf[:, :, None], axis=1)  # [B,2V,C]
    sa_lo, sb_lo = selk[..., 0], selk[..., 1]
    if k > 32:
        sa_hi, sb_hi = selk[..., 2], selk[..., 3]
    else:
        sa_hi = sb_hi = jnp.zeros_like(sa_lo)
    words, masks = _four_plane_addrs(sa_lo, sa_hi, sb_lo, sb_hi, k)  # [4,B,2V]

    w = plane_words(k)
    offs = (jnp.arange(1, 4, dtype=jnp.uint32) * jnp.uint32(w)).reshape(3, 1, 1)
    got = jnp.take(planes, (words[1:] + offs).astype(jnp.int32), axis=0)
    confirmed = occupied & ((got & masks[1:]) != 0).all(axis=0)  # [B, 2V]

    # map confirmations back onto the window axis with a compare-reduce:
    # [B, Wp, 2V] vector work instead of a [B, Wp] per-row gather (which
    # costs as many gathers as the plane-A probe itself)
    iota_w = jnp.arange(memA.shape[1], dtype=jnp.int32)
    conf_w = jnp.any((posbuf[:, None, :] == iota_w[None, :, None])
                     & confirmed[:, None, :], axis=2) & sel
    unverified = memA & ~sel

    return (greedy_ge(conf_w, k, t),
            ~greedy_ge(conf_w | unverified, k, t))


def _probe_cascade(planes, codes, k: int, t: int, V: int, strand: str,
                   wmax=None):
    wk = window_keys(codes, k, strand, wmax)
    p = "f" if strand == "fwd" else "r"
    tag, untag = _strand_cascade(planes, wk, p, k, t, V)
    return jnp.where(tag, jnp.int8(VERDICT_TAGGED),
                     jnp.where(untag, jnp.int8(VERDICT_UNTAGGED),
                               jnp.int8(VERDICT_AMBIG)))


def _probe_cascade2(planes, codes, k: int, t: int, V: int, wmax=None):
    """Fused both-strand cascade. The reference tags a read when EITHER
    strand reaches t non-overlapping hits (search_reads.h:49-83; the
    fwd-then-rc order is an early-exit optimization, not a semantic one), so
    tagged = tag_f | tag_r, untagged = untag_f & untag_r, else ambiguous."""
    wk = window_keys(codes, k, "both", wmax)
    tag_f, untag_f = _strand_cascade(planes, wk, "f", k, t, V)
    tag_r, untag_r = _strand_cascade(planes, wk, "r", k, t, V)
    return jnp.where(tag_f | tag_r, jnp.int8(VERDICT_TAGGED),
                     jnp.where(untag_f & untag_r, jnp.int8(VERDICT_UNTAGGED),
                               jnp.int8(VERDICT_AMBIG)))


@functools.partial(jax.jit,
                   static_argnames=("k", "t", "V", "strand", "wmax"))
def probe_cascade(planes, codes, k: int, t: int, V: int, strand: str,
                  wmax=None):
    """Cascade classification, one strand. Returns verdict [N] int8."""
    return _probe_cascade(planes, codes, k, t, V, strand, wmax)


@functools.partial(jax.jit,
                   static_argnames=("length", "k", "t", "V", "strand",
                                    "wmax"))
def probe_cascade_packed(planes, codes2, valid, length: int, k: int, t: int,
                         V: int, strand: str, wmax=None):
    codes = unpack_codes(codes2, valid, length)
    return _probe_cascade(planes, codes, k, t, V, strand, wmax)


@functools.partial(jax.jit, static_argnames=("k", "t", "V", "wmax"))
def probe_cascade2(planes, codes, k: int, t: int, V: int, wmax=None):
    """Fused both-strand cascade on plain int32 codes."""
    return _probe_cascade2(planes, codes, k, t, V, wmax)


@functools.partial(jax.jit,
                   static_argnames=("length", "k", "t", "V", "wmax"))
def probe_cascade2_packed(planes, codes2, valid, length: int, k: int, t: int,
                          V: int, wmax=None):
    codes = unpack_codes(codes2, valid, length)
    return _probe_cascade2(planes, codes, k, t, V, wmax)


def _probe_cascade2_multi(planes_list, codes, k: int, t: int, V: int,
                          wmax=None):
    """Amortized multi-index cascade: verdicts for ONE query batch against
    S dense plane sets, sharing the upload and the window-key computation
    (the reference's step-0 schedule searches each query set against up to
    N-1 index sets, Commet.py:186-240). Per-index plane gathers are
    irreducible -- the sharing amortizes the batch transport + keygen that
    the pairwise loop repays per index, which is what the high-fill
    regime (fill > the stream gate, where the sorted-join path disables
    itself) leaves on the table. Returns [S, B] int8 verdicts, each
    bit-identical to probe_cascade2 against that index."""
    wk = window_keys(codes, k, "both", wmax)
    out = []
    for planes in planes_list:
        tag_f, untag_f = _strand_cascade(planes, wk, "f", k, t, V)
        tag_r, untag_r = _strand_cascade(planes, wk, "r", k, t, V)
        out.append(jnp.where(
            tag_f | tag_r, jnp.int8(VERDICT_TAGGED),
            jnp.where(untag_f & untag_r, jnp.int8(VERDICT_UNTAGGED),
                      jnp.int8(VERDICT_AMBIG))))
    return jnp.stack(out)


@functools.partial(jax.jit,
                   static_argnames=("length", "k", "t", "V", "wmax"))
def probe_cascade2_multi_clean(planes_list, codes2, lengths, length: int,
                               k: int, t: int, V: int, wmax=None):
    """Multi-index fused both-strand cascade for N-free batches."""
    codes = unpack_codes_clean(codes2, lengths, length)
    return _probe_cascade2_multi(planes_list, codes, k, t, V, wmax)


@functools.partial(jax.jit,
                   static_argnames=("length", "k", "t", "V", "wmax"))
def probe_cascade2_multi_packed(planes_list, codes2, valid, length: int,
                                k: int, t: int, V: int, wmax=None):
    """Multi-index fused both-strand cascade for dirty batches."""
    codes = unpack_codes(codes2, valid, length)
    return _probe_cascade2_multi(planes_list, codes, k, t, V, wmax)


def unpack_codes_clean(codes2: jax.Array, lengths: jax.Array, length: int):
    """Unpack 2-bit codes for reads with NO internal invalid bases: validity
    is just position < length, so the 1-bit validity plane is never
    uploaded."""
    n = codes2.shape[0]
    shifts = (jnp.arange(16, dtype=jnp.uint32) * 2)[None, None, :]
    c = ((codes2[:, :, None] >> shifts) & 3).reshape(n, -1)[:, :length]
    v = jnp.arange(length, dtype=jnp.int32)[None, :] < lengths[:, None]
    return jnp.where(v, c.astype(jnp.int32), INVALID_CODE)


@functools.partial(jax.jit,
                   static_argnames=("length", "k", "t", "V", "wmax"))
def probe_cascade2_clean(planes, codes2, lengths, length: int, k: int,
                         t: int, V: int, wmax=None):
    """Fused both-strand cascade for N-free reads (lengths replace the
    validity plane in transport)."""
    codes = unpack_codes_clean(codes2, lengths, length)
    return _probe_cascade2(planes, codes, k, t, V, wmax)


# --------------------------------------------------------------------------
# Build (index)
# --------------------------------------------------------------------------

def _segmented_or_last(words, masks):
    """Given per-entry (word, mask) sorted by word, OR the masks of equal
    words together and return the combined mask on the LAST entry of each
    run (zeros elsewhere)."""

    def combine(left, right):
        wl, ml = left
        wr, mr = right
        merged = jnp.where(wl == wr, ml | mr, mr)
        return wr, merged

    _, or_masks = jax.lax.associative_scan(combine, (words, masks))
    is_last = jnp.concatenate([words[1:] != words[:-1],
                               jnp.ones((1,), dtype=bool)])
    return jnp.where(is_last, or_masks, 0)


@functools.partial(jax.jit, static_argnames=("length", "k"),
                   donate_argnums=(0,))
def build_chunk_packed(planes, codes2, valid, length: int, k: int):
    codes = unpack_codes(codes2, valid, length)
    return _build_chunk_impl(planes, codes, k)


@functools.partial(jax.jit, static_argnames=("length", "k"),
                   donate_argnums=(0,))
def build_chunk_packed_clean(planes, codes2, lengths, length: int, k: int):
    """build_chunk for N-free batches (lengths replace the validity plane
    in transport — 3x less upload volume)."""
    codes = unpack_codes_clean(codes2, lengths, length)
    return _build_chunk_impl(planes, codes, k)


@functools.partial(jax.jit, static_argnames=("k",), donate_argnums=(0,))
def build_chunk(planes: jax.Array, codes: jax.Array, k: int):
    """Feed every complete forward-strand window of every read into the 4
    membership planes (reference include/index_reads.h:49-61 feeds all
    overlapping k-mers, forward only).

    Implementation: per plane, sort the (hi, lo) keys, segmented-OR the bit
    masks per word, drop bits already present in the plane (gather), then a
    collision-free scatter-add. Exactly equivalent to scatter-OR.
    """
    return _build_chunk_impl(planes, codes, k)


def _build_chunk_impl(planes: jax.Array, codes: jax.Array, k: int):
    wk = window_keys(codes, k, strand="fwd")
    ok = wk["ok"].reshape(-1)
    w = plane_words(k)

    a_lo, a_hi = wk["fa_lo"].reshape(-1), wk["fa_hi"].reshape(-1)
    b_lo, b_hi = wk["fb_lo"].reshape(-1), wk["fb_hi"].reshape(-1)
    plane_keys = (
        (a_lo, a_hi),
        (b_lo, b_hi),
        (a_lo ^ b_lo, a_hi ^ b_hi),
        (a_lo | b_lo, a_hi | b_hi),
    )
    for p, (lo, hi) in enumerate(plane_keys):
        word, mask = _plane_addr(lo, hi, k)
        # invalid windows -> out-of-range word, mask 0; sorts to the end
        word = jnp.where(ok, word, jnp.uint32(0xFFFFFFFF))
        mask = jnp.where(ok, mask, jnp.uint32(0))
        word, mask = jax.lax.sort((word, mask), num_keys=1)
        or_mask = _segmented_or_last(word, mask)
        word = jnp.minimum(word, jnp.uint32(w - 1))
        flat_idx = (word + jnp.uint32(p * w)).astype(jnp.int32)
        existing = jnp.take(planes, flat_idx, axis=0)
        add_mask = or_mask & ~existing
        planes = planes.at[flat_idx].add(add_mask, mode="drop",
                                         unique_indices=False)
    return planes


# --------------------------------------------------------------------------
# Bulk build: the high-fill plane build as few huge sorted scatters
#
# The per-batch build above pays 2 random accesses per k-mer per plane (the
# existing-bit gather + the scatter-add). The bulk build collects each
# partition's (keya, keyb) window keys once (the stream path's
# chunk_index_keys kernel), then per plane:
# derive (word, mask) -> one giant sort -> segmented-OR -> mark non-last
# duplicates out-of-bounds -> ONE scatter-set of deduplicated masks. The
# first chunk of a plane scatters into the zeroed plane directly; later
# chunks scatter into a scratch plane OR-ed in densely (bandwidth-bound)
# -- no gathers anywhere. One random access per k-mer per plane instead of
# two. Its speed against the per-batch build is unmeasured on the GPU.
# --------------------------------------------------------------------------

BULK_OOB = np.uint32(0xFFFFFFFF)


@functools.partial(jax.jit, static_argnames=("k", "plane", "wide"))
def bulk_plane_sorted(keys, keysb, hib, flags, k: int, plane: int,
                      wide: bool):
    """One plane's deduplicated scatter stream from a chunk's collected
    window keys (chunk_index_keys output, flattened): returns
    (word [N] int32 with dropped entries -1, or_mask [N] uint32), sorted
    by word, each surviving word carrying the OR of its run's masks.

    plane: 0=A(keya) 1=B(keyb) 2=C(a^b) 3=D(a|b)
    (reference include/bloom_filter.h:37-43)."""
    a_lo, b_lo = keys, keysb
    if wide:
        a_hi, b_hi = hib >> jnp.uint32(8), hib & jnp.uint32(0xFF)
    else:
        a_hi = b_hi = jnp.zeros_like(a_lo)
    if plane == 0:
        lo, hi = a_lo, a_hi
    elif plane == 1:
        lo, hi = b_lo, b_hi
    elif plane == 2:
        lo, hi = a_lo ^ b_lo, a_hi ^ b_hi
    else:
        lo, hi = a_lo | b_lo, a_hi | b_hi
    word, mask = _plane_addr(lo, hi, k)
    ok = flags == 0
    word = jnp.where(ok, word, BULK_OOB)
    mask = jnp.where(ok, mask, jnp.uint32(0))
    word, mask = jax.lax.sort((word, mask), num_keys=1)
    or_mask = _segmented_or_last(word, mask)
    is_last = jnp.concatenate([word[1:] != word[:-1],
                               jnp.ones((1,), dtype=bool)])
    # dropped entries (non-last duplicates, invalid windows) get a LARGE
    # POSITIVE out-of-bounds index: mode="drop" skips those, whereas a
    # negative index would WRAP per numpy semantics and clobber the
    # plane's last word. A (word, 0) overwrite after the run's full mask
    # would clobber it, hence the non-last marking.
    wordi = jnp.where(is_last & (word != BULK_OOB),
                      word.astype(jnp.int32), jnp.int32(0x7FFFFFFF))
    return wordi, or_mask


@functools.partial(jax.jit, donate_argnums=(0,))
def bulk_scatter_set(target, word, or_mask):
    """Unique-index overwrite scatter of a deduplicated sorted chunk.
    Correct only when every surviving word index appears once (guaranteed
    by bulk_plane_sorted) and target holds no prior bits for this chunk's
    range (the zeroed plane for chunk 0, a zeroed scratch plane after)."""
    return target.at[word].set(or_mask, mode="drop", unique_indices=True)


@functools.partial(jax.jit, static_argnames=("offset", "w"),
                   donate_argnums=(0,))
def bulk_or_plane(planes, scratch, offset: int, w: int):
    """Dense OR of a scratch plane into planes[offset : offset+w]."""
    return jax.lax.dynamic_update_slice(
        planes, jax.lax.dynamic_slice(planes, (offset,), (w,)) | scratch,
        (offset,))


@functools.partial(jax.jit, static_argnames=("length",))
def class_counts_packed(codes2: jax.Array, valid: jax.Array,
                        lengths: jax.Array, length: int):
    """Device-side per-read symbol-class counts for the entropy filter
    (reference src/filter_reads.cpp:249-306 counts A,C,G,T,other per
    read): the O(N*L) scan over bases runs as vector compares/sums on
    device; the O(5)-per-read float32-exact Shannon epilogue stays on the
    host (core/filter.py) because device transcendentals are not
    guaranteed to be the correctly-rounded glibc logf the reference's
    arithmetic depends on.

    Returns [N, 5] int32 counts; class 4 (other) = lengths - ACGT sum
    (the validity plane marks non-ACGT bases invalid, identically to
    padding, so 'other' falls out of the length difference)."""
    codes = unpack_codes(codes2, valid, length)
    acgt = [(codes == c).sum(axis=1, dtype=jnp.int32) for c in range(4)]
    other = lengths.astype(jnp.int32) - sum(acgt)
    return jnp.stack(acgt + [other], axis=1)


@functools.partial(jax.jit, static_argnames=("k",))
def count_kmers(codes: jax.Array, k: int):
    """Number of complete windows (indexable k-mers) per read - the quantity
    accumulated against max_kmer for partition boundaries
    (reference index_reads.h:55-58)."""
    b, L = codes.shape
    L32 = -(-L // 32) * 32
    if L32 != L:
        codes = jnp.pad(codes, ((0, 0), (0, L32 - L)),
                        constant_values=INVALID_CODE)
    valid = (codes < INVALID_CODE).astype(jnp.uint32)
    ext_v = _extract_all(_pack_bits_msb(valid, L32), L32)
    W = max(1, L - k + 1)
    full = jnp.uint32(0xFFFFFFFF)
    if k <= 32:
        vmask = full if k == 32 else jnp.uint32(((1 << k) - 1) << (32 - k))
        ok = (ext_v[:, :W] & vmask) == vmask
    else:
        ok = (ext_v[:, :W] == full) & (ext_v[:, k - 32 : k - 32 + W] == full)
    return ok.sum(axis=1, dtype=jnp.int32)
