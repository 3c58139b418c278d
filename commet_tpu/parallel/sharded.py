"""Multi-device execution: membership planes sharded across the mesh,
query batches data-parallel, results merged with collectives.

Replaces the reference's parallelism story (SGE job DAG over a shared
filesystem, Commet.py:119,204-236) with a jax.sharding Mesh over the
devices of one host (GPUs joined by NVLink; XLA lowers the collectives to
NCCL):

  - the 4 membership planes ([4, W] uint32) are sharded on the word axis
    across mesh axis "d" - the device equivalent of the reference's
    RAM-bounded sequential index partitions (index_and_search.cpp:255-277),
    except the shards are resident simultaneously and probed in parallel;
  - query read batches are sharded on the read axis (data parallel);
  - each device computes plane-membership hits for the whole batch against
    its word range; a psum over "d" assembles full membership, after which
    each device greedy-counts its own rows;
  - per-pair matrix counts merge with psum.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from commet_tpu.core import kernels
from commet_tpu.core.kernels import (_four_plane_addrs, _greedy,
                                     plane_words, window_keys)

shard_map = jax.shard_map


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("d",))


# --------------------------------------------------------------------------
# Data-parallel mode (planes replicated, batch sharded)
#
# Throughput scales with devices only if each device probes a DISJOINT
# slice of the batch. When the 4 membership planes fit in one device's
# memory (2^(k-1) bytes: 4 GiB at the k=33 default), replicate them and
# shard the read axis — GSPMD then partitions the existing single-device
# kernels with no collectives on the hot path (tags come back
# batch-sharded). The plane-sharded mode below remains for planes that
# exceed one device's memory.
# --------------------------------------------------------------------------


def dp_shardings(mesh: Mesh):
    """(replicated, batch-sharded) NamedShardings for DP mode."""
    return (NamedSharding(mesh, P()), NamedSharding(mesh, P("d")))


def device_hbm_bytes() -> int:
    """Memory the runtime lets this process use on one local device
    (``memory_stats()['bytes_limit']``). Raises when the backend reports
    no limit (the CPU backend does not): callers that size device-resident
    data must not guess one."""
    dev = jax.local_devices()[0]
    stats = dev.memory_stats() or {}
    limit = int(stats.get("bytes_limit", 0))
    if limit <= 0:
        raise RuntimeError(
            f"{dev.platform} device {dev.device_kind!r} reports no memory "
            "limit (memory_stats()['bytes_limit']); device memory budgets "
            "cannot be derived on this backend")
    return limit


def dp_fits(k: int, n_devices: int = 1, hbm_bytes: int | None = None) -> bool:
    """Can every device of an ``n_devices`` mesh hold its own copy of the
    4 planes (2^(k-1) bytes) in half its memory? Never beyond
    ``kernels.MAX_SINGLE_DEVICE_K``, whose flat plane index is int32. The
    CPU backend's devices report no limit and share the host's memory, so
    there all ``n_devices`` copies must fit half of physical memory."""
    if k > kernels.MAX_SINGLE_DEVICE_K:
        return False
    plane_bytes = 1 << max(k - 1, 0)
    if hbm_bytes is None:
        if jax.local_devices()[0].platform == "cpu":
            host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
            return n_devices * plane_bytes <= host // 2
        hbm_bytes = device_hbm_bytes()
    return plane_bytes <= hbm_bytes // 2


def alloc_planes_sharded(k: int, mesh: Mesh):
    """[4, W] uint32 planes, word axis sharded over mesh axis 'd'."""
    w = plane_words(k)
    sharding = NamedSharding(mesh, P(None, "d"))
    return jax.device_put(jnp.zeros((4, w), dtype=jnp.uint32), sharding)


def _local_membership(planes_local, words, masks, k, lo, w_local):
    """Bit-tests against this chip's word range; False outside it."""
    in_range = (words >= lo) & (words < lo + w_local)
    wl = jnp.clip(words - lo, 0, w_local - 1).astype(jnp.int32)
    flat = planes_local.reshape(-1)
    offs = (jnp.arange(4, dtype=jnp.int32) * w_local).reshape(
        (4,) + (1,) * (words.ndim - 1))
    got = jnp.take(flat, wl + offs, axis=0)
    return in_range & ((got & masks) != 0)


def build_search_step(mesh: Mesh, k: int, t: int):
    """Returns jitted (build_fn, search_fn) over the mesh.

    build_fn(planes [4,W] P(None,'d'), codes [N,L] replicated) -> planes
    search_fn(planes, codes [N,L] P('d',None)) -> tags [N] P('d')
    """
    n_dev = mesh.devices.size
    w = plane_words(k)
    if w % n_dev != 0:
        raise ValueError(f"plane words {w} not divisible by mesh size {n_dev}")
    w_local = w // n_dev
    if 4 * w_local > 1 << 31:
        raise ValueError(
            f"k={k} over {n_dev} devices leaves 4 * {w_local} plane words "
            "per device, beyond the int32 local plane index; use more "
            "devices")

    def _build(planes_local, codes):
        # codes replicated: every chip scans everything, keeps its range
        lo = jax.lax.axis_index("d").astype(jnp.uint32) * np.uint32(w_local)
        s = window_keys(codes, k, strand="fwd")
        ok = s["ok"].reshape(-1)
        a_lo, a_hi = s["fa_lo"].reshape(-1), s["fa_hi"].reshape(-1)
        b_lo, b_hi = s["fb_lo"].reshape(-1), s["fb_hi"].reshape(-1)
        words, masks = _four_plane_addrs(a_lo, a_hi, b_lo, b_hi, k)
        out = planes_local
        for p in range(4):
            word, mask = words[p], masks[p]
            mine = ok & (word >= lo) & (word < lo + np.uint32(w_local))
            wl = jnp.where(mine, word - lo, np.uint32(w_local))  # sentinel
            mask = jnp.where(mine, mask, 0)
            wl, mask = jax.lax.sort((wl, mask), num_keys=1)
            from commet_tpu.core.kernels import _segmented_or_last
            or_mask = _segmented_or_last(wl, mask)
            wl = jnp.minimum(wl, np.uint32(w_local - 1)).astype(jnp.int32)
            existing = out[p, wl]
            out = out.at[p, wl].add(or_mask & ~existing)
        return out

    def _search(planes_local, codes_local):
        lo = jax.lax.axis_index("d").astype(jnp.uint32) * np.uint32(w_local)
        # assemble the full batch on every chip, membership via psum
        codes = jax.lax.all_gather(codes_local, "d", tiled=True)
        s = window_keys(codes, k)
        ok = s["ok"]
        fw_w, fw_m = _four_plane_addrs(s["fa_lo"], s["fa_hi"],
                                       s["fb_lo"], s["fb_hi"], k)
        rc_w, rc_m = _four_plane_addrs(s["ra_lo"], s["ra_hi"],
                                       s["rb_lo"], s["rb_hi"], k)
        part_f = _local_membership(planes_local, fw_w, fw_m, k, lo, w_local)
        part_r = _local_membership(planes_local, rc_w, rc_m, k, lo, w_local)
        # each word lives on exactly one chip -> psum == OR
        both = jax.lax.psum(jnp.stack([part_f, part_r]).astype(jnp.int32), "d")
        mem_f = both[0].all(axis=0)  # AND over the 4 planes
        mem_r = both[1].all(axis=0)
        cnt_f = _greedy(mem_f & ok, k, t)
        cnt_r = _greedy(mem_r & ok, k, t)
        tags = (cnt_f >= t) | (cnt_r >= t)
        # keep only this chip's rows
        n_local = codes_local.shape[0]
        me = jax.lax.axis_index("d")
        return jax.lax.dynamic_slice(tags, (me * n_local,), (n_local,))

    build_fn = jax.jit(shard_map(
        _build, mesh=mesh,
        in_specs=(P(None, "d"), P()),
        out_specs=P(None, "d")),
        donate_argnums=(0,))
    search_fn = jax.jit(shard_map(
        _search, mesh=mesh,
        in_specs=(P(None, "d"), P("d", None)),
        out_specs=P("d")))
    return build_fn, search_fn


def stream_search_step(mesh: Mesh, length: int, k: int, t: int, wmax: int,
                       packed: bool = False):
    """Data-parallel sorted-join stream probe over the mesh: the
    StreamIndex (sorted join columns) replicates, the read batch shards on
    the read axis, and every device runs the full single-device stream
    pipeline (sort + join + unsort + greedy) on its shard — no collectives
    on the hot path, verdicts come back batch-sharded.

    k > 32 (the reference's k=33 default, index_and_search.cpp:71)
    replicates the packed hi-bit column alongside the join columns.
    ``packed=True`` builds the dirty-batch variant (reads ship the full
    1-bit validity plane instead of lengths)."""
    from commet_tpu.core import stream as stream_mod

    wide = k > 32
    base = (stream_mod.probe_cascade2_stream_packed if packed
            else stream_mod.probe_cascade2_stream)
    fn = functools.partial(base, length=length, k=k, t=t, wmax=wmax)

    if wide:
        def _search(ika, ikb, mi, ihib, c2, aux):
            return fn(ika, ikb, mi, c2, aux, ihib=ihib)
        in_specs = (P(), P(), P(), P(), P("d", None),
                    P("d", None) if packed else P("d"))
    else:
        def _search(ika, ikb, mi, c2, aux):
            return fn(ika, ikb, mi, c2, aux)
        in_specs = (P(), P(), P(), P("d", None),
                    P("d", None) if packed else P("d"))

    # check_vma=False: the join's search bounds start from replicated
    # constants and become shard-varying inside its loop
    return jax.jit(shard_map(
        _search, mesh=mesh, in_specs=in_specs,
        out_specs=P("d"), check_vma=False))


# --------------------------------------------------------------------------
# Key-range-sharded StreamIndex: the stream analog of plane sharding. When a
# partition's sorted join columns + exact sets exceed one device's memory,
# the lexicographically sorted columns split into contiguous ranges -- each
# device owns one key range. Every device joins the FULL query stream
# against its slice; per-window verdicts merge with a max over the mesh:
#
#   NONMEM(0) < CAND(1) < CONF(2)
#
# Soundness of the max-merge: each device's verdict is exact for the
# multiset held in its slice (a device whose slice lacks a key simply finds
# no match and answers NONMEM). Over the union of the slices, CONF holds iff
# some slice holds the exact pair, and CAND iff no slice holds the pair but
# some slice holds keya -- which is exactly what the max computes, even
# when an equal-keya run straddles a slice boundary. The merged verdicts
# therefore equal the single-device verdicts.
# --------------------------------------------------------------------------


def shard_stream_index(sx, n: int):
    """Split a core.stream.StreamIndex into n contiguous key-range slices,
    as stacked arrays ready for P('d') sharding.

    Returns dict with:
      ika/ikb [n*per]            (sharded join columns; SENTINEL pad)
      mi_loc  [n] int32          (valid entries inside each slice)
      sets    [n, 4, per_s] uint32 (sa..sd sliced the same way; None if
                                  the index has no exact sets, i.e. wide
                                  keys)
      set_mi  [n] int32
    """
    import jax.numpy as jnp

    from commet_tpu.core.stream import SENTINEL

    mi = int(sx.mi)

    def split(cols):
        """Pad each 1-D column to n equal slices; returns the padded
        columns, the slice length and each slice's valid count."""
        ln = max(int(c.shape[0]) for c in cols)
        per = -(-ln // n)
        out = [jnp.concatenate([c, jnp.full((per * n - int(c.shape[0]),),
                                            SENTINEL, jnp.uint32)])
               for c in cols]
        valid = jnp.asarray(np.clip(mi - np.arange(n) * per, 0, per),
                            jnp.int32)
        return out, per, valid

    (ika, ikb), _per, mi_loc = split((sx.ika, sx.ikb))
    out = {"ika": ika, "ikb": ikb, "mi_loc": mi_loc}
    if sx.sa is not None:
        sets, per, set_mi = split((sx.sa, sx.sb, sx.sc, sx.sd))
        out["sets"] = jnp.stack([s.reshape(n, per) for s in sets], axis=1)
        out["set_mi"] = set_mi
    else:
        out["sets"] = None
        out["set_mi"] = None
    return out


def sharded_stream_step(mesh: Mesh, length: int, k: int, t: int, wmax: int,
                        packed: bool = False):
    """Streamed probe against a key-range-sharded index (shard_stream_index
    layout): batch replicated, index sharded, verdicts pmax-merged. Narrow
    keys only (k <= 32). Returns verdicts [B] int8, replicated."""
    from commet_tpu.core import kernels
    from commet_tpu.core import stream as stream_mod

    def _search(ika_l, ikb_l, mi_l, c2, aux):
        if packed:
            codes = kernels.unpack_codes(c2, aux, length)
        else:
            codes = kernels.unpack_codes_clean(c2, aux, length)
        wk = kernels.window_keys(codes, k, "both", wmax)
        mem = stream_mod._membership_stream(ika_l, ikb_l, mi_l[0], wk)
        mem = jax.lax.pmax(mem.astype(jnp.int32), "d").astype(jnp.int8)
        return stream_mod._stream_verdict(wk, mem, k, t)

    return jax.jit(shard_map(
        _search, mesh=mesh,
        in_specs=(P("d"), P("d"), P("d"), P(), P()),
        out_specs=P(), check_vma=False))


def sharded_exact_step(mesh: Mesh, length: int, k: int, t: int, wmax: int):
    """Exact sorted-set probe against key-range-sharded value sets: each
    chip tests membership in its slice of each of the four sets; per-set
    hits OR across the mesh (psum > 0 — equal-value runs may straddle a
    shard boundary), then AND across sets and greedy count, exactly
    matching core.stream.probe_exact_sets."""
    from commet_tpu.core import kernels
    from commet_tpu.core import stream as stream_mod

    def _exact(sets_l, set_mi_l, c2, vd):
        codes = kernels.unpack_codes(c2, vd, length)
        wk = kernels.window_keys(codes, k, "both", wmax)
        ok = wk["ok"]
        tagged = None
        for p in ("f", "r"):
            a = wk[p + "a_lo"]
            b = wk[p + "b_lo"]
            hits = jnp.stack([
                stream_mod._in_sorted(sets_l[0, 0], set_mi_l[0], a),
                stream_mod._in_sorted(sets_l[0, 1], set_mi_l[0], b),
                stream_mod._in_sorted(sets_l[0, 2], set_mi_l[0], a ^ b),
                stream_mod._in_sorted(sets_l[0, 3], set_mi_l[0], a | b),
            ]).astype(jnp.int32)
            hits = jax.lax.psum(hits, "d")  # OR across shards
            member = (hits > 0).all(axis=0) & ok
            tag_s = kernels.greedy_ge(member, k, t)
            tagged = tag_s if tagged is None else (tagged | tag_s)
        return tagged

    return jax.jit(shard_map(
        _exact, mesh=mesh,
        in_specs=(P("d", None, None), P("d"), P(), P()),
        out_specs=P(), check_vma=False))


def stream_exact_step(mesh: Mesh, length: int, k: int, t: int, wmax: int):
    """DP wrapper for the exact sorted-set fallback probe."""
    from commet_tpu.core import stream as stream_mod

    fn = functools.partial(stream_mod.probe_exact_sets,
                           length=length, k=k, t=t, wmax=wmax)

    def _search(sa, sb, sc, sd, mi, c2, vd):
        return fn(sa, sb, sc, sd, mi, c2, vd)

    return jax.jit(shard_map(
        _search, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P("d", None), P("d", None)),
        out_specs=P("d"), check_vma=False))


@functools.partial(jax.jit, static_argnames=("mesh_axis",))
def popcount_psum(tags, mesh_axis: str = "d"):
    """Per-shard tag count merged across the mesh (matrix cell merge)."""
    return tags.sum(dtype=jnp.int32)


def full_pair_step(mesh: Mesh, k: int, t: int):
    """One complete pair-comparison step over the mesh: build the sharded
    planes from an index batch, classify a query batch, psum the shared-read
    count. This is the multi-chip 'training step' equivalent."""
    build_fn, search_fn = build_search_step(mesh, k, t)

    def step(planes, index_codes, query_codes):
        planes = build_fn(planes, index_codes)
        tags = search_fn(planes, query_codes)
        return planes, tags, tags.sum(dtype=jnp.int32)

    return step


def auto_mesh():
    """Mesh from the COMMET_TPU_DEVICES env var: an integer device count,
    or "all" for every visible device. Returns None (single-device
    execution) when unset/1. This is how the CLI tools opt into
    multi-device runs."""
    spec = os.environ.get("COMMET_TPU_DEVICES", "").strip().lower()
    if not spec or spec in ("1", "none"):
        return None
    local = jax.local_devices()  # per-process mesh: shardings stay
    n = len(local) if spec == "all" else int(spec)  # host-addressable
    if n <= 1:
        return None
    return Mesh(np.array(local[:n]), ("d",))
