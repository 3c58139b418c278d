"""The index->search engine: the device equivalent of the reference's
index_and_search tool (src/index_and_search.cpp) with bit-exact semantics.

Execution model
---------------
The reference streams reads single-threaded through a RAM-bounded Bloom
index built in sequential partitions. Here:
  - the host layer batches eligible reads into fixed-shape padded 2-bit
    code tensors;
  - partition boundaries replicate the reference's read-granular cursor
    semantics exactly, including the read *dropped* at every partition
    boundary (index_reads.h:49-61 fetches one read past the cap and never
    indexes it) and found-read skipping between partitions
    (file_manager.h:99-109);
  - per partition, the membership structure is built on device and every
    still-untagged query read is classified in large data-parallel
    batches. The default structure for k <= 34 at low fill is the sorted
    (keya, keyb) StreamIndex probed by the sorted join (core/stream.py,
    planeless for k <= 32); other configurations build
    the 4 dense 2^k-bit membership planes and probe them with the gather
    cascade (core/kernels.py). All paths produce bit-identical tags.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

import jax
import jax.numpy as jnp

from commet_tpu.core import kernels
from commet_tpu.io.reads import ReadSet

# default read-batch geometry; padded shapes are bucketed to limit recompiles
DEFAULT_BATCH = 4096
LENGTH_BUCKET = 32


def max_kmer_for(k: int) -> int:
    """Partition cap: (unsigned long)(1e9 / 2^(33-k))
    (reference index_and_search.cpp:73,146)."""
    return int(1000000000.0 / (2.0 ** (33 - k)))


def _pad_length(lmax: int, k: int) -> int:
    lmax = max(lmax, k)
    return -(-lmax // LENGTH_BUCKET) * LENGTH_BUCKET


def _bucket_size(n: int, batch: int, mesh=None) -> int:
    """Power-of-two batch bucket (>= 2048, <= batch), rounded up to a
    multiple of the mesh size so DP shardings stay even."""
    size = min(batch, max(2048, 1 << (max(n, 1) - 1).bit_length()))
    if mesh is not None:
        nd = mesh.devices.size
        size = -(-size // nd) * nd
    return size


@dataclass
class EncodedSet:
    """Device-friendly view of a ReadSet: flat 2-bit codes + ragged index."""

    rs: ReadSet
    flat_codes: List[np.ndarray] = field(default_factory=list)
    offsets: List[np.ndarray] = field(default_factory=list)
    lengths: List[np.ndarray] = field(default_factory=list)

    def __post_init__(self):
        for f in self.rs.files:
            c, o, l = f.encoded()
            self.flat_codes.append(c)
            self.offsets.append(o)
            self.lengths.append(l)

    def gather_batch(self, idx: np.ndarray, lpad: int) -> np.ndarray:
        """Pack reads (file_idx, read_pos) pairs into a [B, lpad] uint8 code
        array (pad value INVALID). Uses the native batch assembler when
        available."""
        from commet_tpu.native import parser as native
        have_native = native.available()
        b = len(idx)
        out = np.full((b, lpad), kernels.INVALID_CODE, dtype=np.uint8)
        for fi in range(len(self.flat_codes)):
            rows = np.nonzero(idx[:, 0] == fi)[0]
            if len(rows) == 0:
                continue
            pos = idx[rows, 1]
            if have_native:
                out[rows] = native.gather_batch(
                    self.flat_codes[fi], self.offsets[fi], self.lengths[fi],
                    pos, lpad)
            else:
                for r, p in zip(rows, pos):
                    off = self.offsets[fi][p]
                    ln = min(int(self.lengths[fi][p]), lpad)
                    out[r, :ln] = self.flat_codes[fi][off : off + ln]
        return out

    def read_lengths(self, idx: np.ndarray) -> np.ndarray:
        if len(idx) == 0:
            return np.zeros(0, dtype=np.int32)
        return np.array([self.lengths[fi][pos] for fi, pos in idx], dtype=np.int32)

    def gather_packed(self, idx: np.ndarray, lpad: int, rows_pad: int):
        """Assemble a batch directly in the device wire format:
        (codes2 [R, ceil(lpad/16)], valid [R, ceil(lpad/32)], lens [R],
        clean). Pad rows (R > len(idx)) stay all-invalid. Uses the native
        one-pass gather+pack when available."""
        w16, w32 = -(-lpad // 16), -(-lpad // 32)
        c2 = np.zeros((rows_pad, w16), dtype=np.uint32)
        vd = np.zeros((rows_pad, w32), dtype=np.uint32)
        ln = np.zeros(rows_pad, dtype=np.int32)
        clean = True
        from commet_tpu.native import parser as native
        have_native = native.available()
        if have_native:
            for fi in range(len(self.flat_codes)):
                rows = np.nonzero(idx[:, 0] == fi)[0]
                if not len(rows):
                    continue
                sc2, svd, sln, dirty = native.gather_packed(
                    self.flat_codes[fi], self.offsets[fi], self.lengths[fi],
                    idx[rows, 1], lpad)
                c2[rows], vd[rows], ln[rows] = sc2, svd, sln
                clean &= not dirty
            return c2, vd, ln, clean
        from commet_tpu.core import kernels as _k
        codes = self.gather_batch(idx, lpad)
        pc2, pvd = _k.pack_codes_np(codes)
        c2[: len(idx)], vd[: len(idx)] = pc2, pvd
        valid = codes != _k.INVALID_CODE
        ln[: len(idx)] = valid.sum(axis=1)
        clean = bool((valid[:, :-1] >= valid[:, 1:]).all())
        return c2, vd, ln, clean


@dataclass
class ResidentIndex:
    """One index read set kept fully resident on device as planeless
    StreamIndex partitions, for the amortized all-vs-all schedule: each
    query set's sorted key stream is produced ONCE per batch and joined
    against every resident index (reference Commet.py:186-240 searches a
    query set against up to N-1 index sets; the query sort and unsort
    amortize by that S)."""

    name: str
    partitions: List  # stream.StreamIndex, one per max_kmer partition
    nb_indexed: int
    total_kmers: int
    build_seconds: float
    # lazy per-partition host exact sets for the wide-key (k > 32) AMBIG
    # fallback: sorted uint64 value multisets of the four reference planes
    # (A=keya, B=keyb, C=a^b, D=a|b), pulled from the device join planes
    # on first use. AMBIG residues are tiny (~0.1% of reads), so a host
    # searchsorted resolves them exactly without 4 GiB bit planes per
    # resident index.
    host_exact: List = field(default_factory=list)

    def host_exact_sets(self, pi: int):
        if not self.host_exact:
            self.host_exact = [None] * len(self.partitions)
        if self.host_exact[pi] is None:
            sx = self.partitions[pi]
            mi = int(sx.mi)
            a_lo = np.asarray(sx.ika).reshape(-1)[:mi].astype(np.uint64)
            b_lo = np.asarray(sx.ikb).reshape(-1)[:mi].astype(np.uint64)
            if sx.ihib is not None:
                hib = np.asarray(sx.ihib).reshape(-1)[:mi].astype(np.uint64)
                a = (hib >> np.uint64(8) << np.uint64(32)) | a_lo
                b = ((hib & np.uint64(0xFF)) << np.uint64(32)) | b_lo
            else:
                a, b = a_lo, b_lo
            self.host_exact[pi] = tuple(
                np.sort(v) for v in (a, b, a ^ b, a | b))
        return self.host_exact[pi]

    def device_bytes(self) -> int:
        tot = 0
        for sx in self.partitions:
            tot += int(sx.ika.size + sx.ikb.size) * 4
            if sx.ihib is not None:  # wide-key (k=33/34) hi-bit plane
                tot += int(sx.ihib.size) * 4
            for s in (sx.sa, sx.sb, sx.sc, sx.sd):
                if s is not None:
                    tot += int(s.size) * 4
        return tot


@dataclass
class ResidentPlanes:
    """One index read set kept fully resident on device as dense membership
    planes (one 4-plane array per max_kmer partition), for the amortized
    all-vs-all schedule in the HIGH-FILL regime where the planeless
    StreamIndex disables itself (the reference's own default: max_kmer
    partitions sit at 11.6% fill, index_and_search.cpp:73,146). One query
    batch upload + window-key computation then serves every resident
    index's cascade probe (kernels.probe_cascade2_multi_*)."""

    name: str
    partitions: List  # [4 * plane_words] uint32 device arrays
    fills: List[float]
    nb_indexed: int
    total_kmers: int
    build_seconds: float

    def device_bytes(self) -> int:
        return sum(int(p.size) * 4 for p in self.partitions)


class Engine:
    """Builds membership planes from an index set and classifies query sets
    against them, with reference partitioning semantics."""

    def __init__(self, k: int, t: int, batch: int = DEFAULT_BATCH,
                 max_kmer: Optional[int] = None, mesh=None,
                 cascade: Optional[bool] = None,
                 mesh_mode: Optional[str] = None):
        self.k = k
        self.t = t
        self.batch = batch
        self.max_kmer = max_kmer_for(k) if max_kmer is None else max_kmer
        # cascade probe (plane-A prefilter + targeted verification + exact
        # fallback); bit-exact vs the full probe, ~4x fewer plane gathers
        if cascade is None:
            cascade = os.environ.get("COMMET_TPU_CASCADE", "1") != "0"
        self.cascade = cascade
        self._verify_v = 4  # per-partition, set from the index fill estimate
        # sorted-set join (core/stream.py): membership by binary search
        # over the partition's sorted window keys instead of dense-plane
        # gathers, for low-fill partitions. Single-chip and DP-mesh
        # (batch-sharded) modes; k <= 34. Off by default: on the H100 the
        # dense cascade ran the low-fill all-vs-all 4.5x faster (PERF.md).
        # COMMET_TPU_STREAM=1 enables it for low-fill partitions, =force
        # at any fill (used by the tests).
        stream_env = os.environ.get("COMMET_TPU_STREAM", "0")
        self._on_cpu = jax.devices()[0].platform == "cpu"
        self._stream_forced = stream_env == "force"
        self._stream_env_on = stream_env in ("1", "force") and k <= 34
        self.stream = self._stream_env_on and mesh is None  # may widen below
        self.stream_batch = int(os.environ.get("COMMET_TPU_STREAM_BATCH",
                                               "65536"))
        # host-IO pipeline: background-thread gather+pack of batch N+1
        # while the device runs batch N (COMMET_TPU_PREFETCH=0 disables)
        self.prefetch = os.environ.get("COMMET_TPU_PREFETCH", "1") != "0"

        self._ika = self._ikb = None
        self._ik_mi = None
        self._sidx = None
        # host-IO pipeline accounting: per-search-call
        # decomposition of where wall time goes. pack_s accumulates on the
        # prefetch thread (total host gather+pack work), block_s is the
        # time the DISPATCH loop actually waited for a batch (0 == the
        # pipeline fully hid host IO behind device work), fetch_s is the
        # tail spent fetching verdicts. last_io_stats holds the previous
        # search call's numbers for bench/driver reporting.
        self.last_io_stats: Dict[str, float] = {}
        self._io_pack = self._io_block = 0.0
        self._stream_serving = False  # set per partition from the fill
        self._stream_dp_fns = {}
        # CAND-flood guard: when the index fill (valid k-mers / 2^k) is
        # high, most windows are keya collisions and the streamed verdicts
        # degenerate to AMBIG; the gather cascade is the right tool there
        self.stream_max_fill = float(os.environ.get(
            "COMMET_TPU_STREAM_MAX_FILL", "0.02"))
        # multi-chip modes (commet_tpu/parallel/sharded.py):
        #   dp    - planes replicated, batch sharded: linear reads/s scaling,
        #           reuses the single-chip cascade kernels via GSPMD
        #   plane - planes sharded on the word axis (k too large for one
        #           device's memory), batch replicated, psum-merged
        #           membership
        self.mesh = mesh
        self.mesh_mode = None
        self._sharded_fns = None
        self._rep_sharding = self._batch_sharding = None
        if mesh is not None:
            from commet_tpu.parallel import sharded
            if batch % mesh.devices.size != 0:
                raise ValueError("batch must divide evenly across the mesh")
            self._sharded = sharded
            if mesh_mode is None:
                mesh_mode = ("dp" if sharded.dp_fits(k, mesh.devices.size)
                             else "plane")
            self.mesh_mode = mesh_mode
            if self.mesh_mode == "dp":
                self._rep_sharding, self._batch_sharding = \
                    sharded.dp_shardings(mesh)
                # DP mode also serves the stream probe: index replicated,
                # batch sharded, every chip streams its shard. Wide keys
                # (k=33/34, covering the reference default) replicate the
                # packed hi-bit column alongside the join columns.
                self.stream = self._stream_env_on
            else:
                self._sharded_fns = sharded.build_search_step(mesh, k, t)

    # ---------------------------------------------------------------- utils
    def _batched_codes(self, enc: EncodedSet, idx: np.ndarray,
                       lpad: Optional[int] = None, bucket: bool = False):
        """Yield (row_slice, codes_batch[B, lpad]) over idx in fixed batches.

        bucket=True pads the batch dimension to the next power of two
        (>= 2048, <= self.batch) instead of always self.batch — used for the
        small remainder passes (rc strand, ambiguous fallback) so they don't
        pay full-batch gather volume."""
        if len(idx) == 0:
            return
        if lpad is None:
            lengths = enc.read_lengths(idx)
            lpad = _pad_length(int(lengths.max(initial=1)), self.k)
        size = self.batch
        if bucket:
            size = _bucket_size(len(idx), self.batch, self.mesh)
        for start in range(0, len(idx), size):
            chunk = idx[start : start + size]
            codes = enc.gather_batch(chunk, lpad)
            if len(chunk) < size:
                pad = np.full((size - len(chunk), lpad),
                              kernels.INVALID_CODE, dtype=np.uint8)
                codes = np.concatenate([codes, pad], axis=0)
            yield slice(start, start + len(chunk)), codes

    def _batched_packed(self, enc: EncodedSet, idx: np.ndarray,
                        lpad: int, bucket: bool = False,
                        size: Optional[int] = None):
        """Yield (row_slice, codes2, valid, lens, clean) wire-format batches
        (see _batched_codes for the bucketing rule).

        Host-IO pipeline: the NEXT batch's gather+pack runs on a background
        thread while the caller dispatches/uploads the current one (the
        native assembler releases the GIL), so host packing overlaps device
        compute instead of serializing with it — the reference's
        single-threaded read loop (include/fastq_file.h:353-684) has no
        such overlap to give."""
        if len(idx) == 0:
            return
        if size is None:
            size = self.batch
            if bucket:
                size = _bucket_size(len(idx), self.batch, self.mesh)
        starts = list(range(0, len(idx), size))

        def job(start):
            t0 = time.time()
            chunk = idx[start : start + size]
            c2, vd, ln, clean = enc.gather_packed(chunk, lpad, size)
            self._io_pack += time.time() - t0
            return slice(start, start + len(chunk)), c2, vd, ln, clean

        if len(starts) == 1 or not self.prefetch:
            for start in starts:
                t0 = time.time()
                got = job(start)
                self._io_block += time.time() - t0
                yield got
            return
        from concurrent.futures import ThreadPoolExecutor
        ex = ThreadPoolExecutor(max_workers=1)
        try:
            fut = ex.submit(job, starts[0])
            for nxt in starts[1:]:
                t0 = time.time()
                cur = fut.result()
                self._io_block += time.time() - t0
                fut = ex.submit(job, nxt)
                yield cur
            t0 = time.time()
            last = fut.result()
            self._io_block += time.time() - t0
            yield last
        finally:
            ex.shutdown(wait=False)

    def _io_reset(self):
        self._io_pack = self._io_block = 0.0
        self._io_t0 = time.time()

    def _io_stash(self, fetch_s: float):
        wall = time.time() - self._io_t0
        self.last_io_stats = {
            "wall_s": round(wall, 4),
            "host_pack_s": round(self._io_pack, 4),
            "host_block_s": round(self._io_block, 4),
            "fetch_s": round(fetch_s, 4),
            # dispatch-loop occupancy: fraction of wall NOT spent waiting
            # for host packing or result fetches -- the device-feed duty
            # cycle the prefetch pipeline is supposed to maximize
            "feed_busy_frac": round(
                max(0.0, 1.0 - (self._io_block + fetch_s) / wall)
                if wall > 0 else 0.0, 4),
        }

    @staticmethod
    def _native():
        from commet_tpu.native import parser as native
        return native if native.available() else None

    def _dev(self, arr, kind: str = "batch"):
        """Host array -> device array; in DP mesh mode, batch arrays land
        sharded on the read axis and planes replicated (GSPMD partitions
        the single-chip kernels from these shardings alone)."""
        if self._batch_sharding is not None:
            sh = (self._batch_sharding if kind == "batch"
                  else self._rep_sharding)
            return jax.device_put(np.asarray(arr), sh)
        return jnp.asarray(arr)

    def count_kmers(self, enc: EncodedSet, idx: np.ndarray) -> np.ndarray:
        """Per-read complete-window counts for the partitioning cursor."""
        native = self._native()
        out = np.zeros(len(idx), dtype=np.int64)
        if native is not None:
            for fi in range(len(enc.flat_codes)):
                rows = np.nonzero(idx[:, 0] == fi)[0]
                if len(rows):
                    out[rows] = native.count_kmers(
                        enc.flat_codes[fi], enc.offsets[fi], enc.lengths[fi],
                        idx[rows, 1], self.k)
            return out
        for sl, codes in self._batched_codes(enc, idx):
            cnt = kernels.count_kmers(jnp.asarray(codes, dtype=jnp.int32), self.k)
            out[sl] = np.asarray(cnt)[: sl.stop - sl.start]
        return out

    def partitions(self, kmer_counts: np.ndarray) -> List[np.ndarray]:
        """Split eligible-read indices into partitions with the exact
        reference cursor semantics: reads are indexed while the partition's
        cumulative k-mer count is < max_kmer; the first read fetched at or
        past the cap is consumed but never indexed
        (index_reads.h:49-61, index_and_search.cpp:255-277)."""
        n = len(kmer_counts)
        parts: List[np.ndarray] = []
        cursor = 0
        seen = 0
        while seen < n:  # outer loop: get_reads_count() < nb_reads_to_index
            nb = 0
            members = []
            # first fetch of this index_reads call
            seen += 1
            if cursor >= n:
                break
            r = cursor
            cursor += 1
            while True:
                if nb >= self.max_kmer:
                    break  # read r is consumed but NOT indexed (dropped)
                members.append(r)
                nb += int(kmer_counts[r])
                seen += 1
                if cursor >= n:
                    r = None
                    break
                r = cursor
                cursor += 1
            parts.append(np.array(members, dtype=np.int64))
            if r is None:
                break
        return parts


    def _device_batch(self, n: int, build: bool = False) -> int:
        """Device-facing batch size for build/probe loops: larger than the
        assembly batch to amortize the fixed per-dispatch cost; bounded by
        the bucket rule. Build batches stay at <= 16384 reads. Both clamps
        were set on an earlier accelerator and are unmeasured on the GPU."""
        if build:
            # COMMET_TPU_BUILD_BATCH overrides the build clamp (probe has
            # COMMET_TPU_PROBE_BATCH)
            cap = int(os.environ.get("COMMET_TPU_BUILD_BATCH",
                                     str(min(self.batch, 16384))))
            return _bucket_size(n, cap, self.mesh)
        cap = max(self.batch, int(os.environ.get(
            "COMMET_TPU_PROBE_BATCH", "65536")))
        return _bucket_size(n, cap, self.mesh)

    def _alloc_planes(self):
        """Zero planes allocated on the device (no 2^(k-1)-byte host
        upload); replicated over the mesh in DP mode."""
        if self._rep_sharding is not None:
            import functools
            fn = jax.jit(functools.partial(kernels.alloc_planes, self.k),
                         out_shardings=self._rep_sharding)
            return fn()
        return kernels.alloc_planes(self.k)

    # ------------------------------------------------------------ main flow
    def build_planes(self, planes, enc: EncodedSet, idx: np.ndarray):
        """Build the partition's membership structure.

        Stream-serving partitions (single-chip, k<=32, low fill) build NO
        bit planes at all: the sorted (keya, keyb) join planes plus the
        four sorted plane-value sets (StreamIndex) carry both the streamed
        probe and its exact fallback -- returns None. Other configurations
        build the 4 dense device planes (sort -> segmented-OR -> scatter on
        device; native host bitset build on the CPU backend).
        """
        if self._sharded_fns is not None:
            build_fn, _ = self._sharded_fns
            if planes is None:
                planes = self._sharded.alloc_planes_sharded(self.k, self.mesh)
            for _, codes in self._batched_codes(enc, idx):
                planes = build_fn(planes, jnp.asarray(codes, jnp.int32))
            return planes
        if self._stream_serving:
            from commet_tpu.core import stream as _stream
            collect = []
            wide = self.k > 32
            if self._on_cpu:
                for _, codes in self._batched_codes(enc, idx):
                    collect.append(_stream.chunk_index_keys_codes(
                        jnp.asarray(codes, jnp.int32), self.k))
            else:
                # one pass: each uploaded batch feeds key collection AND
                # (for k > 32, which keeps bit planes for the exact
                # fallback) the plane build, so no batch is uploaded twice
                if wide and planes is None:
                    planes = self._alloc_planes()
                lengths = enc.read_lengths(idx)
                lpad = _pad_length(int(lengths.max(initial=1)), self.k)
                for _sl, c2, vd, ln, cl in self._batched_packed(
                        enc, idx, lpad,
                        size=self._device_batch(len(idx), build=True)):
                    c2d = self._dev(c2, "rep")
                    if cl:  # N-free: lengths replace the validity plane
                        lnd = self._dev(ln, "rep")
                        collect.append(_stream.chunk_index_keys_clean(
                            c2d, lnd, lpad, self.k))
                        if wide:
                            planes = kernels.build_chunk_packed_clean(
                                planes, c2d, lnd, lpad, self.k)
                    else:
                        vdd = self._dev(vd, "rep")
                        collect.append(_stream.chunk_index_keys(
                            c2d, vdd, lpad, self.k))
                        if wide:
                            planes = kernels.build_chunk_packed(
                                planes, c2d, vdd, lpad, self.k)
            self._finish_index_keys(collect)
            if not wide:
                return None  # planeless: the StreamIndex is everything
            if not self._on_cpu:
                return planes
            # CPU wide (tests only): fall through to the native build
        else:
            self._finish_index_keys(None)
        bulk_env = os.environ.get("COMMET_TPU_BULK_BUILD", "1")
        use_bulk = (self.mesh is None
                    and (not self._on_cpu or bulk_env == "force")
                    and bulk_env != "0")
        if use_bulk:
            if planes is None:
                planes = self._alloc_planes()
            return self._build_planes_bulk(planes, enc, idx)
        if not self._on_cpu:
            # packed transport: 2-bit codes + 1-bit validity per base
            if planes is None:
                planes = self._alloc_planes()
            lengths = enc.read_lengths(idx)
            lpad = _pad_length(int(lengths.max(initial=1)), self.k)
            for _sl, c2, vd, _ln, _cl in self._batched_packed(
                    enc, idx, lpad,
                    size=self._device_batch(len(idx), build=True)):
                planes = kernels.build_chunk_packed(
                    planes, self._dev(c2, "rep"), self._dev(vd, "rep"),
                    lpad, self.k)
            return planes
        native = self._native()
        # CPU backend: the host build IS the device build (the "upload" is
        # a local copy). On an accelerator the planes are built on device;
        # a host build plus upload there is unmeasured.
        if native is not None and self.k >= 5:
            planes_np = np.zeros(4 * kernels.plane_words(self.k),
                                 dtype=np.uint32)
            for fi in range(len(enc.flat_codes)):
                rows = np.nonzero(idx[:, 0] == fi)[0]
                if len(rows):
                    native.build_planes_into(
                        planes_np, enc.flat_codes[fi], enc.offsets[fi],
                        enc.lengths[fi], idx[rows, 1], self.k)
            return self._dev(planes_np, "rep")
        if planes is None:
            planes = self._alloc_planes()
        for _, codes in self._batched_codes(enc, idx):
            planes = kernels.build_chunk(
                planes, self._dev(np.asarray(codes, np.int32), "rep"),
                self.k)
        return planes

    def _build_planes_bulk(self, planes, enc: EncodedSet, idx: np.ndarray):
        """High-fill plane build as few huge sorted scatters: collect the
        partition's window keys once with the stream keygen kernel, then
        per plane derive+sort+dedup each ~2^27-entry chunk and write it
        with ONE unique-index scatter-set -- no existing-bit gathers
        (kernels.py bulk design notes)."""
        from commet_tpu.core import stream as _stream
        lengths = enc.read_lengths(idx)
        lpad = _pad_length(int(lengths.max(initial=1)), self.k)
        w = kernels.plane_words(self.k)
        # chunk capacity: entries per sorted scatter round. 2^27 keeps the
        # sort operands + derived streams inside HBM next to 4 GiB planes
        # at k=33; smaller planes can afford larger chunks.
        default_cap = 1 << (27 if self.k >= 32 else 28)
        cap = int(os.environ.get("COMMET_TPU_BULK_CHUNK", str(default_cap)))
        wide = self.k > 32
        acc: List = []
        slots = 0

        def flush():
            nonlocal acc, slots, planes
            if not acc:
                return
            if len(acc) == 1:
                ka, kb, hib, fl = acc[0]
            else:
                ka = jnp.concatenate([a[0] for a in acc])
                kb = jnp.concatenate([a[1] for a in acc])
                hib = jnp.concatenate([a[2] for a in acc]) if wide else None
                fl = jnp.concatenate([a[3] for a in acc])
            acc = []
            slots = 0
            for p in range(4):
                word, or_mask = kernels.bulk_plane_sorted(
                    ka, kb, hib if wide else fl, fl, self.k, p, wide)
                scratch = kernels.bulk_scatter_set(
                    jnp.zeros(w, jnp.uint32), word, or_mask)
                planes = kernels.bulk_or_plane(planes, scratch, p * w, w)

        for _sl, c2, vd, ln, cl in self._batched_packed(
                enc, idx, lpad, size=self._device_batch(len(idx))):
            if cl:  # N-free batch: skip the validity-plane upload
                ka, kb, hib, fl, _cnt = _stream.chunk_index_keys_clean(
                    jnp.asarray(c2), jnp.asarray(ln), lpad, self.k)
            else:
                ka, kb, hib, fl, _cnt = _stream.chunk_index_keys(
                    jnp.asarray(c2), jnp.asarray(vd), lpad, self.k)
            acc.append((ka, kb, hib, fl))
            slots += int(ka.size)
            if slots >= cap:
                flush()
        flush()
        return planes

    def _finish_index_keys(self, collect):
        """Sort the per-batch (keya, keyb) chunks into the partition's
        StreamIndex (join planes + exact-fallback sets); resets it when
        streaming is off."""
        self._sidx = None
        self._ika = self._ikb = self._ik_mi = None
        if collect is None or not self.stream or not collect:
            return
        from commet_tpu.core import stream as _stream
        keys = [c[0] for c in collect]
        keysb = [c[1] for c in collect]
        hibs = [c[2] for c in collect]
        flags = [c[3] for c in collect]
        counts = [int(c[4]) for c in collect]
        self._sidx = _stream.finalize_index(keys, keysb, hibs, flags,
                                            counts, wide=self.k > 32)
        if self._rep_sharding is not None:
            for name in ("ika", "ikb", "ihib", "mi", "sa", "sb", "sc",
                         "sd"):
                val = getattr(self._sidx, name)
                if val is not None:
                    setattr(self._sidx, name,
                            jax.device_put(val, self._rep_sharding))
        self._ika, self._ikb = self._sidx.ika, self._sidx.ikb
        self._ik_mi = self._sidx.mi

    def search_set(self, planes, enc: EncodedSet, idx: np.ndarray):
        """Classify reads ``idx``; returns bool tags [len(idx)].

        Two streaming passes: forward strand over everything, then the
        reverse-complement strand only over the fwd-untagged remainder
        (host-compacted between passes) - the vectorized equivalent of the
        reference's per-read fwd-then-rc early exit (search_reads.h:64-83).
        """
        tags = np.zeros(len(idx), dtype=bool)
        if self._sharded_fns is not None:
            _, search_fn = self._sharded_fns
            for sl, codes in self._batched_codes(enc, idx):
                tagged = search_fn(planes, jnp.asarray(codes, jnp.int32))
                tags[sl] = np.asarray(tagged)[: sl.stop - sl.start]
            return tags
        if self._stream_serving and (planes is None
                                     or self._sidx is not None):
            # stream-serving partition (planes present only for k > 32,
            # where they back the exact fallback)
            return self._search_stream_only(enc, idx, planes)
        if self.cascade:
            return self._search_cascade(planes, enc, idx)
        return self._search_full(planes, enc, idx)

    def _search_stream_only(self, enc: EncodedSet, idx: np.ndarray,
                            planes=None):
        """Streamed classification: sorted-join verdicts for every batch
        (dirty batches ship the validity plane), then the rare AMBIG
        residue resolves through the exact sorted-set probe (k <= 32,
        planeless) or the full plane probe (k > 32) -- bit-identical
        to the reference either way."""
        from commet_tpu.core import stream as _stream
        tags = np.zeros(len(idx), dtype=bool)
        if self._sidx is None:  # empty index partition: nothing can match
            return tags
        lengths = enc.read_lengths(idx)
        lmax = int(lengths.max(initial=1))
        lpad = _pad_length(lmax, self.k)
        wmax = max(1, lmax - self.k + 1)
        sx = self._sidx
        size = max(_bucket_size(len(idx), self.stream_batch, self.mesh),
                   2048)
        # keep the batch's window-key volume inside MAX_UNSORT_KEYS (binds
        # only for multi-kb reads; the stream stays usable, just in
        # smaller batches)
        max_keys = _stream.MAX_UNSORT_KEYS
        while size > 2048 and size * 2 * wmax > max_keys:
            size //= 2
        dp = self.mesh is not None  # DP mesh: per-chip shard streaming
        if dp:
            ndev = self.mesh.devices.size
            size = max(-(-size // ndev) * ndev, ndev)
        if size * 2 * wmax > max_keys:
            # absurdly long reads: stream geometry impossible -> exact path
            return self._search_stream_fallback(enc, idx, planes, lpad,
                                                wmax)
        wide = self.k > 32
        if dp:
            key = (lpad, wmax)
            if key not in self._stream_dp_fns:
                self._stream_dp_fns[key] = (
                    self._sharded.stream_search_step(
                        self.mesh, lpad, self.k, self.t, wmax),
                    self._sharded.stream_search_step(
                        self.mesh, lpad, self.k, self.t, wmax, packed=True))
            dp_stream, dp_stream_packed = self._stream_dp_fns[key]
        pending = []  # (slice, device verdict) -- sync after dispatching
        self._io_reset()
        for sl, c2, vd, ln, clean in self._batched_packed(enc, idx, lpad,
                                                          size=size):
            if dp:
                fn = dp_stream if clean else dp_stream_packed
                aux = self._dev(ln) if clean else self._dev(vd)
                args = (sx.ika, sx.ikb, sx.mi) + \
                    ((sx.ihib,) if wide else ()) + (self._dev(c2), aux)
                verdict = fn(*args)
            elif clean:
                # the S=1 case of the multi-index pipeline (one compiled
                # probe shape family for both schedules); verdict equality
                # with the single-index probe is test-proven
                # (test_probe_multi_matches_single)
                verdict = _stream.probe_multi_stream_clean(
                    (sx.ika,), (sx.ikb,), (sx.mi,), self._dev(c2),
                    self._dev(ln), lpad, self.k, self.t, wmax,
                    ihibs=(sx.ihib,) if sx.ihib is not None else None)[0]
            else:
                verdict = _stream.probe_multi_stream_packed(
                    (sx.ika,), (sx.ikb,), (sx.mi,), self._dev(c2),
                    self._dev(vd), lpad, self.k, self.t, wmax,
                    ihibs=(sx.ihib,) if sx.ihib is not None else None)[0]
            pending.append((sl, verdict))
        amb_parts = []
        t_fetch = time.time()
        for sl, verdict in pending:
            got = np.asarray(verdict)[: sl.stop - sl.start]
            tags[sl] = got == kernels.VERDICT_TAGGED
            amb_parts.append(np.arange(sl.start, sl.stop)[
                got == kernels.VERDICT_AMBIG])
        self._io_stash(time.time() - t_fetch)
        amb = (np.concatenate(amb_parts) if amb_parts
               else np.zeros(0, dtype=np.int64))
        if len(amb):
            tags[amb] = self._search_stream_fallback(enc, idx[amb], planes,
                                                     lpad, wmax)
        return tags

    def _stream_dp_exact(self, lpad: int, wmax: int):
        key = ("exact", lpad, wmax)
        if key not in self._stream_dp_fns:
            self._stream_dp_fns[key] = (
                None, self._sharded.stream_exact_step(
                    self.mesh, lpad, self.k, self.t, wmax))
        return self._stream_dp_fns[key]

    def _search_stream_fallback(self, enc: EncodedSet, rows_idx: np.ndarray,
                                planes, lpad: int, wmax: int):
        """Exact verdicts for the stream's residue: sorted-set probe for
        k <= 32 (planeless), full plane probe for wide keys."""
        from commet_tpu.core import stream as _stream
        sx = self._sidx
        if sx is None or sx.sa is None:
            # wide keys (k > 32): the exact fallback probes the bit planes
            return self._search_full(planes, enc, rows_idx)
        dp = self.mesh is not None
        tags = np.zeros(len(rows_idx), dtype=bool)
        for start in range(0, len(rows_idx), self.batch):
            rows = slice(start, min(start + self.batch, len(rows_idx)))
            n = rows.stop - rows.start
            bsize = _bucket_size(n, self.batch, self.mesh)
            c2, vd, _ln, _cl = enc.gather_packed(rows_idx[rows], lpad,
                                                 bsize)
            if dp:
                _, dp_exact = self._stream_dp_exact(lpad, wmax)
                got = dp_exact(sx.sa, sx.sb, sx.sc, sx.sd, sx.mi,
                               self._dev(c2), self._dev(vd))
            else:
                got = _stream.probe_exact_sets(
                    sx.sa, sx.sb, sx.sc, sx.sd, sx.mi, self._dev(c2),
                    self._dev(vd), lpad, self.k, self.t, wmax)
            tags[rows] = np.asarray(got)[:n]
        return tags

    def _search_full(self, planes, enc: EncodedSet, idx: np.ndarray):
        """Exact full probe: forward strand over everything, then the
        reverse-complement strand over the fwd-untagged remainder
        (host-compacted) — the vectorized equivalent of the reference's
        per-read fwd-then-rc early exit (search_reads.h:64-83)."""
        on_cpu = self._on_cpu
        lengths = enc.read_lengths(idx) if len(idx) else np.zeros(1)
        lmax = int(lengths.max(initial=1))
        lpad = _pad_length(lmax, self.k)
        wmax = max(1, lmax - self.k + 1)
        tags = np.zeros(len(idx), dtype=bool)

        def run_strand(rows, strand, out_rows):
            plain = (kernels.search_batch_fwd if strand == "fwd"
                     else kernels.search_batch_rc)
            packed = (kernels.search_batch_fwd_packed if strand == "fwd"
                      else kernels.search_batch_rc_packed)
            if on_cpu:
                for sl, codes in self._batched_codes(enc, rows, lpad=lpad,
                                                     bucket=True):
                    got = plain(planes,
                                self._dev(np.asarray(codes, np.int32)),
                                self.k, self.t, wmax)
                    tags[out_rows[sl]] |= np.asarray(got)[: sl.stop - sl.start]
            else:
                for sl, c2, vd, _ln, _cl in self._batched_packed(
                        enc, rows, lpad, bucket=True):
                    got = packed(planes, self._dev(c2), self._dev(vd),
                                 lpad, self.k, self.t, wmax)
                    tags[out_rows[sl]] |= np.asarray(got)[: sl.stop - sl.start]

        run_strand(idx, "fwd", np.arange(len(idx)))
        remaining = np.nonzero(~tags)[0]
        if len(remaining):
            run_strand(idx[remaining], "rc", remaining)
        return tags

    def _search_cascade(self, planes, enc: EncodedSet, idx: np.ndarray):
        """Cascade classification: one fused plane-A-prefilter +
        targeted-verification kernel per batch decides most reads exactly
        for both strands at once. AMBIG reads (mostly reads whose plane-A
        hit runs extend past the verification window) get a second cascade
        round with a wider window; only the residual re-runs through the
        exact full probe. Final tags are bit-identical to the full probe
        (kernels.py cascade soundness notes)."""
        on_cpu = self._on_cpu
        tags = np.zeros(len(idx), dtype=bool)
        lengths = enc.read_lengths(idx)
        lmax = int(lengths.max(initial=1))
        lpad = _pad_length(lmax, self.k)
        wmax = max(1, lmax - self.k + 1)
        rounds = [self._verify_v]
        if self._verify_v < 16:
            rounds.append(16)
        amb = np.arange(len(idx))
        # probe batches run larger than the assembly batch: fewer dispatches
        # amortize the fixed per-call cost (65536 is unmeasured on the GPU)
        psize = _bucket_size(len(idx),
                             max(self.batch,
                                 int(os.environ.get("COMMET_TPU_PROBE_BATCH",
                                                    "65536"))), self.mesh)
        self._io_reset()
        fetch_s = 0.0
        for v in rounds:
            if not len(amb):
                return tags
            rows = idx[amb]
            pending = []  # (slice, device verdict) — sync after dispatching
            if on_cpu:
                for sl, codes in self._batched_codes(enc, rows, lpad=lpad,
                                                     bucket=True):
                    pending.append((sl, kernels.probe_cascade2(
                        planes, self._dev(np.asarray(codes, np.int32)),
                        self.k, self.t, v, wmax)))
            else:
                for sl, c2, vd, ln, clean in self._batched_packed(
                        enc, rows, lpad,
                        size=min(psize, _bucket_size(len(rows), psize,
                                                     self.mesh))):
                    if clean:
                        verdict = kernels.probe_cascade2_clean(
                            planes, self._dev(c2), self._dev(ln), lpad,
                            self.k, self.t, v, wmax)
                    else:
                        verdict = kernels.probe_cascade2_packed(
                            planes, self._dev(c2), self._dev(vd), lpad,
                            self.k, self.t, v, wmax)
                    pending.append((sl, verdict))
            amb_parts = []
            t_fetch = time.time()
            for sl, verdict in pending:
                got = np.asarray(verdict)[: sl.stop - sl.start]
                tags[amb[sl]] = got == kernels.VERDICT_TAGGED
                amb_parts.append(amb[sl][got == kernels.VERDICT_AMBIG])
            fetch_s += time.time() - t_fetch
            amb = (np.concatenate(amb_parts) if amb_parts
                   else np.zeros(0, dtype=np.int64))
        self._io_stash(fetch_s)
        if len(amb):
            tags[amb] = self._search_full(planes, enc, idx[amb])
        return tags

    # ------------------------------------------------ amortized multi-index
    # The all-vs-all driver's step-0 schedule (reference Commet.py:186-240)
    # searches every query set against up to N-1 index sets. Keeping those
    # indexes resident as planeless StreamIndexes lets ONE sorted query
    # stream per batch serve every (index, partition) join -- the query
    # sort + unsort is paid once instead of once per pair. Results are
    # bit-identical to the pairwise path: per (index, partition) verdicts
    # use the same join and the same exact fallback.

    def resident_budget(self) -> float:
        """Device bytes the amortized schedule may hold in resident
        StreamIndexes: COMMET_TPU_RESIDENT_BUDGET if set, else half the
        device's memory limit (the other half serves the probe's working
        set). The CPU backend reports no device memory limit -- its
        indexes live in host memory -- so nothing is capped there."""
        env = os.environ.get("COMMET_TPU_RESIDENT_BUDGET")
        if env:
            return float(env)
        if self._on_cpu:
            return float("inf")
        from commet_tpu.parallel.sharded import device_hbm_bytes
        return device_hbm_bytes() / 2

    def build_resident(self, index_set: ReadSet,
                       budget: Optional[float] = None
                       ) -> Optional[ResidentIndex]:
        """Build every max_kmer partition of ``index_set`` as a resident
        planeless StreamIndex. Returns None when this engine/config cannot
        serve it (stream off, k > 34, mesh mode, high fill, or the
        device-memory budget ``resident_budget()`` would be exceeded).
        ``budget`` optionally narrows the allowance further (the amortized
        driver passes its REMAINING cumulative budget, so an index that
        would overshoot is rejected BEFORE any device allocation happens)
        -- callers fall back to the pairwise index_and_search path."""
        if not (self.stream and self.k <= 34 and self.mesh is None):
            return None
        from commet_tpu.core import stream as _stream
        t0 = time.time()
        enc = EncodedSet(index_set)
        elig = index_set.eligible()
        kcounts = self.count_kmers(enc, elig) if len(elig) else \
            np.zeros(0, dtype=np.int64)
        parts = self.partitions(kcounts)
        total = int(kcounts.sum())
        allowed = self.resident_budget()
        if budget is not None:
            allowed = min(allowed, budget)
        # ~24 B/k-mer: join columns + exact sets (narrow keys) or hi-bit
        # column (wide keys); checked before any device work
        if total * 24.0 > allowed:
            return None
        for part in parts:
            fill = float(kcounts[part].sum()) / float(2 ** self.k)
            if fill > self.stream_max_fill and not self._stream_forced:
                return None
        on_cpu = self._on_cpu
        sxs = []
        for part in parts:
            rows = elig[part]
            collect = []
            if on_cpu:
                for _, codes in self._batched_codes(enc, rows):
                    collect.append(_stream.chunk_index_keys_codes(
                        jnp.asarray(codes, jnp.int32), self.k))
            else:
                lengths = enc.read_lengths(rows)
                lpad = _pad_length(int(lengths.max(initial=1)), self.k)
                for _sl, c2, vd, ln, cl in self._batched_packed(
                        enc, rows, lpad,
                        size=self._device_batch(len(rows))):
                    if cl:  # N-free: skip the validity-plane upload
                        collect.append(_stream.chunk_index_keys_clean(
                            jnp.asarray(c2), jnp.asarray(ln), lpad,
                            self.k))
                    else:
                        collect.append(_stream.chunk_index_keys(
                            jnp.asarray(c2), jnp.asarray(vd), lpad,
                            self.k))
            if not collect:
                continue
            sx = _stream.finalize_index(
                [c[0] for c in collect], [c[1] for c in collect],
                [c[2] for c in collect], [c[3] for c in collect],
                [int(c[4]) for c in collect], wide=self.k > 32)
            sxs.append(sx)
        if sxs:
            jax.block_until_ready(sxs[-1].ika)
        return ResidentIndex(index_set.name, sxs,
                             int(sum(len(p) for p in parts)), total,
                             time.time() - t0)

    def _exact_sets_rows(self, sx, enc: EncodedSet, rows_idx: np.ndarray,
                         lpad: int, wmax: int) -> np.ndarray:
        """Exact sorted-set verdicts (planeless fallback) for given rows
        against one StreamIndex partition."""
        from commet_tpu.core import stream as _stream
        tags = np.zeros(len(rows_idx), dtype=bool)
        for start in range(0, len(rows_idx), self.batch):
            rows = slice(start, min(start + self.batch, len(rows_idx)))
            n = rows.stop - rows.start
            bsize = _bucket_size(n, self.batch, None)
            c2, vd, _ln, _cl = enc.gather_packed(rows_idx[rows], lpad, bsize)
            got = _stream.probe_exact_sets(
                sx.sa, sx.sb, sx.sc, sx.sd, sx.mi, self._dev(c2),
                self._dev(vd), lpad, self.k, self.t, wmax)
            tags[rows] = np.asarray(got)[:n]
        return tags

    def _host_exact_wide(self, sets_u64, enc: EncodedSet,
                         rows_idx: np.ndarray, lpad: int,
                         wmax: int) -> np.ndarray:
        """Host-side exact reference-Bloom classification for wide keys
        (k > 32): window keys computed on device, membership of all four
        derived values tested with np.searchsorted against the partition's
        sorted uint64 multisets, greedy non-overlap count per strand
        (search_reads.h:34-87). Used only on the tiny wide-multi AMBIG
        residue, where per-resident 4 GiB bit planes are not affordable."""
        sa, sb, sc, sd = sets_u64
        tags = np.zeros(len(rows_idx), dtype=bool)
        for start in range(0, len(rows_idx), self.batch):
            rows = slice(start, min(start + self.batch, len(rows_idx)))
            n = rows.stop - rows.start
            bsize = _bucket_size(n, self.batch, None)
            c2, vd, _ln, _cl = enc.gather_packed(rows_idx[rows], lpad,
                                                 bsize)
            codes = kernels.unpack_codes(jnp.asarray(c2), jnp.asarray(vd),
                                         lpad)
            wk = kernels.window_keys(codes, self.k, "both", wmax)
            ok = np.asarray(wk["ok"])[:n]

            def u64(pref):
                lo = np.asarray(wk[pref + "_lo"])[:n].astype(np.uint64)
                hi = np.asarray(wk[pref + "_hi"])[:n].astype(np.uint64)
                return (hi << np.uint64(32)) | lo

            got = np.zeros(n, dtype=bool)
            for p in ("f", "r"):
                a = u64(p + "a")
                b = u64(p + "b")
                member = ok.copy()
                for arr, vals in ((sa, a), (sb, b), (sc, a ^ b),
                                  (sd, a | b)):
                    pos = np.searchsorted(arr, vals)
                    hit = np.zeros_like(member)
                    inb = pos < len(arr)
                    hit[inb] = arr[np.minimum(pos[inb], len(arr) - 1)] \
                        == vals[inb]
                    member &= hit
                # greedy non-overlapping count capped at t, per read
                cnt = np.zeros(n, dtype=np.int64)
                allow = np.zeros(n, dtype=np.int64)
                for w in range(member.shape[1]):
                    h = member[:, w] & (w >= allow) & (cnt < self.t)
                    cnt += h
                    allow = np.where(h, w + self.k, allow)
                got |= cnt >= self.t
            tags[rows] = got
        return tags

    def search_multi_set(self, query_set: ReadSet,
                         residents: List[ResidentIndex],
                         out_dir: Optional[str] = None,
                         log_dir: Optional[str] = None,
                         save: bool = True,
                         max_slots: int = 32) -> Dict[str, Dict[str, int]]:
        """Classify ``query_set`` against every resident index with one
        sorted query stream per batch. Writes the same per-file result bvs,
        logs, and counters as len(residents) pairwise index_and_search
        calls would (keyed by resident/index name), with identical tags:
        per-partition join verdicts OR-ed across partitions, AMBIG residue
        through the exact sorted-set probe.

        Returns None when the batch geometry cannot serve the query set
        (reads so long a 2048-read batch still exceeds the stream's
        2^30-key budget) -- the caller falls back to the classic
        pairwise schedule, which handles any read length."""
        from commet_tpu.core import stream as _stream
        t_start = time.time()
        enc_q = EncodedSet(query_set)
        cand = query_set.untagged_eligible()
        slots = [(ri, pi, sx) for ri, r in enumerate(residents)
                 for pi, sx in enumerate(r.partitions)]
        tags_slot = np.zeros((len(slots), len(cand)), dtype=bool)
        fb_time = [0.0] * len(residents)  # per-resident exact-fallback time
        if len(cand) and slots:
            lengths = enc_q.read_lengths(cand)
            lmax = int(lengths.max(initial=1))
            lpad = _pad_length(lmax, self.k)
            wmax = max(1, lmax - self.k + 1)
            size = max(_bucket_size(len(cand), self.stream_batch, None),
                       2048)
            while size > 2048 and size * 2 * wmax > _stream.MAX_UNSORT_KEYS:
                size //= 2
            if size * 2 * wmax > _stream.MAX_UNSORT_KEYS:
                return None  # absurdly long reads: pairwise path serves
            # groups bound the unpacked [S, B, 2, W] verdict volume
            groups = [slots[i : i + max_slots]
                      for i in range(0, len(slots), max_slots)]
            base = 0
            wide = self.k > 32
            self._io_reset()
            fetch_s = 0.0
            for group in groups:
                ikas = tuple(sx.ika for _ri, _pi, sx in group)
                ikbs = tuple(sx.ikb for _ri, _pi, sx in group)
                mis = tuple(sx.mi for _ri, _pi, sx in group)
                ihibs = tuple(sx.ihib for _ri, _pi, sx in group) if wide \
                    else None
                pending = []
                for _sl, c2, vd, ln, clean in self._batched_packed(
                        enc_q, cand, lpad, size=size):
                    if clean:
                        v = _stream.probe_multi_stream_clean(
                            ikas, ikbs, mis, self._dev(c2), self._dev(ln),
                            lpad, self.k, self.t, wmax, ihibs=ihibs)
                    else:
                        v = _stream.probe_multi_stream_packed(
                            ikas, ikbs, mis, self._dev(c2), self._dev(vd),
                            lpad, self.k, self.t, wmax, ihibs=ihibs)
                    pending.append((_sl, v))
                amb_slot = [[] for _ in group]
                t_fetch = time.time()
                for sl, v in pending:
                    got = np.asarray(v)[:, : sl.stop - sl.start]
                    tags_slot[base : base + len(group), sl] = \
                        got == kernels.VERDICT_TAGGED
                    for s in range(len(group)):
                        amb_slot[s].append(np.arange(sl.start, sl.stop)[
                            got[s] == kernels.VERDICT_AMBIG])
                fetch_s += time.time() - t_fetch
                for s, (ri, pi, sx) in enumerate(group):
                    amb = (np.concatenate(amb_slot[s]) if amb_slot[s]
                           else np.zeros(0, dtype=np.int64))
                    if not len(amb):
                        continue
                    t_fb = time.time()
                    if sx.sa is not None:
                        tags_slot[base + s, amb] = self._exact_sets_rows(
                            sx, enc_q, cand[amb], lpad, wmax)
                    else:  # wide keys: host exact sets (planeless)
                        tags_slot[base + s, amb] = self._host_exact_wide(
                            residents[ri].host_exact_sets(pi), enc_q,
                            cand[amb], lpad, wmax)
                    fb_time[ri] += time.time() - t_fb
                base += len(group)
            self._io_stash(fetch_s)
        return self._multi_finish(query_set, residents, cand, tags_slot,
                                  fb_time, t_start, out_dir, log_dir, save)

    def _multi_finish(self, query_set: ReadSet, residents, cand,
                      tags_slot, fb_time, t_start, out_dir, log_dir, save):
        """Shared tail of the amortized multi-index searches: per-resident
        counters (reference [indexed, searched, shared] semantics), per-pair
        logs, and result-bv writes — identical to len(residents) pairwise
        index_and_search calls."""
        search_elapsed = time.time() - t_start
        counters = {}
        si = 0
        # per-pair log honesty: the joint probe
        # genuinely serves all residents at once, so its cost is an
        # equal share; each resident's exact-fallback time is its own and
        # is attributed individually
        joint = max(0.0, search_elapsed - sum(fb_time))
        for ri, r in enumerate(residents):
            np_r = len(r.partitions)
            tr = tags_slot[si : si + np_r]
            si += np_r
            tags = tr.any(axis=0) if np_r else np.zeros(len(cand), bool)
            before_last = (tr[:-1].any(axis=0) if np_r > 1
                           else np.zeros(len(cand), bool))
            c = {
                "indexed": r.nb_indexed,
                "searched": len(cand) - int(before_last.sum()),
                "shared": int(tags.sum()),
                "index_time": r.build_seconds,
                "search_time": joint / max(1, len(residents)) + fb_time[ri],
                "total_time": time.time() - t_start,
            }
            counters[r.name] = c
            if log_dir is not None:
                self._write_log(log_dir, query_set.name, r.name, c)
            if save and out_dir is not None:
                hit = cand[tags] if len(cand) else cand
                if len(hit):
                    query_set.tag(hit[:, 0], hit[:, 1])
                query_set.save_result_bvs(out_dir, r.name)
                for bvr in query_set.result_bvs:
                    bvr.set_all_false()
        return counters

    # ------------------------------------------- amortized high-fill planes
    def build_resident_planes(self, index_set: ReadSet,
                              budget: Optional[float] = None
                              ) -> Optional["ResidentPlanes"]:
        """Build every max_kmer partition of ``index_set`` as resident
        dense membership planes, for the amortized multi-index cascade in
        the high-fill regime (the stream gate excludes every
        full default-regime partition, so amortize what IS shared there --
        the query batch upload + window-key computation). Returns None when
        this engine cannot serve it (mesh mode) or the plane bytes would
        exceed ``budget`` -- callers fall back to the pairwise path."""
        if self.mesh is not None:
            return None
        t0 = time.time()
        enc = EncodedSet(index_set)
        elig = index_set.eligible()
        kcounts = self.count_kmers(enc, elig) if len(elig) else \
            np.zeros(0, dtype=np.int64)
        parts = self.partitions(kcounts)
        plane_bytes = 4 * kernels.plane_words(self.k) * 4
        if budget is not None and len(parts) * plane_bytes > budget:
            return None
        prev_serving = self._stream_serving
        self._stream_serving = False
        try:
            planes_list, fills = [], []
            for part in parts:
                planes = self.build_planes(None, enc, elig[part])
                planes_list.append(planes)
                fills.append(float(kcounts[part].sum()) / float(2 ** self.k))
        finally:
            self._stream_serving = prev_serving
        if planes_list:
            jax.block_until_ready(planes_list[-1])
        return ResidentPlanes(index_set.name, planes_list, fills,
                              int(sum(len(p) for p in parts)),
                              int(kcounts.sum()), time.time() - t0)

    def search_multi_set_planes(self, query_set: ReadSet,
                                residents: List["ResidentPlanes"],
                                out_dir: Optional[str] = None,
                                log_dir: Optional[str] = None,
                                save: bool = True
                                ) -> Dict[str, Dict[str, int]]:
        """Classify ``query_set`` against every resident dense-plane index
        with ONE batch upload + window-key computation per batch serving
        all cascades (kernels.probe_cascade2_multi_*). Writes the same
        per-file result bvs, logs, and counters as len(residents) pairwise
        index_and_search calls, with identical tags: first-round verdicts
        per (resident, partition), per-slot V=16 second round, exact full
        probe on the residual."""
        t_start = time.time()
        enc_q = EncodedSet(query_set)
        cand = query_set.untagged_eligible()
        slots = [(ri, pi, r.partitions[pi], r.fills[pi])
                 for ri, r in enumerate(residents)
                 for pi in range(len(r.partitions))]
        tags_slot = np.zeros((len(slots), len(cand)), dtype=bool)
        fb_time = [0.0] * len(residents)
        if len(cand) and slots:
            lengths = enc_q.read_lengths(cand)
            lmax = int(lengths.max(initial=1))
            lpad = _pad_length(lmax, self.k)
            wmax = max(1, lmax - self.k + 1)
            max_fill = max(f for _ri, _pi, _pl, f in slots)
            v1 = 4 if max_fill < 0.02 else (8 if max_fill < 0.15 else 24)
            planes_tuple = tuple(pl for _ri, _pi, pl, _f in slots)
            psize = _bucket_size(len(cand),
                                 max(self.batch,
                                     int(os.environ.get(
                                         "COMMET_TPU_PROBE_BATCH",
                                         "65536"))), None)
            self._io_reset()
            pending = []
            for sl, c2, vd, ln, clean in self._batched_packed(
                    enc_q, cand, lpad, size=psize):
                if clean:
                    v = kernels.probe_cascade2_multi_clean(
                        planes_tuple, self._dev(c2), self._dev(ln), lpad,
                        self.k, self.t, v1, wmax)
                else:
                    v = kernels.probe_cascade2_multi_packed(
                        planes_tuple, self._dev(c2), self._dev(vd), lpad,
                        self.k, self.t, v1, wmax)
                pending.append((sl, v))
            amb_slot = [[] for _ in slots]
            t_fetch = time.time()
            for sl, v in pending:
                got = np.asarray(v)[:, : sl.stop - sl.start]
                tags_slot[:, sl] = got == kernels.VERDICT_TAGGED
                for s in range(len(slots)):
                    amb_slot[s].append(np.arange(sl.start, sl.stop)[
                        got[s] == kernels.VERDICT_AMBIG])
            self._io_stash(time.time() - t_fetch)
            for s, (ri, _pi, planes, _f) in enumerate(slots):
                amb = (np.concatenate(amb_slot[s]) if amb_slot[s]
                       else np.zeros(0, dtype=np.int64))
                if not len(amb):
                    continue
                t_fb = time.time()
                # per-slot second cascade round (wider verification
                # window) + exact full probe on what remains -- the same
                # sandwich as _search_cascade, so tags are bit-identical
                rows = cand[amb]
                on_cpu = self._on_cpu
                verdicts = np.zeros(len(amb), dtype=np.int8)
                if v1 < 16:
                    if on_cpu:
                        for bsl, codes in self._batched_codes(
                                enc_q, rows, lpad=lpad, bucket=True):
                            got = kernels.probe_cascade2(
                                planes,
                                self._dev(np.asarray(codes, np.int32)),
                                self.k, self.t, 16, wmax)
                            verdicts[bsl] = np.asarray(got)[
                                : bsl.stop - bsl.start]
                    else:
                        for bsl, c2, vd, ln, clean in self._batched_packed(
                                enc_q, rows, lpad, bucket=True):
                            if clean:
                                got = kernels.probe_cascade2_clean(
                                    planes, self._dev(c2), self._dev(ln),
                                    lpad, self.k, self.t, 16, wmax)
                            else:
                                got = kernels.probe_cascade2_packed(
                                    planes, self._dev(c2), self._dev(vd),
                                    lpad, self.k, self.t, 16, wmax)
                            verdicts[bsl] = np.asarray(got)[
                                : bsl.stop - bsl.start]
                else:
                    verdicts[:] = kernels.VERDICT_AMBIG
                tags_slot[s, amb] = verdicts == kernels.VERDICT_TAGGED
                rem = amb[verdicts == kernels.VERDICT_AMBIG]
                if len(rem):
                    tags_slot[s, rem] = self._search_full(
                        planes, enc_q, cand[rem])
                fb_time[ri] += time.time() - t_fb
        return self._multi_finish(query_set, residents, cand, tags_slot,
                                  fb_time, t_start, out_dir, log_dir, save)

    def index_and_search(self, index_set: ReadSet, query_sets: List[ReadSet],
                         out_dir: Optional[str] = None,
                         log_dir: Optional[str] = None,
                         save: bool = True) -> Dict[str, Dict[str, int]]:
        """The full partitioned loop (index_and_search.cpp:255-277): build
        planes per partition, classify every query set per partition with
        found-read skipping; finally write per-file result .bv's.

        Returns per-query-set counters {name: {indexed, searched, shared}}.
        """
        profile_dir = os.environ.get("COMMET_TPU_PROFILE")
        if profile_dir:
            import contextlib
            trace_cm = jax.profiler.trace(profile_dir)
        else:
            import contextlib
            trace_cm = contextlib.nullcontext()
        with trace_cm:
            return self._index_and_search(index_set, query_sets, out_dir,
                                          log_dir, save)

    def _index_and_search(self, index_set: ReadSet, query_sets: List[ReadSet],
                          out_dir: Optional[str], log_dir: Optional[str],
                          save: bool) -> Dict[str, Dict[str, int]]:
        t_start = time.time()
        enc_index = EncodedSet(index_set)
        enc_queries = [EncodedSet(q) for q in query_sets]

        elig = index_set.eligible()
        kcounts = self.count_kmers(enc_index, elig) if len(elig) else \
            np.zeros(0, dtype=np.int64)
        parts = self.partitions(kcounts)

        nb_indexed = 0
        found_tot = [0] * len(query_sets)
        searched_last = [0] * len(query_sets)
        index_time = 0.0
        search_times = [0.0] * len(query_sets)

        planes = None
        for part in parts:
            # size the cascade's verification window to the partition's fill:
            # denser planes -> more A-hits per negative read -> verify more
            # positions to keep the AMBIG fallback rate low
            fill = float(kcounts[part].sum()) / float(2 ** self.k)
            # at the default-regime fill (11.6%) 2V=16 covers the ~9
            # plane-A hits per strand of a random read, leaving a small
            # AMBIG tail to the V=16 second round + exact fallback. The
            # values are unmeasured on the GPU.
            self._verify_v = 4 if fill < 0.02 else (8 if fill < 0.15 else 24)
            # stream-serving partitions skip the bit planes entirely: the
            # StreamIndex (sorted join planes + exact-fallback sets) is the
            # whole membership structure (decided from the fill upper
            # bound, known before building)
            self._stream_serving = (
                self.stream
                and (self.mesh is None or self.mesh_mode == "dp")
                and (self._stream_forced or fill <= self.stream_max_fill))
            t0 = time.time()
            planes = self.build_planes(None, enc_index, elig[part])
            jax.block_until_ready(planes if planes is not None
                                  else self._ika)
            index_time += time.time() - t0
            nb_indexed += len(part)
            for qi, (q, enc_q) in enumerate(zip(query_sets, enc_queries)):
                t0 = time.time()
                cand = q.untagged_eligible()
                searched_last[qi] = len(cand)
                if len(cand):
                    tags = self.search_set(planes, enc_q, cand)
                    hit = cand[tags]
                    found_tot[qi] += len(hit)
                    if len(hit):
                        q.tag(hit[:, 0], hit[:, 1])
                search_times[qi] += time.time() - t0

        counters = {}
        for qi, q in enumerate(query_sets):
            counters[q.name] = {
                "indexed": nb_indexed,
                "searched": searched_last[qi],
                "shared": found_tot[qi],
                "index_time": index_time,
                "search_time": search_times[qi],
                "total_time": time.time() - t_start,
            }
            if log_dir is not None:
                self._write_log(log_dir, q.name, index_set.name, counters[q.name])
            if save and out_dir is not None:
                q.save_result_bvs(out_dir, index_set.name)
        return counters

    @staticmethod
    def _write_log(log_dir: str, qname: str, iname: str, c: Dict[str, float]):
        """Per-pair log with the reference's format
        (index_and_search.cpp:288-300)."""
        path = os.path.join(log_dir, f"{qname}_in_{iname}.log")
        with open(path, "w") as f:
            f.write("Index  time: %g s\n" % c["index_time"])
            f.write("Search time: %g s\n" % c["search_time"])
            f.write("Total  time: %g s\n" % c["total_time"])
            f.write("[indexed %d, searched %d, shared %d]\n"
                    % (c["indexed"], c["searched"], c["shared"]))
