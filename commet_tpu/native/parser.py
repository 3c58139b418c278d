"""ctypes bindings for the native IO library (libcommet_io.so).

Builds lazily with `make -C commet_tpu/native` if the shared object is
missing; callers fall back to the pure-Python parser when unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(__file__)
_SO = os.path.join(_DIR, "libcommet_io.so")

_lib = None


def _make():
    try:
        subprocess.run(["make", "-C", _DIR, "clean", "all"], check=True,
                       capture_output=True)
    except (OSError, subprocess.CalledProcessError) as exc:
        raise OSError(f"cannot build native io library: {exc}")


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO):
        _make()
    lib = ctypes.CDLL(_SO)
    if not hasattr(lib, "cio_build_planes_mt"):
        # stale build from an older checkout: rebuild once
        del lib
        os.remove(_SO)
        _make()
        lib = ctypes.CDLL(_SO)
    lib.cio_parse.restype = ctypes.c_void_p
    lib.cio_parse.argtypes = [ctypes.c_char_p]
    for name, res in (("cio_n_reads", ctypes.c_int64),
                      ("cio_total_bases", ctypes.c_int64),
                      ("cio_format", ctypes.c_int),
                      ("cio_gzipped", ctypes.c_int)):
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = [ctypes.c_void_p]
    for name, typ in (("cio_codes", ctypes.c_uint8),
                      ("cio_offsets", ctypes.c_int64),
                      ("cio_lengths", ctypes.c_int32),
                      ("cio_class_counts", ctypes.c_int64)):
        fn = getattr(lib, name)
        fn.restype = ctypes.POINTER(typ)
        fn.argtypes = [ctypes.c_void_p]
    lib.cio_free.argtypes = [ctypes.c_void_p]
    lib.cio_gather_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)]
    lib.cio_gather_packed.restype = ctypes.c_int
    lib.cio_gather_packed.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32)]
    lib.cio_build_planes_mt.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int]
    lib.cio_count_kmers.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int, ctypes.POINTER(ctypes.c_int64)]
    _lib = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except (OSError, AttributeError):  # unbuildable / stale symbols
        return False


def parse_file(path: str):
    """Parse + encode a read file natively. Returns a dict with numpy views
    (copies) of codes/offsets/lengths/class_counts plus format info."""
    lib = _load()
    h = lib.cio_parse(path.encode())
    if not h:
        raise ValueError(f"Unknown format or unreadable file: {path}")
    try:
        n = lib.cio_n_reads(h)
        total = lib.cio_total_bases(h)
        codes = np.ctypeslib.as_array(lib.cio_codes(h), shape=(total,)).copy() \
            if total else np.zeros(0, dtype=np.uint8)
        offsets = np.ctypeslib.as_array(lib.cio_offsets(h), shape=(n + 1,)).copy()
        lengths = (np.ctypeslib.as_array(lib.cio_lengths(h), shape=(n,)).copy()
                   if n else np.zeros(0, dtype=np.int32))
        counts = (np.ctypeslib.as_array(lib.cio_class_counts(h),
                                        shape=(n, 5)).copy()
                  if n else np.zeros((0, 5), dtype=np.int64))
        return {
            "n_reads": int(n),
            "codes": codes,
            "offsets": offsets,
            "lengths": lengths,
            "class_counts": counts,
            "format": "fasta" if lib.cio_format(h) == 1 else "fastq",
            "gzipped": bool(lib.cio_gzipped(h)),
        }
    finally:
        lib.cio_free(h)


# reads below which the threaded plane build is not worth its thread
# start-up (each thread scans every read)
_BUILD_THREAD_MIN_READS = 100_000


def build_planes_into(planes: np.ndarray, codes: np.ndarray,
                      offsets: np.ndarray, lengths: np.ndarray,
                      idx: np.ndarray, k: int) -> None:
    """OR every complete forward window of reads ``idx`` into ``planes``
    (uint32 [4 * 2^(k-5)] viewed as bytes), on one thread per host core
    for large read sets. Requires k >= 5."""
    if k < 5:
        raise ValueError(f"native plane build needs k >= 5, got {k}")
    if planes.dtype != np.uint32 or planes.size != 4 * (1 << (k - 5)) \
            or not planes.flags.c_contiguous:
        raise ValueError("planes must be a contiguous uint32 "
                         f"[4 * 2^{k - 5}] array")
    lib = _load()
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    nthreads = (os.cpu_count() or 1) \
        if len(idx) >= _BUILD_THREAD_MIN_READS else 1
    pview = planes.view(np.uint8)
    lib.cio_build_planes_mt(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(idx), k,
        pview.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), nthreads)


def count_kmers(codes: np.ndarray, offsets: np.ndarray, lengths: np.ndarray,
                idx: np.ndarray, k: int) -> np.ndarray:
    lib = _load()
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    out = np.zeros(len(idx), dtype=np.int64)
    if len(idx):
        lib.cio_count_kmers(
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idx), k,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out


def gather_packed(codes: np.ndarray, offsets: np.ndarray,
                  lengths: np.ndarray, idx: np.ndarray, lpad: int):
    """Gather + pack reads ``idx`` directly into the device wire format.
    Returns (codes2 [n, ceil(lpad/16)] uint32, valid [n, ceil(lpad/32)]
    uint32, lens [n] int32, dirty) — dirty=True when some read carries an
    INTERNAL invalid base (batch not 'clean')."""
    lib = _load()
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    n = len(idx)
    c2 = np.zeros((n, -(-lpad // 16)), dtype=np.uint32)
    vd = np.zeros((n, -(-lpad // 32)), dtype=np.uint32)
    ln = np.zeros(n, dtype=np.int32)
    dirty = lib.cio_gather_packed(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, lpad,
        c2.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        vd.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ln.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return c2, vd, ln, bool(dirty)


def gather_batch(codes: np.ndarray, offsets: np.ndarray, lengths: np.ndarray,
                 idx: np.ndarray, lpad: int) -> np.ndarray:
    """Native padded batch assembly (pad value 4 = invalid)."""
    lib = _load()
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    out = np.empty((len(idx), lpad), dtype=np.uint8)
    lib.cio_gather_batch(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(idx), lpad,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out
