"""Host-side read-file layer: fasta/fastq (+gzip) parsing and 2-bit encoding.

Two parser backends with identical semantics:
  - native C++ (commet_tpu/native/libcommet_io.so, built on demand): parses,
    2-bit-encodes and per-read class-counts in one pass - the production
    data plane feeding the device kernels;
  - pure Python fallback (and the provider of full record text for
    extract_reads-style materialization).

Parsing semantics are byte-compatible with the reference readers:
  - format sniffing by the first byte, '>' = fasta, '@' = fastq, else try
    gzip and sniff the decompressed first byte
    (reference include/file_manager.h:117-157);
  - fasta: a read per '>' line, sequence = concatenation of the following
    non-empty lines, lines split on '\n' only (CR kept, like C++ getline)
    (reference include/fasta_file.h:62-68,143-175);
  - fastq: read count = non-empty lines // 4; per record the sequence is the
    line immediately after the (empty-line-skipping) header line
    (reference include/fastq_file.h:60-67,131-206).

Encoding: bases map to 2-bit codes A=0 C=1 G=2 T=3 (case-insensitive); any
other byte (the reference's "N" class, include/alphabet.h:44-58) maps to
code 4 = invalid, which resets the rolling hash window exactly like
``hash.clear()`` in the reference.
"""

from __future__ import annotations

import gzip
import os
from typing import List, Optional, Tuple

import numpy as np

from commet_tpu.io.bv import BitVector

from commet_tpu.native import parser as _native

# the fast C++ parser (commet_tpu/native), built on first use; False when
# it cannot be built here (no compiler or zlib)
_HAVE_NATIVE = _native.available()

# byte -> 2-bit code LUT; 4 marks an invalid (non-ACGT) byte
CODE_LUT = np.full(256, 4, dtype=np.uint8)
for _c, _v in ((b"Aa", 0), (b"Cc", 1), (b"Gg", 2), (b"Tt", 3)):
    CODE_LUT[_c[0]] = _v
    CODE_LUT[_c[1]] = _v

INVALID = 4


def _read_raw(path: str) -> bytes:
    with open(path, "rb") as f:
        head = f.read(2)
    if head[:1] in (b">", b"@"):
        with open(path, "rb") as f:
            return f.read()
    with gzip.open(path, "rb") as f:
        return f.read()


def sniff_format(path: str) -> Tuple[str, bool]:
    """Return ('fasta'|'fastq', gzipped) using the reference's first-byte
    sniffing (file_manager.h:117-157)."""
    with open(path, "rb") as f:
        c = f.read(1)
    if c == b">":
        return "fasta", False
    if c == b"@":
        return "fastq", False
    with gzip.open(path, "rb") as f:
        c = f.read(1)
    if c == b">":
        return "fasta", True
    if c == b"@":
        return "fastq", True
    raise ValueError(f"Unknown format: {path}")


def parse_fasta(raw: bytes):
    """Returns (sequences, records): per read the sequence bytes and the
    full record text (header + sequence lines, '\n'-terminated)."""
    lines = raw.split(b"\n")
    seqs: List[bytes] = []
    recs: List[bytes] = []
    cur: Optional[list] = None
    currec: Optional[list] = None
    for ln in lines:
        if ln[:1] == b">":
            if cur is not None:
                seqs.append(b"".join(cur))
                recs.append(b"\n".join(currec) + b"\n")
            cur = []
            currec = [ln]
        elif cur is not None and ln:
            cur.append(ln)
            currec.append(ln)
    if cur is not None:
        seqs.append(b"".join(cur))
        recs.append(b"\n".join(currec) + b"\n")
    return seqs, recs


def parse_fastq(raw: bytes):
    """Reference fastq semantics: read count = non-empty lines // 4
    (fastq_file.h:60-67); sequence = the line right after each
    empty-line-skipped header (fastq_file.h:154-173)."""
    lines = raw.split(b"\n")
    n_nonempty = sum(1 for ln in lines if ln)
    nb_reads = n_nonempty // 4
    seqs: List[bytes] = []
    recs: List[bytes] = []
    i = 0
    nlines = len(lines)

    def skip_empty(j):
        while j < nlines and not lines[j]:
            j += 1
        return j

    for _ in range(nb_reads):
        i = skip_empty(i)
        if i >= nlines:
            break
        header = lines[i]
        i += 1
        seq = lines[i] if i < nlines else b""
        i += 1
        i = skip_empty(i)
        plus = lines[i] if i < nlines else b""
        i += 1
        i = skip_empty(i)
        qual = lines[i] if i < nlines else b""
        i += 1
        seqs.append(seq)
        recs.append(b"\n".join((header, seq, plus, qual)) + b"\n")
    return seqs, recs


class ReadFile:
    """One read file: encoded reads + the per-read *filter* bit vector.

    Mirrors the reference ReadFile (include/read_file.h:35): ``filter_bv``
    selects which reads exist for downstream consumers; the result vector
    (owned by ReadSet) accumulates search tags. Sequence/record text is
    materialized lazily (only extract/save paths need it).
    """

    def __init__(self, path: str, bv_path: Optional[str] = None,
                 use_native: Optional[bool] = None):
        self.path = path
        if not os.path.exists(path):
            # reference readers exit(1) with this message
            # (include/fasta_file.h:55-57). exists (not isfile): the
            # reference's ifstream reads FIFOs/process substitution too
            raise FileNotFoundError(2, "Cannot open read file", path)
        if use_native is None:
            use_native = _HAVE_NATIVE
        self._seqs: Optional[List[bytes]] = None
        self._records: Optional[List[bytes]] = None
        if use_native:
            d = _native.parse_file(path)
            self.fmt = d["format"]
            self.was_gzipped = d["gzipped"]
            self._codes = d["codes"]
            self._offsets = d["offsets"]
            self._lengths = d["lengths"]
            self._class_counts = d["class_counts"]
            self.nb_reads = d["n_reads"]
        else:
            self.fmt, self.was_gzipped = sniff_format(path)
            raw = _read_raw(path)
            seqs, recs = (parse_fasta(raw) if self.fmt == "fasta"
                          else parse_fastq(raw))
            self._seqs, self._records = seqs, recs
            self.nb_reads = len(seqs)
            self._codes = None
            self._offsets = None
            self._lengths = None
            self._class_counts = None

        if bv_path:
            bv = BitVector.read(bv_path)
            if bv.size != self.nb_reads:
                raise ValueError(
                    f"Number of reads in {path} and boolean vector size are "
                    f"not equal")
        else:
            bv = BitVector(self.nb_reads, fill=True)
        self.filter_bv = bv

    # ------------------------------------------------------------- lazy text
    def _ensure_text(self) -> None:
        if self._seqs is None:
            raw = _read_raw(self.path)
            self._seqs, self._records = (
                parse_fasta(raw) if self.fmt == "fasta" else parse_fastq(raw))

    @property
    def seqs(self) -> List[bytes]:
        self._ensure_text()
        return self._seqs

    @property
    def records(self) -> List[bytes]:
        self._ensure_text()
        return self._records

    # ---------------------------------------------------------- encoded view
    def _ensure_encoded(self) -> None:
        if self._codes is None:
            seqs = self.seqs
            if seqs:
                lengths = np.fromiter((len(s) for s in seqs), dtype=np.int32,
                                      count=len(seqs))
                flat = np.frombuffer(b"".join(seqs), dtype=np.uint8)
                self._codes = CODE_LUT[flat]
            else:
                lengths = np.zeros(0, dtype=np.int32)
                self._codes = np.zeros(0, dtype=np.uint8)
            self._lengths = lengths
            self._offsets = np.zeros(len(lengths) + 1, dtype=np.int64)
            np.cumsum(lengths, out=self._offsets[1:])

    def encoded(self):
        """(flat_codes uint8, offsets int64 [N+1], lengths int32 [N])."""
        self._ensure_encoded()
        return self._codes, self._offsets, self._lengths

    def class_counts(self):
        """Per-read (A,C,G,T,other) counts + lengths, for the filter."""
        self._ensure_encoded()
        if self._class_counts is None:
            n = self.nb_reads
            counts = np.zeros((n, 5), dtype=np.int64)
            if n:
                read_id = np.repeat(np.arange(n, dtype=np.int64),
                                    self._lengths)
                np.add.at(counts, (read_id, self._codes.astype(np.int64)), 1)
            self._class_counts = counts
        return self._class_counts, self._lengths.astype(np.int64)

    def nb_valid_reads(self) -> int:
        return self.filter_bv.nb_one()


def load_read_file(path: str, bv_path: Optional[str] = None) -> ReadFile:
    """Open a read file, count reads, attach its filter bit vector
    (all-true when ``bv_path`` is None, reference fasta_file.h:49-116)."""
    return ReadFile(path, bv_path)


def basename(path: str) -> str:
    """The reference's basename: everything after the last '/'
    (file_manager.h:247)."""
    return path[path.rfind("/") + 1 :]


class ReadSet:
    """An ordered collection of read files forming one (virtual) read set,
    with per-file filter and result bit vectors.

    Mirrors the reference FileManager (include/file_manager.h:39): reads
    stream in file order; a read is *eligible* when its filter bit is set;
    search passes additionally skip reads already tagged in the result
    vector (file_manager.h:99-109).
    """

    def __init__(self, name: str = ""):
        self.name = name
        self.files: List[ReadFile] = []
        self.result_bvs: List[BitVector] = []

    def add_file(self, path: str, bv_path: Optional[str] = None) -> None:
        rf = load_read_file(path, bv_path)
        self.files.append(rf)
        self.result_bvs.append(BitVector(rf.nb_reads))

    def total_valid_reads(self) -> int:
        return sum(f.nb_valid_reads() for f in self.files)

    def eligible(self):
        """Global list of eligible reads as (file_idx, read_pos) pairs in
        streaming order (filter bit set)."""
        out = []
        for fi, f in enumerate(self.files):
            pos = np.nonzero(f.filter_bv.as_bool_array())[0]
            out.append(np.stack([np.full(len(pos), fi, dtype=np.int64), pos],
                                axis=1))
        if not out:
            return np.zeros((0, 2), dtype=np.int64)
        return np.concatenate(out, axis=0)

    def untagged_eligible(self):
        """Eligible reads whose result bit is still 0 (search candidates,
        file_manager.h:99-109)."""
        out = []
        for fi, f in enumerate(self.files):
            mask = (f.filter_bv.as_bool_array()
                    & ~self.result_bvs[fi].as_bool_array())
            pos = np.nonzero(mask)[0]
            out.append(np.stack([np.full(len(pos), fi, dtype=np.int64), pos],
                                axis=1))
        if not out:
            return np.zeros((0, 2), dtype=np.int64)
        return np.concatenate(out, axis=0)

    def tag(self, file_idx: np.ndarray, read_pos: np.ndarray) -> None:
        for fi in np.unique(file_idx):
            self.result_bvs[fi].set_many(read_pos[file_idx == fi])

    def apply_result_as_filter(self) -> None:
        """The reference's apply_bv_on_files(): result vectors become the
        new filter vectors; results reset (file_manager.h:277-285)."""
        for f, r in zip(self.files, self.result_bvs):
            f.filter_bv = r.copy()
        for r in self.result_bvs:
            r.set_all_false()

    def save_result_bvs(self, directory: str, suffix: str) -> None:
        """Write per-file result vectors as <dir>/<basename>_in_<suffix>.bv
        with comment '<path> in <suffix>' (file_manager.h:245-252)."""
        for f, r in zip(self.files, self.result_bvs):
            out = os.path.join(directory, basename(f.path) + "_in_" + suffix
                               + ".bv")
            r.comment = f.path + " in " + suffix
            r.write(out)
