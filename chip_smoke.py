#!/usr/bin/env python3
"""End-to-end smoke run of the COMMET pipeline on a GPU, checked against a
plain host reference.

    python chip_smoke.py            # one GPU: the `default` and `lowfill`
                                    # phases (about ten minutes)
    python chip_smoke.py --multi    # four GPUs: `commet --devices 4` (DP
                                    # mode) against a one-GPU run of the
                                    # same data, and nothing else

One process holds the card(s) for the whole run and calls the CLI entry
functions in-process. Every read set is generated from ``--seed`` into a
temporary directory.

Phases (k=33, t=2: the reference defaults; 100-bp reads):

  default  the reference default regime: S0 = 14.5M reads (~9.9e8 k-mers,
           one full max_kmer partition, ~11.5% plane fill, 4 GiB planes),
           S1 and S2 = 1M reads each, 30% of them carrying 2k-long
           fragments of S0 reads; S2 is fastq.gz with ~1% N bases. Runs
           the `commet` driver: dense plane cohorts, the cascade probe,
           exact fallback, the 3-pass refinement and the CSV matrices.
  lowfill  4 sets of 1M reads (~6.8e7 k-mers each, ~0.8% fill, below the
           stream gate): the driver with COMMET_TPU_STREAM=1 (resident
           StreamIndexes and the sorted join), then again with the
           default dense cascade; every .bv and CSV must be
           byte-identical. The `index_and_search` tool re-runs one
           step-0 pair.

Each phase checks, for every step-0 ``X_in_Y.bv``, 5,000 sampled query
reads (up to half of them tagged) against the sequential transcription of
the reference (tests/oracle.py) reading Y's four planes built on the host
by the native C++ code, and every ``matrix_plain.csv`` entry against the
popcount of the .bv it comes from. Any mismatch fails the run.

Output: the card's name and power limit first (nvidia-smi), the JAX
version and XLA_FLAGS, one JSON line per phase, and as the last line
``{"ok": true, "device": {...}}``. A run without a GPU, or with any failed
check, exits non-zero without that line. ``--scale`` shrinks every read
count for a quick check.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import gzip
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
K, T, READ_LEN = 33, 2, 100
FRAG = 2 * K  # implanted fragment: two non-overlapping shared k-mers
SAMPLE = 5000
LUT = np.frombuffer(b"ACGTN", dtype=np.uint8)
COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                  "/jax/core/compile/jaxpr_to_mlir_module_duration",
                  "/jax/core/compile/backend_compile_duration")


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_identity() -> str:
    """name, power.limit of every visible card, as nvidia-smi reports."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


# --------------------------------------------------------------------------
# Data
# --------------------------------------------------------------------------

def random_reads(rng, n):
    return rng.integers(0, 4, size=(n, READ_LEN), dtype=np.uint8)


def implant(rng, reads, donor_sets, frac=0.3):
    """Copy a FRAG-long fragment of a random read of a random donor set
    into ``frac`` of ``reads`` (in place)."""
    n = len(reads)
    rows = rng.choice(n, size=int(n * frac), replace=False)
    which = rng.integers(0, len(donor_sets), size=len(rows))
    cols = np.arange(FRAG)
    for di, donors in enumerate(donor_sets):
        r = rows[which == di]
        d = rng.integers(0, len(donors), size=len(r))
        ds = rng.integers(0, READ_LEN - FRAG + 1, size=len(r))
        qs = rng.integers(0, READ_LEN - FRAG + 1, size=len(r))
        for s in range(0, len(r), 1 << 18):
            sl = slice(s, s + (1 << 18))
            reads[r[sl, None], qs[sl, None] + cols] = \
                donors[d[sl, None], ds[sl, None] + cols]


def sprinkle_n(rng, reads, frac=0.01):
    flat = reads.reshape(-1)
    flat[rng.integers(0, flat.size, size=int(flat.size * frac))] = 4


def write_fasta(path, reads):
    with open(path, "wb") as f:
        for s in range(0, len(reads), 1 << 20):
            block = reads[s : s + (1 << 20)]
            rec = np.empty((len(block), READ_LEN + 4), np.uint8)
            rec[:, :3] = np.frombuffer(b">r\n", np.uint8)
            rec[:, 3:-1] = LUT[block]
            rec[:, -1] = ord("\n")
            f.write(rec.tobytes())


def write_fastq_gz(path, reads):
    with gzip.open(path, "wb", compresslevel=1) as f:
        for s in range(0, len(reads), 1 << 20):
            block = reads[s : s + (1 << 20)]
            rec = np.empty((len(block), 2 * READ_LEN + 7), np.uint8)
            rec[:, :3] = np.frombuffer(b"@r\n", np.uint8)
            rec[:, 3 : 3 + READ_LEN] = LUT[block]
            rec[:, 3 + READ_LEN : 6 + READ_LEN] = \
                np.frombuffer(b"\n+\n", np.uint8)
            rec[:, 6 + READ_LEN : -1] = ord("I")
            rec[:, -1] = ord("\n")
            f.write(rec.tobytes())


def make_default_sets(rng, workdir, scale):
    """S0 (fasta), S1 (fasta), S2 (fastq.gz with N bases); returns the
    fof path and per-set read counts."""
    # S1/S2 are cut from 2M to 1M reads to keep a cold-cache run well
    # inside its time limit; S0 stays one full 1e9-k-mer partition
    n0, n12 = int(14_500_000 * scale), int(1_000_000 * scale)
    s0 = random_reads(rng, n0)
    paths = [os.path.join(workdir, f) for f in ("S0.fa", "S1.fa",
                                                 "S2.fq.gz")]
    write_fasta(paths[0], s0)
    s1 = random_reads(rng, n12)
    implant(rng, s1, [s0])
    write_fasta(paths[1], s1)
    s2 = random_reads(rng, n12)
    implant(rng, s2, [s0])
    sprinkle_n(rng, s2)
    write_fastq_gz(paths[2], s2)
    fof = os.path.join(workdir, "default.fof")
    with open(fof, "w") as f:
        for i, p in enumerate(paths):
            f.write(f"S{i}: {p}\n")
    return fof, {"S0": n0, "S1": n12, "S2": n12}


def make_lowfill_sets(rng, workdir, scale):
    n = int(1_000_000 * scale)
    sets = []
    with open(os.path.join(workdir, "lowfill.fof"), "w") as fof:
        for i in range(4):
            reads = random_reads(rng, n)
            if sets:
                implant(rng, reads, sets)
            sets.append(reads)
            path = os.path.join(workdir, f"L{i}.fa")
            write_fasta(path, reads)
            fof.write(f"L{i}: {path}\n")
    return os.path.join(workdir, "lowfill.fof"), {f"L{i}": n
                                                  for i in range(4)}


# --------------------------------------------------------------------------
# Running the driver
# --------------------------------------------------------------------------

class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling."""

    def __init__(self):
        import jax
        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event in COMPILE_EVENTS:
            self.total += duration


@contextlib.contextmanager
def env(**values):
    """Set environment variables (None: leave unset) while active."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update({k: v for k, v in values.items() if v is not None})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def spy(owner, name):
    """Record every return value of ``owner.name`` while active."""
    real = getattr(owner, name)
    calls = []

    def wrapped(*a, **kw):
        out = real(*a, **kw)
        calls.append(out)
        return out

    setattr(owner, name, wrapped)
    try:
        yield calls
    finally:
        setattr(owner, name, real)


@contextlib.contextmanager
def engines():
    """Record every Engine constructed while active."""
    from commet_tpu.engine.engine import Engine
    real = Engine.__init__
    made = []

    def init(self, *a, **kw):
        real(self, *a, **kw)
        made.append(self)

    Engine.__init__ = init
    try:
        yield made
    finally:
        Engine.__init__ = real


@contextlib.contextmanager
def step0_snapshot(out_dir, snap_dir):
    """Copy the step-0 result vectors aside before the refinement passes
    rewrite them (the first refine_pair call follows every step-0 search
    in the amortized schedules)."""
    from commet_tpu.cli import commet as cli
    real = cli.refine_pair
    taken = []

    def wrapped(*a, **kw):
        if not taken:
            os.makedirs(snap_dir)
            for p in glob.glob(os.path.join(out_dir, "*_in_*.bv")):
                shutil.copy(p, snap_dir)
            taken.append(True)
        return real(*a, **kw)

    cli.refine_pair = wrapped
    try:
        yield taken
    finally:
        cli.refine_pair = real


def run_commet(fof, out_dir, clock, extra=()):
    """commet driver, in-process; its progress output goes to stderr.
    Returns (wall seconds, compile seconds)."""
    from commet_tpu.cli import commet as cli
    t0, c0 = time.time(), clock.total
    with contextlib.redirect_stdout(sys.stderr):
        rc = cli.main([fof, "-k", str(K), "-t", str(T), "-o", out_dir + "/",
                       "--no-plots", *extra])
    check(rc == 0, f"commet driver returned {rc}")
    wall, comp = time.time() - t0, clock.total - c0
    # on stderr as each run ends, so a run cut by a time limit still says
    # how far it got
    print(f"commet -> {out_dir}: {wall:.2f} s wall, {comp:.2f} s compile",
          file=sys.stderr, flush=True)
    return wall, comp


# --------------------------------------------------------------------------
# Host reference
# --------------------------------------------------------------------------

def load_oracle():
    spec = importlib.util.spec_from_file_location(
        "commet_oracle", os.path.join(ROOT, "tests", "oracle.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class HostPlanes:
    """The reference's 4-plane membership test (oracle.BloomOracle's
    interface) over planes built on the host by the native C++ code:
    plane p, key v -> byte p * 2^(k-3) + (v >> 3), bit v & 7."""

    def __init__(self, planes, k):
        self.bytes = planes.view(np.uint8)
        self.plane_bytes = 1 << (k - 3)

    def is_found(self, h) -> bool:
        for p, key in enumerate((h.a, h.b, h.c, h.d)):
            byte = self.bytes[p * self.plane_bytes + (key >> 3)]
            if not (byte >> (key & 7)) & 1:
                return False
        return True


class SetData:
    """One single-file read set as the pipeline saw it: codes + the
    filter vector the driver wrote."""

    def __init__(self, path, out_dir):
        from commet_tpu.io.reads import ReadFile
        rf = ReadFile(path, os.path.join(out_dir,
                                         os.path.basename(path) + ".bv"))
        self.path = path
        self.codes, self.offsets, self.lengths = rf.encoded()
        self.eligible = rf.filter_bv.as_bool_array()

    def seq(self, r) -> str:
        o = self.offsets[r]
        return LUT[self.codes[o : o + self.lengths[r]]].tobytes().decode()


def host_planes(index: SetData):
    """Y's four planes over all its eligible reads (one partition)."""
    from commet_tpu.core import kernels
    from commet_tpu.engine.engine import max_kmer_for
    from commet_tpu.native import parser as native
    rows = np.nonzero(index.eligible)[0]
    kmers = int(native.count_kmers(index.codes, index.offsets,
                                   index.lengths, rows, K).sum())
    check(kmers < max_kmer_for(K),
          f"{index.path}: {kmers} k-mers span several partitions")
    planes = np.zeros(4 * kernels.plane_words(K), np.uint32)
    native.build_planes_into(planes, index.codes, index.offsets,
                             index.lengths, rows, K)
    return HostPlanes(planes, K), kmers


def check_step0(oracle, snap_dir, sets, names, rng):
    """Sampled reference check of every step-0 X_in_Y.bv (X after Y)."""
    from commet_tpu.io.bv import BitVector
    report = []
    for yi in range(len(names) - 1):
        bloom, kmers = host_planes(sets[yi])
        for xi in range(yi + 1, len(names)):
            x = sets[xi]
            bv = os.path.join(snap_dir, os.path.basename(x.path) + "_in_"
                              + names[yi] + ".bv")
            tags = BitVector.read(bv).as_bool_array()
            check(not (tags & ~x.eligible).any(),
                  f"{bv}: tags outside the eligible reads")
            tagged = np.nonzero(tags)[0]
            untagged = np.nonzero(x.eligible & ~tags)[0]
            nt = min(len(tagged), SAMPLE // 2)
            pick = np.concatenate([
                rng.choice(tagged, nt, replace=False),
                rng.choice(untagged, min(SAMPLE - nt, len(untagged)),
                           replace=False)])
            bad = sum(oracle.search_read(bloom, x.seq(r), K, T)
                      != bool(tags[r]) for r in pick)
            report.append({"bv": os.path.basename(bv),
                           "index_kmers": kmers,
                           "tagged": int(len(tagged)),
                           "sampled": int(len(pick)),
                           "sampled_tagged": int(nt),
                           "mismatches": int(bad)})
            check(bad == 0, f"{bv}: {bad} of {len(pick)} sampled reads "
                            "disagree with the host reference")
        del bloom
    return report


def check_matrix(out_dir, names, paths):
    """matrix_plain.csv against the popcounts of its .bv files."""
    from commet_tpu.io.bv import BitVector

    def ones(p):
        return int(BitVector.read(p).as_bool_array().sum())

    with open(os.path.join(out_dir, "matrix_plain.csv")) as f:
        rows = [line.rstrip("\n").split(";") for line in f]
    check(rows[0][1:] == names, f"matrix header {rows[0]}")
    for i, row in enumerate(rows[1:]):
        check(row[0] == names[i], f"matrix row {row[0]}")
        for j, cell in enumerate(row[1:]):
            suffix = ".bv" if i == j else "_in_" + names[j] + ".bv"
            want = ones(os.path.join(out_dir, os.path.basename(paths[i])
                                     + suffix))
            check(int(cell) == want,
                  f"matrix_plain[{names[i]}][{names[j]}] = {cell}, "
                  f"popcount {want}")


def outputs(out_dir):
    return sorted(os.path.basename(p) for p in
                  glob.glob(os.path.join(out_dir, "*.bv"))
                  + glob.glob(os.path.join(out_dir, "*.csv")))


def check_identical(dir_a, dir_b, what):
    files = outputs(dir_a)
    check(files and files == outputs(dir_b),
          f"{what}: different output files")
    for name in files:
        with open(os.path.join(dir_a, name), "rb") as fa, \
                open(os.path.join(dir_b, name), "rb") as fb:
            check(fa.read() == fb.read(), f"{what}: {name} differs")
    return len(files)


def peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def set_layout(fof):
    from commet_tpu.io.fof import driver_read_files, driver_set_names
    files = driver_read_files(fof)
    check(all(len(f) == 1 for f in files), "one file per set expected")
    return driver_set_names(fof), [f[0] for f in files]


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------

def phase_default(args, workdir, clock, oracle, rng):
    from commet_tpu.core import kernels
    from commet_tpu.engine.engine import Engine
    t0 = time.time()
    fof, reads = make_default_sets(rng, workdir, args.scale)
    gen_s = time.time() - t0
    names, paths = set_layout(fof)
    out = os.path.join(workdir, "default_out")
    with step0_snapshot(out, out + "_step0") as taken, \
            spy(Engine, "search_multi_set_planes") as cohort_calls:
        wall, comp = run_commet(fof, out, clock)
    check(taken, "no refinement pass ran")
    check(cohort_calls, "the plane-cohort schedule did not run")
    check_matrix(out, names, paths)
    t1 = time.time()
    sets = [SetData(p, out) for p in paths]
    report = check_step0(oracle, out + "_step0", sets, names, rng)
    return {"phase": "default", "reads": reads,
            "plane_bytes": 4 * kernels.plane_words(K) * 4,
            "peak_bytes": peak_bytes(), "datagen_s": round(gen_s, 2),
            "wall_s": round(wall, 2), "compile_s": round(comp, 2),
            "reference_check_s": round(time.time() - t1, 2),
            "step0": report,
            "mismatches": sum(r["mismatches"] for r in report)}


def phase_lowfill(args, workdir, clock, oracle, rng):
    from commet_tpu.cli import index_and_search as ias_cli
    from commet_tpu.engine.engine import Engine
    t0 = time.time()
    fof, reads = make_lowfill_sets(rng, workdir, args.scale)
    gen_s = time.time() - t0
    names, paths = set_layout(fof)
    stream_out = os.path.join(workdir, "lowfill_stream")
    dense_out = os.path.join(workdir, "lowfill_dense")
    with step0_snapshot(stream_out, stream_out + "_step0"), \
            spy(Engine, "build_resident") as residents, \
            env(COMMET_TPU_STREAM="1"):
        stream_wall, stream_comp = run_commet(fof, stream_out, clock)
    check(any(r is not None for r in residents),
          "no resident StreamIndex was built: the stream path did not run")
    with spy(Engine, "search_multi_set_planes") as cohort_calls:
        dense_wall, dense_comp = run_commet(fof, dense_out, clock)
    check(cohort_calls, "the dense run did not take the cascade path")
    n_files = check_identical(stream_out, dense_out,
                              "stream vs dense cascade")
    check_matrix(stream_out, names, paths)

    # the index_and_search tool on one step-0 pair (pairwise stream path)
    ias_out = os.path.join(workdir, "lowfill_ias")
    fof_i, fof_s = (os.path.join(workdir, f) for f in ("ias_i.txt",
                                                       "ias_s.txt"))
    with open(fof_i, "w") as f:
        f.write(f"{names[0]}: {paths[0]},{stream_out}/"
                f"{os.path.basename(paths[0])}.bv\n")
    with open(fof_s, "w") as f:
        f.write(f"{names[1]}: {paths[1]},{stream_out}/"
                f"{os.path.basename(paths[1])}.bv\n")
    t_ias = time.time()
    with contextlib.redirect_stdout(sys.stderr):
        rc = ias_cli.main(["-i", fof_i, "-s", fof_s, "-k", str(K), "-t",
                           str(T), "-o", ias_out, "-l", ias_out])
    check(rc == 0, f"index_and_search returned {rc}")
    ias_wall = time.time() - t_ias
    pair_bv = os.path.basename(paths[1]) + "_in_" + names[0] + ".bv"
    with open(os.path.join(ias_out, pair_bv), "rb") as fa, \
            open(os.path.join(stream_out + "_step0", pair_bv), "rb") as fb:
        check(fa.read() == fb.read(),
              f"index_and_search {pair_bv} differs from the driver's")

    t1 = time.time()
    sets = [SetData(p, stream_out) for p in paths]
    report = check_step0(oracle, stream_out + "_step0", sets, names, rng)
    out = {"phase": "lowfill", "reads": reads, "plane_bytes": 0,
           "peak_bytes": peak_bytes(), "datagen_s": round(gen_s, 2),
           "stream_wall_s": round(stream_wall, 2),
           "stream_compile_s": round(stream_comp, 2),
           "dense_wall_s": round(dense_wall, 2),
           "dense_compile_s": round(dense_comp, 2),
           "index_and_search_s": round(ias_wall, 2),
           "identical_outputs": n_files,
           "reference_check_s": round(time.time() - t1, 2),
           "step0": report,
           "mismatches": sum(r["mismatches"] for r in report)}
    return out


def phase_multi(args, workdir, clock):
    import jax
    check(len(jax.devices()) >= 4, f"--multi needs 4 GPUs, JAX found "
                                   f"{len(jax.devices())}")
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    fof, reads = make_default_sets(rng, workdir, args.scale)
    gen_s = time.time() - t0
    dp_out = os.path.join(workdir, "multi_dp4")
    one_out = os.path.join(workdir, "multi_1")
    with engines() as dp_engines:
        dp_wall, dp_comp = run_commet(fof, dp_out, clock, ("--devices", "4"))
    check(dp_engines and all(
        e.mesh is not None and e.mesh.devices.size == 4
        and e.mesh_mode == "dp" for e in dp_engines),
        "the --devices 4 run did not take the 4-device DP mode")
    with engines() as one_engines:
        one_wall, one_comp = run_commet(fof, one_out, clock, ("--devices", "1"))
    check(one_engines and all(e.mesh is None for e in one_engines),
          "the --devices 1 run used a mesh")
    n_files = check_identical(dp_out, one_out, "4-GPU DP vs 1 GPU")
    return {"phase": "multi", "reads": reads, "datagen_s": round(gen_s, 2),
            "dp4_wall_s": round(dp_wall, 2),
            "dp4_compile_s": round(dp_comp, 2),
            "one_wall_s": round(one_wall, 2),
            "one_compile_s": round(one_comp, 2),
            "identical_outputs": n_files, "peak_bytes": peak_bytes()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--multi", action="store_true",
                    help="4 GPUs: DP driver run vs 1 GPU, nothing else")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="fraction of every read count (quick checks)")
    args = ap.parse_args(argv)

    print(card_identity(), flush=True)
    import jax
    print(f"jax {jax.__version__} XLA_FLAGS="
          f"{os.environ.get('XLA_FLAGS', '')!r}", flush=True)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX found {dev.platform}", file=sys.stderr)
        return 1
    from commet_tpu.native import parser as native
    check(native.available(), "the native IO library is not in use")

    clock = CompileClock()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if args.multi:
            results = [phase_multi(args, workdir, clock)]
        else:
            oracle = load_oracle()
            rng = np.random.default_rng(args.seed)
            results = [phase_default(args, workdir, clock, oracle, rng),
                       phase_lowfill(args, workdir, clock, oracle, rng)]
        for r in results:
            print(json.dumps(dict(r, native_io=True)), flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
