"""commet driver CLI - the all-vs-all pipeline (reference Commet.py:438-601).

Given a file-of-files manifest (one line per read set,
"name: file[,bv]; file[,bv]; ..."), it:
  1. filters every read file (length/N/entropy/max-reads) into a .bv unless
     bvs are supplied in the manifest (Commet.py:103-121,557-562);
  2. runs the ordered 3-step refinement over every pair of sets
     (Commet.py:186-240): all-in-Si, then per later set X:
     Si in (X in Si), then X in (Si in (X in Si));
  3. emits matrix_plain/percentage/normalized.csv, byte-identical to the
     reference's (Commet.py:245-317), plus heatmap/dendrogram PNGs
     (matplotlib/scipy instead of R).

State flows through .bv files between steps exactly like the reference's
subprocess pipeline, so individual stages stay restartable/resumable.
"""

from __future__ import annotations

import argparse
import os
import sys

from commet_tpu.cli import filter_reads as filter_cli
from commet_tpu.engine.engine import Engine
from commet_tpu.io.bv import BitVector
from commet_tpu.io.fof import driver_read_bvs, driver_read_files, driver_set_names
from commet_tpu.io.reads import ReadSet


def filter_all_reads(read_matrix, out_dir, l, n, e, m):
    """Per-file filter_reads invocations (Commet.py:103-121)."""
    for tab_line in read_matrix:
        argv_m = []
        if m >= 0:
            argv_m = ["-m", str(m // len(tab_line))]
        for path in tab_line:
            argv = [path, "-l", str(l), "-e", str(e)]
            if n >= 0:
                argv += ["-n", str(n)]
            argv += argv_m + ["-o", out_dir + os.path.basename(path) + ".bv"]
            print("Filtering: filter_reads " + " ".join(argv))
            filter_cli.main(argv)


def _load_set(name, files, bvs) -> ReadSet:
    rs = ReadSet(name)
    for f, b in zip(files, bvs):
        rs.add_file(f, b or None)
    return rs


def refine_pair(read_matrix, bv_matrix, names, out_dir, ref_id, j, eng):
    """Steps a/b of the Compareads 3-pass refinement for pair (ref_id, j)
    (Commet.py:211-238); requires the pair's step-0 result bvs on disk."""
    # STEP a: Si in (X in Si) - index X narrowed by its _in_Si bvs
    x_bvs = [out_dir + os.path.basename(f) + "_in_" +
             os.path.basename(names[ref_id]) + ".bv"
             for f in read_matrix[j]]
    x_narrow = _load_set(names[j], read_matrix[j], x_bvs)
    si = _load_set(names[ref_id], read_matrix[ref_id], bv_matrix[ref_id])
    print(f" {names[ref_id]} in ({names[j]} in {names[ref_id]})")
    eng.index_and_search(x_narrow, [si], out_dir=out_dir, log_dir=out_dir)

    # STEP b: X in (Si in (X in Si)) - index Si narrowed by its _in_X bvs
    si_bvs = [out_dir + os.path.basename(f) + "_in_" +
              os.path.basename(names[j]) + ".bv"
              for f in read_matrix[ref_id]]
    si_narrow = _load_set(names[ref_id], read_matrix[ref_id], si_bvs)
    x_full = _load_set(names[j], read_matrix[j], bv_matrix[j])
    print(f" {names[j]} in ({names[ref_id]} in ({names[j]} in {names[ref_id]}))")
    eng.index_and_search(si_narrow, [x_full], out_dir=out_dir, log_dir=out_dir)


def compare_all_against(read_matrix, bv_matrix, names, out_dir, ref_id, eng):
    """One reference round (Commet.py:186-240) executed in-process: results
    chain through .bv files on disk like the reference's job DAG."""
    n_sets = len(names)

    # STEP 0 "all in Si": index Si, search every later set
    index_set = _load_set(names[ref_id], read_matrix[ref_id], bv_matrix[ref_id])
    queries = [_load_set(names[j], read_matrix[j], bv_matrix[j])
               for j in range(ref_id + 1, n_sets)]
    print(f"All in {names[ref_id]}")
    eng.index_and_search(index_set, queries, out_dir=out_dir, log_dir=out_dir)

    for j in range(ref_id + 1, n_sets):
        refine_pair(read_matrix, bv_matrix, names, out_dir, ref_id, j, eng)


def run_amortized_rounds(read_matrix, bv_matrix, names, out_dir, end, eng):
    """The transposed all-vs-all schedule: every step-0 index set S_0 ..
    S_{end-1} is built ONCE as a resident StreamIndex, then each query set
    S_j streams its batches once against all earlier resident indexes (one
    query sort serving up to j joins -- engine.search_multi_set). Pair
    results are identical to the reference's per-round schedule
    (Commet.py:186-240): each pair's step-0 outcome depends only on its own
    (index, query) sets, so reordering across pairs is observationally
    equivalent; the a/b refinement steps then run pairwise as before.
    Returns False when the configuration cannot be served (wide keys, high
    fill, memory budget) -- the caller falls back to the classic rounds."""
    if os.environ.get("COMMET_TPU_MULTI", "1") == "0":
        return False
    if not eng.stream or eng.mesh is not None:
        # no resident StreamIndexes without the single-device stream path:
        # amortize the dense planes instead
        return run_plane_cohorts(read_matrix, bv_matrix, names, out_dir,
                                 end, eng)
    n = len(names)
    budget = eng.resident_budget()
    residents = []
    total_bytes = 0
    for i in range(end):
        rs = _load_set(names[i], read_matrix[i], bv_matrix[i])
        # pass the REMAINING cumulative budget so an index that would
        # overshoot is rejected before it allocates device memory
        r = eng.build_resident(rs, budget=budget - total_bytes)
        if r is None:
            # high fill / wide residents the stream cannot serve: the
            # dense-plane cohort schedule amortizes the query transport
            # + keygen instead (the reference's default regime)
            del residents
            return run_plane_cohorts(read_matrix, bv_matrix, names,
                                     out_dir, end, eng)
        total_bytes += r.device_bytes()
        if total_bytes > budget:
            return False
        residents.append(r)
    for j in range(1, n):
        targets = residents[: min(j, end)]
        rs_q = _load_set(names[j], read_matrix[j], bv_matrix[j])
        print(f"{names[j]} in {{{', '.join(r.name for r in targets)}}}")
        got = eng.search_multi_set(rs_q, targets, out_dir=out_dir,
                                   log_dir=out_dir)
        if got is None:  # geometry can't serve (e.g. very long reads):
            return False  # classic pairwise schedule handles any input
    del residents  # free device memory before the pairwise refinement
    for i in range(end):
        for j in range(i + 1, n):
            refine_pair(read_matrix, bv_matrix, names, out_dir, i, j, eng)
    return True


# device memory the plane-cohort schedule leaves free next to its resident
# planes: the bulk build's workspace at k=33 (a 2^27-entry chunk's four
# key columns and sort operands, ~4.3 GB, plus one 1 GiB scratch plane),
# rounded up
PLANES_WORKSPACE = 6 << 30


def planes_budget() -> float:
    """Device bytes for resident dense planes: COMMET_TPU_PLANES_BUDGET if
    set, else the device's memory limit less PLANES_WORKSPACE. The CPU
    backend reports no device memory limit -- its planes live in host
    memory -- so nothing is capped there."""
    env = os.environ.get("COMMET_TPU_PLANES_BUDGET")
    if env:
        return float(env)
    import jax
    if jax.devices()[0].platform == "cpu":
        return float("inf")
    from commet_tpu.parallel.sharded import device_hbm_bytes
    return float(device_hbm_bytes() - PLANES_WORKSPACE)


def run_plane_cohorts(read_matrix, bv_matrix, names, out_dir, end, eng):
    """The amortized all-vs-all schedule for the HIGH-FILL regime (the
    reference's own default: full max_kmer partitions at 11.6% fill,
    index_and_search.cpp:73,146), where the planeless StreamIndex gates
    itself off. Step-0 index sets are built as resident dense-plane
    indexes in contiguous cohorts bounded by device memory; each query set
    then searches all its cohort predecessors with ONE batch upload +
    window-key computation per batch (engine.search_multi_set_planes).
    Pair results are identical to the per-round schedule; refinement runs
    pairwise as before. Returns False when fewer than 2 indexes fit
    (amortization would buy nothing -- classic path serves)."""
    import jax
    if jax.devices()[0].platform == "cpu" and \
            os.environ.get("COMMET_TPU_PLANE_COHORTS", "") != "force":
        return False  # CPU (tests): dense multi-plane batches are slow
    if end < 2 or eng.mesh is not None:
        return False  # nothing to amortize / mesh: classic path
    n = len(names)
    budget = planes_budget()
    from commet_tpu.core import kernels as _k
    if 2 * 4 * _k.plane_words(eng.k) * 4 > budget:
        return False  # cannot hold even a 2-index cohort
    i = 0
    while i < end:
        cohort = []
        total = 0
        while i < end:
            rs = _load_set(names[i], read_matrix[i], bv_matrix[i])
            saved_chunk = os.environ.get("COMMET_TPU_BULK_CHUNK")
            if cohort and eng.k >= 32 and saved_chunk is None:
                # building next to already-resident multi-GiB planes:
                # halve the bulk-build sort workspace to keep peak HBM
                # (resident planes + new planes + sort operands) in budget
                os.environ["COMMET_TPU_BULK_CHUNK"] = str(1 << 26)
            try:
                r = eng.build_resident_planes(rs, budget=budget - total)
            finally:
                if saved_chunk is None:
                    os.environ.pop("COMMET_TPU_BULK_CHUNK", None)
            if r is None:
                break
            cohort.append(r)
            total += r.device_bytes()
            i += 1
        if not cohort:
            return False  # single index exceeds the budget: classic path
        first = i - len(cohort)
        for j in range(first + 1, n):
            targets = cohort[: min(j - first, len(cohort))]
            rs_q = _load_set(names[j], read_matrix[j], bv_matrix[j])
            print(f"{names[j]} in {{{', '.join(r.name for r in targets)}}}"
                  " [plane cohort]")
            eng.search_multi_set_planes(rs_q, targets, out_dir=out_dir,
                                        log_dir=out_dir)
        del cohort  # free the planes before the next cohort builds
    for a in range(end):
        for j in range(a + 1, n):
            refine_pair(read_matrix, bv_matrix, names, out_dir, a, j, eng)
    return True


def bv_count(path: str) -> int:
    return BitVector.read(path).nb_one()


def py2_str_float(v: float) -> str:
    """CPython 2.7 ``str(float)``: PyOS_double_to_string(v, 'g', 12,
    Py_DTSF_ADD_DOT_0) — 12 significant digits, with ``.0`` appended to
    integral results unless an exponent is present. The reference driver is
    python 2 (Commet.py:299,314,408-420), so byte parity of the float CSVs
    requires this formatter rather than py3's shortest repr."""
    s = "%.12g" % v
    if "." not in s and "e" not in s and "n" not in s:  # n: inf/nan
        s += ".0"
    return s


def output_matrices(read_matrix, bv_matrix, names, out_dir, plots=True):
    """CSV matrices, byte-identical to Commet.py:245-317 (incl. the py2
    str(float) 12-significant-digit formatting)."""
    number_reads_all_sets = []
    matrix = []
    for i in range(len(names)):
        number_reads_all_sets.append(sum(bv_count(b) for b in bv_matrix[i]))
    for i in range(len(names)):
        row = []
        for j in range(len(names)):
            if i == j:
                row.append(number_reads_all_sets[i])
                continue
            shared = sum(
                bv_count(out_dir + os.path.basename(f) + "_in_" + names[j] + ".bv")
                for f in read_matrix[i])
            row.append(shared)
        matrix.append(row)

    def write_matrix(fname, value_fn):
        with open(out_dir + fname, "w") as f:
            for name in names:
                f.write(";" + name)
            f.write("\n")
            for i in range(len(names)):
                f.write(names[i])
                for j in range(len(names)):
                    f.write(";" + str(value_fn(i, j)))
                f.write("\n")

    write_matrix("matrix_plain.csv", lambda i, j: matrix[i][j])
    write_matrix("matrix_percentage.csv", lambda i, j: py2_str_float(
        100 * matrix[i][j] / float(number_reads_all_sets[i])))
    write_matrix("matrix_normalized.csv", lambda i, j: py2_str_float(
        100 * (matrix[i][j] + matrix[j][i])
        / float(number_reads_all_sets[i] + number_reads_all_sets[j])))

    if plots:
        try:
            from commet_tpu.viz.plots import dendrogram_png, heatmap_png
            dendrogram_png(out_dir + "matrix_normalized.csv",
                           out_dir + "dendrogram_normalized.png")
            for kind in ("plain", "percentage", "normalized"):
                heatmap_png(out_dir + f"matrix_{kind}.csv",
                            out_dir + "matrix_normalized.csv",
                            out_dir + f"heatmap_{kind}.png", kind.capitalize())
        except Exception as exc:  # plotting must never fail the pipeline
            print(f"(plots skipped: {exc})")

    print("All Commet work is done")
    for kind in ("plain", "percentage", "normalized"):
        print(f"\t\t{out_dir}matrix_{kind}.csv")


def _run_scheduled(read_matrix, bv_matrix, names, out_dir, end, eng, jobs):
    """Execute the pair-comparison rounds as a dependency DAG (the
    reference's SGE hold_jid chains, Commet.py:186-240, run in-process).
    Steps within a round chain strictly; rounds for different ref sets only
    share the filter prerequisites, mirroring the reference ordering.

    Resume: each completed job drops a ``.job_<name>.done`` marker next to
    its outputs; on re-run, jobs whose marker AND outputs all exist are
    skipped (the reference's implicit file-based restartability,
    Commet.py precomputed-bv re-run semantics, made explicit). Delete a
    pair's outputs (or markers) to recompute just that pair."""
    from commet_tpu.engine.scheduler import JobGraph

    g = JobGraph(workers=jobs)

    def with_marker(fn, name):
        marker = os.path.join(out_dir, f".job_{name}.done")

        def run():
            fn()
            with open(marker, "w") as f:
                f.write("done\n")
        return run

    def done_when(name, outputs):
        marker = os.path.join(out_dir, f".job_{name}.done")

        def check():
            return (os.path.exists(marker)
                    and all(os.path.exists(p) for p in outputs))
        return check

    def make_round(ref_id):
        def step0():
            index_set = _load_set(names[ref_id], read_matrix[ref_id],
                                  bv_matrix[ref_id])
            queries = [_load_set(names[j], read_matrix[j], bv_matrix[j])
                       for j in range(ref_id + 1, len(names))]
            eng.index_and_search(index_set, queries, out_dir=out_dir,
                                 log_dir=out_dir)

        name0 = f"all_in_{ref_id}"
        outs0 = [out_dir + os.path.basename(f) + "_in_"
                 + os.path.basename(names[ref_id]) + ".bv"
                 for j in range(ref_id + 1, len(names))
                 for f in read_matrix[j]]
        outs0 += [out_dir + f"{names[j]}_in_{names[ref_id]}.log"
                  for j in range(ref_id + 1, len(names))]
        root = g.add(name0, with_marker(step0, name0), device=True,
                     done_check=done_when(name0, outs0))
        for j in range(ref_id + 1, len(names)):
            def step_a(j=j):
                x_bvs = [out_dir + os.path.basename(f) + "_in_"
                         + os.path.basename(names[ref_id]) + ".bv"
                         for f in read_matrix[j]]
                x_narrow = _load_set(names[j], read_matrix[j], x_bvs)
                si = _load_set(names[ref_id], read_matrix[ref_id],
                               bv_matrix[ref_id])
                eng.index_and_search(x_narrow, [si], out_dir=out_dir,
                                     log_dir=out_dir)

            def step_b(j=j):
                si_bvs = [out_dir + os.path.basename(f) + "_in_"
                          + os.path.basename(names[j]) + ".bv"
                          for f in read_matrix[ref_id]]
                si_narrow = _load_set(names[ref_id], read_matrix[ref_id],
                                      si_bvs)
                x_full = _load_set(names[j], read_matrix[j], bv_matrix[j])
                eng.index_and_search(si_narrow, [x_full], out_dir=out_dir,
                                     log_dir=out_dir)

            # pairs fan out independently after step 0, like the reference's
            # per-pair hold_jid chains (Commet.py:224,236)
            name_a = f"{ref_id}_in_{j}"
            outs_a = [out_dir + os.path.basename(f) + "_in_"
                      + os.path.basename(names[j]) + ".bv"
                      for f in read_matrix[ref_id]]
            outs_a += [out_dir + f"{names[ref_id]}_in_{names[j]}.log"]
            a = g.add(name_a, with_marker(step_a, name_a), deps=[root],
                      device=True, done_check=done_when(name_a, outs_a))
            name_b = f"{j}_in_{ref_id}"
            outs_b = [out_dir + os.path.basename(f) + "_in_"
                      + os.path.basename(names[ref_id]) + ".bv"
                      for f in read_matrix[j]]
            outs_b += [out_dir + f"{names[j]}_in_{names[ref_id]}.log"]
            g.add(name_b, with_marker(step_b, name_b), deps=[a],
                  device=True, done_check=done_when(name_b, outs_b))

    for ref_id in range(end):
        make_round(ref_id)
    g.run()


def output_vectors(read_matrix, bv_matrix, names, out_dir):
    """one_vs_all outputs: vector_plain.csv / vector_percentage.csv
    (Commet.py:355-433, reproduced literally including the
    'shared/reverse' cell format)."""
    number_reads_all_sets = [sum(bv_count(b) for b in bv_matrix[i])
                             for i in range(len(names))]

    vector_sum_shared_reads = []
    array_sum_shared_reads = []
    for j in range(len(names)):
        if j == 0:
            array_sum_shared_reads.append(number_reads_all_sets[0])
            continue
        shared = sum(
            bv_count(out_dir + os.path.basename(f) + "_in_" + names[j] + ".bv")
            for f in read_matrix[0])
        array_sum_shared_reads.append(shared)
    vector_sum_shared_reads.append(array_sum_shared_reads)
    vector_sum_shared_reads.append(number_reads_all_sets[0])
    for i in range(1, len(names)):
        shared = sum(
            bv_count(out_dir + os.path.basename(f) + "_in_" + names[0] + ".bv")
            for f in read_matrix[i])
        vector_sum_shared_reads.append(shared)

    with open(out_dir + "vector_plain.csv", "w") as f:
        for name in names:
            f.write(";" + name)
        f.write("\n" + names[0])
        for j in range(len(names)):
            f.write(";" + str(vector_sum_shared_reads[0][j]) + "/"
                    + str(vector_sum_shared_reads[j + 1]))
        f.write("\n")

    with open(out_dir + "vector_percentage.csv", "w") as f:
        for name in names:
            f.write(";" + name)
        f.write("\n" + names[0])
        for j in range(len(names)):
            v1 = 100 * vector_sum_shared_reads[0][j] / float(number_reads_all_sets[0])
            v2 = 100 * vector_sum_shared_reads[j + 1] / float(number_reads_all_sets[j])
            f.write(";" + py2_str_float(v1) + "/" + py2_str_float(v2))
        f.write("\n")

    print("All Commet work is done")
    print("\t\t" + out_dir + "vector_plain.csv")
    print("\t\t" + out_dir + "vector_percentage.csv")


def main(argv=None) -> int:
    from commet_tpu.config import enable_compile_cache
    enable_compile_cache()
    from commet_tpu.parallel.distributed import init_distributed
    init_distributed()  # no-op unless COMMET_TPU_COORDINATOR/_DISTRIBUTED set
    parser = argparse.ArgumentParser(
        description="Computes the filtering and the full N x N intersections "
                    "of read sets on an accelerator")
    parser.add_argument("input_file", type=str)
    parser.add_argument("--sge", action="store_true",
                        help="compatibility alias for --jobs 2 (the "
                             "reference's SGE cluster mode becomes an "
                             "in-process dependency-scheduled job DAG)")
    parser.add_argument("--one_vs_all", action="store_true")
    parser.add_argument("--no-plots", dest="plots", action="store_false")
    parser.add_argument("-o", "--output_directory", dest="directory",
                        default="output_commet/")
    parser.add_argument("-k", type=int, default=33)
    parser.add_argument("-t", type=int, default=2)
    parser.add_argument("-l", type=int, default=0)
    parser.add_argument("-n", type=int, default=-1)
    parser.add_argument("-e", type=float, default=0)
    parser.add_argument("-m", type=int, default=-1)
    parser.add_argument("-b", "--binaries_directory", type=str,
                        dest="binary_directory", default=None,
                        help="accepted for reference drop-in compatibility; "
                             "unused (no external binaries)")
    parser.add_argument("--devices", type=str, default=None,
                        help="number of local devices to use (or 'all'); "
                             "planes replicate and the read axis shards "
                             "when they fit one device's memory, else "
                             "planes shard (sets COMMET_TPU_DEVICES)")
    parser.add_argument("--batch", type=int, default=4096,
                        help="device batch size (reads per search step)")
    parser.add_argument("--jobs", type=int, default=1,
                        help="run the pipeline as a dependency-scheduled job "
                             "DAG with N host workers (the reference's --sge "
                             "equivalent; device stages serialize)")
    args = parser.parse_args(argv)
    if args.sge and args.jobs == 1:
        print("SGE mode requested: running as an in-process job DAG")
        args.jobs = 2

    out_dir = args.directory
    if not out_dir.endswith("/"):
        out_dir += "/"
    os.makedirs(out_dir, exist_ok=True)

    k, t, l = args.k, args.t, args.l
    # l-default quirk (Commet.py:509-513): l=0 stays 0 (no length filter)
    if l < k * t and l != 0:
        print(f"l should be at least k*t. {l} is too small with k={k} and t={t}.")
        l = k * t
    print(f"k={k} t={t} l={l}")

    # multi-host (COMMET_TPU_COORDINATOR/_DISTRIBUTED): each process owns a
    # stride of the comparison rounds over the shared filesystem — the
    # cluster equivalent of the reference's SGE job partitioning
    # (Commet.py:204-236); analysis is deferred exactly like --sge mode.
    import jax
    nprocs, rank = jax.process_count(), jax.process_index()

    read_matrix = driver_read_files(args.input_file)
    names = driver_set_names(args.input_file)
    bv_matrix = driver_read_bvs(args.input_file)
    if bv_matrix is None:
        # only rank 0 filters (all ranks share the filesystem; concurrent
        # writers of the same .bv would race), others wait at a barrier
        if rank == 0:
            print("Reads were not filtered, we filter them.")
            filter_all_reads(read_matrix, out_dir, l, args.n, args.e, args.m)
        if nprocs > 1:
            from jax.experimental.multihost_utils import sync_global_devices
            sync_global_devices("commet_filter_done")
        bv_matrix = [[out_dir + os.path.basename(f) + ".bv" for f in line]
                     for line in read_matrix]

    if args.devices:
        os.environ["COMMET_TPU_DEVICES"] = args.devices
    from commet_tpu.parallel.sharded import auto_mesh
    eng = Engine(k=k, t=t, batch=args.batch, mesh=auto_mesh())
    end = 1 if args.one_vs_all else len(read_matrix) - 1
    if args.jobs > 1:
        _run_scheduled(read_matrix, bv_matrix, names, out_dir, end, eng,
                       args.jobs)
    else:
        # single-host: try the amortized schedule first (resident indexes,
        # one query sort serving every step-0 join); identical outputs,
        # falls back per-configuration. Multi-host keeps the per-round
        # striding (rounds are the distribution unit).
        done = nprocs == 1 and run_amortized_rounds(
            read_matrix, bv_matrix, names, out_dir, end, eng)
        if not done:
            for ref_id in range(end):
                if ref_id % nprocs != rank:
                    continue
                compare_all_against(read_matrix, bv_matrix, names, out_dir,
                                    ref_id, eng)

    if nprocs > 1:
        print("multi-host run: rank %d/%d finished its rounds; run "
              "commet_analysis after all ranks complete to aggregate "
              "matrices" % (rank, nprocs))
        return 0
    if args.one_vs_all:
        output_vectors(read_matrix, bv_matrix, names, out_dir)
    else:
        output_matrices(read_matrix, bv_matrix, names, out_dir, plots=args.plots)
    return 0


def entry() -> None:
    """console_scripts entry point (pyproject.toml)."""
    from commet_tpu.cli.util import guarded
    sys.exit(guarded(main))


if __name__ == "__main__":
    from commet_tpu.cli.util import guarded

    sys.exit(guarded(main))
