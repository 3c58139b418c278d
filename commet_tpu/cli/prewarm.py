"""Populate the persistent compile cache for the default serving geometry.

A cold process compiles every kernel it touches; the persistent XLA cache
(commet_tpu.config.enable_compile_cache) keeps those compilations across
processes. Running `python -m commet_tpu.cli.prewarm` once after install
(or after upgrading, which changes kernel hashes) moves that cost out of
the first real pipeline run. Whether it pays off on a given machine is
unmeasured.

Compiles (without executing) the plane-path kernel set the engine uses
for the default geometry: read length <= 128 after bucketing, batch
buckets 2048..65536, k in {32, 33} (the README smoke-test k and the
reference default, src/index_and_search.cpp:71), V in the engine's fill
policy set. The sorted-join probe is not prewarmed: its shapes follow the
index size. Any compile failure raises.
"""

from __future__ import annotations

import argparse
import sys
import time


def prewarm(ks=(32, 33), lpad: int = 128, batches=(2048, 16384, 65536),
            verbose: bool = True) -> int:
    from commet_tpu.config import enable_compile_cache
    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from commet_tpu.core import kernels, stream

    t = 2
    n = 0
    t_all = time.time()
    for k in ks:
        wmax = lpad - k + 1
        # plane shapes for the real k would allocate GiBs just to compile;
        # lower with ShapeDtypeStructs instead
        planes_s = jax.ShapeDtypeStruct((4 * kernels.plane_words(k),),
                                        jnp.uint32)
        for b in batches:
            c2 = jax.ShapeDtypeStruct((b, lpad // 16), jnp.uint32)
            vd = jax.ShapeDtypeStruct((b, lpad // 32), jnp.uint32)
            ln = jax.ShapeDtypeStruct((b,), jnp.int32)
            todo = [
                (kernels.build_chunk_packed, (planes_s, c2, vd, lpad, k)),
                (kernels.search_batch_fwd_packed,
                 (planes_s, c2, vd, lpad, k, t)),
                (kernels.search_batch_rc_packed,
                 (planes_s, c2, vd, lpad, k, t)),
                (stream.chunk_index_keys, (c2, vd, lpad, k)),
            ]
            for v in (4, 8, 16, 24):
                todo.append((kernels.probe_cascade2_clean,
                             (planes_s, c2, ln, lpad, k, t, v, wmax)))
                todo.append((kernels.probe_cascade2_packed,
                             (planes_s, c2, vd, lpad, k, t, v, wmax)))
            for fn, args in todo:
                t0 = time.time()
                fn.lower(*args).compile()
                n += 1
                if verbose:
                    print(f"  compiled {fn.__name__} k={k} b={b} "
                          f"({time.time()-t0:.1f}s)", flush=True)
    if verbose:
        print(f"prewarm: {n} kernels compiled into the persistent cache "
              f"in {time.time()-t_all:.0f}s", flush=True)
    return n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-k", type=int, action="append", default=None,
                   help="k values to warm (default: 32 and 33)")
    p.add_argument("--quick", action="store_true",
                   help="only the 65536-read bucket")
    args = p.parse_args(argv)
    ks = tuple(args.k) if args.k else (32, 33)
    batches = (65536,) if args.quick else (2048, 16384, 65536)
    prewarm(ks=ks, batches=batches)
    return 0


if __name__ == "__main__":
    sys.exit(main())
