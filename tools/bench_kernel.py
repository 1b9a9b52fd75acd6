"""Time the packed-operator kernel against its blocked XLA reference on a GPU.

    python tools/bench_kernel.py [--N 327680] [--M 131072] [--B 1,3,32]
                                 [--reps 5] [--tiles ax:32,64,4,2 ...]

For each path (complete genotypes, then ~1.6% missing calls), each width B
and each direction it checks the kernel (default tiles and each ``--tiles``
override: tnw, tm, warps, stages) against the blocked XLA
reference (``Precision.HIGHEST``) on the card and prints milliseconds per
call, packed GB/s and the largest error over each column's largest value.
``--json PATH`` also writes the rows as JSON.  Fails when no GPU is found.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gvamp import runtime, sim  # noqa: E402
from gvamp.ops import matvec  # noqa: E402


def timed(fn, *args, reps):
    jax.block_until_ready(fn(*args))          # compile + warm
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps, out


def col_err(got, ref):
    """max_j max_i |got - ref| / max_i |ref| over the B columns."""
    got = jnp.asarray(got, jnp.float32).reshape(-1, ref.shape[-1])
    ref = jnp.asarray(ref, jnp.float32).reshape(-1, ref.shape[-1])
    den = jnp.maximum(jnp.max(jnp.abs(ref), axis=0), 1e-30)
    return float(jnp.max(jnp.max(jnp.abs(got - ref), axis=0) / den))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--N", type=int, default=327680)
    ap.add_argument("--M", type=int, default=131072)
    ap.add_argument("--B", default="1,3,32")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--paths", default="complete,missing")
    ap.add_argument("--no-ref", action="store_true",
                    help="skip the XLA reference (kernel times only)")
    ap.add_argument("--json", default="", help="also write rows here")
    ap.add_argument("--tiles", nargs="*", default=[],
                    help="extra tiles to time, e.g. ax:32,64,4,2")
    args = ap.parse_args(argv)
    runtime.require_gpu()
    runtime.enable_compile_cache()
    card = runtime.card_info()
    print(f"# device {jax.devices()[0].device_kind} | {card}", flush=True)
    packed = args.N // 16 * args.M * 4
    rows = []
    for path in args.paths.split(","):
        complete = path == "complete"
        words = sim.synth_words(args.N, args.M, seed=1, miss=not complete)
        Nw, Mp = words.shape
        for B in [int(b) for b in args.B.split(",")]:
            k = jax.random.split(jax.random.key(B), 3)
            W = jax.random.normal(k[0], (Mp, B), jnp.float32)
            U = W * jax.random.uniform(k[1], (Mp, 1), jnp.float32, 0.0, 2.0)
            V = jax.random.normal(k[2], (4, 4 * Nw, B), jnp.float32)
            ax_ref = at_ref = None
            if not args.no_ref:
                t, ax_ref = timed(jax.jit(lambda w, W, U: matvec.axm_xla(
                    w, W, U, complete)), words, W, U, reps=1)
                rows.append(dict(path=path, B=B, dir="ax", impl="xla", ms=t * 1e3))
                t, at_ref = timed(jax.jit(lambda w, V: matvec.atxm_xla(
                    w, V, complete)), words, V, reps=1)
                rows.append(dict(path=path, B=B, dir="atx", impl="xla", ms=t * 1e3))
            cfgs = [(None, None)]
            for spec in args.tiles:
                d, tl = spec.split(":")
                cfgs.append((d, tuple(int(x) for x in tl.split(","))))
            for only, tiles in cfgs:
                name = f"kernel{list(tiles)}" if tiles else "kernel"
                if only in (None, "ax"):
                    t, z = timed(lambda w, W, U: matvec.axm_pallas(
                        w, W, U, complete, tiles=tiles),
                        words, W, U, reps=args.reps)
                    rows.append(dict(path=path, B=B, dir="ax", impl=name,
                                     ms=t * 1e3, err=None if ax_ref is None
                                     else col_err(z, ax_ref)))
                if only in (None, "atx"):
                    t, (av, bv) = timed(lambda w, V: matvec.atxm_pallas(
                        w, V, complete, tiles=tiles),
                        words, V, reps=args.reps)
                    err = None
                    if at_ref is not None:
                        err = max(col_err(av, at_ref[0]),
                                  col_err(jnp.broadcast_to(bv, at_ref[1].shape)
                                          if complete else bv, at_ref[1]))
                    rows.append(dict(path=path, B=B, dir="atx", impl=name,
                                     ms=t * 1e3, err=err))
            for r in rows:
                if r.get("printed"):
                    continue
                r["printed"] = True
                r["packed_GBps"] = packed / (r["ms"] * 1e-3) / 1e9
                print(f"{r['path']:8s} B={r['B']:<3d} {r['dir']:3s} "
                      f"{r['impl']:24s} {r['ms']:10.3f} ms "
                      f"{r['packed_GBps']:8.1f} GB/s packed  err="
                      f"{r.get('err')}  | {card}", flush=True)
            del W, U, V, ax_ref, at_ref
        del words
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(device=jax.devices()[0].device_kind, card=card,
                           N=args.N, M=args.M, rows=rows), f, indent=1)


if __name__ == "__main__":
    main()
