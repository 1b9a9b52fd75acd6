"""Native .bed loader throughput: C++/OpenMP reader vs the numpy fallback.

Measures the host-side cost of getting a packed PLINK file into the
word-major planar layout the kernels consume (reference analog: MPI-IO
read + no transform, data.cpp:201-234 — the reference keeps byte-major
and pays the layout cost inside every matvec instead).

Usage: python tools/bench_loader.py [N] [M]     (defaults 65536 16384)
CPU-only; needs no accelerator.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from gvamp import native
from gvamp.ops.layout import PlanarLayout

N = int(sys.argv[1]) if len(sys.argv) > 1 else 65536
M = int(sys.argv[2]) if len(sys.argv) > 2 else 16384


def main():
    lay = PlanarLayout.create(N)
    Mpad = ((M + 511) // 512) * 512
    rng = np.random.default_rng(0)
    bed = rng.integers(0, 256, size=(M, lay.mbytes), dtype=np.uint8)
    path = "/tmp/bench_loader.bed"
    with open(path, "wb") as f:
        f.write(bytes([0x6C, 0x1B, 0x01]))
        f.write(bed.tobytes())
    gb = bed.nbytes / 1e9
    print(f"# bed payload {gb:.2f} GB (N={N}, M={M})", flush=True)

    lib = native.get_lib()
    print(f"# native lib: {'loaded' if lib else 'UNAVAILABLE'}", flush=True)

    # file -> planar words (pread + cache-blocked transpose), native
    best = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        w_native = native.read_bed_words(path, N, M, 0, lay.n_words, Mpad)
        best = min(best, time.perf_counter() - t0)
    if w_native is not None:
        print(f"native file->words: {best:.3f} s  ({gb / best:.2f} GB/s)",
              flush=True)

    # in-memory bytes -> planar words, native
    best_m = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        w_mem = native.bed_to_words(bed, N, lay.n_words, Mpad)
        best_m = min(best_m, time.perf_counter() - t0)
    if w_mem is not None:
        print(f"native bytes->words: {best_m:.3f} s  ({gb / best_m:.2f} GB/s)",
              flush=True)

    # numpy fallback (what environments without a toolchain pay)
    t0 = time.perf_counter()
    w_np = np.full((lay.n_words, Mpad), 0x55555555, dtype=np.uint32)
    w_np[:, :M] = lay.pack_words(bed).T
    dt_np = time.perf_counter() - t0
    print(f"numpy bytes->words: {dt_np:.3f} s  ({gb / dt_np:.2f} GB/s)",
          flush=True)

    if w_native is not None:
        assert np.array_equal(w_native, w_np), "native != numpy layout"
        print(f"# layouts identical; native speedup {dt_np / best_m:.1f}x "
              f"over numpy", flush=True)


if __name__ == "__main__":
    main()
