"""Multi-trait batching sweep: effective throughput vs T (round 5).

With SLQ removing the T*P probe columns from the block CG, the wide-RHS
width at trait count T is T CG columns + T rider columns, all riding one
decode pass of the packed matrix.  This sweep
measures the per-iteration cost at T in {4, 8, 16} against one trait on
the shared packed matrix, reporting effective-throughput multiples.

Usage: python tools/bench_multiT.py [N] [M] [K]   (defaults 102400 131072 4)
Fails when JAX finds no GPU.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

N = int(sys.argv[1]) if len(sys.argv) > 1 else 102400
M = int(sys.argv[2]) if len(sys.argv) > 2 else 131072
K = int(sys.argv[3]) if len(sys.argv) > 3 else 4


def main():
    import jax

    from gvamp import runtime

    runtime.require_gpu()
    runtime.enable_compile_cache()
    print(f"# {runtime.card_info()}", flush=True)

    import bench
    from tools.bench_engines import time_scan
    from gvamp import linear, multi, sim

    geno, lay, mpad = bench.synth_geno(N, M)
    print(f"# backend={jax.default_backend()} "
          f"packed={lay.n_words * 4 * mpad / 1e9:.2f} GB N={N} M={M} K={K}",
          flush=True)
    rng = np.random.default_rng(0)
    vars_t, probs_t = sim.two_group_prior(M, 1000, 0.5)
    beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
    cfg = linear.VampConfig(max_iter=K + 8, rho=0.15, gam1_init=1e-8,
                            gamw_init=2.0, stop_criteria_thr=0.0)

    y = sim.simulate_linear_phenotype(geno, beta[:M], 2.0, rng)
    geno.set_phen(y)
    single = time_scan(
        lambda: linear.init_state(geno, cfg, probs_t, vars_t),
        lambda: linear.make_aux(geno, cfg),
        lambda: linear.make_step(geno, cfg),
        lambda: linear.make_scan_step(geno, cfg, K))
    out = {"config": f"N{N}_M{M}_K{K}", "single_s_it": round(single, 4)}
    print(f"# single: {single:.4f} s/it", flush=True)

    for T in (4, 8, 16):
        ys = [sim.simulate_linear_phenotype(
                  geno, sim.simulate_mixture(np.random.default_rng(t), M,
                                             vars_t, probs_t)[:M],
                  2.0, np.random.default_rng(100 + t))
              for t in range(T)]
        mp = multi.MultiPhen.build(geno, ys, standardize=False)
        s_it = time_scan(
            lambda: multi.init_state(mp, cfg, probs_t, vars_t),
            lambda: multi.make_aux(mp, cfg),
            lambda: multi.make_step(mp, cfg),
            lambda: multi.make_scan_step(multi.make_step, mp, cfg, K))
        eff = T / (s_it / single)
        out[f"T{T}_s_it"] = round(s_it, 4)
        out[f"T{T}_effective_x"] = round(eff, 2)
        print(f"# T={T}: {s_it:.4f} s/it ({s_it / single:.3f}x one trait "
              f"= {eff:.2f}x effective)", flush=True)

    print(json.dumps(out))


if __name__ == "__main__":
    main()
