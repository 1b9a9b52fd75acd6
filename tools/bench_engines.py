"""Per-iteration wall-clock for ALL engine families at production scale.

One 3.36 GB complete-genotype packed matrix (N=102,400 x M=131,072),
one GPU, all four engines in throughput (scan) mode so the numbers
measure the device, not per-dispatch host latency:

  - linear single-trait   (reference main_real.cpp driver analog)
  - probit                (main_real_probit.cpp)
  - Huber                 (main_real_Huber.cpp)
  - multi-trait linear T=8 (beyond-reference batching; target: <= 1.0x
    one trait per iteration)

Each engine: init + 2 per-dispatch warm steps (compile + CG-count
stabilization), one throwaway scan dispatch (autotuning), then
best-of-3 timed scans of K iterations.  Prints one JSON line with
{engine: s_per_iter} plus the T=8-vs-single ratio.

Usage: python tools/bench_engines.py [N] [M] [K]
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
T = int(os.environ.get("BENCH_T", 8))


def time_scan(init_fn, aux_fn, step_fn, scan_fn, warm=2):
    """Common timing harness: warm steps, throwaway scan, best-of-3 scans."""
    import jax

    state, aux = init_fn(), aux_fn()
    step, scan = step_fn(), scan_fn()
    for _ in range(warm):
        state, _ = step(state, aux)
    jax.block_until_ready(state)
    state, _ = scan(state, aux)
    jax.block_until_ready(state)
    best = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        state, _ = scan(state, aux)
        jax.block_until_ready(state)
        best = min(best, time.perf_counter() - t0)
    return best / K


def main():
    import jax

    from gvamp import runtime

    runtime.require_gpu()
    runtime.enable_compile_cache()
    print(f"# {runtime.card_info()}", flush=True)

    import bench  # repo-root bench.py: synth_geno
    from gvamp import linear, multi, probit, robust, sim

    geno, lay, mpad = bench.synth_geno(N, M)
    print(f"# backend={jax.default_backend()} "
          f"packed={lay.n_words * 4 * mpad / 1e9:.2f} GB N={N} M={M} K={K}",
          flush=True)
    rng = np.random.default_rng(0)
    vars_t, probs_t = sim.two_group_prior(M, 1000, 0.5)
    beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
    out = {}

    # ---- linear single-trait ------------------------------------------
    y = sim.simulate_linear_phenotype(geno, beta[:M], 2.0, rng)
    geno.set_phen(y)
    cfg = linear.VampConfig(max_iter=K + 8, rho=0.15, gam1_init=1e-8,
                            gamw_init=2.0, stop_criteria_thr=0.0)
    out["linear_s_it"] = time_scan(
        lambda: linear.init_state(geno, cfg, probs_t, vars_t),
        lambda: linear.make_aux(geno, cfg),
        lambda: linear.make_step(geno, cfg),
        lambda: linear.make_scan_step(geno, cfg, K))
    print(f"# linear: {out['linear_s_it']:.4f} s/it", flush=True)

    # ---- probit --------------------------------------------------------
    yb = sim.simulate_probit_phenotype(geno, beta[:M], 1.0, rng)
    geno.set_phen(yb)
    pcfg = probit.ProbitConfig(max_iter=K + 8, rho=0.3, seed=2,
                               stop_criteria_thr=0.0)
    out["probit_s_it"] = time_scan(
        lambda: probit.init_state(geno, pcfg, probs_t, vars_t),
        lambda: probit.make_aux(geno, pcfg),
        lambda: probit.make_step(geno, pcfg),
        lambda: probit.make_scan_step(geno, pcfg, K))
    print(f"# probit: {out['probit_s_it']:.4f} s/it", flush=True)

    # ---- Huber ---------------------------------------------------------
    xpad = geno.pad_m(beta[:M] * np.sqrt(N))
    g = geno.deplanarize(geno.ax(xpad))[:N]
    geno.set_phen(g + rng.standard_t(3.0, N) * 0.5)
    rcfg = robust.RobustConfig(max_iter=K + 8, rho=0.3, seed=5,
                               stop_criteria_thr=0.0, mc_steps=100)
    out["huber_s_it"] = time_scan(
        lambda: robust.init_state(geno, rcfg, probs_t, vars_t),
        lambda: robust.make_aux(geno, rcfg),
        lambda: robust.make_step(geno, rcfg),
        lambda: robust.make_scan_step(geno, rcfg, K))
    print(f"# huber: {out['huber_s_it']:.4f} s/it", flush=True)

    # ---- multi-trait linear T=8 ----------------------------------------
    ys = [sim.simulate_linear_phenotype(
              geno, sim.simulate_mixture(np.random.default_rng(t), M,
                                         vars_t, probs_t)[:M],
              2.0, np.random.default_rng(100 + t))
          for t in range(T)]
    mp = multi.MultiPhen.build(geno, ys, standardize=False)
    out["multi8_s_it"] = time_scan(
        lambda: multi.init_state(mp, cfg, probs_t, vars_t),
        lambda: multi.make_aux(mp, cfg),
        lambda: multi.make_step(mp, cfg),
        lambda: multi.make_scan_step(multi.make_step, mp, cfg, K))
    out["multi8_vs_single"] = round(out["multi8_s_it"] / out["linear_s_it"], 3)
    out["multi8_effective_x"] = round(T / out["multi8_vs_single"], 2)
    print(f"# multi T={T}: {out['multi8_s_it']:.4f} s/it "
          f"({out['multi8_vs_single']}x one trait = "
          f"{out['multi8_effective_x']}x effective)", flush=True)

    out = {k: (round(v, 4) if isinstance(v, float) else v)
           for k, v in out.items()}
    out["backend"] = jax.default_backend()
    out["config"] = f"N{N}_M{M}_K{K}"
    print(json.dumps(out))


if __name__ == "__main__":
    main()
