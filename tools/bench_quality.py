"""Biobank-scale inference-quality runs (the BASELINE.md headline rows).

Full inference (not a timing synthetic) at N=327,680 x M=131,072 —
10.74 GB packed, 5,000 causal markers, h2=0.5 — on one GPU:

  - linear: 12 VAMP iterations incl. compile; expect corr(x_hat, truth)
    ~0.98, train R2 ~ h2, gamw -> ~true 2.0
  - probit (binary phenotype): 10 iterations; expect corr ~0.92

A third mode reproduces the reference's PRODUCTION recipe (VERDICT r4 #5;
dnanexus_example/run_gvamp.sh:25-31): **30 iterations, the 23-component
default prior (utilities.cpp:91-140), rho 0.05, store-pvals** at the
config-B shape — the long-horizon f32-drift and EM-merge-dynamics pin the
12-iteration 3-component rows leave open.  Emits the full
corr/R2/gamw/prior trajectory plus the LOO p-value pass wall-clock.

Usage: python tools/bench_quality.py [linear|probit|both|production]
Fails when JAX finds no GPU.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

N, M = 327680, 131072


def run_linear(geno, lay, mpad, beta, probs_t, vars_t, rng):
    from gvamp import linear, sim

    y = sim.simulate_linear_phenotype(geno, beta[:M], 2.0, rng)
    geno.set_phen(y)
    cfg = linear.VampConfig(max_iter=12, rho=0.15, gam1_init=1e-8,
                            gamw_init=2.0)
    t0 = time.perf_counter()
    x_hat, state, hist = linear.infer(geno, cfg, probs_t, vars_t,
                                      true_signal=beta[:M], verbose=False,
                                      sync_every=4)
    wall = time.perf_counter() - t0
    corr = np.corrcoef(x_hat, beta[:M])[0, 1]
    print(f"linear: 12 its in {wall:.1f}s wall (incl. compile); "
          f"corr(x_hat, truth)={corr:.4f} "
          f"R2={float(hist[-1]['R2_train_1']):.4f} "
          f"gamw={float(hist[-1]['gamw']):.3f}", flush=True)


def run_probit(geno, lay, mpad, beta, probs_t, vars_t, rng):
    from gvamp import probit, sim

    y = sim.simulate_probit_phenotype(geno, beta[:M], 1.0, rng)
    geno.set_phen(y)
    cfg = probit.ProbitConfig(max_iter=10, rho=0.3, seed=2)
    t0 = time.perf_counter()
    x_hat, state, hist = probit.infer(geno, cfg, probs_t, vars_t,
                                      true_signal=beta[:M], verbose=False,
                                      sync_every=2)
    wall = time.perf_counter() - t0
    corr = np.corrcoef(x_hat, beta[:M])[0, 1]
    print(f"probit: 10 its in {wall:.1f}s wall (incl. compile); "
          f"corr(x_hat, truth)={corr:.4f}", flush=True)


def run_production(geno, lay, mpad, beta, rng):
    """The reference's production recipe at config-B scale: 30 iterations,
    23-component default prior, rho 0.05, LOO p-values at the end
    (dnanexus_example/run_gvamp.sh:25-31; utilities.cpp:91-140)."""
    import jax.numpy as jnp
    from gvamp import linear, sim
    from gvamp.ops import pvals as pv
    from gvamp.prior import initialize_prior

    y = sim.simulate_linear_phenotype(geno, beta[:M], 2.0, rng)
    geno.set_phen(y)
    probs23, vars23 = initialize_prior(None, None, N, M)
    extrap = bool(int(os.environ.get("BENCH_CG_EXTRAPOLATE", 1)))
    cfg = linear.VampConfig(max_iter=30, rho=0.05, gam1_init=1e-8,
                            gamw_init=2.0, stop_criteria_thr=0.0,
                            cg_extrapolate=extrap)
    t0 = time.perf_counter()
    x_hat, state, hist = linear.infer(geno, cfg, probs23, vars23,
                                      true_signal=beta[:M], verbose=False,
                                      sync_every=6)
    wall = time.perf_counter() - t0
    for h in hist:
        print(f"  it {int(h['it']):2d}: corr={float(h['corr_x1']):.4f} "
              f"R2={float(h['R2_train_1']):.4f} gamw={float(h['gamw']):.4f} "
              f"gam1={float(h['gam1']):.4g} cg={int(h['cg_iters'])} "
              f"n_live_comp={(np.asarray(h['probs']) > 1e-12).sum()}",
              flush=True)
    corr = np.corrcoef(x_hat, beta[:M])[0, 1]
    print(f"production: 30 its in {wall:.1f}s wall (incl. compile); "
          f"corr(x_hat, truth)={corr:.4f} "
          f"R2={float(hist[-1]['R2_train_1']):.4f} "
          f"gamw={float(hist[-1]['gamw']):.3f} (true 2.0)", flush=True)
    # store-pvals: the LOO pass over the full 10.74 GB packed matrix
    t0 = time.perf_counter()
    x_int = geno.pad_m(x_hat * np.sqrt(geno.N))
    z1 = geno.ax(x_int)
    p = pv.loo_pvals(geno, z1, jnp.asarray(x_int))
    t_pv = time.perf_counter() - t0
    causal = np.abs(beta[:M]) > 1e-12
    print(f"pvals: LOO over {lay.n_words * 4 * mpad / 1e9:.2f} GB in "
          f"{t_pv:.1f}s; median causal p={np.median(p[causal]):.3e} "
          f"null p={np.median(p[~causal]):.3f} "
          f"min p={p.min():.3e}", flush=True)


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else "both"
    import jax
    from gvamp import runtime

    runtime.require_gpu()
    runtime.enable_compile_cache()
    print(f"# {runtime.card_info()}", flush=True)

    import bench  # repo-root: synth_geno
    from gvamp import sim

    geno, lay, mpad = bench.synth_geno(N, M)
    print(f"# backend={jax.default_backend()} "
          f"packed={lay.n_words * 4 * mpad / 1e9:.2f} GB", flush=True)
    rng = np.random.default_rng(0)
    vars_t, probs_t = sim.two_group_prior(M, 5000, 0.5)
    beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
    if which in ("linear", "both"):
        run_linear(geno, lay, mpad, beta, probs_t, vars_t,
                   np.random.default_rng(1))
    if which in ("probit", "both"):
        run_probit(geno, lay, mpad, beta, probs_t, vars_t,
                   np.random.default_rng(2))
    if which == "production":
        run_production(geno, lay, mpad, beta, np.random.default_rng(1))


if __name__ == "__main__":
    main()
