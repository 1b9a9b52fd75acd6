"""LMMSE CG residual-tolerance study (round 5).

With SLQ supplying alpha2 and the noise-EM trace (linear.VampConfig
.use_slq), the block CG's remaining job is the LMMSE column x2 itself —
the Onsager/trace estimates no longer depend on CG solve quality.  The
reference's hardcoded 1e-5 relative-residual exit (vamp.cpp:1217) is far
below the statistical error of x2 as an MMSE estimate (per-coordinate
posterior sd ~ 1/sqrt(eta2), orders above a 1e-4-relative CG residual)
and below the f32 engine's own noise floor.  This study measures what a
relaxed exit actually does to inference at biobank scale: full runs at
tol in {1e-5 (reference), 3e-5, 1e-4, 3e-4}, recording the
corr-vs-truth / gamw / R2 trajectories, the steady-state CG iteration
count, and per-iteration wall-clock.

Usage: python tools/bench_cgtol.py [N] [M] [ITERS]   (default config B)
Fails when JAX finds no GPU.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

N = int(sys.argv[1]) if len(sys.argv) > 1 else 327680
M = int(sys.argv[2]) if len(sys.argv) > 2 else 131072
ITERS = int(sys.argv[3]) if len(sys.argv) > 3 else 12


def main():
    import jax

    from gvamp import runtime

    runtime.require_gpu()
    runtime.enable_compile_cache()
    print(f"# {runtime.card_info()}", flush=True)

    import bench
    from gvamp import linear, sim

    geno, lay, mpad = bench.synth_geno(N, M)
    print(f"# backend={jax.default_backend()} "
          f"packed={lay.n_words * 4 * mpad / 1e9:.2f} GB N={N} M={M}",
          flush=True)
    rng = np.random.default_rng(0)
    vars_t, probs_t = sim.two_group_prior(M, 5000, 0.5)
    beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
    y = sim.simulate_linear_phenotype(geno, beta[:M], 2.0,
                                      np.random.default_rng(1))
    geno.set_phen(y)

    out = {"config": f"N{N}_M{M}_I{ITERS}"}
    ref_traj = None
    for tol in (1e-5, 3e-5, 1e-4, 3e-4):
        cfg = linear.VampConfig(max_iter=ITERS, rho=0.15, gam1_init=1e-8,
                                gamw_init=2.0, stop_criteria_thr=0.0,
                                cg_err_tol=tol)
        t0 = time.perf_counter()
        x_hat, state, hist = linear.infer(geno, cfg, probs_t, vars_t,
                                          true_signal=beta[:M], verbose=False,
                                          sync_every=4)
        wall = time.perf_counter() - t0
        corr = float(np.corrcoef(x_hat, beta[:M])[0, 1])
        traj = {k: np.array([float(h[k]) for h in hist])
                for k in ("corr_x1", "gamw", "R2_train_1", "gam1")}
        cg = np.array([int(h["cg_iters"]) for h in hist])
        row = dict(corr=round(corr, 6),
                   gamw=round(float(traj["gamw"][-1]), 5),
                   R2=round(float(traj["R2_train_1"][-1]), 5),
                   cg_mean=round(float(cg.mean()), 2),
                   cg_last=int(cg[-1]), wall_s=round(wall, 1))
        if ref_traj is None:
            ref_traj = traj
            row["traj_dev"] = 0.0
        else:
            # max relative deviation of the corr trajectory vs tol=1e-5
            # (it-1 has x1 = 0 -> corr NaN for every tol; compare where
            # the reference trajectory is finite)
            ok = np.isfinite(ref_traj["corr_x1"])
            dev = float(np.max(
                np.abs(traj["corr_x1"][ok] - ref_traj["corr_x1"][ok])
                / np.maximum(np.abs(ref_traj["corr_x1"][ok]), 1e-12)))
            row["traj_dev"] = round(dev, 8)
        out[f"tol_{tol:g}"] = row
        print(f"# tol={tol:g}: corr={row['corr']:.6f} gamw={row['gamw']} "
              f"R2={row['R2']} cg_mean={row['cg_mean']} "
              f"corr-traj max rel dev vs 1e-5: {row['traj_dev']:.2e} "
              f"({wall:.0f}s incl compile)", flush=True)

    print(json.dumps(out))


if __name__ == "__main__":
    main()
