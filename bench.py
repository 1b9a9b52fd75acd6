"""Benchmark: wall-clock per linear-VAMP iteration on a GPU.

    python bench.py

Config A (headline, BASELINE.json configs[0]): linear VAMP on simulated
data, N=5k, M=20k, 3-component mixture, CG LMMSE.  The reference publishes
no numbers (BASELINE.md), so its baseline was measured: the reference C++
(g++ -march=native -DMANVECT -Ofast, single-rank MPI stub, one CPU core
with AVX-512) on this exact config takes 2.09 s per VAMP iteration
(BASELINE.md "Measured").  vs_baseline is that number over ours.

Config B: the same engine at N=327,680, M=131,072 (10.74 GB packed),
complete genotypes, then (Bm) with ~1.6% missing calls; config X: the
N << M regime (N=5,120, M=524,288), dual against primal.  Their numbers
are extra fields on the same JSON line.  Skip them with BENCH_FAST=1.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}
with the device it ran on.  Fails when JAX finds no GPU.
"""

import json
import os
import sys
import time

import numpy as np

N = int(os.environ.get("BENCH_N", 5000))
M = int(os.environ.get("BENCH_M", 20480))
K_ITERS = int(os.environ.get("BENCH_ITERS", 8))
# config B: NW=20480 words -> N=327,680 individuals; 10.74 GB packed
BW_N = int(os.environ.get("BENCH_BW_N", 327680))
BW_M = int(os.environ.get("BENCH_BW_M", 131072))
BW_ITERS = int(os.environ.get("BENCH_BW_ITERS", 2))


def synth_geno(N, M, miss=False):
    """(GenoBed over packed words synthesized on the device, layout, Mpad);
    see sim.synth_words."""
    from gvamp import sim
    from gvamp.data import GenoBed

    words = sim.synth_words(N, M, miss=miss)
    geno = GenoBed.from_device_words(words, np.zeros(N), N=N, M=M,
                                     standardize_phen=False)
    return geno, geno.layout, words.shape[1]


def run_config(N, M, k_iters, warm_steps=2, miss=False, use_xxt=False,
               cg_extrapolate=None):
    """Build the sim problem, run the scan-mode engine, return timings."""
    import jax
    from gvamp import linear, sim

    rng = np.random.default_rng(0)
    geno, lay, mpad = synth_geno(N, M, miss=miss)
    vars_t, probs_t = sim.two_group_prior(M, 1000, 0.5)
    beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
    y = sim.simulate_linear_phenotype(geno, beta[:M], 2.0, rng)
    geno.set_phen(y)

    if cg_extrapolate is None:  # default ON (VampConfig round-5 default);
        # BENCH_CG_EXTRAPOLATE=0 is the A/B kill-switch
        cg_extrapolate = bool(int(os.environ.get("BENCH_CG_EXTRAPOLATE", 1)))
    cfg = linear.VampConfig(max_iter=k_iters + warm_steps, rho=0.15,
                            gam1_init=1e-8, gamw_init=2.0, use_xxt=use_xxt,
                            cg_extrapolate=cg_extrapolate and not use_xxt)
    state = linear.init_state(geno, cfg, probs_t, vars_t)
    aux = linear.make_aux(geno, cfg)
    step = linear.make_step(geno, cfg)
    scan_step = linear.make_scan_step(geno, cfg, k_iters)

    # warmup: compile + iterations until CG counts stabilize, then TWO scan
    # executions (the first post-compile run pays one-time autotuning)
    for _ in range(warm_steps):
        state, metrics = step(state, aux)
    _s, _m = scan_step(state, aux)
    float(_m["gam1"][-1])  # sync
    _s, _m = scan_step(state, aux)
    float(_m["gam1"][-1])

    # throughput mode: K iterations per dispatch (linear.make_scan_step),
    # best of 3
    best = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        state, metrics = scan_step(state, aux)
        metrics = {k: np.asarray(v)[-1]
                   for k, v in jax.device_get(metrics).items()}
        best = min(best, time.perf_counter() - t0)
    dt_iter = best / k_iters
    cg_it = float(metrics["cg_iters"])
    probe_it = float(metrics["probe_iters"])

    # single-pass-equivalents per iteration: joint block CG (the init mult
    # is tracked — only the amortized 1/gram_refresh refresh tick pays a
    # pass), each CG mult two passes (ax + atx); ATy and A@bern are
    # precomputed in aux.
    mult_passes = 2
    if use_xxt:
        # dual mode: tracked init mult (gmu_n — amortized 1/gram_refresh
        # refresh tick) + the wide [r2, x1] forward pass + the
        # x2-extraction atx
        passes = (mult_passes * (max(cg_it, probe_it)
                                 + 1.0 / max(cfg.gram_refresh, 1)) + 1 + 1)
    else:
        # fold_noise: the noise-EM pass disappears (resid2/trace_corr via
        # the CG exit Gram identity, z1 rides the first CG iteration's
        # forward pass)
        noise_pass = 1 if (not cfg.fold_noise
                           or os.environ.get("GVAMP_NOISE_PASS") == "1") else 0
        passes = (mult_passes * (max(cg_it, probe_it)
                                 + 1.0 / max(cfg.gram_refresh, 1)) + noise_pass)
    packed_bytes = lay.n_words * 4 * mpad
    return dict(dt_iter=dt_iter, passes=passes, packed_bytes=packed_bytes,
                gbs=passes * packed_bytes / dt_iter / 1e9,
                cg_it=cg_it, gam1=float(metrics["gam1"]))


def main():
    from gvamp import runtime

    devs = runtime.require_gpu()
    runtime.enable_compile_cache()
    card = runtime.card_info()
    print(f"# {card}", file=sys.stderr)
    a = run_config(N, M, K_ITERS)

    # ---- measured reference baseline (BASELINE.md): the reference C++ at
    # 2.09 s/iteration on one CPU core (AVX-512, -DMANVECT -Ofast)
    REF_ITER_S = 2.09
    out = {
        "metric": "linear_vamp_iter_wallclock_N5k_M20k",
        "value": round(a["dt_iter"] * 1e3, 3),
        "unit": "ms",
        "vs_baseline": round(REF_ITER_S / a["dt_iter"], 2),
        "device": {"platform": devs[0].platform, "kind": devs[0].device_kind,
                   "count": len(devs)},
        "card": card,
    }
    print(f"# A: passes/it={a['passes']:.0f} "
          f"packed={a['packed_bytes']/1e9:.2f}GB "
          f"eff_bandwidth={a['gbs']:.0f}GB/s "
          f"gam1={a['gam1']:.4g} cg_it={a['cg_it']:.0f}", file=sys.stderr)

    if os.environ.get("BENCH_FAST", "") != "1":
        try:
            b = run_config(BW_N, BW_M, BW_ITERS, warm_steps=1)
            out.update(
                bw_config=f"N{BW_N}_M{BW_M}",
                bw_packed_gb=round(b["packed_bytes"] / 1e9, 2),
                bw_iter_s=round(b["dt_iter"], 3),
                bw_passes=int(b["passes"]),
                bw_gbs=round(b["gbs"], 1),
            )
            print(f"# B: packed={b['packed_bytes']/1e9:.2f}GB "
                  f"iter={b['dt_iter']:.3f}s passes={b['passes']:.0f} "
                  f"bandwidth={b['gbs']:.0f}GB/s cg_it={b['cg_it']:.0f}",
                  file=sys.stderr)
        except Exception as e:  # never lose the headline metric
            print(f"# B failed: {type(e).__name__}: {str(e)[:200]}",
                  file=sys.stderr)

        # ---- config Bm: config-B scale WITH missing genotypes (~1.6%) —
        # the general-kernel path real (non-imputed) cohorts pay
        try:
            bm = run_config(BW_N, BW_M, BW_ITERS, warm_steps=1, miss=True)
            out.update(
                bw_miss_iter_s=round(bm["dt_iter"], 3),
                bw_miss_gbs=round(bm["gbs"], 1),
            )
            print(f"# Bm (miss): iter={bm['dt_iter']:.3f}s "
                  f"passes={bm['passes']:.0f} bandwidth={bm['gbs']:.0f}GB/s "
                  f"cg_it={bm['cg_it']:.0f}", file=sys.stderr)
        except Exception as e:
            print(f"# Bm failed: {type(e).__name__}: {str(e)[:200]}",
                  file=sys.stderr)

        # ---- config X: the dual/XXT regime N<<M (N=5k, M=524k) — dual
        # N-space CG vs the primal M-space solve
        try:
            xn = int(os.environ.get("BENCH_XXT_N", 5120))
            xm = int(os.environ.get("BENCH_XXT_M", 524288))
            xd = run_config(xn, xm, 4, warm_steps=1, use_xxt=True)
            xp = run_config(xn, xm, 4, warm_steps=1, use_xxt=False)
            out.update(
                xxt_config=f"N{xn}_M{xm}",
                xxt_iter_s=round(xd["dt_iter"], 4),
                xxt_primal_iter_s=round(xp["dt_iter"], 4),
            )
            print(f"# X (N<<M): dual={xd['dt_iter']:.4f}s/it "
                  f"(cg={xd['cg_it']:.0f}) primal={xp['dt_iter']:.4f}s/it "
                  f"(cg={xp['cg_it']:.0f})", file=sys.stderr)
        except Exception as e:
            print(f"# X failed: {type(e).__name__}: {str(e)[:200]}",
                  file=sys.stderr)

    print(json.dumps(out))


if __name__ == "__main__":
    main()
