"""Huber engine lever study at production scale (VERDICT r4 #2).

The Huber model's reference-faithful dynamics (sign-mixed beta1
derivative, vamp_Huber.cpp:485-503) drive tau2 through ~10 orders of
magnitude; the LMMSE operator conditioning explodes and the CG saturates
its 60-iteration budget on most iterations (the reference pays the same
budget, options.hpp:110).  This study measures the repo's levers TOGETHER
on the N=102,400 x M=131,072 config at stab_gamma=1 (reference dynamics
preserved):

  probe      use_slq=0            round-4 baseline (probe CG columns)
  slq        use_slq=1 (default)  alpha2 via Lanczos quadrature
  slq+d128   + deflate_k=128      exact inverse on the top-128 subspace
  slq+d256   + deflate_k=256
  slq+p6     + cg_plateau=6       tighter stagnation exit
  slq+d256p6 both

Each config runs max_iter=2+K iterations (2 warm single steps, then ONE
timed K-iteration scan — the honest mix of warm and CG-saturated
windows, not a best-of-3 lottery over 4-iteration windows) and reports
s/it, the mean/max CG iterations, and corr(x1, truth) at the end — the
quality gate: every lever must reproduce the probe baseline's trajectory.

Usage: python tools/bench_huber.py [N] [M] [K]     (defaults 102400 131072 12)
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

N = int(sys.argv[1]) if len(sys.argv) > 1 else 102400
M = int(sys.argv[2]) if len(sys.argv) > 2 else 131072
K = int(sys.argv[3]) if len(sys.argv) > 3 else 12


def main():
    import jax

    from gvamp import runtime

    runtime.require_gpu()
    runtime.enable_compile_cache()
    print(f"# {runtime.card_info()}", flush=True)

    import bench  # repo-root bench.py: synth_geno
    from gvamp import robust, sim

    geno, lay, mpad = bench.synth_geno(N, M)
    gb = lay.n_words * 4 * mpad / 1e9
    print(f"# backend={jax.default_backend()} packed={gb:.2f} GB "
          f"N={N} M={M} K={K}", flush=True)
    rng = np.random.default_rng(0)
    vars_t, probs_t = sim.two_group_prior(M, 1000, 0.5)
    beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
    xpad = geno.pad_m(beta[:M] * np.sqrt(N))
    g = geno.deplanarize(geno.ax(xpad))[:N]
    geno.set_phen(g + rng.standard_t(3.0, N) * 0.5)

    configs = {
        "probe": dict(use_slq=False),
        "slq": dict(),
        "slq_d128": dict(deflate_k=128),
        "slq_d256": dict(deflate_k=256),
        "slq_p6": dict(cg_plateau=6),
        "slq_d256_p6": dict(deflate_k=256, cg_plateau=6),
        # the supported throughput mode: --stab-gamma bounds the tau1/gam1
        # log-steps, keeping the LMMSE operator conditioned (an extension;
        # reference dynamics = 1.0)
        "slq_sg09": dict(stab_gamma=0.9),
    }
    sel = os.environ.get("HUBER_CONFIGS", "")
    if sel:
        configs = {k: v for k, v in configs.items() if k in sel.split(",")}

    out = {"config": f"N{N}_M{M}_K{K}", "packed_gb": round(gb, 2)}
    for name, kw in configs.items():
        cfg = robust.RobustConfig(max_iter=K + 2, rho=0.3, seed=5,
                                  stop_criteria_thr=0.0, mc_steps=100, **kw)
        t_setup0 = time.perf_counter()
        state = robust.init_state(cfg=cfg, geno=geno, probs=probs_t,
                                  vars_user=vars_t)
        aux = robust.make_aux(geno, cfg)
        jax.block_until_ready(aux.bern)
        if aux.slq is not None:
            jax.block_until_ready(aux.slq.lam)
        if aux.defl is not None:
            jax.block_until_ready(aux.defl[1])
        setup_s = time.perf_counter() - t_setup0
        step = robust.make_step(geno, cfg)
        scan = robust.make_scan_step(geno, cfg, K)
        for _ in range(2):
            state, m = step(state, aux)
        jax.block_until_ready(state)
        # compile the scan before timing it
        t0 = time.perf_counter()
        state, ms = scan(state, aux)
        ms = jax.device_get(ms)
        dt = (time.perf_counter() - t0)
        # the first scan call pays compile; run once more for the timing
        # ONLY if the compile window dominated (cheap guard: a second scan
        # would double the study's wall-clock at 60-it CG saturation)
        cg_its = np.asarray(ms["cg_iters"]).ravel()
        x1 = np.asarray(jax.device_get(state.x1))[:M]
        corr = float(np.corrcoef(x1, beta[:M])[0, 1])
        out[name] = dict(s_it_incl_compile=round(dt / K, 4),
                         setup_s=round(setup_s, 2),
                         cg_mean=round(float(cg_its.mean()), 1),
                         cg_max=int(cg_its.max()),
                         corr=round(corr, 5),
                         tau1_last=float(np.asarray(ms["tau1"]).ravel()[-1]))
        # timed re-scan (no compile): the honest steady-state number
        t0 = time.perf_counter()
        state2, ms2 = scan(state, aux)
        jax.device_get(ms2["cg_iters"])
        out[name]["s_it"] = round((time.perf_counter() - t0) / K, 4)
        out[name]["cg_mean2"] = round(
            float(np.asarray(ms2["cg_iters"]).mean()), 1)
        print(f"# {name}: {out[name]['s_it']:.4f} s/it "
              f"(cg mean {out[name]['cg_mean']}→{out[name]['cg_mean2']}, "
              f"max {out[name]['cg_max']}; setup {setup_s:.1f}s; "
              f"corr {corr:.5f})", flush=True)

    print(json.dumps(out))


if __name__ == "__main__":
    main()
