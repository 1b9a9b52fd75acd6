"""Open-ended randomized robustness sweep across every engine and flag axis.

Broader than tests/test_fuzz.py's fixed cases: each trial draws a random
configuration over (shape, missingness, phenotype NAs, model family incl.
the three multi-trait engines, dtype, h2, sync_every scan mode,
gram_refresh, deflation, n_probes, XXT, --red, learn_vars, covariates)
and checks the run stays finite.  Non-finite anything = FAIL (with the
full config echoed for reproduction); a finite run with weak signal
correlation = WARN (VAMP is legitimately fragile at small N, so only
blowups are bugs).

Designed for idle-CPU soak runs:  nice -n 19 python tools/fuzz_extended.py
[n_trials] [seed0] >> /tmp/fuzz_ext.log 2>&1 &
"""
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def make_bed(codes):
    M, N = codes.shape
    mb = (N + 3) // 4
    by = np.zeros((M, mb), dtype=np.uint8)
    for k in range(4):
        cols = np.arange(k, N, 4)
        by[:, (cols - k) // 4] |= (codes[:, cols].astype(np.uint8) << (2 * k))
    return by


def _corr(x, beta):
    """corr(x, truth), robust to degenerate draws: a mixture draw with zero
    causal markers (possible at small M) makes corrcoef NaN with no engine
    involvement — score it 1.0 so only real blowups fail."""
    x, beta = np.asarray(x), np.asarray(beta)
    if x.std() == 0.0 or beta.std() == 0.0:
        return 1.0 if np.isfinite(x).all() else np.nan
    return np.corrcoef(x, beta)[0, 1]


def run_trial(seed):
    import jax.numpy as jnp

    from gvamp import linear, multi, probit, robust, sim
    from gvamp.data import GenoBed

    rng = np.random.default_rng(seed)
    N = int(rng.integers(150, 1600))
    M = int(rng.integers(96, 900))
    miss = float(rng.choice([0.0, 0.0, 0.01, 0.05, 0.2]))
    model = str(rng.choice(["linear", "linear", "bin_class", "robust",
                            "multi-linear", "multi-probit", "multi-robust"]))
    dtype = jnp.float32 if rng.random() < 0.7 else jnp.float64
    h2 = float(rng.uniform(0.2, 0.95))
    sync_every = int(rng.choice([1, 1, 3, 4]))
    gram_refresh = int(rng.choice([1, 8, 3]))
    # deflation is engine-agnostic since the op-argument fix (round 5)
    deflate_k = int(rng.choice([0, 0, 0, 4])) \
        if not model.startswith("multi") or rng.random() < 0.3 else 0
    n_probes = int(rng.choice([1, 1, 2]))
    use_xxt = bool(model == "linear" and M > N and rng.random() < 0.7)
    red = bool(model == "linear" and not use_xxt and N >= 640
               and rng.random() < 0.15)
    learn_vars = bool(rng.random() < 0.5)
    T = int(rng.integers(2, 5)) if model.startswith("multi") else 1
    max_iter = int(rng.integers(4, 8))
    use_slq = bool(rng.random() < 0.7)           # SLQ default vs probe path
    slq_k = int(rng.choice([8, 16, 32]))
    cg_plateau = int(rng.choice([12, 12, 0, 6]))  # incl. red x plateau
    fold_noise = bool(rng.random() < 0.8)         # fold kill-switch A/B
    resume_mid = bool(rng.random() < 0.25 and max_iter >= 5)
    cfgd = dict(max_iter=max_iter, rho=0.25, gam1_init=1e-8,
                gram_refresh=gram_refresh, n_probes=n_probes,
                learn_vars=learn_vars, stop_criteria_thr=0.0,
                use_slq=use_slq, slq_k=slq_k, cg_plateau=cg_plateau,
                fold_noise=fold_noise, deflate_k=deflate_k)

    desc = (f"seed={seed} N={N} M={M} miss={miss} model={model} "
            f"dt={'f32' if dtype == jnp.float32 else 'f64'} h2={h2:.2f} "
            f"sync={sync_every} gr={gram_refresh} defl={deflate_k} "
            f"P={n_probes} xxt={use_xxt} red={red} lv={learn_vars} T={T} "
            f"it={max_iter} slq={int(use_slq)}k{slq_k} plat={cg_plateau} "
            f"fold={int(fold_noise)} resume={int(resume_mid)}")

    codes = sim.random_genotypes(rng, M, N, miss_rate=miss)
    geno = GenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                               standardize_phen=False, dtype=dtype)
    cv = max(M // 20, 2)
    vars_t, probs_t = sim.two_group_prior(M, cv, h2)

    def phen(bmodel, beta, r):
        if bmodel == "bin_class":
            return sim.simulate_probit_phenotype(geno, beta, 1.0, r)
        y = sim.simulate_linear_phenotype(geno, beta, 1.0 / (1.0 - h2), r)
        y[r.choice(N, max(N // 40, 1), replace=False)] = np.nan
        return y

    base = model.split("-")[-1] if model.startswith("multi") else model
    base = {"linear": "linear", "probit": "bin_class", "bin_class":
            "bin_class", "robust": "robust"}[base]
    betas = [sim.simulate_mixture(rng, M, vars_t, probs_t)
             for _ in range(max(T, 1))]
    ys = [phen(base, b, rng) for b in betas]

    def drive(run_fn, cfg_cls, target, state_cls, extra=None):
        """Run the engine; with resume_mid, split the run at max_iter//2
        through a full save_state/load_state file round-trip (the --resume
        surface) and continue to the full budget."""
        kw = dict(cfgd)
        if extra:
            kw.update(extra)
        if resume_mid:
            import dataclasses
            import tempfile

            from gvamp import ckpt

            cfg1 = cfg_cls(**{**kw, "max_iter": max_iter // 2})
            _, st1, _ = run_fn(target, cfg1, probs_t, vars_t,
                               verbose=False, sync_every=sync_every)
            with tempfile.TemporaryDirectory() as td:
                path = os.path.join(td, "fuzz_ck.npz")
                ckpt.save_state(path, st1, it=max_iter // 2, model=model,
                                cfg=dataclasses.asdict(cfg1))
                loaded, _ = ckpt.load_state(path, state_cls)
            return run_fn(target, cfg_cls(**kw), probs_t, vars_t,
                          verbose=False, sync_every=sync_every,
                          resume_state=loaded)
        return run_fn(target, cfg_cls(**kw), probs_t, vars_t,
                      verbose=False, sync_every=sync_every)

    if model.startswith("multi"):
        mp = multi.MultiPhen.build(geno, ys,
                                   standardize=(base != "bin_class"))
        eng = {"multi-linear": (multi.infer, linear.VampConfig,
                                multi.MultiState),
               "multi-probit": (multi.infer_probit, probit.ProbitConfig,
                                multi.ProbitMultiState),
               "multi-robust": (multi.infer_huber, robust.RobustConfig,
                                multi.HuberMultiState)}[model]
        run, cfg_cls, st_cls = eng
        x, state, hist = drive(run, cfg_cls, mp, st_cls)
        corr = min((_corr(x[:, t], betas[t]) for t in range(T)),
                   default=1.0)
    else:
        geno.set_phen(ys[0])
        if model == "linear":
            x, state, hist = drive(linear.infer, linear.VampConfig, geno,
                                   linear.LinState,
                                   extra=dict(use_xxt=use_xxt, red=red))
        elif model == "bin_class":
            x, state, hist = drive(probit.infer, probit.ProbitConfig, geno,
                                   probit.ProbitState)
        else:
            x, state, hist = drive(robust.infer, robust.RobustConfig, geno,
                                   robust.RobustState)
        corr = _corr(x, betas[0])

    bad = []
    if not np.isfinite(np.asarray(x)).all():
        bad.append("x non-finite")
    for k in ("gam1", "gam2", "tau1"):
        if k in hist[-1] and not np.isfinite(np.asarray(hist[-1][k])).all():
            bad.append(f"{k} non-finite")
    if not np.isfinite(corr):
        bad.append("corr non-finite")
    if bad:
        return "FAIL", desc + " :: " + ", ".join(bad)
    if corr < 0.1:
        return "WARN", desc + f" :: weak corr {corr:.3f}"
    return "OK", desc + f" :: corr {corr:.3f}"


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000
    seed0 = int(sys.argv[2]) if len(sys.argv) > 2 else 1000
    import jax
    jax.config.update("jax_enable_x64", True)  # make the f64 draws real f64
    fails = warns = 0
    for i in range(n):
        seed = seed0 + i
        t0 = time.time()
        try:
            status, msg = run_trial(seed)
        except Exception:
            status = "FAIL"
            msg = f"seed={seed} :: EXCEPTION\n" + traceback.format_exc()
        dt = time.time() - t0
        if status == "FAIL":
            fails += 1
        elif status == "WARN":
            warns += 1
        print(f"[{i + 1}/{n}] {status} ({dt:.0f}s) {msg}", flush=True)
    print(f"done: {fails} FAIL, {warns} WARN of {n}", flush=True)
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
