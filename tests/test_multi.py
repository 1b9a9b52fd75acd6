"""Multi-trait engine: per-trait parity with independent single-trait runs."""

import numpy as np
import jax.numpy as jnp

from gvamp import linear, multi, sim
from gvamp.data import GenoBed
from test_data_layer import make_bed
import pytest

# engine-scale tests: excluded from the <5-min core tier (README: test tiers)
pytestmark = pytest.mark.slow


def _build(seed=23, N=500, M=256, T=3, h2s=(0.8, 0.5, 0.3)):
    rng = np.random.default_rng(seed)
    codes = sim.random_genotypes(rng, M, N, miss_rate=0.01)
    geno = GenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                               standardize_phen=False, dtype=jnp.float64)
    ys, betas, priors = [], [], []
    for t in range(T):
        vars_t, probs_t = sim.two_group_prior(M, 15, h2s[t])
        beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
        y = sim.simulate_linear_phenotype(geno, beta, 1 / (1 - h2s[t]), rng)
        if t == 1:  # one trait gets missing phenotypes
            y[rng.choice(N, 25, replace=False)] = np.nan
        ys.append(y)
        betas.append(beta)
        priors.append((probs_t, vars_t))
    return geno, codes, ys, betas, priors


def test_multi_trait_matches_single_runs():
    geno, codes, ys, betas, priors = _build()
    # all traits share the prior of trait 0 so the comparison is exact
    probs_t, vars_t = priors[0]
    cfg = linear.VampConfig(max_iter=5, rho=0.3, gam1_init=1e-8,
                            gamw_init=2.0, seed=3,
                            stop_criteria_thr=0.0)  # no early stop
    mp = multi.MultiPhen.build(geno, ys, standardize=False)
    xm, sm, hm = multi.infer(mp, cfg, probs_t, vars_t, verbose=False)

    for t, y in enumerate(ys):
        g1 = GenoBed.from_arrays(make_bed(codes), y, N=geno.N,
                                 standardize_phen=False, dtype=jnp.float64)
        xs, ss, hs = linear.infer(g1, cfg, probs_t, vars_t, verbose=False)
        np.testing.assert_allclose(xm[:, t], xs, rtol=1e-6, atol=1e-10)
        np.testing.assert_allclose(float(hm[-1]["gam1"][t]),
                                   float(hs[-1]["gam1"]), rtol=1e-6)
        np.testing.assert_allclose(float(hm[-1]["gamw"][t]),
                                   float(hs[-1]["gamw"]), rtol=1e-6)


def test_multi_trait_recovers_signals():
    geno, codes, ys, betas, priors = _build(N=800, M=400, T=2, h2s=(0.8, 0.6))
    probs_t, vars_t = priors[0]
    cfg = linear.VampConfig(max_iter=10, rho=0.3, gam1_init=1e-8,
                            gamw_init=2.0)
    mp = multi.MultiPhen.build(geno, ys, standardize=False)
    xm, sm, hm = multi.infer(mp, cfg, probs_t, vars_t, verbose=False)
    for t in range(2):
        corr = np.corrcoef(xm[:, t], betas[t])[0, 1]
        assert corr > 0.85, (t, corr)


def test_multi_trait_cli(tmp_path):
    """--phen-files a,b,c triggers the joint multi-trait run."""
    from gvamp import cli
    from gvamp.io import plink, vecio

    geno, codes, ys, betas, priors = _build(N=400, M=192, T=2, h2s=(0.8, 0.6))
    plink.write_bed(str(tmp_path / "m.bed"), codes)
    pfs = []
    for t, y in enumerate(ys):
        p = str(tmp_path / f"m{t}.phen")
        plink.write_phen(p, y)
        pfs.append(p)
    probs_t, vars_t = priors[0]
    cli.main([
        "--run-mode", "infere", "--model", "linear",
        "--bed-file", str(tmp_path / "m.bed"),
        "--phen-files", ",".join(pfs),
        "--N", str(geno.N), "--Mt", str(geno.M), "--iterations", "5",
        "--rho", "0.3",
        "--vars", ",".join(map(str, vars_t)),
        "--probs", ",".join(map(str, probs_t)),
        "--out-dir", str(tmp_path), "--out-name", "mt",
        "--dtype", "float64", "--verbosity", "0",
    ])
    for t in range(2):
        est = vecio.read_bin_shard(str(tmp_path / f"mt_phen{t}_it_5.bin"),
                                   geno.M, 0)
        corr = np.corrcoef(est, betas[t])[0, 1]
        assert corr > 0.7, (t, corr)


def test_multi_trait_shard_invariance():
    """Multi-trait results identical on 1 device and an 8-device mesh."""
    import jax

    geno1, codes, ys, betas, priors = _build(N=400, M=256, T=2, h2s=(0.8, 0.5))
    probs_t, vars_t = priors[0]
    cfg = linear.VampConfig(max_iter=3, rho=0.3, gam1_init=1e-8,
                            gamw_init=2.0, stop_criteria_thr=0.0)
    mp1 = multi.MultiPhen.build(geno1, ys, standardize=False)
    x1, s1, h1 = multi.infer(mp1, cfg, probs_t, vars_t, verbose=False)

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("m",))
    geno8 = GenoBed.from_arrays(make_bed(codes), np.zeros(geno1.N),
                                N=geno1.N, standardize_phen=False,
                                dtype=jnp.float64, mesh=mesh)
    mp8 = multi.MultiPhen.build(geno8, ys, standardize=False)
    x8, s8, h8 = multi.infer(mp8, cfg, probs_t, vars_t, verbose=False)
    np.testing.assert_allclose(x1, x8, rtol=1e-8, atol=1e-12)


def test_multi_zmodel_shard_invariance():
    """Multi-trait probit AND Huber results match between 1 device and an
    8-device marker mesh (the z-model engines reuse the same sharded
    matvec/psum machinery as the linear engine — reference collectives are
    model-agnostic, vamp_probit.cpp / vamp_Huber.cpp)."""
    import jax
    from gvamp import probit, robust

    rng = np.random.default_rng(61)
    N, M, T = 300, 192, 2
    codes = sim.random_genotypes(rng, M, N)
    geno1 = GenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                                standardize_phen=False, dtype=jnp.float64)
    vars_t, probs_t = sim.two_group_prior(M, 12, 0.8)
    ys_bin, ys_rob = [], []
    for t in range(T):
        beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
        ys_bin.append(sim.simulate_probit_phenotype(geno1, beta, 1.0, rng))
        x = geno1.pad_m(beta * np.sqrt(N))
        g = geno1.deplanarize(geno1.ax(jnp.asarray(x)))[:N]
        ys_rob.append(g + rng.standard_t(3.0, N) * 0.5)

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("m",))
    geno8 = GenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                                standardize_phen=False, dtype=jnp.float64,
                                mesh=mesh)

    # use_slq=False pins the EXACT f64 shard-invariance of the sharded
    # matvec/psum machinery (this test's subject).  The SLQ basis reduces
    # across shards in a different order (psum inside the Lanczos
    # recurrence), so its alpha2 is shard-invariant only to ~1e-12 raw —
    # amplified to ~1e-7 on x after 3 z-model iterations; checked at a
    # loose tolerance below.
    pcfg = probit.ProbitConfig(max_iter=3, rho=0.25, gam1_init=1e-8, seed=3,
                               stop_criteria_thr=0.0, use_slq=False)
    xp1, _, _ = multi.infer_probit(
        multi.MultiPhen.build(geno1, ys_bin, standardize=False),
        pcfg, probs_t, vars_t, verbose=False)
    xp8, _, _ = multi.infer_probit(
        multi.MultiPhen.build(geno8, ys_bin, standardize=False),
        pcfg, probs_t, vars_t, verbose=False)
    np.testing.assert_allclose(xp1, xp8, rtol=1e-8, atol=1e-12)

    pcfg_slq = probit.ProbitConfig(max_iter=3, rho=0.25, gam1_init=1e-8,
                                   seed=3, stop_criteria_thr=0.0)
    xs1, _, _ = multi.infer_probit(
        multi.MultiPhen.build(geno1, ys_bin, standardize=False),
        pcfg_slq, probs_t, vars_t, verbose=False)
    xs8, _, _ = multi.infer_probit(
        multi.MultiPhen.build(geno8, ys_bin, standardize=False),
        pcfg_slq, probs_t, vars_t, verbose=False)
    np.testing.assert_allclose(xs1, xs8, rtol=2e-5, atol=1e-9)

    # Huber: 3 iterations only — its gamma trajectory chaotically amplifies
    # ulp-level reduction-order differences past that;
    # use_slq=False for the same reason as the probit block above
    rcfg = robust.RobustConfig(max_iter=3, rho=0.25, gam1_init=1e-8, seed=3,
                               stop_criteria_thr=0.0, use_slq=False)
    xr1, _, _ = multi.infer_huber(
        multi.MultiPhen.build(geno1, ys_rob, standardize=False),
        rcfg, probs_t, vars_t, verbose=False)
    xr8, _, _ = multi.infer_huber(
        multi.MultiPhen.build(geno8, ys_rob, standardize=False),
        rcfg, probs_t, vars_t, verbose=False)
    np.testing.assert_allclose(xr1, xr8, rtol=1e-6, atol=1e-10)


def test_multi_probit_matches_single_runs():
    """Joint multi-trait probit == independent single probit runs."""
    from gvamp import probit

    rng = np.random.default_rng(41)
    N, M, T = 500, 256, 2
    codes = sim.random_genotypes(rng, M, N)
    geno = GenoBed.from_arrays(make_bed(codes), np.zeros(N),
                               standardize_phen=False, N=N, dtype=jnp.float64)
    vars_t, probs_t = sim.two_group_prior(M, 15, 0.8)
    ys, betas = [], []
    for t in range(T):
        beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
        ys.append(sim.simulate_probit_phenotype(geno, beta, 1.0, rng))
        betas.append(beta)

    cfg = probit.ProbitConfig(max_iter=4, rho=0.25, gam1_init=1e-8,
                              seed=3, stop_criteria_thr=0.0)
    mp = multi.MultiPhen.build(geno, ys, standardize=False)
    xm, sm, hm = multi.infer_probit(mp, cfg, probs_t, vars_t, verbose=False)

    for t, y in enumerate(ys):
        g1 = GenoBed.from_arrays(make_bed(codes), y, N=N,
                                 standardize_phen=False, dtype=jnp.float64)
        xs, ss, hs = probit.infer(g1, cfg, probs_t, vars_t, verbose=False)
        np.testing.assert_allclose(xm[:, t], xs, rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(float(hm[-1]["tau1"][t]),
                                   float(hs[-1]["tau1"]), rtol=1e-6)
        corr = np.corrcoef(xm[:, t], betas[t])[0, 1]
        assert corr > 0.3, (t, corr)


def test_multi_huber_matches_single_runs():
    """Joint multi-trait Huber == independent single robust runs."""
    from gvamp import robust

    rng = np.random.default_rng(51)
    N, M, T = 500, 256, 2
    codes = sim.random_genotypes(rng, M, N)
    geno = GenoBed.from_arrays(make_bed(codes), np.zeros(N),
                               standardize_phen=False, N=N, dtype=jnp.float64)
    vars_t, probs_t = sim.two_group_prior(M, 15, 0.8)
    ys, betas = [], []
    for t in range(T):
        beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
        x = geno.pad_m(beta * np.sqrt(N))
        g = geno.deplanarize(geno.ax(jnp.asarray(x)))[:N]
        ys.append(g + rng.standard_t(3.0, N) * 0.5)
        betas.append(beta)

    cfg = robust.RobustConfig(max_iter=4, rho=0.25, gam1_init=1e-8,
                              seed=3, stop_criteria_thr=0.0)
    mp = multi.MultiPhen.build(geno, ys, standardize=False)
    xm, sm, hm = multi.infer_huber(mp, cfg, probs_t, vars_t, verbose=False)

    # NOTE exactness is not expected: the deltaH MC-EM draws differ (the
    # multi engine splits one key across traits); compare estimate quality
    for t, y in enumerate(ys):
        g1 = GenoBed.from_arrays(make_bed(codes), y, N=N,
                                 standardize_phen=False, dtype=jnp.float64)
        xs, ss, hs = robust.infer(g1, cfg, probs_t, vars_t, verbose=False)
        corr_m = np.corrcoef(xm[:, t], betas[t])[0, 1]
        corr_s = np.corrcoef(xs, betas[t])[0, 1]
        assert np.isfinite(xm[:, t]).all()
        assert corr_m > 0.5, (t, corr_m)
        assert abs(corr_m - corr_s) < 0.1, (t, corr_m, corr_s)


def test_multi_deflation_matches_plain():
    """--deflate-k in the multi-trait engines: identical estimates (the
    deflation basis is a preconditioner, not an approximation)."""
    geno, codes, ys, betas, priors = _build(N=400, M=256, T=2, h2s=(0.8, 0.5))
    probs_t, vars_t = priors[0]
    mp = multi.MultiPhen.build(geno, ys, standardize=False)
    base = dict(max_iter=4, rho=0.3, gam1_init=1e-8, gamw_init=2.0,
                stop_criteria_thr=0.0)
    cfg0 = linear.VampConfig(**base)
    cfgd = linear.VampConfig(deflate_k=16, deflate_iters=4, **base)
    x0, s0, h0 = multi.infer(mp, cfg0, probs_t, vars_t, verbose=False)
    xd, sd, hd = multi.infer(mp, cfgd, probs_t, vars_t, verbose=False)
    # both runs solve to the same CG residual tolerance; agreement is at
    # the solve-tolerance scale, not exact (test_cg.py convention)
    np.testing.assert_allclose(x0, xd, rtol=1e-2, atol=2e-3)
    for t in range(2):
        assert np.corrcoef(x0[:, t], xd[:, t])[0, 1] > 0.99999
    # deflation must not need MORE CG iterations
    assert (hd[-1]["cg_iters"] <= h0[-1]["cg_iters"] + 1).all()

    # probit multi engine takes the same path through _make_zmodel_lmmse
    from gvamp import probit as probit_mod
    rng = np.random.default_rng(3)
    ys_bin = [(np.sign(ys[t] - np.nanmean(ys[t])) + 1) / 2 for t in range(2)]
    mpb = multi.MultiPhen.build(geno, ys_bin, standardize=False)
    pcfg0 = probit_mod.ProbitConfig(max_iter=3, stop_criteria_thr=0.0)
    pcfgd = probit_mod.ProbitConfig(max_iter=3, stop_criteria_thr=0.0,
                                    deflate_k=16, deflate_iters=4)
    xp0, _, _ = multi.infer_probit(mpb, pcfg0, probs_t, vars_t, verbose=False)
    xpd, _, _ = multi.infer_probit(mpb, pcfgd, probs_t, vars_t, verbose=False)
    np.testing.assert_allclose(xp0, xpd, rtol=1e-2, atol=2e-3)
    for t in range(2):
        assert np.corrcoef(xp0[:, t], xpd[:, t])[0, 1] > 0.9999


def test_multi_complete_fast_path_matches_general():
    """Complete genotypes route the multi engine onto the complete path;
    results must match the general path exactly (b-contraction collapses
    to per-column scalars)."""
    rng = np.random.default_rng(31)
    N, M, T = 500, 256, 2
    codes = sim.random_genotypes(rng, M, N, miss_rate=0.0)  # complete
    ys = []
    for t in range(T):
        vars_t, probs_t = sim.two_group_prior(M, 15, 0.7)
        beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
        g = GenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                                standardize_phen=False, dtype=jnp.float64)
        ys.append(sim.simulate_linear_phenotype(g, beta, 3.0, rng))
    cfg = linear.VampConfig(max_iter=4, rho=0.3, gam1_init=1e-8,
                            gamw_init=2.0, stop_criteria_thr=0.0)
    outs = {}
    for name, force_general in (("fast", False), ("general", True)):
        # the kernels in the Pallas interpreter; forcing _complete=False
        # routes the general (a+b) kernels at the same digit precision.
        # The kernels are float32 only (float64 is refused), so float32
        # containers exercise the identical routing
        geno = GenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                                   standardize_phen=False,
                                   backend="interpret")
        assert geno.geno_complete
        if force_general:
            geno._complete = False
        mp = multi.MultiPhen.build(geno, ys, standardize=False)
        outs[name] = multi.infer(mp, cfg, probs_t, vars_t, verbose=False)
    # identical routing algebra; only int8 digit rounding differs between
    # the complete and general kernels (~1e-7 of colmax)
    np.testing.assert_allclose(outs["fast"][0], outs["general"][0],
                               rtol=1e-4, atol=1e-8)
    corr = np.corrcoef(outs["fast"][0].ravel(),
                       outs["general"][0].ravel())[0, 1]
    assert corr > 0.9999999


def test_multi_zmodel_stab_gamma_identity():
    """--stab-gamma in the multi-trait z-model engines: the it-2 per-trait
    gam1/tau1 recurrences damp to old^(1-s) * new^s of the undamped run
    (same identity as the single-trait tests; covers both wiring sites in
    multi.py's probit and Huber steps)."""
    from gvamp import probit, robust

    rng = np.random.default_rng(29)
    N, M, T = 300, 192, 2
    codes = sim.random_genotypes(rng, M, N)
    geno = GenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                               standardize_phen=False, dtype=jnp.float64)
    vars_t, probs_t = sim.two_group_prior(M, 12, 0.8)
    ys_bin, ys_rob = [], []
    for t in range(T):
        beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
        ys_bin.append(sim.simulate_probit_phenotype(geno, beta, 1.0, rng))
        g = geno.deplanarize(geno.ax(jnp.asarray(
            geno.pad_m(beta * np.sqrt(N)))))[:N]
        ys_rob.append(g + rng.standard_t(3.0, N) * 0.5)

    s = 0.5
    for cfg_cls, run, ys in (
            (probit.ProbitConfig, multi.infer_probit, ys_bin),
            (robust.RobustConfig, multi.infer_huber, ys_rob)):
        hs = {}
        for sg in (1.0, s):
            cfg = cfg_cls(max_iter=2, rho=0.25, gam1_init=1e-8, seed=3,
                          stop_criteria_thr=0.0, stab_gamma=sg)
            _, _, hs[sg] = run(multi.MultiPhen.build(geno, ys,
                                                     standardize=False),
                               cfg, probs_t, vars_t, verbose=False)
        for k in ("gam1", "tau1"):
            old = np.asarray(hs[1.0][0][k], float)
            np.testing.assert_array_equal(old, np.asarray(hs[s][0][k], float))
            want = old ** (1 - s) * np.asarray(hs[1.0][1][k], float) ** s
            np.testing.assert_allclose(np.asarray(hs[s][1][k], float), want,
                                       rtol=1e-8)


def test_multi_fold_noise_matches_explicit_pass():
    """Multi-trait fold_noise (per-trait resid2/trace_corr via the CG exit
    Gram identity, z1 via first-iteration rider columns) reproduces the
    explicit noise-EM wide pass trajectory-for-trajectory."""
    geno, codes, ys, betas, priors = _build()
    probs_t, vars_t = priors[0]
    runs = {}
    for fold in (False, True):
        cfg = linear.VampConfig(max_iter=5, rho=0.3, gam1_init=1e-8,
                                gamw_init=2.0, seed=4, fold_noise=fold,
                                stop_criteria_thr=0.0)
        mp = multi.MultiPhen.build(geno, ys, standardize=False)
        runs[fold] = multi.infer(mp, cfg, probs_t, vars_t, verbose=False)
    for key in ("gamw", "R2_train_1", "R2_train_2", "alpha2", "gam1"):
        a = np.array([np.asarray(m[key]) for m in runs[False][2]])
        b = np.array([np.asarray(m[key]) for m in runs[True][2]])
        np.testing.assert_allclose(b, a, rtol=5e-6, err_msg=key)
    np.testing.assert_allclose(np.asarray(runs[True][0]),
                               np.asarray(runs[False][0]), rtol=0,
                               atol=1e-7 * np.abs(runs[False][0]).max())
