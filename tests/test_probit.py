"""Probit model tests: z-denoisers vs scipy, Newton covariate solver,
end-to-end signal recovery with covariates."""

import numpy as np
import jax
import jax.numpy as jnp
import scipy.stats as st

from gvamp import probit, sim
from gvamp.data import GenoBed
from test_data_layer import make_bed
import pytest

# engine-scale tests: excluded from the <5-min core tier (README: test tiers)
pytestmark = pytest.mark.slow


def test_g1_bin_class_matches_conditional_mean():
    """E[z|p,y] under z~N(p, 1/tau), y = 1{z+eps>0}: closed form via Mills."""
    tau1, pv = 2.0, 1.0
    p = np.linspace(-3, 3, 31)
    for y in (0.0, 1.0):
        ours = np.asarray(probit.g1_bin_class(jnp.asarray(p), tau1, y, 0.0, pv))
        sgn = 2 * y - 1
        c = p / np.sqrt(pv + 1 / tau1)
        mills = np.exp(st.norm.logpdf(sgn * c) - st.norm.logcdf(sgn * c))
        expect = p + sgn * mills / tau1 / np.sqrt(pv + 1 / tau1)
        np.testing.assert_allclose(ours, expect, rtol=1e-10)


def test_g1d_bin_class_is_derivative():
    tau1, pv = 1.3, 1.0
    p = jnp.linspace(-4.0, 4.0, 41)
    for y in (0.0, 1.0):
        auto = jax.vmap(jax.grad(
            lambda x: probit.g1_bin_class(x, tau1, y, 0.7, pv)))(p)
        ours = probit.g1d_bin_class(p, tau1, y, 0.7, pv)
        np.testing.assert_allclose(np.asarray(ours), np.asarray(auto), rtol=1e-8)


def test_newton_cov_recovers_effects():
    """Pure-covariate probit data: Newton must find the MLE ~ truth."""
    rng = np.random.default_rng(0)
    N, C = 4000, 3
    Z = rng.normal(size=(N, C))
    eta_true = np.array([0.5, -0.25, 0.8])
    pr = st.norm.cdf(Z @ eta_true)
    y = (rng.random(N) < pr).astype(np.float64)
    eta = probit.newton_cov(jnp.asarray(y), jnp.zeros(N), jnp.asarray(Z),
                            jnp.zeros(C), jnp.ones(N))
    np.testing.assert_allclose(np.asarray(eta), eta_true, atol=0.1)


def test_probit_vamp_recovers_signal():
    rng = np.random.default_rng(4)
    N, M, CV, h2 = 1500, 300, 20, 0.9
    codes = sim.random_genotypes(rng, M, N)
    geno = GenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                               standardize_phen=False, dtype=jnp.float64)
    vars_t, probs_t = sim.two_group_prior(M, CV, h2)
    beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
    # covariates with known effects (sim_probit.cpp:170-186 style)
    C = 2
    geno.covs = rng.normal(size=(N, C))
    cov_eff_true = np.array([0.25, -0.25])
    y = sim.simulate_probit_phenotype(geno, beta, 1.0, rng, cov_eff_true)
    geno.set_phen(y)
    assert 0.2 < y.mean() < 0.8

    cfg = probit.ProbitConfig(max_iter=10, rho=0.3, seed=2)
    x_hat, state, hist = probit.infer(geno, cfg, probs_t, vars_t,
                                      true_signal=beta, verbose=False)
    corr = np.corrcoef(x_hat, beta)[0, 1]
    assert corr > 0.55, f"corr {corr}"
    # covariate effects estimated in the right ballpark
    np.testing.assert_allclose(np.asarray(hist[-1]["cov_eff"]),
                               cov_eff_true, atol=0.15)


def test_probit_scan_step_matches():
    rng = np.random.default_rng(6)
    N, M = 500, 192
    codes = sim.random_genotypes(rng, M, N)
    geno = GenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                               standardize_phen=False, dtype=jnp.float64)
    vars_t, probs_t = sim.two_group_prior(M, 12, 0.8)
    beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
    y = sim.simulate_probit_phenotype(geno, beta, 1.0, rng)
    geno.set_phen(y)
    cfg = probit.ProbitConfig(max_iter=3, rho=0.2, gam1_init=1e-8)
    s1 = probit.init_state(geno, cfg, probs_t, vars_t)
    aux = probit.make_aux(geno, cfg)
    step = probit.make_step(geno, cfg)
    for _ in range(3):
        s1, m1 = step(s1, aux)
    s3 = probit.init_state(geno, cfg, probs_t, vars_t)
    scan3 = probit.make_scan_step(geno, cfg, 3)
    s3, ms = scan3(s3, aux)
    np.testing.assert_allclose(np.asarray(s1.x1), np.asarray(s3.x1),
                               rtol=1e-10, atol=1e-14)


def test_probit_phase_timers_match_fused():
    """Phased probit step == fused step; phase_ms_* recorded."""
    rng = np.random.default_rng(9)
    N, M = 600, 200
    codes = sim.random_genotypes(rng, M, N)
    geno = GenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                               standardize_phen=False, dtype=jnp.float64)
    vars_t, probs_t = sim.two_group_prior(M, 15, 0.8)
    beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
    y = sim.simulate_probit_phenotype(geno, beta, 1.0, rng)
    geno.set_phen(y)
    cfg = probit.ProbitConfig(max_iter=3, rho=0.3, seed=2,
                              stop_criteria_thr=0.0)
    x_f, s_f, h_f = probit.infer(geno, cfg, probs_t, vars_t, verbose=False)
    x_p, s_p, h_p = probit.infer(geno, cfg, probs_t, vars_t, verbose=False,
                                 phase_timers=True)
    # ulp-level: the phased jits may fuse the tracked CG init residual
    # algebra differently than the fused step (same math, 1-ulp drift)
    np.testing.assert_allclose(x_p, x_f, rtol=0,
                               atol=1e-12 * (np.abs(x_f).max() + 1e-30))
    for k in ("gam1", "tau1", "alpha2"):
        np.testing.assert_allclose(float(h_p[-1][k]), float(h_f[-1][k]),
                                   rtol=1e-12)
    for nm in ("denoise_x", "denoise_z", "lmmse_cg", "lmmse_z_finish"):
        assert f"phase_ms_{nm}" in h_p[-1]


def test_probit_sync_every_matches():
    """Scan throughput mode (sync_every) == per-iteration dispatch."""
    rng = np.random.default_rng(9)
    N, M = 600, 200
    codes = sim.random_genotypes(rng, M, N)
    geno = GenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                               standardize_phen=False, dtype=jnp.float64)
    vars_t, probs_t = sim.two_group_prior(M, 15, 0.8)
    beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
    y = sim.simulate_probit_phenotype(geno, beta, 1.0, rng)
    geno.set_phen(y)
    cfg = probit.ProbitConfig(max_iter=4, rho=0.3, seed=2,
                              stop_criteria_thr=0.0)
    x1, s1, h1 = probit.infer(geno, cfg, probs_t, vars_t, verbose=False)
    x2, s2, h2 = probit.infer(geno, cfg, probs_t, vars_t, verbose=False,
                              sync_every=2)
    np.testing.assert_array_equal(x1, x2)
    assert len(h1) == len(h2) == 4
    for k in ("gam1", "tau1"):
        np.testing.assert_array_equal(float(h1[-1][k]), float(h2[-1][k]))


def test_probit_gram_tracking_matches_true_init_mult():
    """Warm-started CG with the tracked Gram product (gram_refresh=8, the
    default) stays within CG-truncation noise of the reference's
    zero-start behavior (gram_refresh=1) through an 8-iteration run."""
    import dataclasses
    rng = np.random.default_rng(14)
    N, M = 600, 160
    codes = sim.random_genotypes(rng, M, N)
    geno = GenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                               standardize_phen=False, dtype=jnp.float64)
    vars_t, probs_t = sim.two_group_prior(M, 12, 0.9)
    beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
    y = sim.simulate_probit_phenotype(geno, beta, 1.0, rng)
    geno.set_phen(y)

    base = probit.ProbitConfig(max_iter=8, rho=0.3, seed=2)
    x_t, _, h_t = probit.infer(geno, dataclasses.replace(base, gram_refresh=1),
                               probs_t, vars_t, verbose=False)
    x_k, _, h_k = probit.infer(geno, base, probs_t, vars_t, verbose=False)
    assert base.gram_refresh > 1
    np.testing.assert_allclose(x_k, x_t, rtol=0,
                               atol=1e-4 * (np.abs(x_t).max() + 1e-30))
    for k in ("gam1", "gam2", "tau1", "alpha2"):
        np.testing.assert_allclose(float(h_k[-1][k]), float(h_t[-1][k]),
                                   rtol=5e-4)


def test_stab_gamma_geometric_recurrence_identity_probit():
    """Probit analog of test_robust's --stab-gamma identity: the it-2
    gam1/tau1 recurrences damp to exactly old^(1-s) * new^s of the
    undamped run (trajectories coincide through it 1)."""
    rng = np.random.default_rng(8)
    N, M = 600, 160
    codes = sim.random_genotypes(rng, M, N)
    geno = GenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                               standardize_phen=False)
    vars_t, probs_t = sim.two_group_prior(M, 12, 0.9)
    beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
    geno.set_phen(sim.simulate_probit_phenotype(geno, beta, 1.0, rng))

    def run(s):
        cfg = probit.ProbitConfig(max_iter=2, rho=0.3, seed=2,
                                  stop_criteria_thr=0.0, stab_gamma=s)
        return probit.infer(geno, cfg, probs_t, vars_t, verbose=False)

    s = 0.5
    _, _, h_ref = run(1.0)
    _, _, h_dmp = run(s)
    for k in ("gam1", "tau1"):
        old = float(h_ref[0][k])
        assert old == float(h_dmp[0][k])
        want = old ** (1 - s) * float(h_ref[1][k]) ** s
        np.testing.assert_allclose(float(h_dmp[1][k]), want, rtol=1e-4)
