"""Huber robust VAMP: proximal identities + heavy-tailed recovery."""

import numpy as np
import jax.numpy as jnp

from gvamp import robust, sim
from gvamp.data import GenoBed
from test_data_layer import make_bed
import pytest

# engine-scale tests: excluded from the <5-min core tier (README: test tiers)
pytestmark = pytest.mark.slow


def test_huber_proximal_identity():
    """g1_huber = y - prox of the Huber penalty scaled by var = 1/tau1."""
    tau1, delta = 2.0, 0.5
    var = 1 / tau1
    p1 = np.linspace(-4, 4, 81)
    y = 1.3
    ours = np.asarray(robust.g1_huber(jnp.asarray(p1), tau1, delta, y))
    # prox_{var*h_delta}(w): solves argmin_e 0.5(e-w)^2 + var*h_delta(e)
    w = y - p1
    thr = (1 + var) * delta
    prox = np.where(np.abs(w) <= thr, w / (1 + var),
                    np.where(w > thr, w - var * delta, w + var * delta))
    np.testing.assert_allclose(ours, y - prox, rtol=1e-12)
    # prox optimality: gradient of the objective at prox is ~0
    for wi, ei in zip(w, prox):
        grad = (ei - wi) + var * np.clip(ei, -delta, delta)
        assert abs(grad) < 1e-10


def test_huber_loss_values():
    z = jnp.asarray([0.0, 1.0, 3.0])
    y = 0.0
    d = 1.5
    got = np.asarray(robust.huber_loss(z, d, y))
    np.testing.assert_allclose(got, [0.0, 0.5, 1.5 * (3 - 0.75)], rtol=1e-12)


def test_em_deltaH_prefers_small_delta_for_heavy_tails():
    """With huge outliers, the MC-EM objective should favor a small delta."""
    import jax
    rng = np.random.default_rng(0)
    N = 2000
    p1 = rng.normal(size=N)
    y = p1 + np.where(rng.random(N) < 0.1, rng.standard_cauchy(N) * 10,
                      rng.normal(size=N) * 0.1)
    d = robust.em_deltaH(jax.random.key(0), jnp.asarray(p1), 25.0,
                         jnp.asarray(y), jnp.ones(N))
    assert float(d) <= 0.4


def test_robust_vamp_recovers_under_heavy_tails():
    rng = np.random.default_rng(9)
    N, M, CV, h2 = 1500, 300, 20, 0.9
    codes = sim.random_genotypes(rng, M, N)
    geno = GenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                               standardize_phen=False, dtype=jnp.float64)
    vars_t, probs_t = sim.two_group_prior(M, CV, h2)
    beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
    # heavy-tailed noise: Student-t with 2.5 dof (sim_heavy_tails.cpp spirit)
    x = geno.pad_m(beta * np.sqrt(N))
    g = geno.deplanarize(geno.ax(jnp.asarray(x)))[:N]
    noise = rng.standard_t(3.0, N) * 0.5
    geno.set_phen(g + noise)

    cfg = robust.RobustConfig(max_iter=6, rho=0.3, seed=5)
    x_hat, state, hist = robust.infer(geno, cfg, probs_t, vars_t,
                                      true_signal=beta, verbose=False)
    corr = np.corrcoef(x_hat, beta)[0, 1]
    assert corr > 0.6, f"corr {corr}"
    assert np.isfinite(float(hist[-1]["deltaH"]))


def test_robust_phase_timers_match_fused():
    """Phased Huber step == fused step; phase_ms_* recorded."""
    rng = np.random.default_rng(12)
    N, M = 600, 200
    codes = sim.random_genotypes(rng, M, N)
    geno = GenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                               standardize_phen=False, dtype=jnp.float64)
    vars_t, probs_t = sim.two_group_prior(M, 15, 0.8)
    beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
    x = geno.pad_m(beta * np.sqrt(N))
    g = geno.deplanarize(geno.ax(jnp.asarray(x)))[:N]
    geno.set_phen(g + rng.standard_t(3.0, N) * 0.5)
    cfg = robust.RobustConfig(max_iter=3, rho=0.3, seed=2,
                              stop_criteria_thr=0.0)
    x_f, s_f, h_f = robust.infer(geno, cfg, probs_t, vars_t, verbose=False)
    x_p, s_p, h_p = robust.infer(geno, cfg, probs_t, vars_t, verbose=False,
                                 phase_timers=True)
    # ulp-level: the phased jits may fuse the tracked CG init residual
    # algebra differently than the fused step (same math, 1-ulp drift)
    np.testing.assert_allclose(x_p, x_f, rtol=0,
                               atol=1e-12 * (np.abs(x_f).max() + 1e-30))
    for k in ("gam1", "tau1", "deltaH"):
        np.testing.assert_allclose(float(h_p[-1][k]), float(h_f[-1][k]),
                                   rtol=1e-12)
    for nm in ("denoise_x", "denoise_z", "lmmse_cg", "lmmse_z_finish"):
        assert f"phase_ms_{nm}" in h_p[-1]


def test_robust_gram_tracking_matches_true_init_mult():
    """Warm-started CG with the tracked Gram product stays within
    CG-truncation noise of the reference's zero-start behavior
    (see test_probit_gram_tracking_matches_true_init_mult)."""
    import dataclasses
    rng = np.random.default_rng(15)
    N, M = 600, 160
    codes = sim.random_genotypes(rng, M, N)
    geno = GenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                               standardize_phen=False, dtype=jnp.float64)
    vars_t, probs_t = sim.two_group_prior(M, 12, 0.8)
    beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
    x = geno.pad_m(beta * np.sqrt(N))
    g = geno.deplanarize(geno.ax(jnp.asarray(x)))[:N]
    geno.set_phen(g + rng.standard_t(3.0, N) * 0.5)

    # 3 iterations: the Huber gammas traverse a volatile regime (swings of
    # orders of magnitude) that chaotically amplifies CG float noise
    # (measured: rel 4.5e-6 at it 3, 2e-3 at it 4, 3.6e-2 at it 8 — the
    # same growth follows ANY ulp-level perturbation); compare before
    # the amplification takes over
    base = robust.RobustConfig(max_iter=3, rho=0.3, seed=3)
    x_t, _, h_t = robust.infer(geno, dataclasses.replace(base, gram_refresh=1),
                               probs_t, vars_t, verbose=False)
    x_k, _, h_k = robust.infer(geno, base, probs_t, vars_t, verbose=False)
    assert base.gram_refresh > 1
    np.testing.assert_allclose(x_k, x_t, rtol=0,
                               atol=1e-4 * (np.abs(x_t).max() + 1e-30))
    for k in ("gam1", "gam2", "deltaH"):
        np.testing.assert_allclose(float(h_k[-1][k]), float(h_t[-1][k]),
                                   rtol=5e-4)


def test_robust_sync_every_matches():
    """Scan throughput mode (sync_every) == per-iteration dispatch,
    including a partial final chunk (max_iter=4, chunks of 3)."""
    rng = np.random.default_rng(21)
    N, M = 500, 160
    codes = sim.random_genotypes(rng, M, N)
    geno = GenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                               standardize_phen=False, dtype=jnp.float64)
    vars_t, probs_t = sim.two_group_prior(M, 12, 0.8)
    beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
    x = geno.pad_m(beta * np.sqrt(N))
    g = geno.deplanarize(geno.ax(jnp.asarray(x)))[:N]
    geno.set_phen(g + rng.standard_t(3.0, N) * 0.5)
    cfg = robust.RobustConfig(max_iter=4, rho=0.3, seed=2,
                              stop_criteria_thr=0.0)
    x1, s1, h1 = robust.infer(geno, cfg, probs_t, vars_t, verbose=False)
    x2, s2, h2 = robust.infer(geno, cfg, probs_t, vars_t, verbose=False,
                              sync_every=3)
    np.testing.assert_array_equal(x1, x2)
    assert len(h1) == len(h2) == 4
    assert int(np.asarray(s2.it)) == 4
    for k in ("gam1", "tau1", "deltaH"):
        np.testing.assert_array_equal(float(h1[-1][k]), float(h2[-1][k]))


def _small_heavy_tail_geno(seed=13, N=500, M=160):
    rng = np.random.default_rng(seed)
    codes = sim.random_genotypes(rng, M, N, miss_rate=0.02)
    geno0 = GenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                                standardize_phen=False)
    vars_t, probs_t = sim.two_group_prior(M, 12, 0.8)
    beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
    g = np.asarray(geno0.deplanarize(
        geno0.ax(jnp.asarray(geno0.pad_m(beta * np.sqrt(N)))))[:N])
    noise_var = np.var(g) * (1 / 0.8 - 1)
    y = g + rng.standard_t(3, N) * np.sqrt(noise_var / 3)
    return GenoBed.from_arrays(make_bed(codes), y, N=N), probs_t, vars_t, beta


def test_stab_gamma_geometric_recurrence_identity():
    """--stab-gamma s damps the it-2 gam1/tau1 recurrences to EXACTLY
    old^(1-s) * new^s of the undamped run (the trajectories coincide
    through it 1, so the undamped it-2 value IS the raw update).  A
    corr-based regression is hopeless here: the Huber gamma trajectory
    chaotically amplifies ulp-level perturbations (reshaping across a
    device mesh changes it), but this one-step identity is exact.  Also
    guards finiteness of a long damped run."""
    geno, probs_t, vars_t, beta = _small_heavy_tail_geno()

    def run(s, iters):
        cfg = robust.RobustConfig(max_iter=iters, rho=0.3, seed=1,
                                  stop_criteria_thr=0.0, stab_gamma=s)
        return robust.infer(geno, cfg, probs_t, vars_t, verbose=False)

    s = 0.5
    _, _, h_ref = run(1.0, 2)
    _, _, h_dmp = run(s, 2)
    for k in ("gam1", "tau1"):
        old = float(h_ref[0][k])          # it-1 value (identical both runs)
        assert old == float(h_dmp[0][k])
        new = float(h_ref[1][k])          # raw it-2 update
        want = old ** (1 - s) * new ** s
        got = float(h_dmp[1][k])
        np.testing.assert_allclose(got, want, rtol=1e-4), k
    # long damped run stays finite (the gammas may drift to the clamp
    # bounds; the trust region forbids the 1e22-scale overshoots the raw
    # recurrence can produce in f32)
    _, st, h12 = run(s, 12)
    assert np.isfinite(np.asarray(st.x1)).all()
    assert all(np.isfinite(float(m["gam1"])) for m in h12)
    assert max(float(m["gam1"]) for m in h12) < 1e12
