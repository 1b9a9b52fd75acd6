"""Integration: the sim.cpp recipe — simulate known truth, infer, verify
recovery (SURVEY.md §4 test strategy item 1) and shard-count invariance."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gvamp.data import GenoBed
from gvamp import linear, sim
from test_data_layer import make_bed

# engine-scale tests: excluded from the <5-min core tier (README: test tiers)
pytestmark = pytest.mark.slow


def build_sim(seed=11, N=900, M=600, CV=30, h2=0.7, mesh=None):
    rng = np.random.default_rng(seed)
    codes = sim.random_genotypes(rng, M, N, miss_rate=0.01)
    vars_t, probs_t = sim.two_group_prior(M, CV, h2)
    beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
    geno = GenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                               standardize_phen=False, dtype=jnp.float64,
                               mesh=mesh)
    gamw = 1 / (1 - h2)
    y = sim.simulate_linear_phenotype(geno, beta, gamw, rng)
    geno.set_phen(y)
    return geno, beta, vars_t, probs_t


def test_linear_vamp_recovers_signal():
    geno, beta, vars_t, probs_t = build_sim()
    cfg = linear.VampConfig(max_iter=12, rho=0.3, gam1_init=1e-8,
                            gamw_init=2.0, seed=7)
    x_hat, state, hist = linear.infer(geno, cfg, probs_t, vars_t,
                                      true_signal=beta, verbose=False)
    corr = np.corrcoef(x_hat, beta)[0, 1]
    assert corr > 0.9, f"corr {corr}"
    # R2 approaches the true h2 neighbourhood and improves monotonically-ish
    r2 = [float(h["R2_train_1"]) for h in hist]
    assert r2[-1] > 0.5
    # gamw estimate heads toward the true noise precision 1/(1-h2)
    assert 1.5 < float(hist[-1]["gamw"]) < 6.0
    # correlation metric inside the engine agrees with the recomputed one
    np.testing.assert_allclose(float(hist[-1]["corr_x1"]), corr, atol=5e-3)


def test_shard_count_invariance():
    """Results must be identical (up to fp) on 1 device and an 8-device mesh —
    the analog of the reference's rank-count-agnostic collectives."""
    geno1, beta, vars_t, probs_t = build_sim(N=500, M=256)
    devs = jax.devices()
    assert len(devs) >= 8, "conftest must provide 8 virtual devices"
    mesh = jax.sharding.Mesh(np.array(devs[:8]), ("m",))
    geno8, beta8, _, _ = build_sim(N=500, M=256, mesh=mesh)
    np.testing.assert_array_equal(beta, beta8)

    cfg = linear.VampConfig(max_iter=4, rho=0.3, gam1_init=1e-8, gamw_init=2.0)
    x1, s1, h1 = linear.infer(geno1, cfg, probs_t, vars_t, verbose=False)
    x8, s8, h8 = linear.infer(geno8, cfg, probs_t, vars_t, verbose=False)
    np.testing.assert_allclose(x1, x8, rtol=1e-8, atol=1e-12)
    for k in ("gam1", "gam2", "gamw", "alpha2"):
        np.testing.assert_allclose(float(h1[-1][k]), float(h8[-1][k]), rtol=1e-8)


def test_freeze_pins_coordinates():
    geno, beta, vars_t, probs_t = build_sim(N=400, M=200)
    freeze = np.zeros(200)
    freeze[:50] = 1.0
    cfg = linear.VampConfig(max_iter=3, rho=0.3)
    x_hat, state, hist = linear.infer(geno, cfg, probs_t, vars_t,
                                      freeze=freeze, verbose=False)
    assert np.isfinite(x_hat).all()


def test_restart_from_estimate():
    """restart run-mode semantics: gam1/gamw injected, r1 from stored estimate
    rescaled by sqrt(N) (vamp.cpp:226-233)."""
    geno, beta, vars_t, probs_t = build_sim(N=400, M=200)
    cfg = linear.VampConfig(max_iter=3, rho=0.3)
    x_a, state_a, h_a = linear.infer(geno, cfg, probs_t, vars_t, verbose=False)
    r1_stored = np.asarray(state_a.r1)[:200] / np.sqrt(400)
    cfg2 = linear.VampConfig(max_iter=2, rho=0.3)
    x_b, state_b, h_b = linear.infer(geno, cfg2, probs_t, vars_t,
                                     r1_init=r1_stored,
                                     gam1=float(state_a.gam1),
                                     gamw=float(state_a.gamw), verbose=False)
    assert np.isfinite(x_b).all()
    # restart should start roughly where the first run ended, not from scratch
    corr = np.corrcoef(x_b, x_a)[0, 1]
    assert corr > 0.8


def test_sample_window_matches_reference_semantics():
    """Windowed container: full-data marker stats + 1/sqrt(4*lb) scaling
    (reference data.cpp:728-801, 825-832)."""
    import numpy as np
    import jax.numpy as jnp
    from gvamp.data import GenoBed
    from helpers import DenseOracle, random_dataset
    from tests_shim import make_bed_bytes

    rng = np.random.default_rng(17)
    N, M = 160, 24
    codes, y = random_dataset(rng, N, M)
    geno = GenoBed.from_arrays(make_bed_bytes(codes), y, N=N, dtype=jnp.float64)
    sb, lb = 8, 24                       # individuals [32, 128)
    win = geno.sample_window(sb, lb)
    assert win.N == 4 * lb

    oracle = DenseOracle(codes, y)
    x = rng.normal(size=geno.Mpad) * np.asarray(geno.m_mask)
    z = win.deplanarize(win.ax(jnp.asarray(x)))[: win.N]
    # dense oracle on the window with FULL-data stats and 1/sqrt(4*lb) scale
    vals = (oracle.a - oracle.mave[:, None]) * oracle.b * oracle.msig[:, None]
    zo = (vals[:, 4 * sb: 4 * (sb + lb)].T @ x[:M]) / np.sqrt(4 * lb)
    zo = zo * oracle.na[4 * sb: 4 * (sb + lb)]
    np.testing.assert_allclose(z, zo, rtol=1e-8, atol=1e-10)


def test_cross_val_and_gamma_damp_smoke():
    """use_cross_val + gamma_damp run and converge on the sim problem."""
    geno, beta, vars_t, probs_t = build_sim(N=700, M=256)
    cfg = linear.VampConfig(max_iter=4, rho=0.3, use_cross_val=True,
                            gamma_damp=0.9, cg_max_iter=30,
                            gam1_init=1e-8, gamw_init=2.0)
    x_est, state, hist = linear.infer(geno, cfg, probs_t, vars_t,
                                      verbose=False)
    assert np.isfinite(x_est).all()
    assert "cv_r2" in hist[-1]
    # holdout R2 should become meaningfully positive on this easy problem
    assert float(hist[-1]["cv_r2"]) > 0.2, hist[-1]["cv_r2"]


def test_state_evolution_predicts_alpha1():
    """SE alpha_bar ~ realized alpha1 once the prior/precisions stabilize."""
    from gvamp.prior import Prior

    geno, beta, vars_t, probs_t = build_sim(N=700, M=256)
    cfg = linear.VampConfig(max_iter=6, rho=0.3, gam1_init=1e-8,
                            gamw_init=2.0)
    x_est, state, hist = linear.infer(geno, cfg, probs_t, vars_t, verbose=False)
    pr = Prior(probs=state.probs, vars=state.vars)
    alpha_bar, eta_bar, gam_bar = linear.state_evolution(
        jax.random.key(0), pr, state.gam1, state.rho, pr, state.gam1,
        geno.Mt, n_mc=200_000)
    realized = float(hist[-1]["alpha1"])
    assert np.isfinite(float(alpha_bar))
    assert abs(float(alpha_bar) - realized) < 0.5 * max(realized, 0.05), (
        float(alpha_bar), realized)


def test_scan_step_matches_single_steps():
    """make_scan_step(k) == k sequential make_step calls."""
    geno, beta, vars_t, probs_t = build_sim(N=400, M=256)
    cfg = linear.VampConfig(max_iter=4, rho=0.3, gam1_init=1e-8, gamw_init=2.0)
    s1 = linear.init_state(geno, cfg, probs_t, vars_t)
    aux = linear.make_aux(geno, cfg)
    step = linear.make_step(geno, cfg)
    for _ in range(4):
        s1, m1 = step(s1, aux)
    s4 = linear.init_state(geno, cfg, probs_t, vars_t)
    scan4 = linear.make_scan_step(geno, cfg, 4)
    s4, ms = scan4(s4, aux)
    np.testing.assert_allclose(np.asarray(s1.x1), np.asarray(s4.x1),
                               rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(float(m1["gam1"]),
                               float(np.asarray(ms["gam1"])[-1]), rtol=1e-10)


def test_infer_sync_every_matches():
    geno, beta, vars_t, probs_t = build_sim(N=400, M=256)
    cfg = linear.VampConfig(max_iter=6, rho=0.3, gam1_init=1e-8,
                            gamw_init=2.0, stop_criteria_thr=0.0)
    x1, s1, h1 = linear.infer(geno, cfg, probs_t, vars_t, verbose=False)
    x3, s3, h3 = linear.infer(geno, cfg, probs_t, vars_t, verbose=False,
                              sync_every=3)
    np.testing.assert_allclose(x1, x3, rtol=1e-10, atol=1e-14)
    assert len(h1) == len(h3) == 6
    for a, b in zip(h1, h3):
        np.testing.assert_allclose(float(a["gam1"]), float(b["gam1"]),
                                   rtol=1e-10)


def test_phase_timers_match_fused():
    """The phased step (per-phase observability, VERDICT #7) must reproduce
    the fused step exactly and attach phase_ms_* wall-clock entries."""
    geno, beta, vars_t, probs_t = build_sim(N=400, M=256)
    cfg = linear.VampConfig(max_iter=3, rho=0.3, gam1_init=1e-8,
                            gamw_init=2.0)
    x_f, s_f, h_f = linear.infer(geno, cfg, probs_t, vars_t, verbose=False)
    x_p, s_p, h_p = linear.infer(geno, cfg, probs_t, vars_t, verbose=False,
                                 phase_timers=True)
    np.testing.assert_array_equal(x_f, x_p)
    for k in ("gam1", "gam2", "gamw", "alpha1", "alpha2"):
        np.testing.assert_array_equal(float(h_f[-1][k]), float(h_p[-1][k]))
    for nm in ("denoise", "z1_project", "lmmse_cg", "noise_em", "finish"):
        assert f"phase_ms_{nm}" in h_p[-1]
        assert float(h_p[-1][f"phase_ms_{nm}"]) > 0.0


def test_gram_tracking_matches_true_init_mult():
    """The tracked-warm-start CG init (gram_refresh > 1: r0 from the carried
    A^T A mu, no packed pass) matches always-computing the true init mult
    (gram_refresh=1, the reference behavior) through a 10-iteration run."""
    geno, beta, vars_t, probs_t = build_sim(N=500, M=320)
    base = dict(max_iter=10, rho=0.3, gam1_init=1e-8, gamw_init=2.0, seed=5)
    x_t, _, h_t = linear.infer(geno, linear.VampConfig(gram_refresh=1, **base),
                               probs_t, vars_t, verbose=False)
    x_k, _, h_k = linear.infer(geno, linear.VampConfig(gram_refresh=8, **base),
                               probs_t, vars_t, verbose=False)
    np.testing.assert_allclose(x_k, x_t, rtol=0,
                               atol=1e-4 * (np.abs(x_t).max() + 1e-30))
    for k in ("gam1", "gam2", "gamw", "alpha2"):
        np.testing.assert_allclose(float(h_k[-1][k]), float(h_t[-1][k]),
                                   rtol=5e-4)
