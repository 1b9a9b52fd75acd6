"""XXT (dual / sample-space) LMMSE denoiser tests (reference denoiserXXT.cpp).

The dual solve x2 = gamw A^T (gamw A A^T + gam2 I)^{-1}(y - A r2) + r2 must
equal the primal (gamw A^T A + gam2 I)^{-1}(gamw A^T y + gam2 r2) exactly
(Woodbury identity), so XXT mode and standard mode must agree on x2 and on
the overall trajectory.
"""

import numpy as np

from gvamp import linear
from test_linear_vamp import build_sim
import pytest

# engine-scale tests: excluded from the <5-min core tier (README: test tiers)
pytestmark = pytest.mark.slow


def test_dual_equals_primal_identity():
    """Woodbury: dense check that the two LMMSE forms coincide."""
    rng = np.random.default_rng(1)
    N, M = 40, 25
    A = rng.normal(size=(N, M)) / np.sqrt(N)
    y = rng.normal(size=N)
    r2 = rng.normal(size=M)
    gamw, gam2 = 1.7, 0.9
    primal = np.linalg.solve(gamw * A.T @ A + gam2 * np.eye(M),
                             gamw * A.T @ y + gam2 * r2)
    dual = gamw * A.T @ np.linalg.solve(gamw * A @ A.T + gam2 * np.eye(N),
                                        y - A @ r2) + r2
    np.testing.assert_allclose(primal, dual, rtol=1e-9)


def test_xxt_mode_matches_standard_mode():
    geno, beta, vars_t, probs_t = build_sim(N=300, M=500, CV=25, h2=0.7)
    cfg_std = linear.VampConfig(max_iter=4, rho=0.3, cg_max_iter=400,
                                cg_err_tol=1e-10)
    cfg_xxt = linear.VampConfig(max_iter=4, rho=0.3, cg_max_iter=400,
                                cg_err_tol=1e-10, use_xxt=True,
                                cg_err_tol_xxt=1e-10)
    x_std, s_std, h_std = linear.infer(geno, cfg_std, probs_t, vars_t,
                                       verbose=False)
    x_xxt, s_xxt, h_xxt = linear.infer(geno, cfg_xxt, probs_t, vars_t,
                                       verbose=False)
    np.testing.assert_allclose(x_xxt, x_std, rtol=1e-5, atol=1e-8)
    for k in ("gam1", "gam2", "gamw"):
        np.testing.assert_allclose(float(h_xxt[-1][k]), float(h_std[-1][k]),
                                   rtol=1e-5)


def test_xxt_mode_with_missing_phenotypes():
    geno, beta, vars_t, probs_t = build_sim(N=320, M=400)
    y = np.asarray(geno.deplanarize(geno.y_planar))
    y[:15] = np.nan
    geno.set_phen(y)
    cfg = linear.VampConfig(max_iter=3, rho=0.3, use_xxt=True)
    x_hat, state, hist = linear.infer(geno, cfg, probs_t, vars_t, verbose=False)
    assert np.isfinite(x_hat).all()


def test_dual_gram_tracking_matches_true_init_mult():
    """XXT mode: tracked dual init residual (gmu_n) == true init mult."""
    geno, beta, vars_t, probs_t = build_sim(N=300, M=500, CV=25, h2=0.7)
    base = dict(max_iter=8, rho=0.3, use_xxt=True, seed=3)
    x_t, _, h_t = linear.infer(
        geno, linear.VampConfig(gram_refresh=1, **base), probs_t, vars_t,
        verbose=False)
    x_k, _, h_k = linear.infer(
        geno, linear.VampConfig(gram_refresh=8, **base), probs_t, vars_t,
        verbose=False)
    np.testing.assert_allclose(x_k, x_t, rtol=0,
                               atol=1e-4 * (np.abs(x_t).max() + 1e-30))
    for k in ("gam1", "gam2", "gamw", "alpha2"):
        np.testing.assert_allclose(float(h_k[-1][k]), float(h_t[-1][k]),
                                   rtol=5e-4)


def test_xxt_honors_gamma_damp():
    """--gamma-damp must produce the SAME damped trajectory in dual mode
    as in primal mode (it was silently dropped from the dual solve)."""
    geno, beta, vars_t, probs_t = build_sim(N=300, M=500, CV=25, h2=0.7)
    kw = dict(max_iter=4, rho=0.3, cg_max_iter=400, cg_err_tol=1e-10,
              gamma_damp=0.5)
    x_std, _, h_std = linear.infer(
        geno, linear.VampConfig(**kw), probs_t, vars_t, verbose=False)
    x_xxt, _, h_xxt = linear.infer(
        geno, linear.VampConfig(use_xxt=True, cg_err_tol_xxt=1e-10, **kw),
        probs_t, vars_t, verbose=False)
    np.testing.assert_allclose(x_xxt, x_std, rtol=1e-5, atol=1e-8)
    for k in ("gam1", "gam2", "gamw", "alpha2"):
        np.testing.assert_allclose(float(h_xxt[-1][k]), float(h_std[-1][k]),
                                   rtol=1e-5)
