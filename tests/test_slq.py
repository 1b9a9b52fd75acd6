"""Stochastic Lanczos quadrature (gvamp/slq.py) vs dense exact algebra.

The SLQ basis replaces the reference's per-iteration Onsager probe CG
(g2d_onsager, vamp.cpp:871-889) and the noise-EM trace reuse
(updateNoisePrec, vamp.cpp:892-927): on a small dense G the quadrature
estimates of u^T f(G) u must match the exact solves for every shift pair,
and must dominate what a truncated CG would deliver.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gvamp import slq


def _dense_spd(n, seed, rank=None):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, (rank or n))).astype(np.float64)
    return (A @ A.T) / n


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("rank_frac", [0.4, 2.5])
def test_quad_matches_dense_exact(seed, rank_frac):
    """Rectangular genotype spectra (the real case): G = A^T A / N with
    M != N keeps the Marchenko-Pastur bulk separated from 0 (plus, when
    M > N, an exact point mass AT 0, which one Lanczos node captures
    exactly), so the k-node rule nails every shift pair."""
    n, k = 96, 40
    G = _dense_spd(n, seed, rank=int(n * rank_frac))
    u = np.where(np.random.default_rng(seed + 9).random(n) > 0.5, 1.0, -1.0)
    u /= np.sqrt(n)
    Gj = jnp.asarray(G, jnp.float64)
    basis = slq.build(lambda X: Gj @ X, jnp.asarray(u[:, None]), k)
    for tau, gam2 in [(1.0, 1.0), (2.3, 1e-3), (0.01, 5.0), (1e3, 1e-2)]:
        Q = tau * G + gam2 * np.eye(n)
        want_inv = float(u @ np.linalg.solve(Q, u))
        want_rat = float(u @ (G @ np.linalg.solve(Q, u)))
        got_inv = float(slq.quad_inv(basis, tau, gam2)[0])
        got_rat = float(slq.quad_ratio(basis, tau, gam2)[0])
        assert abs(got_inv - want_inv) <= 1e-6 * abs(want_inv), (tau, gam2)
        assert abs(got_rat - want_rat) <= 1e-6 * abs(want_rat), (tau, gam2)


def test_square_spectrum_hard_shift():
    """M ~ N: the bulk touches 0 and a near-zero shift makes f(lam) spike —
    the same kappa -> inf regime where the reference's probe CG needs many
    iterations.  The k-node rule equals a k-iteration CG quadform from the
    same start, so demand only the engineering tolerance alpha2 actually
    needs (Hutchinson MC noise is O(1/sqrt(M)) >> this)."""
    n, k = 96, 40
    G = _dense_spd(n, 0)
    u = np.where(np.random.default_rng(9).random(n) > 0.5, 1.0, -1.0)
    u /= np.sqrt(n)
    Gj = jnp.asarray(G, jnp.float64)
    basis = slq.build(lambda X: Gj @ X, jnp.asarray(u[:, None]), k)
    tau, gam2 = 2.3, 1e-3
    Q = tau * G + gam2 * np.eye(n)
    want = float(u @ np.linalg.solve(Q, u))
    got = float(slq.quad_inv(basis, tau, gam2)[0])
    assert abs(got - want) <= 0.2 * abs(want)


def test_block_columns_independent_operators():
    """Column j must see operator j only (the multi-trait contract)."""
    n, k, C = 64, 30, 3
    Gs = [_dense_spd(n, 10 + j, rank=2 * n) for j in range(C)]
    rng = np.random.default_rng(2)
    U = rng.standard_normal((n, C))
    Gsj = jnp.asarray(np.stack(Gs))

    def mult(X):
        return jnp.einsum("cnm,mc->nc", Gsj, X)

    basis = slq.build(mult, jnp.asarray(U), k)
    taus = np.array([0.5, 2.0, 7.0])
    gam2s = np.array([1.0, 1e-2, 3.0])
    got = np.asarray(slq.quad_inv(basis, taus, gam2s))
    for j in range(C):
        Q = taus[j] * Gs[j] + gam2s[j] * np.eye(n)
        want = float(U[:, j] @ np.linalg.solve(Q, U[:, j]))
        assert abs(got[j] - want) <= 2e-5 * abs(want)


def test_breakdown_is_benign():
    """Krylov space smaller than k: exact answers, no NaN from the padding
    (rank-4 G exhausts in <= 5 steps; the k=20 rule must still be exact)."""
    n, k = 48, 20
    G = _dense_spd(n, 5, rank=4)
    rng = np.random.default_rng(1)
    u = rng.standard_normal(n)
    Gj = jnp.asarray(G)
    basis = slq.build(lambda X: Gj @ X, jnp.asarray(u[:, None]), k)
    assert np.all(np.isfinite(np.asarray(basis.lam)))
    assert np.all(np.isfinite(np.asarray(basis.wts)))
    Q = 1.7 * G + 0.3 * np.eye(n)
    want = float(u @ np.linalg.solve(Q, u))
    got = float(slq.quad_inv(basis, 1.7, 0.3)[0])
    assert abs(got - want) <= 1e-8 * abs(want)


def test_zero_start_column():
    n, k = 32, 8
    G = _dense_spd(n, 7)
    U = np.zeros((n, 2))
    U[:, 1] = 1.0
    Gj = jnp.asarray(G)
    basis = slq.build(lambda X: Gj @ X, jnp.asarray(U), k)
    got = np.asarray(slq.quad_inv(basis, 1.0, 1.0))
    assert got[0] == 0.0
    Q = G + np.eye(n)
    want = float(U[:, 1] @ np.linalg.solve(Q, U[:, 1]))
    assert abs(got[1] - want) <= 1e-5 * abs(want)


def test_f32_accuracy_sufficient_for_onsager():
    """f32 end-to-end (the engines' dtype): quadrature error must sit well
    under the Hutchinson MC error the estimator already carries."""
    n, k = 256, 32
    G = _dense_spd(n, 11, rank=3 * n)
    u = np.where(np.random.default_rng(4).random(n) > 0.5, 1.0, -1.0)
    u /= np.sqrt(n)
    Gj = jnp.asarray(G, jnp.float32)
    basis = slq.build(lambda X: Gj @ X,
                      jnp.asarray(u[:, None], jnp.float32), k)
    for tau, gam2 in [(1.0, 1e-4), (3.0, 1e-2), (0.2, 2.0)]:
        Q = tau * G + gam2 * np.eye(n)
        want = float(u @ np.linalg.solve(Q, u))
        got = float(slq.quad_inv(basis, tau, gam2)[0])
        assert abs(got - want) <= 2e-4 * abs(want), (tau, gam2)
