"""CG solver vs direct dense solve, warm start, Onsager probe consistency."""

import numpy as np
import jax.numpy as jnp

from gvamp import cg
from gvamp.data import GenoBed
from helpers import DenseOracle, random_dataset
from test_data_layer import make_bed


def _setup(N=240, M=60, seed=0):
    rng = np.random.default_rng(seed)
    codes, y = random_dataset(rng, N, M, miss_phen=0.0)
    oracle = DenseOracle(codes, y)
    geno = GenoBed.from_arrays(make_bed(codes), y, N=N, dtype=jnp.float64)
    return rng, oracle, geno


def test_cg_matches_direct_solve():
    rng, oracle, geno = _setup()
    tau, gam2 = 1.7, 0.6
    M = oracle.M
    ax_fn, atx_fn = geno.fns()
    mult = cg.make_lmmse_mult(ax_fn, atx_fn, geno.op, tau, gam2)
    v_np = rng.normal(size=M)
    v = geno.pad_m(v_np)
    res = cg.solve(mult, v, jnp.zeros_like(v), cg.jacobi_diag(tau, gam2, geno.N),
                   gam2, max_iter=200, err_tol=1e-12)
    Amat = tau * oracle.A @ oracle.A.T + gam2 * np.eye(M)
    expect = np.linalg.solve(Amat, v_np)
    np.testing.assert_allclose(np.asarray(res.mu)[:M], expect, rtol=1e-7, atol=1e-10)
    assert np.all(np.asarray(res.mu)[M:] == 0.0)


def test_cg_warm_start_converges_faster():
    rng, oracle, geno = _setup(seed=3)
    tau, gam2 = 2.2, 1.1
    ax_fn, atx_fn = geno.fns()
    mult = cg.make_lmmse_mult(ax_fn, atx_fn, geno.op, tau, gam2)
    v = geno.pad_m(rng.normal(size=oracle.M))
    cold = cg.solve(mult, v, jnp.zeros_like(v), cg.jacobi_diag(tau, gam2, geno.N),
                    gam2, max_iter=100, err_tol=1e-6)
    warm = cg.solve(mult, v, cold.mu, cg.jacobi_diag(tau, gam2, geno.N),
                    gam2, max_iter=100, err_tol=1e-6)
    assert int(warm.iters) <= int(cold.iters)
    np.testing.assert_allclose(np.asarray(warm.mu), np.asarray(cold.mu),
                               rtol=1e-4, atol=1e-8)


def test_onsager_probe_mode_estimates_trace():
    """gam2 * u^T Q^{-1} u with u ~ +-1/sqrt(M) estimates gam2/M tr(Q^{-1})
    (g2d_onsager, vamp.cpp:871-889); exact in expectation — here we check the
    probe solve itself against the direct inverse."""
    rng, oracle, geno = _setup(seed=5)
    tau, gam2 = 1.0, 0.8
    M = oracle.M
    ax_fn, atx_fn = geno.fns()
    mult = cg.make_lmmse_mult(ax_fn, atx_fn, geno.op, tau, gam2)
    u_np = rng.choice([-1.0, 1.0], size=M) / np.sqrt(M)
    u = geno.pad_m(u_np)
    res = cg.solve(mult, u, jnp.zeros_like(u), cg.jacobi_diag(tau, gam2, geno.N),
                   gam2, max_iter=300, onsager=True, onsager_tol=1e-14)
    Q = tau * oracle.A @ oracle.A.T + gam2 * np.eye(M)
    expect = gam2 * (u_np @ np.linalg.solve(Q, u_np))
    got = gam2 * float(jnp.sum(u * res.mu))
    np.testing.assert_allclose(got, expect, rtol=1e-6)


def test_deflated_cg_matches_and_converges_faster():
    """Spectral deflation: identical VAMP results, fewer CG iterations on
    LD-structured (serially correlated) genotypes."""
    import jax
    import jax.numpy as jnp
    from gvamp.data import GenoBed
    from gvamp import linear, sim
    from test_data_layer import make_bed

    rng = np.random.default_rng(0)
    N, M, rho = 600, 1024, 0.97
    codes = np.zeros((M, N), dtype=np.uint8)
    codes[0] = sim.random_genotypes(rng, 1, N)[0]
    for m in range(1, M):
        fresh = sim.random_genotypes(rng, 1, N)[0]
        codes[m] = np.where(rng.random(N) < rho, codes[m - 1], fresh)
    geno = GenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                               standardize_phen=False, dtype=jnp.float64)
    vars_t, probs_t = sim.two_group_prior(M, 40, 0.6)
    beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
    y = sim.simulate_linear_phenotype(geno, beta, 2.5, rng)
    geno.set_phen(y)

    results = {}
    for k in (0, 96):
        cfg = linear.VampConfig(max_iter=4, rho=0.2, gam1_init=1e-8,
                                gamw_init=2.0, stop_criteria_thr=0.0,
                                deflate_k=k, deflate_iters=8)
        st = linear.init_state(geno, cfg, probs_t, vars_t)
        aux = linear.make_aux(geno, cfg)
        step = linear.make_step(geno, cfg)
        cg_total = 0
        for _ in range(4):
            st, m = step(st, aux)
            cg_total += int(m["cg_iters"])
        results[k] = (np.asarray(st.x1), cg_total)

    x0, it0 = results[0]
    x1, it1 = results[96]
    # both runs solve to the same CG residual tolerance; agreement is at
    # the solve-tolerance scale, not exact
    np.testing.assert_allclose(x1, x0, rtol=1e-2, atol=2e-3)
    corr = np.corrcoef(x1, x0)[0, 1]
    assert corr > 0.99999, corr
    assert it1 < 0.75 * it0, (it1, it0)


def test_block_cg_zero_rhs_column_finishes():
    """An all-zero RHS column must converge immediately (mu=0, finite
    rel_err), not spin to max_iter on a NaN relative residual."""
    rng, oracle, geno = _setup()
    axm, atxm = geno.fns_multi()
    op = geno.op
    mult = cg.make_lmmse_mult_block(axm, atxm, op, tau=2.0, gam2=0.5)
    v1 = geno.pad_m(rng.standard_normal(geno.M))
    V = jnp.stack([v1, jnp.zeros_like(v1)], axis=1)
    res = cg.solve_block(mult, V, jnp.zeros_like(V),
                         cg.jacobi_diag(2.0, 0.5, geno.N), 0.5,
                         max_iter=50, modes=(0, 0))
    assert np.isfinite(np.asarray(res.rel_err)).all()
    assert int(res.iters[1]) <= 1
    np.testing.assert_allclose(np.asarray(res.mu)[:, 1], 0.0, atol=1e-12)
    assert int(res.iters[0]) < 50  # real column converged normally


def test_geo_damp_properties():
    """geo_damp: s=1 identity, inactive passthrough, bounded log-step."""
    import numpy as np
    from gvamp.linear import geo_damp

    old, new = jnp.asarray(2.0), jnp.asarray(2.0e6)
    # s=1: raw update
    np.testing.assert_allclose(float(geo_damp(new, old, 1.0, True)), 2.0e6)
    # inactive: raw update regardless of s
    np.testing.assert_allclose(float(geo_damp(new, old, 0.3, False)), 2.0e6)
    # s=0.5: geometric mean — log-step halved
    np.testing.assert_allclose(float(geo_damp(new, old, 0.5, True)),
                               float(jnp.sqrt(old * new)), rtol=1e-6)
    # monotone: damped value lies between old and new
    for s in (0.25, 0.75):
        v = float(geo_damp(new, old, s, True))
        assert float(old) < v < float(new)
    # elementwise over vectors (multi-trait use)
    v = geo_damp(jnp.asarray([1e6, 1e-6]), jnp.asarray([1.0, 1.0]), 0.5, True)
    np.testing.assert_allclose(np.asarray(v), [1e3, 1e-3], rtol=1e-5)
