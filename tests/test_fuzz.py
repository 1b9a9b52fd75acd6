"""Seeded robustness sweep: random shapes/missingness/priors across every
model family and dtype must stay finite and produce sane estimates.

Catches the class of numerical blowups the single-config tests miss (e.g.
the f32 alpha2 -> 1 NaN in the Huber loop, found only by driving a
non-default model on non-heavy-tailed data).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from gvamp.data import GenoBed
from gvamp import linear, probit, robust, sim
from test_data_layer import make_bed

# engine-scale tests: excluded from the <5-min core tier (README: test tiers)
pytestmark = pytest.mark.slow

CASES = [
    # (seed, N, M, miss, model, dtype, h2)
    (1, 257, 130, 0.0, "linear", jnp.float32, 0.3),
    (2, 641, 320, 0.08, "linear", jnp.float64, 0.9),
    (3, 400, 256, 0.02, "robust", jnp.float32, 0.6),
    (4, 333, 192, 0.0, "robust", jnp.float64, 0.8),
    (5, 500, 222, 0.05, "bin_class", jnp.float32, 0.8),
    (6, 290, 128, 0.0, "bin_class", jnp.float64, 0.5),
    (7, 200, 512, 0.01, "linear", jnp.float32, 0.7),   # M > N (XXT regime)
    (8, 437, 129, 0.15, "linear", jnp.float32, 0.4),   # heavy missingness
    (9, 300, 160, 0.0, "bin_class", jnp.float32, 0.9), # near-separable probit
    (10, 512, 256, 0.03, "robust", jnp.float32, 0.5),
]


@pytest.mark.parametrize("seed,N,M,miss,model,dtype,h2", CASES)
def test_fuzz_engines_stay_finite(seed, N, M, miss, model, dtype, h2):
    rng = np.random.default_rng(seed)
    codes = sim.random_genotypes(rng, M, N, miss_rate=miss)
    geno = GenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                               standardize_phen=False, dtype=dtype)
    cv = max(M // 20, 2)
    vars_t, probs_t = sim.two_group_prior(M, cv, h2)
    beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
    if model == "bin_class":
        y = sim.simulate_probit_phenotype(geno, beta, 1.0, rng)
    else:
        y = sim.simulate_linear_phenotype(geno, beta, 1.0 / (1.0 - h2), rng)
        # sprinkle phenotype NAs
        y[rng.choice(N, max(N // 40, 1), replace=False)] = np.nan
    geno.set_phen(y)

    if model == "linear":
        cfg = linear.VampConfig(max_iter=5, rho=0.25, gam1_init=1e-8,
                                gamw_init=2.0, use_xxt=(M > N))
        x, state, hist = linear.infer(geno, cfg, probs_t, vars_t,
                                      verbose=False)
    elif model == "bin_class":
        cfg = probit.ProbitConfig(max_iter=5, rho=0.25, gam1_init=1e-8)
        x, state, hist = probit.infer(geno, cfg, probs_t, vars_t,
                                      verbose=False)
    else:
        cfg = robust.RobustConfig(max_iter=5, rho=0.25, gam1_init=1e-8)
        x, state, hist = robust.infer(geno, cfg, probs_t, vars_t,
                                      verbose=False)

    assert np.isfinite(x).all(), (model, dtype)
    for k in ("gam1", "gam2"):
        if k in hist[-1]:
            assert np.isfinite(np.asarray(hist[-1][k])).all(), (model, k)
    # the estimate carries signal (loose: just above chance)
    corr = np.corrcoef(x, beta)[0, 1]
    assert np.isfinite(corr) and corr > 0.1, (model, dtype, corr)


@pytest.mark.parametrize("seed,T", [(41, 3), (42, 2)])
def test_fuzz_multi_trait_stays_finite(seed, T):
    """Multi-trait engine fuzz: odd sizes, per-trait NA patterns, f32."""
    from gvamp import multi

    rng = np.random.default_rng(seed)
    N, M = 311 + seed, 197 + 3 * seed
    codes = sim.random_genotypes(rng, M, N, miss_rate=0.03)
    geno = GenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                               standardize_phen=False, dtype=jnp.float32)
    vars_t, probs_t = sim.two_group_prior(M, 12, 0.6)
    ys, betas = [], []
    for t in range(T):
        beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
        y = sim.simulate_linear_phenotype(geno, beta, 2.5, rng)
        y[rng.choice(N, max(N // 30, 1), replace=False)] = np.nan
        ys.append(y)
        betas.append(beta)
    mp = multi.MultiPhen.build(geno, ys)
    cfg = linear.VampConfig(max_iter=5, rho=0.25, gam1_init=1e-8,
                            gamw_init=2.0)
    x, state, hist = multi.infer(mp, cfg, probs_t, vars_t, verbose=False)
    assert np.isfinite(x).all()
    assert np.isfinite(np.asarray(hist[-1]["gam1"])).all()
    for t in range(T):
        corr = np.corrcoef(x[:, t], betas[t])[0, 1]
        assert np.isfinite(corr) and corr > 0.1, (t, corr)
