"""Mixture-prior tests: g1/g1d analytics, EM update vs NumPy oracle, merging."""

import numpy as np
import jax
import jax.numpy as jnp

from gvamp.prior import Prior, g1, g1d, update_prior, initialize_prior


def np_g1(y, gam1, probs, vars_):
    """Direct f64 restatement of the posterior mean (vamp.cpp:805-834)."""
    sigma = 1.0 / gam1
    vmax = vars_.max()
    pk = pkd = 0.0
    for p, v in zip(probs, vars_):
        e = np.exp(-0.5 * y**2 * (vmax - v) / ((v + sigma) * (vmax + sigma)))
        z = p / np.sqrt(v + sigma) * e
        pk += z
        pkd -= z / (v + sigma) * y
    return y + sigma * pkd / pk


def test_g1_matches_scalar_form():
    probs = np.array([0.9, 0.07, 0.03])
    vars_ = np.array([0.0, 0.5, 5.0])
    prior = Prior(jnp.asarray(probs), jnp.asarray(vars_))
    r = np.linspace(-8, 8, 101)
    ours = np.asarray(g1(jnp.asarray(r), 2.5, prior))
    ref = np.array([np_g1(x, 2.5, probs, vars_) for x in r])
    np.testing.assert_allclose(ours, ref, rtol=1e-12)


def test_g1d_is_derivative_of_g1():
    probs = jnp.array([0.8, 0.15, 0.05])
    vars_ = jnp.array([0.0, 1.0, 10.0])
    prior = Prior(probs, vars_)
    r = jnp.linspace(-5, 5, 41)
    auto = jax.vmap(jax.grad(lambda x: g1(x[None], 3.0, prior)[0]))(r)
    ours = g1d(r, 3.0, prior)
    np.testing.assert_allclose(np.asarray(ours), np.asarray(auto), rtol=1e-9)


def test_g1_posterior_mean_2component_closed_form():
    """Spike + single slab: g1 must equal the analytic posterior mean."""
    lam, v = 0.3, 2.0
    prior = Prior(jnp.array([1 - lam, lam]), jnp.array([0.0, v]))
    gam1 = 1.7
    sigma = 1.0 / gam1
    r = np.linspace(-4, 4, 21)
    # posterior: w(r) * (v/(v+sigma)) * r with w = P(slab | r)
    from scipy.stats import norm
    num = lam * norm.pdf(r, 0, np.sqrt(v + sigma))
    den = num + (1 - lam) * norm.pdf(r, 0, np.sqrt(sigma))
    expect = num / den * (v / (v + sigma)) * r
    ours = np.asarray(g1(jnp.asarray(r), gam1, prior))
    np.testing.assert_allclose(ours, expect, rtol=1e-10)


def np_update_prior(r1, gam1, probs, vars_, mt, em_iters, learn_vars=True):
    """NumPy restatement of one EM pass structure (vamp.cpp:929-1049)."""
    probs, vars_ = probs.copy(), vars_.copy()
    nv = 1.0 / gam1
    lam = 1 - probs[0]
    omegas = probs / lam
    for _ in range(em_iters):
        vmax = vars_.max()
        vs = vars_[1:]
        num = (lam * omegas[None, 1:]
               * np.exp(-0.5 * r1[:, None]**2 * (vmax - vs) / ((vs + nv) * (vmax + nv)))
               / np.sqrt(vs + nv) / np.sqrt(2 * np.pi))
        sn = num.sum(1)
        beta = num / sn[:, None]
        gammas = (gam1 * r1)[:, None] / (1 / vs + gam1)
        vpost = 1 / (1 / vs + gam1)
        pin = 1 / (1 + (1 - lam) / np.sqrt(2 * np.pi * nv)
                   * np.exp(-0.5 * r1**2 * vmax / (nv * (nv + vmax))) / sn)
        sum_pin = pin.sum()
        lam = sum_pin / mt
        res = (beta * pin[:, None]).sum(0)
        res_g = (beta * (gammas**2 + vpost) * pin[:, None]).sum(0)
        if learn_vars:
            vars_[1:] = res_g / res
        omegas = np.concatenate([[0], res / sum_pin])
        probs = np.concatenate([[1 - lam], lam * omegas[1:]])
    return probs, vars_


def test_em_update_matches_numpy():
    rng = np.random.default_rng(0)
    M = 400
    probs = np.array([0.85, 0.1, 0.05])
    vars_ = np.array([0.0, 0.8, 6.0])
    r1 = rng.normal(0, 2.0, M)
    gam1 = 1.3
    ours = update_prior(jnp.asarray(r1), gam1, Prior(jnp.asarray(probs), jnp.asarray(vars_)),
                        jnp.ones(M), float(M), em_max_iter=1, em_err_thr=0.0)
    ref_p, ref_v = np_update_prior(r1, gam1, probs, vars_, M, 1)
    np.testing.assert_allclose(np.asarray(ours.probs), ref_p, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(ours.vars), ref_v, rtol=1e-10)


def test_em_respects_marker_mask():
    """Padded markers must not contribute to the EM sums."""
    rng = np.random.default_rng(1)
    M, pad = 300, 100
    probs = np.array([0.9, 0.1])
    vars_ = np.array([0.0, 1.5])
    r1 = rng.normal(0, 1.5, M)
    r1p = np.concatenate([r1, np.full(pad, 7.7)])
    mask = np.concatenate([np.ones(M), np.zeros(pad)])
    a = update_prior(jnp.asarray(r1), 2.0, Prior(jnp.asarray(probs), jnp.asarray(vars_)),
                     jnp.ones(M), float(M), em_max_iter=2)
    b = update_prior(jnp.asarray(r1p), 2.0, Prior(jnp.asarray(probs), jnp.asarray(vars_)),
                     jnp.asarray(mask), float(M), em_max_iter=2)
    np.testing.assert_allclose(np.asarray(a.probs), np.asarray(b.probs), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(a.vars), np.asarray(b.vars), rtol=1e-12)


def test_component_merging():
    """Close variances merge: probability moves, slot dies, vmax preserved
    (fixed-slot version of vamp.cpp:1054-1071)."""
    rng = np.random.default_rng(2)
    r1 = rng.normal(0, 1, 50)
    probs = jnp.array([0.5, 0.3, 0.2])
    vars_ = jnp.array([0.0, 1.00, 1.01])  # comps 1,2 within 50% rel -> merge
    out = update_prior(jnp.asarray(r1), 1.0, Prior(probs, vars_),
                       jnp.ones(50), 50.0, em_max_iter=0)  # merge-only pass
    p = np.asarray(out.probs)
    v = np.asarray(out.vars)
    assert p[2] == 0.0
    np.testing.assert_allclose(p.sum(), 1.0, rtol=1e-12)
    assert v[2] == v[1]  # survivor var duplicated into dead slot


def test_initialize_prior_default_23():
    probs, vars_ = initialize_prior(None, None, N=1000, Mt=100000)
    assert len(probs) == 23 and len(vars_) == 23
    assert vars_[0] == 0.0
    np.testing.assert_allclose(probs[0], 1 - 50000 / 100000)
    # slab probs halve geometrically
    np.testing.assert_allclose(probs[2] / probs[1], 0.5)
    # vars log-spaced 1e-5..1e2 then / N
    np.testing.assert_allclose(vars_[1] * 1000, 1e-5, rtol=1e-9)
    np.testing.assert_allclose(vars_[-1] * 1000, 1e2, rtol=1e-9)
    # probabilities sum to one
    np.testing.assert_allclose(np.sum(probs), 1.0, rtol=1e-9)


def test_pip_matches_unshifted_bayes_posterior():
    """pip == P(slab | r) by direct (unshifted) Bayes in f64, and behaves:
    0 at r=0 under a dominant spike, -> 1 for |r| >> noise."""
    from gvamp.prior import pip

    probs = np.array([0.9, 0.07, 0.03])
    vars_ = np.array([0.0, 0.5, 5.0])
    gam1 = 2.5
    sigma = 1.0 / gam1
    r = np.linspace(-8.0, 8.0, 101)
    dens = np.stack([p / np.sqrt(2 * np.pi * (v + sigma))
                     * np.exp(-0.5 * r**2 / (v + sigma))
                     for p, v in zip(probs, vars_)])
    ref = 1.0 - dens[0] / dens.sum(axis=0)
    prior = Prior(jnp.asarray(probs), jnp.asarray(vars_))
    ours = np.asarray(pip(jnp.asarray(r), gam1, prior))
    np.testing.assert_allclose(ours, ref, rtol=1e-10, atol=1e-12)
    assert (ours >= 0).all() and (ours <= 1).all()
    assert ours[50] < 0.2 and ours[0] > 0.999 and ours[-1] > 0.999


def test_pip_ignores_merged_zero_prob_slots():
    """A merged slot (prob 0, duplicated var) must not perturb the pip."""
    from gvamp.prior import pip

    r = jnp.linspace(-4.0, 4.0, 17)
    base = Prior(jnp.array([0.8, 0.2]), jnp.array([0.0, 1.0]))
    merged = Prior(jnp.array([0.8, 0.2, 0.0]), jnp.array([0.0, 1.0, 1.0]))
    np.testing.assert_allclose(np.asarray(pip(r, 3.0, base)),
                               np.asarray(pip(r, 3.0, merged)), rtol=1e-12)
