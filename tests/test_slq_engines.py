"""SLQ Onsager integration (linear.VampConfig.use_slq): equality against
the per-iteration probe-CG path and a dense oracle.

The probe RHS is fixed and the Gram operator never changes inside a run
(reference g2d_onsager, vamp.cpp:871-889), so the k-node Gauss/Lanczos
quadrature built once (slq.py) must reproduce the probe path's alpha2 and
gamw trajectories: the k-node rule equals what CG-k from the same start
vector would produce, and the probe CG exits far earlier than k=32.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gvamp import linear, multi, probit, robust, sim, slq
from gvamp.data import GenoBed
from test_data_layer import make_bed


def _dataset(N=600, M=192, seed=11, miss=0.02, h2=0.7):
    rng = np.random.default_rng(seed)
    codes = sim.random_genotypes(rng, M, N, miss_rate=miss)
    geno = GenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                               standardize_phen=False, dtype=jnp.float64)
    vars_t, probs_t = sim.two_group_prior(M, max(M // 16, 2), h2)
    beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
    y = sim.simulate_linear_phenotype(geno, beta, 1.0 / (1 - h2), rng)
    geno.set_phen(y)
    return geno, probs_t, vars_t, beta, rng


def _traj(hist, key):
    return np.asarray([np.asarray(h[key]) for h in hist])


def test_linear_slq_matches_probe_path():
    geno, probs_t, vars_t, beta, _ = _dataset()
    runs = {}
    for flag in (False, True):
        cfg = linear.VampConfig(max_iter=7, rho=0.3, use_slq=flag, slq_k=32)
        x, st, hist = linear.infer(geno, cfg, probs_t, vars_t, verbose=False)
        runs[flag] = (x, hist)
    for key in ("alpha2", "gamw", "gam1", "gam2", "R2_train_2"):
        np.testing.assert_allclose(_traj(runs[True][1], key),
                                   _traj(runs[False][1], key),
                                   rtol=2e-5, err_msg=key)
    np.testing.assert_allclose(runs[True][0], runs[False][0],
                               rtol=1e-4, atol=1e-10)


def test_linear_slq_dual_matches_probe_path():
    geno, probs_t, vars_t, beta, _ = _dataset(seed=4)
    runs = {}
    for flag in (False, True):
        cfg = linear.VampConfig(max_iter=6, rho=0.3, use_xxt=True,
                                use_slq=flag, slq_k=32)
        x, st, hist = linear.infer(geno, cfg, probs_t, vars_t, verbose=False)
        runs[flag] = hist
    for key in ("alpha2", "gamw", "gam1"):
        np.testing.assert_allclose(_traj(runs[True], key),
                                   _traj(runs[False], key),
                                   rtol=2e-5, err_msg=key)


def test_slq_alpha2_matches_dense_solve():
    """quad_inv/quad_ratio vs an EXACT dense solve of
    (tau A^T A + gam2 I) q = u across a tau sweep spanning the z-model
    swings — one basis, every shift."""
    geno, probs_t, vars_t, _, _ = _dataset(N=400, M=96, seed=2)
    cfg = linear.VampConfig(use_slq=True, slq_k=96)  # k = M: exact Krylov
    aux = linear.make_aux(geno, cfg)
    u = np.asarray(aux.bern[:, 0])
    # dense padded Gram via the engine's own operators
    axm_fn, atxm_fn = geno.fns_multi()
    I = jnp.eye(geno.Mpad, dtype=geno.dtype)
    G = np.asarray(atxm_fn(geno.op, axm_fn(geno.op, I)))
    for tau in (1e-4, 1.0, 37.0, 1e5):
        for gam2 in (1e-3, 2.5):
            q = np.linalg.solve(tau * G + gam2 * np.eye(geno.Mpad), u)
            want_inv = float(u @ q)
            want_ratio = float(u @ (G @ q))
            got_inv = float(slq.quad_inv(aux.slq, tau, gam2)[0])
            got_ratio = float(slq.quad_ratio(aux.slq, tau, gam2)[0])
            np.testing.assert_allclose(got_inv, want_inv, rtol=1e-8)
            np.testing.assert_allclose(got_ratio, want_ratio, rtol=1e-8)


def test_probit_slq_matches_probe_path():
    geno, probs_t, vars_t, beta, rng = _dataset(seed=7)
    g = geno.deplanarize(np.asarray(geno.filter_pheno()))[: geno.N]
    yb = (g + rng.normal(size=geno.N) * 0.3 > 0).astype(np.float64)
    geno.set_phen(yb, standardize=False)
    runs = {}
    for flag in (False, True):
        cfg = probit.ProbitConfig(max_iter=6, use_slq=flag, slq_k=32)
        x, st, hist = probit.infer(geno, cfg, probs_t, vars_t, verbose=False)
        runs[flag] = hist
    for key in ("alpha2", "gam1", "tau1"):
        np.testing.assert_allclose(_traj(runs[True], key),
                                   _traj(runs[False], key),
                                   rtol=5e-5, err_msg=key)


def test_huber_slq_matches_probe_path():
    geno, probs_t, vars_t, beta, rng = _dataset(seed=8)
    g = geno.deplanarize(np.asarray(geno.filter_pheno()))[: geno.N]
    yh = g + rng.standard_t(2, size=geno.N) * 0.3
    geno.set_phen(yh, standardize=False)
    runs = {}
    for flag in (False, True):
        cfg = robust.RobustConfig(max_iter=6, use_slq=flag, slq_k=32)
        x, st, hist = robust.infer(geno, cfg, probs_t, vars_t, verbose=False)
        runs[flag] = hist
    # Huber tau2 swings orders of magnitude — the quadrature must track the
    # probe CG through every regime (rtol is looser because tiny alpha2
    # values sit at the probe solve's own convergence floor)
    np.testing.assert_allclose(_traj(runs[True], "alpha2"),
                               _traj(runs[False], "alpha2"), rtol=1e-3)
    np.testing.assert_allclose(_traj(runs[True], "gam1"),
                               _traj(runs[False], "gam1"), rtol=1e-3)


def test_multi_trait_slq_matches_probe_path():
    geno, probs_t, vars_t, beta, rng = _dataset(seed=9)
    y0 = geno.deplanarize(np.asarray(geno.filter_pheno()))[: geno.N]
    ys = [y0, y0 * 0.5 + rng.normal(size=geno.N),
          rng.normal(size=geno.N)]
    mp = multi.MultiPhen.build(geno, ys)
    runs = {}
    for flag in (False, True):
        cfg = linear.VampConfig(max_iter=5, rho=0.3, use_slq=flag, slq_k=32)
        x, st, hist = multi.infer(mp, cfg, probs_t, vars_t, verbose=False)
        runs[flag] = hist
    for key in ("alpha2", "gamw", "gam1"):
        np.testing.assert_allclose(_traj(runs[True], key),
                                   _traj(runs[False], key),
                                   rtol=5e-5, err_msg=key)


def test_linear_fold_kill_switch_with_slq(monkeypatch):
    """GVAMP_NOISE_PASS=1 (explicit noise-EM wide pass) must reproduce the
    folded path under SLQ: resid2 via the exit Gram identity vs the
    explicit A x2 pass, trace via quad_ratio in both arms."""
    geno, probs_t, vars_t, beta, _ = _dataset(N=500, M=160, seed=5)
    runs = {}
    for kill in ("0", "1"):
        monkeypatch.setenv("GVAMP_NOISE_PASS", kill)
        cfg = linear.VampConfig(max_iter=5, rho=0.3, use_slq=True)
        x, st, hist = linear.infer(geno, cfg, probs_t, vars_t, verbose=False)
        runs[kill] = (x, hist)
    for key in ("gamw", "gam1", "R2_train_2"):
        np.testing.assert_allclose(_traj(runs["1"][1], key),
                                   _traj(runs["0"][1], key),
                                   rtol=1e-6, err_msg=key)
    np.testing.assert_allclose(runs["1"][0], runs["0"][0],
                               rtol=1e-5, atol=1e-12)


def test_red_mode_keeps_probe_columns():
    """--red re-draws its sample window per iteration, so the fixed-Gram
    quadrature does not apply: use_slq must be a no-op there (identical
    program, bit-identical trajectories)."""
    geno, probs_t, vars_t, _, _ = _dataset(N=2600, M=128, seed=12, miss=0.0)
    assert linear.probe_cols(
        linear.VampConfig(use_slq=True, red=True)) == 1
    runs = {}
    for flag in (False, True):
        cfg = linear.VampConfig(max_iter=4, red=True, use_slq=flag)
        x, st, hist = linear.infer(geno, cfg, probs_t, vars_t, verbose=False)
        runs[flag] = (x, hist)
    np.testing.assert_array_equal(runs[True][0], runs[False][0])
    np.testing.assert_array_equal(_traj(runs[True][1], "alpha2"),
                                  _traj(runs[False][1], "alpha2"))
