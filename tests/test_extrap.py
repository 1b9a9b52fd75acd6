"""Secant-extrapolated CG warm start (cg.extrapolate_pair,
VampConfig.cg_extrapolate).

The tracked-Gram carry makes the CG init residual free; Gram LINEARITY
makes the extrapolated start mu1 + theta (mu1 - mu2) and its Gram product
free too, and the per-column least-squares theta can only LOWER the
tracked init residual below the plain warm start's.  The solve still
exits at the same cg_err_tol, so the VAMP trajectory stays in the same
solve-accuracy class as the plain warm start (the reference cold-starts
every CG, vamp.cpp:594-596 — both warm starts are extensions).

Effect: steady-state block CG drops from two iterations to ONE on bench
config B (4 -> 2 packed reads/iteration).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gvamp import cg, linear, multi, sim
from gvamp.data import GenoBed
from test_data_layer import make_bed


def _traj(hist, key):
    return np.asarray([np.asarray(h[key]) for h in hist])


def test_extrapolate_pair_linearity_and_ls_optimality():
    rng = np.random.default_rng(5)
    M, B = 96, 3
    A = rng.standard_normal((64, M))
    G = A.T @ A
    mu2 = rng.standard_normal((M, B))
    mu1 = mu2 + 0.1 * rng.standard_normal((M, B))
    gmu1, gmu2 = G @ mu1, G @ mu2
    V = rng.standard_normal((M, B))
    tau, gam2 = 0.7, 1.3

    mu0, gmu0 = cg.extrapolate_pair(jnp.asarray(V), jnp.asarray(mu1),
                                    jnp.asarray(gmu1), jnp.asarray(mu2),
                                    jnp.asarray(gmu2), tau, gam2)
    # (a) Gram linearity: the carried product IS the true Gram product of
    # the extrapolated start (exactly, up to fp)
    np.testing.assert_allclose(np.asarray(gmu0), G @ np.asarray(mu0),
                               rtol=1e-10, atol=1e-10)
    # (b) LS optimality: tracked init residual never above theta=0's
    def res(m, g):
        return np.linalg.norm(V - (tau * np.asarray(g)
                                   + gam2 * np.asarray(m)), axis=0)
    assert (res(mu0, gmu0) <= res(mu1, gmu1) + 1e-12).all()
    # (c) guards: an all-zero previous pair disarms extrapolation exactly
    z = jnp.zeros_like(mu1)
    mu0z, gmu0z = cg.extrapolate_pair(jnp.asarray(V), jnp.asarray(mu1),
                                      jnp.asarray(gmu1), z, z, tau, gam2)
    np.testing.assert_array_equal(np.asarray(mu0z), mu1)
    np.testing.assert_array_equal(np.asarray(gmu0z), gmu1)


def test_extrapolate_pair_per_column_tau():
    # the multi-trait call site passes per-column tau/gam2 rows [1, B]
    rng = np.random.default_rng(6)
    M, B = 64, 4
    A = rng.standard_normal((48, M))
    G = A.T @ A
    mu2 = rng.standard_normal((M, B))
    mu1 = mu2 + 0.05 * rng.standard_normal((M, B))
    V = rng.standard_normal((M, B))
    tau = jnp.asarray(rng.uniform(0.1, 3.0, B))[None, :]
    gam2 = jnp.asarray(rng.uniform(0.1, 3.0, B))[None, :]
    mu0, gmu0 = cg.extrapolate_pair(
        jnp.asarray(V), jnp.asarray(mu1), jnp.asarray(G @ mu1),
        jnp.asarray(mu2), jnp.asarray(G @ mu2), tau, gam2)
    np.testing.assert_allclose(np.asarray(gmu0), G @ np.asarray(mu0),
                               rtol=1e-10, atol=1e-10)
    r0 = np.linalg.norm(V - np.asarray(tau) * np.asarray(gmu0)
                        - np.asarray(gam2) * np.asarray(mu0), axis=0)
    r_plain = np.linalg.norm(V - np.asarray(tau) * (G @ mu1)
                             - np.asarray(gam2) * mu1, axis=0)
    assert (r0 <= r_plain + 1e-12).all()


@pytest.mark.slow
def test_linear_extrapolate_matches_plain():
    """A/B kill-switch: same trajectory class, fewer CG iterations."""
    rng = np.random.default_rng(11)
    N, M = 900, 384
    codes = sim.random_genotypes(rng, M, N, miss_rate=0.02)
    geno = GenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                               standardize_phen=False, dtype=jnp.float64)
    vars_t, probs_t = sim.two_group_prior(M, max(M // 16, 2), 0.7)
    beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
    y = sim.simulate_linear_phenotype(geno, beta, 1.0 / 0.3, rng)
    geno.set_phen(y)
    runs = {}
    for ex in (False, True):
        cfg = linear.VampConfig(max_iter=10, rho=0.3, cg_extrapolate=ex)
        x, st, hist = linear.infer(geno, cfg, probs_t, vars_t, verbose=False)
        runs[ex] = (np.asarray(x), hist)
    for key in ("gam1", "gamw", "alpha2", "R2_train_2"):
        np.testing.assert_allclose(_traj(runs[True][1], key),
                                   _traj(runs[False][1], key),
                                   rtol=3e-4, err_msg=key)
    # estimates agree within the solve-accuracy class
    x0, x1 = runs[False][0], runs[True][0]
    assert np.linalg.norm(x0 - x1) / np.linalg.norm(x0) < 1e-3
    # the point of the feature: never MORE CG iterations at steady state
    c0 = _traj(runs[False][1], "cg_iters")[3:]
    c1 = _traj(runs[True][1], "cg_iters")[3:]
    assert (c1 <= c0).all() and c1.sum() < c0.sum()


@pytest.mark.slow
def test_multi_extrapolate_matches_plain():
    rng = np.random.default_rng(7)
    N, M, T = 600, 256, 3
    codes = sim.random_genotypes(rng, M, N, miss_rate=0.01)
    geno = GenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                               standardize_phen=False, dtype=jnp.float64)
    vars_t, probs_t = sim.two_group_prior(M, 15, 0.6)
    ys = []
    for t in range(T):
        beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
        ys.append(sim.simulate_linear_phenotype(geno, beta, 2.5, rng))
    mp = multi.MultiPhen.build(geno, ys, standardize=False)
    runs = {}
    for ex in (False, True):
        cfg = linear.VampConfig(max_iter=8, rho=0.3, gam1_init=1e-8,
                                stop_criteria_thr=0.0, cg_extrapolate=ex)
        xm, sm, hm = multi.infer(mp, cfg, probs_t, vars_t, verbose=False)
        runs[ex] = (np.asarray(xm), hm)
    for key in ("gam1", "gamw", "alpha2"):
        np.testing.assert_allclose(_traj(runs[True][1], key),
                                   _traj(runs[False][1], key),
                                   rtol=3e-4, err_msg=key)
    x0, x1 = runs[False][0], runs[True][0]
    assert np.linalg.norm(x0 - x1) / np.linalg.norm(x0) < 1e-3
    c0 = _traj(runs[False][1], "cg_iters")[3:]
    c1 = _traj(runs[True][1], "cg_iters")[3:]
    assert c1.sum() <= c0.sum()


def test_resume_pre_extrap_checkpoint(tmp_path):
    """Checkpoints written before the secant-pair fields existed load with
    zero-filled mu_prevb/gmu_prev (ckpt.load_state backward fill) — the
    extrapolation theta guard then disarms until two fresh exits exist."""
    import json

    from gvamp import ckpt

    rng = np.random.default_rng(3)
    N, M = 200, 128
    codes = sim.random_genotypes(rng, M, N, miss_rate=0.0)
    geno = GenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                               standardize_phen=False, dtype=jnp.float64)
    vars_t, probs_t = sim.two_group_prior(M, 4, 0.5)
    y = sim.simulate_linear_phenotype(
        geno, sim.simulate_mixture(rng, M, vars_t, probs_t), 2.0, rng)
    geno.set_phen(y)
    cfg = linear.VampConfig(max_iter=2, rho=0.3)
    x, st, hist = linear.infer(geno, cfg, probs_t, vars_t, verbose=False)
    p = tmp_path / "ck.npz"
    ckpt.save_state(str(p), st, cfg={"use_slq": True})
    z = dict(np.load(p, allow_pickle=False))
    meta = json.loads(bytes(z["_meta"]).decode())
    for f in ("mu_prevb", "gmu_prev"):   # simulate the round-<=4 schema
        meta["fields"].remove(f)
        z.pop(f"f_{f}")
    z["_meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(p, **z)
    st2, meta2 = ckpt.load_state(str(p), linear.LinState)
    assert st2.mu_prevb.shape == st.gmu.shape
    assert not np.asarray(st2.mu_prevb).any()
    assert not np.asarray(st2.gmu_prev).any()
    np.testing.assert_array_equal(np.asarray(st2.x1), np.asarray(st.x1))
