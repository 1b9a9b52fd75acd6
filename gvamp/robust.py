"""Huber-loss robust VAMP (heavy-tailed noise).

Re-design of the reference's ``infere_robust`` (vamp_Huber.cpp:24-441): same
skeleton as the probit loop but the z-denoiser is the closed-form Huber
proximal (Bradic–Chen formulas, vamp_Huber.cpp:443-503) and the Huber
threshold ``deltaH`` is learned each iteration by Monte-Carlo EM over a fixed
grid (vamp_Huber.cpp:522-586).  The MC expectation vectorizes over
(individuals x MC draws x grid points) in one shot instead of the reference's
triple scalar loop.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import os

import jax
import jax.numpy as jnp
import numpy as np

from gvamp import cg
from gvamp.linear import (VampConfig, _cast_like, _clamp_gamma, geo_damp,
                              make_bern_probe)
from gvamp.linear import probe_cols as linear_probe_cols
from gvamp.prior import GAMMA_MIN, Prior, g1, g1d, update_prior

# deltaH M-step grid (vamp_Huber.cpp:259)
DELTA_GRID = np.array([1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1,
                       0.2, 0.4, 0.6, 0.8, 1.0, 1.5, 2.0, 3.0])


# --------------------------------------------------------------------------
# Huber proximal denoisers (vamp_Huber.cpp:443-503)
# --------------------------------------------------------------------------


def g1_huber(p1, tau1, delta, y):
    """Posterior-mode z under Huber loss: y - prox_{var*huber}(y - p1)."""
    var = 1.0 / tau1
    thr = (1.0 + var) * delta
    w = y - p1
    est = jnp.where(jnp.abs(w) <= thr, w / (1.0 + var),
                    jnp.where(w > thr, w - var * delta, w + var * delta))
    return y - est


def g1d_huber(p1, tau1, delta, y):
    """g1_huber - p1 in prox form (the reference's g1d_Huber,
    vamp_Huber.cpp:464-482, corrected: the reference branches its linear
    region on |p1| <= thr instead of |w| <= thr and leaves the
    (|p1| > thr, |w| <= thr) case uninitialized — a documented quirk
    (SURVEY.md §7); the Bradic-Chen Ex. 2 formulas branch on w)."""
    var = 1.0 / tau1
    thr = (1.0 + var) * delta
    w = y - p1
    return jnp.where(jnp.abs(w) <= thr, -var * w / (1.0 + var),
                     jnp.where(w > thr, -var * delta, var * delta))


def g1d_huber_der(p1, tau1, delta, y):
    """The beta1 "derivative" EXACTLY as the reference computes it
    (vamp_Huber.cpp:485-503): branched on |p1| with -1 on the lower tail.

    This is NOT the true prox derivative (that would be est'(w) in (0, 1],
    branch on |w|) — but the reference's published dynamics depend on it:
    its deltaH EM objective is monotone in delta (M_deltaH_update minimizes
    E[huber_delta], which always selects the smallest grid point, 1e-6), so
    the true derivative degenerates to beta1 -> 1 (the zero-information
    limit) and the loop stalls.  With the reference's sign-mixed form,
    beta1 ~ E[sign(w)]-ish stays informative and the robust model matches
    the reference's (good) published behavior — measured corr-vs-truth
    0.804 (ours) vs 0.759 (reference binary) on identical heavy-tailed
    data.  The reference leaves the (|p1| > thr, |w| <= thr) case
    uninitialized (UB); we define it as the lower-tail value."""
    var = 1.0 / tau1
    thr = (1.0 + var) * delta
    w = y - p1
    return jnp.where(jnp.abs(p1) <= thr, 1.0 / (1.0 + var),
                     jnp.where(w > thr, 1.0, -1.0))


def huber_loss(z, delta, y):
    w = y - z
    aw = jnp.abs(w)
    return jnp.where(aw <= delta, w * w / 2.0, delta * (aw - delta / 2.0))


def em_deltaH(key, p1, tau1, y, n_mask, grid=DELTA_GRID,
              num_mc: int = 100):
    """MC grid search for deltaH (vamp_Huber.cpp:522-586).

    E-step: E_{z ~ N(p1, 1/tau1)}[huber_delta(z, y)] averaged over
    individuals, via `num_mc` shared Gaussian draws; M-step: grid argmin.
    The reference's EM_deltaH loop (vamp_Huber.cpp:576-586) repeats E+M
    until the argmin is stable — but its E-step distribution N(p1, 1/tau1)
    does not depend on the current delta, so every EM pass evaluates the
    SAME objective and the argmin is fixed after one pass: a single E+M
    step is mathematically equivalent to the reference loop (which only
    re-rolls the MC draws).  Hence no ``delta``/``num_em`` parameters.
    """
    n = jnp.sum(n_mask)
    eps = jax.random.normal(key, (num_mc,) + p1.shape, p1.dtype)
    z = p1[None, :] + eps / jnp.sqrt(tau1)           # [MC, N]
    # [G] objective: mean over MC draws and individuals
    gridj = jnp.asarray(grid, p1.dtype)
    losses = jax.vmap(
        lambda d: jnp.sum(huber_loss(z, d, y[None, :]) * n_mask[None, :]) / (num_mc * n)
    )(gridj)
    return gridj[jnp.argmin(losses)]


# --------------------------------------------------------------------------
# robust VAMP loop (vamp_Huber.cpp:24-441)
# --------------------------------------------------------------------------


class RobustState(NamedTuple):
    it: jax.Array
    x1: jax.Array
    x2: jax.Array
    r1: jax.Array
    r2: jax.Array
    z1: jax.Array
    z2: jax.Array
    p1: jax.Array
    p2: jax.Array
    gam1: jax.Array
    gam2: jax.Array
    tau1: jax.Array
    tau2: jax.Array
    alpha1: jax.Array
    deltaH: jax.Array
    probs: jax.Array
    vars: jax.Array
    key: jax.Array
    mu_cg: jax.Array    # [Mpad] CG warm start (LMMSE solution carried over)
    mu_probe: jax.Array  # [Mpad, P] probe-column warm starts
    gmu: jax.Array      # [Mpad, 1+P] tracked warm-start Gram product
                        # (see linear.LinState.gmu)
    tau_gmu: jax.Array  # scalar: the tau2 `gmu` was stored at (tau-ratio
                        # guard, cg.tracked_warm_start)


@dataclasses.dataclass(frozen=True)
class RobustConfig(VampConfig):
    gam1_init: float = 1e-8
    auto_var_max_iter: int = 50   # vamp_Huber.cpp:92
    deltaH_init: float = 1e-3     # vamp_Huber.cpp:57
    mc_steps: int = 100


class RobustAux(NamedTuple):
    op: object
    y: jax.Array
    n_mask: jax.Array
    bern: jax.Array
    m_mask: jax.Array
    ts: jax.Array
    defl: object          # (V, lam) CG deflation basis or None
    slq: object = None    # slq.SlqBasis of the fixed Gram A^T A or None
                          # (linear.VampConfig.use_slq) — one basis serves
                          # the whole tau2 trajectory, including Huber's
                          # orders-of-magnitude swings


def init_state(geno, cfg: RobustConfig, probs, vars_user) -> RobustState:
    dt = geno.dtype
    Mp = geno.Mpad
    zeros_m = jnp.zeros((Mp,), dt)
    nb4 = geno.y_planar.shape
    return RobustState(
        it=jnp.asarray(0), x1=zeros_m, x2=zeros_m, r1=zeros_m, r2=zeros_m,
        z1=jnp.zeros(nb4, dt), z2=jnp.zeros(nb4, dt),
        p1=jnp.zeros(nb4, dt), p2=jnp.zeros(nb4, dt),
        gam1=jnp.asarray(cfg.gam1_init, dt), gam2=jnp.asarray(0.0, dt),
        tau1=jnp.asarray(cfg.gam1_init, dt), tau2=jnp.asarray(0.0, dt),
        alpha1=jnp.asarray(0.0, dt), deltaH=jnp.asarray(cfg.deltaH_init, dt),
        probs=jnp.asarray(probs, dt),
        vars=jnp.asarray(np.asarray(vars_user) * geno.N, dt),
        key=jax.random.key(cfg.seed + 2),
        mu_cg=zeros_m,
        mu_probe=jnp.zeros((Mp, linear_probe_cols(cfg)), dt),
        gmu=jnp.zeros((Mp, 1 + linear_probe_cols(cfg)), dt),
        tau_gmu=jnp.asarray(0.0, dt),
    )


def make_aux(geno, cfg: RobustConfig, true_signal=None) -> RobustAux:
    from gvamp.probit import _gram_mult, make_slq_basis
    defl = None
    if cfg.deflate_k > 0:
        from gvamp import cg as _cg
        defl = _cg.top_eigs(_gram_mult(geno), geno.Mpad,
                            cfg.deflate_k,
                            jax.random.fold_in(jax.random.key(cfg.seed), 7),
                            n_iter=cfg.deflate_iters, dtype=geno.dtype,
                            op=geno.op)
    bern = make_bern_probe(geno, cfg.seed, cfg.n_probes)
    return RobustAux(
        op=geno.op, y=geno.filter_pheno(), n_mask=geno.n_mask_planar,
        bern=bern,
        m_mask=geno.m_mask,
        ts=(geno.pad_m(true_signal) * np.sqrt(geno.N)) if true_signal is not None
           else jnp.zeros((geno.Mpad,), geno.dtype),
        defl=defl,
        slq=(make_slq_basis(geno, cfg, bern)
             if cfg.use_slq and not cfg.red else None),
    )


def make_step(geno, cfg: RobustConfig, with_truth: bool = False,
              jit: bool = True, phased: bool = False):
    """Per-iteration Huber step; ``phased=True`` returns the ordered
    (name, phase_fn) sub-steps for per-phase timing, composing to the
    fused step."""
    dt = geno.dtype
    Mt = float(geno.Mt)
    N = float(geno.N)
    ax_fn, atx_fn = geno.fns()
    axm_fn, atxm_fn = geno.fns_multi()
    # z2 = A x2 tracked through the CG recursion (see probit.py /
    # cg.solve_block fwd_mult): 6 -> 5 packed reads/iteration
    track_z2 = (cfg.fold_noise
                and os.environ.get("GVAMP_NOISE_PASS", "0") != "1")
    # SLQ Onsager (linear.VampConfig.use_slq; see probit.py) — ONE fixed-Gram
    # Lanczos basis serves every (tau2, gam2) the Huber trajectory visits
    slq_on = cfg.use_slq and not cfg.red
    P_cg = linear_probe_cols(cfg)
    if slq_on:
        from gvamp import slq as _slq

    def phase_denoise_x(state: RobustState, aux: RobustAux):
        m_mask = aux.m_mask
        it = state.it + 1
        x1_prev = state.x1

        # ---- denoise x (same revar loop as probit; vamp_Huber.cpp:94-131)
        def revar_body(carry):
            i, x1, gam1, alpha1, eta1, probs, vars_, prev = carry
            pr = Prior(probs=probs, vars=vars_)
            x1 = g1(state.r1, gam1, pr) * m_mask
            alpha1 = jnp.sum(g1d(state.r1, gam1, pr) * m_mask) / Mt
            eta1 = gam1 / alpha1
            l2diff = jnp.sum(jnp.square((x1 - state.r1) * m_mask))

            def reest(_):
                g_new = _clamp_gamma(1.0 / (1.0 / eta1 + l2diff / Mt))
                p_ = update_prior(state.r1, g_new, pr, m_mask, Mt,
                                  em_max_iter=cfg.em_max_iter,
                                  em_err_thr=cfg.em_err_thr,
                                  learn_vars=cfg.learn_vars)
                return g_new, p_.probs, p_.vars

            gam1n, probs, vars_ = jax.lax.cond(
                it > 1, reest, lambda _: (gam1, probs, vars_), None)
            return _cast_like((i + 1, x1, gam1n, alpha1, eta1, probs, vars_, gam1),
                              carry)

        def revar_cond(carry):
            i, _, gam1, _, _, _, _, prev = carry
            return (i < cfg.auto_var_max_iter) & ((i == 0) | (it > 1)) & \
                   ((i == 0) | (jnp.abs(gam1 - prev) >= cfg.revar_tol))

        carry0 = (jnp.asarray(0), state.x1, state.gam1, state.alpha1,
                  jnp.asarray(0.0, dt), state.probs, state.vars,
                  jnp.asarray(jnp.inf, dt))
        _, x1, gam1, alpha1, eta1, probs, vars_ = jax.lax.while_loop(
            revar_cond, revar_body, carry0)[:7]

        rho = jnp.asarray(cfg.rho, dt)
        damp = it > 1
        x1 = jnp.where(damp, rho * x1 + (1 - rho) * state.x1, x1)
        alpha1 = jnp.where(damp, rho * alpha1 + (1 - rho) * state.alpha1, alpha1)

        gam2 = _clamp_gamma(eta1 - gam1)
        r2 = ((eta1 * x1 - gam1 * state.r1) / gam2) * m_mask

        return {"it": it, "x1_prev": x1_prev, "x1": x1, "gam1": gam1,
                "alpha1": alpha1, "eta1": eta1, "probs": probs,
                "vars": vars_, "gam2": gam2, "r2": r2}

    def phase_denoise_z(w, state: RobustState, aux: RobustAux):
        yf = aux.y.reshape(-1)
        nm = aux.n_mask.reshape(-1)
        it = w["it"]

        # ---- denoise z with the Huber proximal (vamp_Huber.cpp:225-262) ----
        p1f = state.p1.reshape(-1)
        tau1 = state.tau1
        delta = state.deltaH
        z1f = g1_huber(p1f, tau1, delta, yf) * nm
        beta1 = jnp.sum(g1d_huber_der(p1f, tau1, delta, yf) * nm) / N
        zeta1 = tau1 / beta1
        l2zp = jnp.sum(jnp.square(z1f - p1f) * nm)
        tau1 = jnp.where(it >= 2,
                         _clamp_gamma(1.0 / (1.0 / zeta1 + l2zp / N)), tau1)

        # deltaH MC-EM grid update (vamp_Huber.cpp:259-260)
        key, sub = jax.random.split(state.key)
        delta = em_deltaH(sub, p1f, tau1, yf, nm, num_mc=cfg.mc_steps)

        p2f = ((z1f - beta1 * p1f) / (1.0 - beta1)) * nm
        tau2 = _clamp_gamma(tau1 * (1.0 - beta1) / beta1)
        w = dict(w)
        w.update(z1f=z1f, beta1=beta1, tau1=tau1, delta=delta, key=key,
                 p2f=p2f, tau2=tau2)
        return w

    def phase_lmmse_x(w, state: RobustState, aux: RobustAux):
        op, m_mask = aux.op, aux.m_mask
        it, gam2, r2 = w["it"], w["gam2"], w["r2"]
        p2f, tau2 = w["p2f"], w["tau2"]

        # ---- LMMSE x (vamp_Huber.cpp:297-330) ------------------------------
        nb = state.p2.shape[-1]
        v = tau2 * atx_fn(op, p2f.reshape(4, nb)) + gam2 * r2
        # joint block solve: LMMSE RHS + Onsager probe in one wide-RHS CG
        multb = cg.make_lmmse_mult_block(axm_fn, atxm_fn, op, tau2, gam2)
        diag = cg.jacobi_diag(tau2, gam2, N)
        V = jnp.concatenate([v[:, None], aux.bern[:, :P_cg]], axis=1)
        precond = None
        if cfg.deflate_k > 0:
            precond = cg.make_deflated_precond(
                aux.defl[0], aux.defl[1], tau2, gam2, diag)
        fwd_mult = (cg.make_lmmse_mult_block_fwd(axm_fn, atxm_fn, op, tau2,
                                                 gam2) if track_z2 else None)
        if cfg.gram_refresh > 1:
            # warm-start with the tracked Gram product (linear.py gmu):
            # the init residual costs no packed pass off refresh ticks
            # (the reference zero-starts here, vamp_Huber.cpp:313)
            mu0_raw = jnp.concatenate([state.mu_cg[:, None], state.mu_probe],
                                      axis=1)
            if track_z2:
                mu0, r0, zmu0 = cg.tracked_warm_start_fwd(
                    V, mu0_raw, state.gmu, state.z2, tau2, state.tau_gmu,
                    gam2, it, cfg.gram_refresh, fwd_mult)
            else:
                mu0, r0 = cg.tracked_warm_start(
                    V, mu0_raw, state.gmu, tau2, state.tau_gmu, gam2, it,
                    cfg.gram_refresh, multb)
                zmu0 = None
            sol = cg.solve_block(multb, V, mu0, diag, gam2,
                                 cfg.cg_max_iter,
                                 modes=(0,) + (1,) * P_cg,
                                 err_tol=cfg.cg_err_tol,
                                 onsager_tol=cfg.onsager_tol,
                                 plateau=cfg.cg_plateau,
                                 precond=precond, r0=r0,
                                 fwd_mult=fwd_mult, zmu0=zmu0)
            gmu_new = cg.gram_from_exit(V, sol, tau2, gam2)
        else:
            sol = cg.solve_block(multb, V, jnp.zeros_like(V), diag, gam2,
                                 cfg.cg_max_iter,
                                 modes=(0,) + (1,) * P_cg,
                                 err_tol=cfg.cg_err_tol,
                                 onsager_tol=cfg.onsager_tol,
                                 plateau=cfg.cg_plateau,
                                 precond=precond, start_zero=True,
                                 fwd_mult=fwd_mult,
                                 zmu0=(jnp.zeros_like(state.z2)
                                       if track_z2 else None))
            gmu_new = jnp.zeros_like(sol.mu)
        x2 = sol.mu[:, 0] * m_mask
        if slq_on:
            # SLQ quadrature of f(lam) = 1/(tau2 lam + gam2) on the
            # fixed Gram basis (same deterministic u; g2d_onsager,
            # vamp.cpp:871-889)
            alpha2 = gam2 * jnp.mean(_slq.quad_inv(aux.slq, tau2, gam2))
        else:
            alpha2 = gam2 * jnp.mean(
                jnp.sum(aux.bern * sol.mu[:, 1:], axis=0))
        # alpha2 in (0, 1) mathematically (Q >= gam2 I); fp noise in the
        # probe quadform can hit 1 when gam2 dominates the spectrum, which
        # NaNs gam1 = gam2(1-alpha2)/alpha2 and the r1 division — a latent
        # hazard the reference leaves unguarded (vamp_Huber.cpp:355,
        # vamp_probit.cpp:571).  The upper bound must be representable in
        # the compute dtype (1 - 1e-11 rounds to 1.0 in f32).
        eps1 = 100.0 * jnp.finfo(jnp.asarray(alpha2).dtype).eps
        alpha2 = jnp.clip(alpha2, GAMMA_MIN, 1.0 - eps1)
        eta2 = gam2 / alpha2
        l2x2r2 = jnp.sum(jnp.square((x2 - r2) * m_mask))
        gam2 = jnp.where(it > 1,
                         _clamp_gamma(1.0 / (1.0 / eta2 + l2x2r2 / Mt)), gam2)
        r1 = ((x2 - alpha2 * r2) / (1.0 - alpha2)) * m_mask
        gam1_new = gam2 * (1.0 - alpha2) / alpha2
        # --stab-gamma geometric trust region (extension; reference leaves
        # this recurrence unguarded, vamp_Huber.cpp:355 — see VampConfig)
        if cfg.stab_gamma < 1.0:
            gam1_new = geo_damp(gam1_new, state.gam1,
                                jnp.asarray(cfg.stab_gamma, gam1_new.dtype),
                                it > 1)
        w = dict(w)
        w.update(x2=x2, alpha2=alpha2, gam2=gam2, r1=r1, gam1_new=gam1_new,
                 cg_iters=sol.iters[0], mu_cg=sol.mu[:, 0],
                 mu_probe=sol.mu[:, 1:], gmu=gmu_new, tau_gmu=tau2)
        if track_z2:
            w.update(z2_tracked=sol.zmu)
        return w

    def phase_lmmse_z(w, state: RobustState, aux: RobustAux):
        op, m_mask = aux.op, aux.m_mask
        nm = aux.n_mask.reshape(-1)
        it, x1, x1_prev = w["it"], w["x1"], w["x1_prev"]
        x2, r1, r2 = w["x2"], w["r1"], w["r2"]
        gam1_new, gam2, alpha1, alpha2 = (w["gam1_new"], w["gam2"],
                                          w["alpha1"], w["alpha2"])
        beta1, delta, key = w["beta1"], w["delta"], w["key"]
        p2f, tau2, z1f = w["p2f"], w["tau2"], w["z1f"]
        probs, vars_ = w["probs"], w["vars"]
        nb = state.p2.shape[-1]

        # ---- LMMSE z (vamp_Huber.cpp:368-412) ------------------------------
        # z2 = A x2: tracked through the CG recursion when track_z2
        z2 = w["z2_tracked"] if track_z2 else ax_fn(op, x2)
        z2f = z2.reshape(-1)
        beta2 = Mt / N * (1.0 - alpha2)
        zeta2 = tau2 / beta2
        l2z2p2 = jnp.sum(jnp.square(z2f - p2f) * nm)
        tau2 = jnp.where(it > 1, 1.0 / (1.0 / zeta2 + l2z2p2 / N), tau2)
        p1_new = ((z2f - beta2 * p2f) / (1.0 - beta2)) * nm
        tau1_new = _clamp_gamma(tau2 * (1.0 - beta2) / beta2)
        if cfg.stab_gamma < 1.0:
            tau1_new = geo_damp(tau1_new, state.tau1,
                                jnp.asarray(cfg.stab_gamma, tau1_new.dtype),
                                it > 1)

        rel_change = jnp.sqrt(
            jnp.sum(jnp.square(x1_prev - x1)) /
            jnp.maximum(jnp.sum(jnp.square(x1_prev)), 1e-30))

        metrics = {
            "it": it, "gam1": gam1_new, "gam2": gam2, "tau1": tau1_new,
            "tau2": tau2, "alpha1": alpha1, "alpha2": alpha2, "beta1": beta1,
            "deltaH": delta, "rel_change": rel_change,
            "cg_iters": w["cg_iters"],
            "probs": probs, "vars": vars_,
        }
        if with_truth:
            ts = aux.ts
            metrics["corr_x1"] = jnp.sum(x1 * ts) / jnp.sqrt(
                jnp.sum(jnp.square(x1)) * jnp.sum(jnp.square(ts)))

        new_state = RobustState(
            it=it, x1=x1, x2=x2, r1=r1, r2=r2,
            z1=z1f.reshape(4, nb), z2=z2,
            p1=p1_new.reshape(4, nb), p2=p2f.reshape(4, nb),
            gam1=gam1_new, gam2=gam2, tau1=tau1_new, tau2=tau2,
            alpha1=alpha1, deltaH=delta, probs=probs, vars=vars_, key=key,
            mu_cg=w["mu_cg"], mu_probe=w["mu_probe"], gmu=w["gmu"],
            tau_gmu=w["tau_gmu"])
        return _cast_like(new_state, state), metrics

    phases = (("denoise_x", phase_denoise_x), ("denoise_z", phase_denoise_z),
              ("lmmse_cg", phase_lmmse_x), ("lmmse_z_finish", phase_lmmse_z))

    def step(state: RobustState, aux: RobustAux):
        w = phase_denoise_x(state, aux)
        w = phase_denoise_z(w, state, aux)
        w = phase_lmmse_x(w, state, aux)
        return phase_lmmse_z(w, state, aux)

    if phased:
        return phases
    return jax.jit(step) if jit else step


def make_scan_step(geno, cfg, k: int, **kw):
    """k iterations per dispatch via lax.scan (see linear.make_scan_step)."""
    raw = make_step(geno, cfg, jit=False, **kw)

    def multi(state, aux):
        def body(s, _):
            s2, m = raw(s, aux)
            return s2, m

        return jax.lax.scan(body, state, None, length=k)

    return jax.jit(multi)


def infer(geno, cfg: RobustConfig, probs, vars_user, true_signal=None,
          verbose: bool = True, callbacks=None, phase_timers: bool = False,
          sync_every: int = 1, resume_state: RobustState = None):
    if resume_state is not None:
        from gvamp.linear import _check_resume_probe_cols
        _check_resume_probe_cols(resume_state, cfg)
    state = (resume_state if resume_state is not None
             else init_state(geno, cfg, probs, vars_user))
    aux = make_aux(geno, cfg, true_signal=true_signal)
    kw = dict(with_truth=true_signal is not None)
    chunk = 1 if phase_timers else max(1, int(sync_every))
    if phase_timers:
        from gvamp.linear import timed_step_from_phases
        step = timed_step_from_phases(make_step(geno, cfg, phased=True, **kw))
    elif chunk > 1:
        step = make_scan_step(geno, cfg, chunk, **kw)
    else:
        step = make_step(geno, cfg, **kw)
    history = []
    import time as _time
    from gvamp.linear import dispatch_chunk
    single = step if chunk == 1 else None
    it = int(np.asarray(state.it))
    while it < cfg.max_iter:
        _t0 = _time.perf_counter()
        state, metrics, k_got, single = dispatch_chunk(
            step, single, lambda: make_step(geno, cfg, **kw),
            state, aux, cfg.max_iter - it, chunk)
        # ONE batched transfer: per-key np.asarray costs a
        # separate device round-trip each
        fetched = jax.device_get(metrics)
        span = np.float64((_time.perf_counter() - _t0) * 1e3)
        if k_got == 1:
            chunk_ms = [fetched]
        else:
            chunk_ms = [{k: v[i] for k, v in fetched.items()}
                        for i in range(k_got)]
        for m in chunk_ms:
            it += 1
            # np.asarray above synced the dispatch: honest per-iteration
            # span (reference per-iteration MPI_Wtime prints), amortized
            # over the chunk in scan mode
            m["iter_ms"] = span / len(chunk_ms)
            history.append(m)
            if it >= cfg.max_iter:
                break
        m = history[-1]
        if verbose:
            extra = f" corr={m['corr_x1']:.4f}" if "corr_x1" in m else ""
            print(f"[robust it {it}] gam1={m['gam1']:.5g} tau1={m['tau1']:.5g} "
                  f"deltaH={m['deltaH']:.4g} alpha2={m['alpha2']:.4g} "
                  f"rel={m['rel_change']:.3e}{extra}", flush=True)
            pk = [k for k in m if k.startswith("phase_ms_")]
            if pk:
                print("        " + "  ".join(
                    f"{k[len('phase_ms_'):]}={float(m[k]):.1f}ms"
                    for k in pk), flush=True)
        if callbacks:
            for cb in callbacks:
                cb(it, state, m, geno)
        if it > 1 and float(m["rel_change"]) < cfg.stop_criteria_thr:
            break
    from gvamp import dist
    x1_stored = dist.to_numpy(state.x1)[: geno.M] / np.sqrt(geno.N)
    return x1_stored, state, history
