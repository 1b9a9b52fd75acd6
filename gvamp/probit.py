"""Probit (binary-classification) VAMP with fixed covariate effects.

Re-design of the reference's ``infere_bin_class`` (vamp_probit.cpp:20-658):
the same marker-space denoise/LMMSE skeleton as the linear model plus a
z-space denoising pair (g1_bin_class / g1d_bin_class, erfcx-stable,
vamp_probit.cpp:661-726) and a Newton–Raphson covariate-effect solver with
backtracking line search (vamp_probit.cpp:936-1067, boost::ublas LU replaced
by a dense jnp solve — C is small).

Semantics notes (parity with the reference):
  * phenotype-NA individuals carry y=0 through the z-denoiser (the reference
    filters y to zero and still denoises those slots) — they are, however,
    excluded from the matvecs via the NA mask (our ``atx`` masks its input;
    the reference leaves p2 unmasked there, an inconsistency we resolve
    toward exclusion);
  * the LMMSE CG starts from zero each iteration (vamp_probit.cpp:507), no
    warm start;
  * tau/gam recurrences follow vamp_probit.cpp:446-460, 515-614 including the
    alpha2-parameterized forms r1=(x2-a2 r2)/(1-a2), gam1=gam2(1-a2)/a2.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from gvamp import cg
from gvamp.linear import (VampConfig, _cast_like, _clamp_gamma, geo_damp,
                              make_bern_probe)
from gvamp.linear import probe_cols as linear_probe_cols
from gvamp.ops.special import normal_logcdf, phi_over_Phi
from gvamp.prior import GAMMA_MIN, Prior, g1, g1d, update_prior


# --------------------------------------------------------------------------
# z-space denoisers (vamp_probit.cpp:661-726)
# --------------------------------------------------------------------------


def _sgn_y(y):
    """+-1 case/control sign.  jnp.sign(2y-1) rather than the reference's
    raw (2y-1) (vamp_probit.cpp:678): the reference's data ctor SCALES
    binary phenotypes by 1/sd (data.cpp:171-186), so its real-data driver
    feeds (2y-1) in {-1, 2/sd-1} — correct sign, wrong magnitude.  Using the
    sign makes the denoiser exact for both raw 0/1 and scaled encodings."""
    return jnp.sign(2.0 * y - 1.0)


def g1_bin_class(p, tau1, y, m_cov, probit_var):
    """E[z | p, y] for y = 1{z + eps > 0}, eps ~ N(0, probit_var)."""
    sgn = _sgn_y(y)
    c = (p + m_cov) / jnp.sqrt(probit_var + 1.0 / tau1)
    ratio = phi_over_Phi(sgn * c)
    return p + sgn * ratio / tau1 / jnp.sqrt(probit_var + 1.0 / tau1)


def g1d_bin_class(p, tau1, y, m_cov, probit_var):
    sgn = _sgn_y(y)
    c = (p + m_cov) / jnp.sqrt(probit_var + 1.0 / tau1)
    ratio = phi_over_Phi(sgn * c)
    return 1.0 - ratio / (1.0 + tau1 * probit_var) * (sgn * c + ratio)


# --------------------------------------------------------------------------
# covariate-effect solvers (vamp_probit.cpp:814-1067)
# --------------------------------------------------------------------------


_mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)


def mlogL_probit(y, gg, probit_var, Z, eta, n_mask):
    """-1/N sum log Phi((2y-1)(gg + Z eta)/sqrt(pv)) (vamp_probit.cpp:841)."""
    g = gg + _mm(Z, eta)
    arg = _sgn_y(y) / jnp.sqrt(probit_var) * g
    n = jnp.sum(n_mask)
    return -jnp.sum(normal_logcdf(arg) * n_mask) / n


def grad_cov(y, gg, probit_var, Z, eta, n_mask):
    """Gradient of mlogL wrt eta (vamp_probit.cpp:814-839)."""
    sgn = _sgn_y(y)
    g = gg + _mm(Z, eta)
    ratio = phi_over_Phi(sgn / jnp.sqrt(probit_var) * g)
    n = jnp.sum(n_mask)
    return -_mm(Z.T, ratio * sgn / jnp.sqrt(probit_var) * n_mask) / n


def newton_cov(y, gg, Z, eta0, n_mask, probit_var=1.0, max_iter=500,
               max_ls=300, rel_tol=1e-4):
    """Newton-Raphson with backtracking line search (vamp_probit.cpp:936-1067).

    y, gg: dense [N]; Z: [N, C].  The reference's Newton system ignores
    probit_var in lambda (arg = (2y-1)*g), while the line-search gradient
    uses it — replicated.
    """
    C = Z.shape[1]
    sgn = 2.0 * y - 1.0

    def body(carry):
        it, eta, rel_err, prev_bad = carry
        g = gg + _mm(Z, eta)
        lam = phi_over_Phi(sgn * g) * sgn * n_mask
        W = lam * (lam + g)
        H = _mm(Z.T, Z * W[:, None])
        rhs = _mm(Z.T, lam)
        d = jnp.linalg.solve(H, rhs)
        d = jnp.where(jnp.all(jnp.isfinite(d)), d, jnp.zeros_like(d))
        grad = grad_cov(y, gg, probit_var, Z, eta, n_mask)
        f0 = mlogL_probit(y, gg, probit_var, Z, eta, n_mask)

        def ls_body(ls):
            i, scale, done = ls
            fz = mlogL_probit(y, gg, probit_var, Z, eta + scale * d, n_mask)
            ok = fz <= f0 + jnp.dot(scale * d, grad) / 2.0
            return (i + 1, jnp.where(ok, scale, scale * 0.9), done | ok)

        _, scale, _ = jax.lax.while_loop(
            lambda ls: (ls[0] < max_ls) & (~ls[2]), ls_body,
            (0, jnp.ones((), eta.dtype), jnp.asarray(False)))
        eta_new = eta + scale * d
        norm_eta = jnp.sqrt(jnp.sum(jnp.square(eta)))
        rel = jnp.where(norm_eta == 0, 1.0,
                        jnp.sqrt(jnp.sum(jnp.square(eta_new - eta))) / norm_eta)
        f1 = mlogL_probit(y, gg, probit_var, Z, eta_new, n_mask)
        bad = f1 > f0  # likelihood stopped improving (vamp_probit.cpp:1050-1060)
        return _cast_like((it + 1, eta_new, rel, bad), carry)

    def cond(carry):
        it, eta, rel_err, bad = carry
        return (it < max_iter) & (rel_err >= rel_tol) & (~bad)

    out = jax.lax.while_loop(
        cond, body,
        (jnp.asarray(0), eta0, jnp.asarray(jnp.inf, eta0.dtype), jnp.asarray(False)))
    return out[1]


def grad_desc_cov(y, gg, Z, eta0, n_mask, probit_var=1.0, max_iter=500,
                  grad_tol=1e-3):
    """Plain gradient descent with backtracking (vamp_probit.cpp:860-934)."""

    def body(carry):
        it, eta, gnorm = carry
        grad = grad_cov(y, gg, probit_var, Z, eta, n_mask)
        f0 = mlogL_probit(y, gg, probit_var, Z, eta, n_mask)

        def ls_body(ls):
            i, scale, done = ls
            fz = mlogL_probit(y, gg, probit_var, Z, eta - scale * grad, n_mask)
            ok = fz <= f0 - scale * jnp.dot(grad, grad) / 2.0
            return (i + 1, jnp.where(ok, scale, scale * 0.9), done | ok)

        _, scale, _ = jax.lax.while_loop(
            lambda ls: (ls[0] < 300) & (~ls[2]), ls_body,
            (0, jnp.ones((), eta.dtype), jnp.asarray(False)))
        eta_new = eta - scale * grad
        return _cast_like((it + 1, eta_new, jnp.sqrt(jnp.sum(grad**2))), carry)

    out = jax.lax.while_loop(
        lambda c: (c[0] < max_iter) & (c[2] > grad_tol), body,
        (jnp.asarray(0), eta0, jnp.asarray(jnp.inf, eta0.dtype)))
    return out[1]


# --------------------------------------------------------------------------
# probit-variance EM (vamp_probit.cpp:728-812; reference keeps it available
# but commented out of the loop — provided here as a callable utility)
# --------------------------------------------------------------------------


def update_probit_var(key, v, eta, z_hat, y, n_mask, n_mc=1000,
                      max_iter_bisec=50):
    """MC-EM + log-bisection for the probit noise variance."""

    def f(vv, key):
        z = z_hat + jax.random.normal(key, z_hat.shape, z_hat.dtype) / jnp.sqrt(eta)
        c = (2.0 * y - 1.0) * z / vv
        der = c * jnp.exp(-c * c / 2) / np.sqrt(2 * np.pi) * z / vv \
            / jnp.clip(0.5 * jax.lax.erfc(-c * 0.7071067811865476), 1e-300, None)
        return jnp.sum(der * n_mask)

    lo, hi = jnp.asarray(1e-10, z_hat.dtype), jnp.asarray(1e10, z_hat.dtype)

    def body(carry):
        it, lo, hi, v, key = carry
        key, sub = jax.random.split(key)
        fv = f(v, sub)
        lo = jnp.where(fv > 0, v, lo)
        hi = jnp.where(fv <= 0, v, hi)
        v_new = jnp.sqrt(lo * hi)
        return _cast_like((it + 1, lo, hi, v_new, key), carry)

    out = jax.lax.while_loop(lambda c: c[0] < max_iter_bisec, body,
                             (jnp.asarray(0), lo, hi, jnp.asarray(v, z_hat.dtype), key))
    return out[3]


# --------------------------------------------------------------------------
# the probit VAMP loop
# --------------------------------------------------------------------------


class ProbitState(NamedTuple):
    it: jax.Array
    x1: jax.Array
    x2: jax.Array
    r1: jax.Array
    r2: jax.Array
    z1: jax.Array       # z1_hat planar [4, Nb]
    z2: jax.Array
    p1: jax.Array
    p2: jax.Array
    gam1: jax.Array
    gam2: jax.Array
    tau1: jax.Array
    tau2: jax.Array
    alpha1: jax.Array
    probs: jax.Array
    vars: jax.Array
    cov_eff: jax.Array  # [C] (C >= 1; zero-width handled by C=0 -> [1] dummy)
    mu_cg: jax.Array    # [Mpad] CG warm start (LMMSE solution carried over)
    mu_probe: jax.Array  # [Mpad, P] probe-column warm starts
    gmu: jax.Array      # [Mpad, 1+P] A^T A [mu_cg | mu_probe] — tracked
                        # warm-start Gram product (see linear.LinState.gmu)
    tau_gmu: jax.Array  # scalar: the tau2 `gmu` was stored at (the tau-ratio
                        # guard in cg.tracked_warm_start needs it)


@dataclasses.dataclass(frozen=True)
class ProbitConfig(VampConfig):
    gam1_init: float = 1e-8        # main_real_probit gam1
    gamw_init: float = 1.0
    probit_var: float = 1.0
    auto_var_max_iter: int = 50    # vamp_probit.cpp:158
    z_revar_max_iter: int = 1      # vamp_probit.cpp:335
    newton_max_iter: int = 500


class ProbitAux(NamedTuple):
    op: object
    y: jax.Array          # filtered planar [4, Nb] (binary, NA -> 0)
    n_mask: jax.Array     # planar real-individual mask
    bern: jax.Array
    m_mask: jax.Array
    Z: jax.Array          # covariates planar-dense [Nplanar, C]
    ts: jax.Array         # true signal * sqrt(N) (zeros if absent)
    defl: object          # (V, lam) CG deflation basis or None
    slq: object = None    # slq.SlqBasis of the fixed Gram A^T A (or None):
                          # the same basis serves EVERY (tau2, gam2) the
                          # z-model trajectory visits (linear.VampConfig
                          # .use_slq)


def init_state(geno, cfg: ProbitConfig, probs, vars_user, key=None) -> ProbitState:
    dt = geno.dtype
    Mp = geno.Mpad
    zeros_m = jnp.zeros((Mp,), dt)
    nb4 = geno.y_planar.shape
    key = jax.random.key(cfg.seed + 1) if key is None else key
    # p1 starts as unit Gaussian noise (vamp_probit.cpp:52)
    p1 = jax.random.normal(key, nb4, dt) * geno.n_mask_planar
    C = geno.covs.shape[1] if geno.covs is not None else 0
    return ProbitState(
        it=jnp.asarray(0), x1=zeros_m, x2=zeros_m, r1=zeros_m, r2=zeros_m,
        z1=jnp.zeros(nb4, dt), z2=jnp.zeros(nb4, dt),
        p1=p1, p2=jnp.zeros(nb4, dt),
        gam1=jnp.asarray(cfg.gam1_init, dt), gam2=jnp.asarray(0.0, dt),
        tau1=jnp.asarray(cfg.gam1_init, dt), tau2=jnp.asarray(0.0, dt),
        alpha1=jnp.asarray(0.0, dt),
        probs=jnp.asarray(probs, dt),
        vars=jnp.asarray(np.asarray(vars_user) * geno.N, dt),
        cov_eff=jnp.zeros((max(C, 1),), dt),
        mu_cg=zeros_m,
        mu_probe=jnp.zeros((Mp, linear_probe_cols(cfg)), dt),
        gmu=jnp.zeros((Mp, 1 + linear_probe_cols(cfg)), dt),
        tau_gmu=jnp.asarray(0.0, dt),
    )


def _gram_mult(geno):
    """Shared fixed-Gram operator (op, Pk) -> A^T A Pk (deflation + SLQ
    setup).  The operator pytree stays an ARGUMENT of the jitted program —
    closing over it would capture the packed matrix as a jaxpr constant
    embedded in the compiled program (cg.top_eigs)."""
    axm_fn, atxm_fn = geno.fns_multi()
    return lambda op_, Pk: atxm_fn(op_, axm_fn(op_, Pk))


def make_slq_basis(geno, cfg, bern):
    """One-time Lanczos quadrature of the fixed marker-space Gram in the
    probes' Krylov spaces (linear.VampConfig.use_slq)."""
    import functools

    from gvamp import slq as _slq
    mult = _gram_mult(geno)

    def build(op_, U):
        return _slq.build(functools.partial(mult, op_), U, cfg.slq_k)

    return jax.jit(build)(geno.op, bern)


def make_aux(geno, cfg: ProbitConfig, true_signal=None) -> ProbitAux:
    C = geno.covs.shape[1] if geno.covs is not None else 0
    nb = geno.layout.n_bytes
    if C > 0:
        Z = geno.covs_planar().reshape(4 * nb, C)
    else:
        Z = jnp.zeros((4 * nb, 1), geno.dtype)
    defl = None
    if cfg.deflate_k > 0:
        from gvamp import cg as _cg
        defl = _cg.top_eigs(_gram_mult(geno), geno.Mpad,
                            cfg.deflate_k,
                            jax.random.fold_in(jax.random.key(cfg.seed), 7),
                            n_iter=cfg.deflate_iters, dtype=geno.dtype,
                            op=geno.op)
    bern = make_bern_probe(geno, cfg.seed, cfg.n_probes)
    return ProbitAux(
        op=geno.op, y=geno.filter_pheno(), n_mask=geno.n_mask_planar,
        bern=bern,
        m_mask=geno.m_mask, Z=Z,
        ts=(geno.pad_m(true_signal) * np.sqrt(geno.N)) if true_signal is not None
           else jnp.zeros((geno.Mpad,), geno.dtype),
        defl=defl,
        slq=(make_slq_basis(geno, cfg, bern)
             if cfg.use_slq and not cfg.red else None),
    )


def make_step(geno, cfg: ProbitConfig, n_cov: int = 0, with_truth: bool = False,
              jit: bool = True, phased: bool = False):
    """Per-iteration probit step; ``phased=True`` returns the ordered
    (name, phase_fn) sub-steps for per-phase timing (the reference's
    MPI_Wtime spans in vamp_probit.cpp), composing to the fused step."""
    dt = geno.dtype
    Mt = float(geno.Mt)
    N = float(geno.N)
    ax_fn, atx_fn = geno.fns()
    axm_fn, atxm_fn = geno.fns_multi()
    # z2 = A x2 tracked through the CG recursion (zmu += alpha_0 * A p_0,
    # cg.solve_block fwd_mult) instead of a separate post-solve forward
    # pass: 6 -> 5 packed reads/iteration at steady-state cg_it = 2.
    # Two-pass routing only; same master switch + env kill switch as the
    # linear engine's noise-pass fold (VampConfig.fold_noise).
    track_z2 = (cfg.fold_noise
                and os.environ.get("GVAMP_NOISE_PASS", "0") != "1")
    # SLQ Onsager (linear.VampConfig.use_slq): the block CG carries only the
    # LMMSE column; alpha2 = gam2 <u, (tau2 G + gam2 I)^{-1} u> is an O(k)
    # quadrature on the fixed Gram basis for ANY (tau2, gam2) — exactly the
    # z-model trajectories whose tau2 swings would otherwise drive the probe
    # columns through ill-conditioned solves
    slq_on = cfg.use_slq and not cfg.red
    P_cg = linear_probe_cols(cfg)
    if slq_on:
        from gvamp import slq as _slq
    pv = cfg.probit_var

    def phase_denoise_x(state: ProbitState, aux: ProbitAux):
        op, m_mask, n_mask = aux.op, aux.m_mask, aux.n_mask
        yf = aux.y.reshape(-1)            # flat planar filtered y
        nm = n_mask.reshape(-1)
        it = state.it + 1
        state = state._replace(it=it)
        x1_prev = state.x1

        # ---- covariate effects (iteration 1 only; vamp_probit.cpp:110-126)
        cov_eff = state.cov_eff
        if n_cov > 0:
            gg = state.z1.reshape(-1)

            def solve_cov(_):
                return newton_cov(yf, gg, aux.Z, jnp.zeros_like(cov_eff), nm,
                                  probit_var=pv, max_iter=cfg.newton_max_iter)

            cov_eff = jax.lax.cond(it == 1, solve_cov, lambda _: cov_eff, None)
            m_cov = _mm(aux.Z, cov_eff) * nm
        else:
            m_cov = jnp.zeros_like(yf)

        # ---- denoise x (revar loop, vamp_probit.cpp:158-197) --------------
        def revar_body(carry):
            i, x1, gam1, alpha1, eta1, probs, vars_, prev = carry
            pr = Prior(probs=probs, vars=vars_)
            x1 = g1(state.r1, gam1, pr) * m_mask
            d = g1d(state.r1, gam1, pr)
            alpha1 = jnp.sum(d * m_mask) / Mt
            eta1 = gam1 / alpha1
            l2diff = jnp.sum(jnp.square((x1 - state.r1) * m_mask))

            def reest(_):
                g_new = _clamp_gamma(1.0 / (1.0 / eta1 + l2diff / Mt))
                p2_ = update_prior(state.r1, g_new, pr, m_mask, Mt,
                                   em_max_iter=cfg.em_max_iter,
                                   em_err_thr=cfg.em_err_thr,
                                   learn_vars=cfg.learn_vars)
                return g_new, p2_.probs, p2_.vars

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

        # damping (vamp_probit.cpp:199-204) — rho_it2 = rho
        rho = jnp.asarray(cfg.rho, dt)
        damp = it > 1
        x1 = jnp.where(damp, rho * x1 + (1 - rho) * state.x1, x1)
        alpha1 = jnp.where(damp, rho * alpha1 + (1 - rho) * state.alpha1, alpha1)

        gam2 = _clamp_gamma(eta1 - gam1)
        r2 = ((eta1 * x1 - gam1 * state.r1) / gam2) * m_mask

        return {"it": it, "x1_prev": x1_prev, "x1": x1, "gam1": gam1,
                "alpha1": alpha1, "eta1": eta1, "probs": probs,
                "vars": vars_, "cov_eff": cov_eff, "m_cov": m_cov,
                "gam2": gam2, "r2": r2}

    def phase_denoise_z(w, state: ProbitState, aux: ProbitAux):
        yf = aux.y.reshape(-1)
        nm = aux.n_mask.reshape(-1)
        it, m_cov = w["it"], w["m_cov"]

        # ---- denoise z (vamp_probit.cpp:330-390) ---------------------------
        p1f = state.p1.reshape(-1)
        tau1 = state.tau1
        z1f = g1_bin_class(p1f, tau1, yf, m_cov, pv) * nm
        beta1 = jnp.sum(g1d_bin_class(p1f, tau1, yf, m_cov, pv) * nm) / N
        zeta1 = tau1 / beta1
        l2zp = jnp.sum(jnp.square((z1f - p1f)) * nm)
        tau1 = jnp.where(it > 1,
                         _clamp_gamma(1.0 / (1.0 / zeta1 + l2zp / N)), tau1)
        # (single z-revar pass: the reference sets auto_var_max_iter=1 there,
        # vamp_probit.cpp:335; tau1 update applies from it>=2)

        p2f = ((z1f - beta1 * p1f) / (1.0 - beta1)) * nm
        tau2 = tau1 * (1.0 - beta1) / beta1
        w = dict(w)
        w.update(z1f=z1f, beta1=beta1, tau1=tau1, p2f=p2f, tau2=tau2)
        return w

    def phase_lmmse_x(w, state: ProbitState, aux: ProbitAux):
        op, m_mask = aux.op, aux.m_mask
        it, gam2, r2 = w["it"], w["gam2"], w["r2"]
        p2f, tau2 = w["p2f"], w["tau2"]

        # ---- LMMSE x (vamp_probit.cpp:495-560) -----------------------------
        nb = state.p2.shape[-1]
        p2_planar = p2f.reshape(4, nb)
        v = tau2 * atx_fn(op, p2_planar) + gam2 * r2
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
            # warm-start from the previous LMMSE/probe solutions with the
            # tracked Gram product (linear.py gmu): the init residual is
            # elementwise algebra except on refresh ticks, so the warm
            # start costs no packed pass (the reference zero-starts here,
            # vamp_probit.cpp:507)
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
        # this recurrence unguarded, vamp_probit.cpp:571 — see VampConfig)
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

    def phase_lmmse_z(w, state: ProbitState, aux: ProbitAux):
        op, m_mask = aux.op, aux.m_mask
        nm = aux.n_mask.reshape(-1)
        it, x1, x1_prev = w["it"], w["x1"], w["x1_prev"]
        x2, r1, r2 = w["x2"], w["r1"], w["r2"]
        gam1_new, gam2, alpha1, alpha2 = (w["gam1_new"], w["gam2"],
                                          w["alpha1"], w["alpha2"])
        eta1, beta1 = w["eta1"], w["beta1"]
        p2f, tau2, z1f = w["p2f"], w["tau2"], w["z1f"]
        probs, vars_, cov_eff = w["probs"], w["vars"], w["cov_eff"]
        nb = state.p2.shape[-1]

        # ---- LMMSE z (vamp_probit.cpp:567-614) -----------------------------
        # z2 = A x2: tracked through the CG recursion when track_z2 (exact
        # same quantity, CG-recursion fp drift, refresh-reset), else the
        # explicit forward pass
        z2 = w["z2_tracked"] if track_z2 else ax_fn(op, x2)
        z2f = z2.reshape(-1)
        beta2 = Mt / N * (1.0 - alpha2)
        zeta2 = tau2 / beta2
        l2z2p2 = jnp.sum(jnp.square(z2f - p2f) * nm)
        tau2 = jnp.where(it > 1, 1.0 / (1.0 / zeta2 + l2z2p2 / N), tau2)
        p1_new = ((z2f - beta2 * p2f) / (1.0 - beta2)) * nm
        tau1_new = tau2 * (1.0 - beta2) / beta2
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
            "beta2": beta2, "eta1": eta1, "rel_change": rel_change,
            "cg_iters": w["cg_iters"], "probs": probs, "vars": vars_,
            "cov_eff": cov_eff,
        }
        if with_truth:
            ts = aux.ts
            corr = jnp.sum(x1 * ts) / jnp.sqrt(
                jnp.sum(jnp.square(x1)) * jnp.sum(jnp.square(ts)))
            metrics["corr_x1"] = corr

        new_state = ProbitState(
            it=it, x1=x1, x2=x2, r1=r1, r2=r2,
            z1=z1f.reshape(4, nb), z2=z2, p1=p1_new.reshape(4, nb),
            p2=p2f.reshape(4, nb),
            gam1=gam1_new, gam2=gam2, tau1=tau1_new, tau2=tau2,
            alpha1=alpha1, probs=probs, vars=vars_, cov_eff=cov_eff,
            mu_cg=w["mu_cg"], mu_probe=w["mu_probe"], gmu=w["gmu"],
            tau_gmu=w["tau_gmu"])
        return _cast_like(new_state, state), metrics

    phases = (("denoise_x", phase_denoise_x), ("denoise_z", phase_denoise_z),
              ("lmmse_cg", phase_lmmse_x), ("lmmse_z_finish", phase_lmmse_z))

    def step(state: ProbitState, aux: ProbitAux):
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


def infer(geno, cfg: ProbitConfig, probs, vars_user, true_signal=None,
          verbose: bool = True, callbacks=None, phase_timers: bool = False,
          sync_every: int = 1, resume_state: ProbitState = None):
    """Full probit VAMP run; returns (x1_hat_stored /sqrt(N), state, history).

    ``phase_timers`` dispatches each phase separately and records
    ``phase_ms_*`` per iteration (linear.timed_step_from_phases);
    ``sync_every`` > 1 runs that many iterations per device dispatch
    (make_scan_step throughput mode, overridden by phase_timers)."""
    n_cov = geno.covs.shape[1] if geno.covs is not None else 0
    if resume_state is not None:
        from gvamp.linear import _check_resume_probe_cols
        _check_resume_probe_cols(resume_state, cfg)
    state = (resume_state if resume_state is not None
             else init_state(geno, cfg, probs, vars_user))
    aux = make_aux(geno, cfg, true_signal=true_signal)
    kw = dict(n_cov=n_cov, with_truth=true_signal is not None)
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
            print(f"[probit it {it}] gam1={m['gam1']:.5g} tau1={m['tau1']:.5g} "
                  f"beta1={m['beta1']:.4g} alpha2={m['alpha2']:.4g} "
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
