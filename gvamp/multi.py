"""Multi-trait linear VAMP: T phenotypes in one run over a shared .bed.

An extension beyond the reference, which processes one phenotype
per run (main_real.cpp:52 "currently only one phenotype file is supported").
Because the packed-matvec decode dominates wall-clock and wide-RHS columns
ride it nearly free (ops/matvec.py), running T traits together costs ~1.5x a
single-trait run instead of T times: every marker-space vector gains a
trailing trait axis, every scalar becomes a [T] vector, the denoisers/EM
vmap over traits, and all T LMMSE solves + T*P Onsager probes share ONE
block-CG (cg.solve_block with per-column (gamw_t, gam2_t) operators).

Per-trait semantics are identical to the single-trait engine (linear.py):
each trait gets its own marker statistics over its own phenotype-NA support
(reference data.cpp:446-483), its own prior/EM trajectory, noise precision,
damping, and stopping; traits that converge freeze while the rest continue.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from gvamp import cg
from gvamp.data import GenoBed
from gvamp.linear import (VampConfig, _cast_like, _clamp_gamma,
                              geo_damp, probe_cols)
from gvamp.prior import Prior, g1, g1d, update_prior


class MultiOp(NamedTuple):
    """Shared packed matrix + per-trait standardization arrays."""

    words: jax.Array   # uint32[Nw, Mpad] (shared)
    mave: jax.Array    # f[Mpad, T]
    msig: jax.Array    # f[Mpad, T]
    na: jax.Array      # f[4, Nb, T] per-trait phenotype-NA indicator
    m_mask: jax.Array  # f[Mpad]


@dataclasses.dataclass
class MultiPhen:
    """T phenotypes bound to one GenoBed's packed matrix."""

    geno: GenoBed
    T: int
    mave: jax.Array    # [Mpad, T]
    msig: jax.Array
    na: jax.Array      # [4, Nb, T]
    y: jax.Array       # [4, Nb, T] standardized, NA slots zero
    nonas: np.ndarray  # int[T]
    intercepts: np.ndarray
    scales: np.ndarray

    @classmethod
    def build(cls, geno: GenoBed, ys: list, standardize: bool = True
              ) -> "MultiPhen":
        """Per-trait standardization + marker statistics (each trait's stats
        use its own NA support, reference data.cpp:128-192, 446-483)."""
        lay = geno.layout
        dt = geno.dtype
        maves, msigs, nas, yps = [], [], [], []
        nonas, icepts, scales = [], [], []
        for y_raw in ys:
            y_raw = np.asarray(y_raw, np.float64)
            isna = np.isnan(y_raw)
            nn = int((~isna).sum())
            if standardize and nn > 1:
                avg = float(np.nanmean(y_raw))
                sqn = float(np.sqrt((nn - 1) / np.nansum((y_raw - avg) ** 2)))
            else:
                avg, sqn = 0.0, 1.0
            y = np.where(isna, 0.0, y_raw) * sqn
            na_p = jnp.asarray(lay.planarize((~isna).astype(np.float64)), dt)
            mave, msig = geno.marker_stats_for(na_p, nn)
            maves.append(mave)
            msigs.append(msig)
            nas.append(na_p)
            yps.append(jnp.asarray(lay.planarize(y), dt))
            nonas.append(nn); icepts.append(avg); scales.append(sqn)
        return cls(
            geno=geno, T=len(ys),
            mave=jnp.stack(maves, axis=1), msig=jnp.stack(msigs, axis=1),
            na=jnp.stack(nas, axis=-1), y=jnp.stack(yps, axis=-1),
            nonas=np.asarray(nonas), intercepts=np.asarray(icepts),
            scales=np.asarray(scales))

    @property
    def op(self) -> MultiOp:
        return MultiOp(words=self.geno.words, mave=self.mave, msig=self.msig,
                       na=self.na, m_mask=self.geno.m_mask)

    def filter_pheno(self) -> jax.Array:
        return self.y * self.na

    def fns(self):
        """(axm_fn, atxm_fn) with PER-COLUMN standardization: inputs/outputs
        carry a trailing column axis whose stats columns are given by `cols`
        (a trait index per column), so block-CG can mix traits and probes.
        Both run through the shared matrix's GenoBed.fns_multi with the
        gathered per-column statistics."""
        from gvamp.data import BedOp
        axm, atxm = self.geno.fns_multi()

        def bed_op(op: MultiOp, cols):
            return BedOp(words=op.words, mave=op.mave[:, cols],
                         msig=op.msig[:, cols], na_planar=op.na[:, :, cols],
                         m_mask=op.m_mask)

        def axm_fn(op: MultiOp, X, cols):
            return axm(bed_op(op, cols), X)

        def atxm_fn(op: MultiOp, V, cols):
            return atxm(bed_op(op, cols), V)

        return axm_fn, atxm_fn


class MultiState(NamedTuple):
    it: jax.Array
    x1: jax.Array        # [Mpad, T]
    x2: jax.Array
    r1: jax.Array
    r2: jax.Array
    z1: jax.Array        # [4, Nb, T]
    mu_cg: jax.Array     # [Mpad, T]
    mu_probe: jax.Array  # [Mpad, T*P]
    gam1: jax.Array      # [T]
    gam2: jax.Array
    gamw: jax.Array
    eta1: jax.Array
    eta2: jax.Array
    alpha1: jax.Array
    alpha2: jax.Array
    rho: jax.Array
    probs: jax.Array     # [T, L]
    vars: jax.Array      # [T, L]
    stopped: jax.Array   # bool[T] — converged traits freeze
    gmu: jax.Array       # [Mpad, T+T*P] A^T A [mu_cg | mu_probe] (tracked
                         # warm-start Gram product, see linear.LinState.gmu)
    tau_gmu: jax.Array   # [T] the per-trait tau `gmu` was stored at
                         # (tau-ratio guard, cg.tracked_warm_start)
    mu_prevb: jax.Array  # [Mpad, T+T*P] the one-older exit block and its
    gmu_prev: jax.Array  # tracked Gram product — the secant pair for
                         # cfg.cg_extrapolate (see linear.LinState)


def init_state(mp: MultiPhen, cfg: VampConfig, probs, vars_user) -> MultiState:
    dt = mp.geno.dtype
    Mp, T, L = mp.geno.Mpad, mp.T, np.asarray(probs).shape[-1]
    zeros = jnp.zeros((Mp, T), dt)
    probs_t = jnp.broadcast_to(jnp.asarray(probs, dt), (T, L))
    vars_t = jnp.broadcast_to(
        jnp.asarray(np.asarray(vars_user) * mp.geno.N, dt), (T, L))
    return MultiState(
        it=jnp.asarray(0), x1=zeros, x2=zeros, r1=zeros, r2=zeros,
        z1=jnp.zeros_like(mp.y), mu_cg=zeros,
        mu_probe=jnp.zeros((Mp, T * probe_cols(cfg)), dt),
        gam1=jnp.full((T,), cfg.gam1_init, dt),
        gam2=jnp.zeros((T,), dt), gamw=jnp.full((T,), cfg.gamw_init, dt),
        eta1=jnp.zeros((T,), dt), eta2=jnp.zeros((T,), dt),
        alpha1=jnp.zeros((T,), dt), alpha2=jnp.zeros((T,), dt),
        rho=jnp.full((T,), cfg.rho, dt),
        probs=probs_t, vars=vars_t, stopped=jnp.zeros((T,), bool),
        gmu=jnp.zeros((Mp, T * (1 + probe_cols(cfg))), dt),
        tau_gmu=jnp.zeros((T,), dt),
        mu_prevb=jnp.zeros((Mp, T * (1 + probe_cols(cfg))), dt),
        gmu_prev=jnp.zeros((Mp, T * (1 + probe_cols(cfg))), dt))


class MultiAux(NamedTuple):
    op: MultiOp
    y: jax.Array        # [4, Nb, T] filtered
    bern: jax.Array     # [Mpad, P] shared probes
    aty: jax.Array      # [Mpad, T] per-trait A_t^T y_t
    z_bern: jax.Array   # [4, Nb, T*P] per-trait A_t @ probes
    m_mask: jax.Array
    defl: object = None  # (V [Mpad, k], lam [k]) shared deflation basis
    slq: object = None   # slq.SlqBasis with T*P columns: probe j under
                         # trait t's OWN Gram A_t^T A_t (per-trait
                         # standardization + NA support) — slq.lanczos_block
                         # runs C independent columnwise Krylov spaces, so
                         # one setup serves every trait exactly
                         # (linear.VampConfig.use_slq)


def _make_defl(mp: MultiPhen, cfg):
    """Shared CG deflation basis (cg.top_eigs) for the multi-trait block
    solves.  The basis is computed over trait 0's standardized Gram; other
    traits' Grams differ only through their phenotype-NA supports, so the
    basis remains an SPD preconditioner for every column (correctness is
    unaffected — only the per-trait iteration savings are approximate)."""
    if cfg.deflate_k <= 0:
        return None
    from gvamp import cg as _cg
    axm_fn, atxm_fn = mp.fns()
    cols0 = np.zeros(cfg.deflate_k, dtype=int)
    # op passed as a jit ARGUMENT (jaxpr-constant hazard, cg.top_eigs)
    mult = lambda op_, Pk: atxm_fn(op_, axm_fn(op_, Pk, cols0), cols0)
    return _cg.top_eigs(mult, mp.geno.Mpad, cfg.deflate_k,
                        jax.random.fold_in(jax.random.key(cfg.seed), 7),
                        n_iter=cfg.deflate_iters, dtype=mp.geno.dtype,
                        op=mp.op)


def _make_slq(mp: MultiPhen, cfg, bern) -> "object":
    """T*P-column Lanczos quadrature: probe j in trait t's Krylov space
    under trait t's own Gram (one setup pass block, linear.VampConfig
    .use_slq)."""
    if not cfg.use_slq or cfg.red:
        return None
    from gvamp import slq as _slq
    axm_fn, atxm_fn = mp.fns()
    T, P_ = mp.T, cfg.n_probes
    cols_tp = np.repeat(np.arange(T), P_)

    # op as a jit ARGUMENT (jaxpr-constant hazard, cg.top_eigs)
    def build(op_, U):
        mult = lambda X: atxm_fn(op_, axm_fn(op_, X, cols_tp), cols_tp)
        return _slq.build(mult, U, cfg.slq_k)

    bern_tp = jnp.tile(bern, (1, T))
    return jax.jit(build)(mp.op, bern_tp)


def make_aux(mp: MultiPhen, cfg: VampConfig) -> MultiAux:
    from gvamp.linear import make_bern_probe

    P_ = cfg.n_probes
    T = mp.T
    bern = make_bern_probe(mp.geno, cfg.seed, P_)
    axm_fn, atxm_fn = mp.fns()
    yf = mp.filter_pheno()
    cols_t = np.arange(T)
    aty = atxm_fn(mp.op, yf, cols_t)
    cols_tp = np.repeat(np.arange(T), P_)
    if cfg.use_slq and not cfg.red:
        # dead under SLQ (both trace branches use quad_ratio): skip the
        # T*P-wide setup pass and the [4, Nb, T*P] array
        z_bern = jnp.zeros(yf.shape[:2] + (0,), yf.dtype)
    else:
        bern_tp = jnp.tile(bern, (1, T))  # [Mpad, T*P] (probe j of trait t)
        z_bern = axm_fn(mp.op, bern_tp, cols_tp)
    return MultiAux(op=mp.op, y=yf, bern=bern, aty=aty, z_bern=z_bern,
                    m_mask=mp.geno.m_mask, defl=_make_defl(mp, cfg),
                    slq=_make_slq(mp, cfg, bern))


def make_step(mp: MultiPhen, cfg: VampConfig, jit: bool = True):
    dt = mp.geno.dtype
    Mt = float(mp.geno.Mt)
    N = float(mp.geno.N)
    T = mp.T
    P_ = cfg.n_probes
    axm_fn, atxm_fn = mp.fns()
    cols_t = np.arange(T)
    cols_tp = np.repeat(np.arange(T), P_)
    # SLQ (linear.VampConfig.use_slq): zero probe COLUMNS ride the CG; the
    # quadratures use the full T*P probe basis in aux.slq
    slq_on = cfg.use_slq and not cfg.red
    P_cg = probe_cols(cfg)
    cols_tpc = np.repeat(np.arange(T), P_cg)
    cols_all = np.concatenate([cols_t, cols_tpc])
    if slq_on:
        from gvamp import slq as _slq
    # fold the noise-EM pass into the CG exit identities, exactly like the
    # single-trait engine (linear.VampConfig.fold_noise): two-pass routing
    # only, env kill switch for A/B
    fold_noise = (cfg.fold_noise
                  and os.environ.get("GVAMP_NOISE_PASS", "0") != "1")

    g1_t = jax.vmap(g1, in_axes=(1, 0, Prior(0, 0)), out_axes=1)
    g1d_t = jax.vmap(g1d, in_axes=(1, 0, Prior(0, 0)), out_axes=1)
    upd_t = jax.vmap(
        lambda r, g, pr, mm: update_prior(
            r, g, pr, mm, Mt, em_max_iter=cfg.em_max_iter,
            em_err_thr=cfg.em_err_thr, learn_vars=cfg.learn_vars),
        in_axes=(1, 0, Prior(0, 0), None))

    def step(state: MultiState, aux: MultiAux):
        op, y, bern, m_mask = aux.op, aux.y, aux.bern, aux.m_mask
        it = state.it + 1
        state = state._replace(it=it)
        x1_prev = state.x1
        live = ~state.stopped  # bool[T]

        # ---- denoising: fixed-count re-estimation loop with per-trait
        # convergence masking (linear.py revar loop, vamp.cpp:289-338)
        def revar_body(i, carry):
            x1, gam1, alpha1, eta1, probs, vars_, prev_gam1 = carry
            pr = Prior(probs=probs, vars=vars_)
            act = (i == 0) | ((it > 1)
                              & (jnp.abs(gam1 - prev_gam1) >= cfg.revar_tol))
            x1n = g1_t(state.r1, gam1, pr) * m_mask[:, None]
            dn = g1d_t(state.r1, gam1, pr)
            alpha1n = jnp.sum(dn * m_mask[:, None], axis=0) / Mt
            eta1n = gam1 / alpha1n
            l2diff = jnp.sum(jnp.square((x1n - state.r1) * m_mask[:, None]),
                             axis=0)
            gam1n = jnp.where(
                it > 1, _clamp_gamma(1.0 / (1.0 / eta1n + l2diff / Mt)), gam1)
            pr2 = upd_t(state.r1, gam1n, pr, m_mask)
            sel = lambda n, o: jnp.where(act, n, o)
            selm = lambda n, o: jnp.where(act[None, :], n, o)
            # prior re-estimation only from it > 1 (vamp.cpp:318-330); at
            # it == 1 the single update happens after the loop
            actl = (act & (it > 1))[:, None]
            sell = lambda n, o: jnp.where(actl, n, o)
            out = (selm(x1n, x1), sel(gam1n, gam1), sel(alpha1n, alpha1),
                   sel(eta1n, eta1), sell(pr2.probs, probs),
                   sell(pr2.vars, vars_), sel(gam1, prev_gam1))
            return _cast_like(out, carry)

        big = jnp.full((T,), jnp.inf, dt)
        carry = (state.x1, state.gam1, state.alpha1, state.eta1,
                 state.probs, state.vars, big)
        x1, gam1, alpha1, eta1, probs, vars_ = jax.lax.fori_loop(
            0, max(cfg.auto_var_max_iter, 1), revar_body, carry)[:6]

        # prior update when the re-estimation loop is off or at it == 1
        # (linear.py post-loop update, vamp.cpp:518-519)
        pr1 = upd_t(state.r1, gam1, Prior(probs=probs, vars=vars_), m_mask)
        first = jnp.asarray((cfg.auto_var_max_iter == 0) | (it <= 1))
        probs = jnp.where(first, pr1.probs, probs)
        vars_ = jnp.where(first, pr1.vars, vars_)

        # damping + adaptive rho (vamp.cpp:348-414, 501-502)
        damp = it > 1
        rho = state.rho
        x1 = jnp.where(damp, rho[None, :] * x1 + (1 - rho[None, :]) * state.x1,
                       x1)
        alpha1 = jnp.where(damp, rho * alpha1 + (1 - rho) * state.alpha1,
                           alpha1)
        xi = jnp.minimum(2.0 * jnp.minimum(alpha1, state.alpha2), 1.0)
        rho = jnp.where(damp, jnp.maximum(rho, xi), rho)

        # freeze converged traits
        x1 = jnp.where(live[None, :], x1, state.x1)
        gam1 = jnp.where(live, gam1, state.gam1)
        alpha1 = jnp.where(live, alpha1, state.alpha1)
        eta1 = jnp.where(live, eta1, state.eta1)

        # z1 = A x1 rides the noise-EM wide pass below (one fewer HBM
        # pass/iteration, like the single-trait engine)
        gam2 = _clamp_gamma(eta1 - gam1)
        r2 = ((eta1[None, :] * x1 - gam1[None, :] * state.r1)
              / gam2[None, :]) * m_mask[:, None]
        r2 = jnp.where(live[None, :], r2, state.r2)

        l2y = jnp.sum(jnp.square(y), axis=(0, 1))

        # ---- LMMSE: T solves + T*P probes in ONE block CG ----------------
        # gamma_damp scales gam2 for the whole LMMSE block and is restored
        # before the re-estimate, like the single-trait linear engine
        # (reference --gamma-damp, vamp.cpp:553-554, 642-643)
        gamw = state.gamw
        gam2_eff = gam2 * cfg.gamma_damp
        tau_cols = jnp.concatenate([gamw, gamw[cols_tpc]])
        gam2_cols = jnp.concatenate([gam2_eff, gam2_eff[cols_tpc]])
        diag_cols = (tau_cols * (N - 1.0) / N + gam2_cols)[None, :]

        def multb(Pk):
            return (tau_cols[None, :] * atxm_fn(op, axm_fn(op, Pk, cols_all),
                                                cols_all)
                    + gam2_cols[None, :] * Pk)

        v = gamw[None, :] * aux.aty + gam2_eff[None, :] * r2
        bern_tp = jnp.tile(bern[:, :P_cg], (1, T))
        V = jnp.concatenate([v, bern_tp], axis=1)
        mu0 = jnp.concatenate([state.mu_cg, state.mu_probe], axis=1)
        precond = None
        if cfg.deflate_k > 0:
            precond = cg.make_deflated_precond(
                aux.defl[0], aux.defl[1], tau_cols, gam2_cols, diag_cols)
        r0 = None
        if cfg.gram_refresh > 1:
            # tracked warm-start Gram product (see linear.py / the guards
            # in cg.tracked_warm_start): the init residual is elementwise
            # algebra except on refresh ticks
            tau_ref = jnp.concatenate([state.tau_gmu,
                                       state.tau_gmu[cols_tpc]])[None, :]
            gmu_c = state.gmu
            if cfg.cg_extrapolate:
                # per-trait secant extrapolation over the last two exits
                # (see linear.py / cg.extrapolate_pair): LS theta per
                # column, zero packed passes
                mu0, gmu_c = cg.extrapolate_pair(
                    V, mu0, state.gmu, state.mu_prevb, state.gmu_prev,
                    tau_cols[None, :], gam2_cols[None, :])
            mu0, r0 = cg.tracked_warm_start(
                V, mu0, gmu_c, tau_cols[None, :], tau_ref,
                gam2_cols[None, :], it, cfg.gram_refresh, multb)
        # fold_noise: the T z1 = A_t x1_t columns ride the first CG
        # iteration's forward pass (see linear.py); no extra packed read
        rider = x1 if fold_noise else None

        def rider_mult(Pk, X):
            Z = axm_fn(op, jnp.concatenate([Pk, X], axis=1),
                       np.concatenate([cols_all, cols_t]))
            B = Pk.shape[1]
            return (tau_cols[None, :] * atxm_fn(op, Z[..., :B], cols_all)
                    + gam2_cols[None, :] * Pk), Z[..., B:]

        sol = cg.solve_block(multb, V, mu0, diag_cols, gam2_cols,
                             cfg.cg_max_iter,
                             modes=(0,) * T + (1,) * (T * P_cg),
                             err_tol=cfg.cg_err_tol,
                             onsager_tol=cfg.onsager_tol,
                                 plateau=cfg.cg_plateau,
                             precond=precond, r0=r0,
                             rider=rider,
                             rider_mult=rider_mult if fold_noise else None)
        gmu_new = cg.gram_from_exit(V, sol, tau_cols[None, :],
                                    gam2_cols[None, :])
        x2 = sol.mu[:, :T] * m_mask[:, None]
        invq = sol.mu[:, T:]
        x2 = jnp.where(live[None, :], x2, state.x2)

        # per-trait Onsager alpha2: SLQ quadrature per (trait, probe) column
        # on the T*P-column basis, or the probe-CG Hutchinson trace
        if slq_on:
            quad = _slq.quad_inv(aux.slq, gamw[cols_tp],
                                 gam2_eff[cols_tp]).reshape(T, P_).mean(axis=1)
        else:
            quad = jnp.sum(bern_tp * invq, axis=0).reshape(T, P_).mean(axis=1)
        alpha2 = gam2_eff * quad
        eta2 = gam2 / alpha2
        l2_x2r2 = jnp.sum(jnp.square((x2 - r2) * m_mask[:, None]), axis=0)
        gam2 = jnp.where((cfg.auto_var_max_iter >= 1) & (it > 2),
                         _clamp_gamma(1.0 / (1.0 / eta2 + l2_x2r2 / Mt)), gam2)
        gam1_new = _clamp_gamma(eta2 - gam2)
        r1 = ((eta2[None, :] * x2 - gam2[None, :] * r2)
              / gam1_new[None, :]) * m_mask[:, None]

        # noise precision per trait (updateNoisePrec, vamp.cpp:892-927)
        if fold_noise:
            # resid2/trace_corr via the CG exit Gram identity (exact for any
            # mu: tau*A^T A mu = V - r - gam2*mu), z1 via the rider columns —
            # NO packed pass here (see linear.py phase_noise)
            z1 = sol.rider_out
            muT, rT = sol.mu[:, :T], sol.r[:, :T]
            quad_t = (jnp.sum(muT * V[:, :T], axis=0)
                      - jnp.sum(muT * rT, axis=0)
                      - gam2_eff * jnp.sum(jnp.square(muT), axis=0)) / gamw
            resid2 = jnp.maximum(
                quad_t - 2.0 * jnp.sum(muT * aux.aty, axis=0) + l2y, 0.0)
            if slq_on:
                trace_corr = _slq.quad_ratio(
                    aux.slq, gamw[cols_tp], gam2_eff[cols_tp]
                ).reshape(T, P_).mean(axis=1) * Mt
            else:
                trq = (jnp.sum(jnp.square(bern_tp), axis=0)
                       - jnp.sum(bern_tp * sol.r[:, T:], axis=0)
                       - gam2_cols[T:] * jnp.sum(bern_tp * invq, axis=0)) \
                    / tau_cols[T:]
                trace_corr = trq.reshape(T, P_).mean(axis=1) * Mt
            R2_2 = 1.0 - resid2 / l2y
        else:
            # one wide pass computes A x2, A invq AND the deferred z1 = A x1
            Z2 = axm_fn(op, jnp.concatenate([x2, invq, x1], axis=1),
                        np.concatenate([cols_all, cols_t]))
            ax2 = Z2[..., :T]
            z1 = Z2[..., T + T * P_cg:]
            resid2 = jnp.sum(jnp.square(ax2 - y), axis=(0, 1))
            if slq_on:
                trace_corr = _slq.quad_ratio(
                    aux.slq, gamw[cols_tp], gam2_eff[cols_tp]
                ).reshape(T, P_).mean(axis=1) * Mt
            else:
                tc = jnp.sum(aux.z_bern * Z2[..., T:T + T * P_],
                             axis=(0, 1))
                trace_corr = tc.reshape(T, P_).mean(axis=1) * Mt
            R2_2 = 1.0 - jnp.sum(jnp.square(y - ax2), axis=(0, 1)) / l2y
        gamw_new = N / (resid2 + trace_corr)
        R2_1 = 1.0 - jnp.sum(jnp.square(y - z1), axis=(0, 1)) / l2y

        rel_change = jnp.sqrt(
            jnp.sum(jnp.square(x1_prev - x1), axis=0) /
            jnp.maximum(jnp.sum(jnp.square(x1_prev), axis=0), 1e-300))
        stopped = state.stopped | ((it > 1)
                                   & (rel_change < cfg.stop_criteria_thr))

        # freeze all trailing state of stopped traits
        live_tp = live[np.asarray(cols_tpc)]
        new_state = MultiState(
            it=it, x1=x1, x2=x2,
            r1=jnp.where(live[None, :], r1, state.r1), r2=r2,
            z1=jnp.where(live[None, None, :], z1, state.z1),
            mu_cg=jnp.where(live[None, :], sol.mu[:, :T], state.mu_cg),
            mu_probe=jnp.where(live_tp[None, :], invq, state.mu_probe),
            gam1=jnp.where(live, gam1_new, state.gam1),
            gam2=jnp.where(live, gam2, state.gam2),
            gamw=jnp.where(live, gamw_new, state.gamw),
            eta1=eta1, eta2=jnp.where(live, eta2, state.eta2),
            alpha1=alpha1, alpha2=jnp.where(live, alpha2, state.alpha2),
            rho=rho,
            probs=jnp.where(live[:, None], probs, state.probs),
            vars=jnp.where(live[:, None], vars_, state.vars),
            stopped=stopped,
            gmu=jnp.where(jnp.concatenate([live, live_tp])[None, :],
                          gmu_new, state.gmu),
            tau_gmu=jnp.where(live, gamw, state.tau_gmu),
            # roll the secant pair on the same live mask as gmu: frozen
            # traits keep their pair (delta -> 0 -> theta guard disarms)
            mu_prevb=(jnp.where(
                jnp.concatenate([live, live_tp])[None, :],
                jnp.concatenate([state.mu_cg, state.mu_probe], axis=1),
                state.mu_prevb) if cfg.cg_extrapolate else state.mu_prevb),
            gmu_prev=(jnp.where(jnp.concatenate([live, live_tp])[None, :],
                                state.gmu, state.gmu_prev)
                      if cfg.cg_extrapolate else state.gmu_prev))
        new_state = _cast_like(new_state, state)
        metrics = {
            "it": it, "gam1": gam1, "gam2": gam2, "gamw": gamw_new,
            "alpha1": alpha1, "alpha2": alpha2, "rho": rho,
            "R2_train_1": R2_1, "R2_train_2": R2_2,
            "rel_change": rel_change, "cg_iters": sol.iters[:T],
            "stopped": stopped,
        }
        return new_state, metrics

    return jax.jit(step) if jit else step


def make_scan_step(make_step_fn, mp, cfg, k: int, **kw):
    """k multi-trait iterations per device dispatch via lax.scan (throughput
    mode, --sync-every): converged traits are frozen inside the step so the
    extra scan iterations are no-ops for them; semantics match k single
    steps exactly (equality-tested)."""
    raw = make_step_fn(mp, cfg, jit=False, **kw)

    def multi_it(state, aux):
        def body(s, _):
            return raw(s, aux)

        return jax.lax.scan(body, state, None, length=k)

    return jax.jit(multi_it)


def _run_multi_loop(step, state, aux, cfg, chunk, mp, verbose_print,
                    callbacks, make_single=None):
    """Shared chunked driver loop for the three multi-trait engines.

    ``make_single`` (required when ``chunk > 1``) lazily builds a one-step
    program for the final partial chunk, so state stops EXACTLY at
    cfg.max_iter instead of silently overrunning it by up to chunk-1
    device iterations."""
    history = []
    import time as _time
    from gvamp.linear import dispatch_chunk
    single = step if chunk == 1 else None
    it = int(np.asarray(state.it))  # > 0 when resuming from a checkpoint
    while it < cfg.max_iter:
        _t0 = _time.perf_counter()
        state, metrics, k_got, single = dispatch_chunk(
            step, single, make_single, state, aux, cfg.max_iter - it, chunk)
        fetched = jax.device_get(metrics)  # one batched transfer
        span = np.float64((_time.perf_counter() - _t0) * 1e3)
        if k_got == 1:
            chunk_ms = [fetched]
        else:
            chunk_ms = [{k: v[i] for k, v in fetched.items()}
                        for i in range(k_got)]
        for m in chunk_ms:
            it += 1
            m["iter_ms"] = span / len(chunk_ms)
            history.append(m)
            # NB: no mid-chunk break on `stopped` — the device already ran
            # the full chunk (stopped traits freeze, so the tail iterations
            # are no-ops), and breaking early would desync the logical `it`
            # from state.it in the checkpoint/dump callbacks below
            if it >= cfg.max_iter:
                break
        m = history[-1]
        if verbose_print:
            verbose_print(it, m)
        if callbacks:
            for cb in callbacks:
                cb(it, state, m, mp.geno)
        if bool(np.asarray(m["stopped"]).all()):
            if verbose_print:
                print("all traits met the stopping criterion")
            break
    return state, history


def infer(mp: MultiPhen, cfg: VampConfig, probs, vars_user,
          verbose: bool = True, callbacks=None, sync_every: int = 1,
          resume_state: MultiState = None):
    """Run the joint multi-trait loop; returns (x_stored [M, T], state, hist).

    Stops when every trait's rel-change criterion fires (converged traits
    freeze in place while the rest continue).  ``sync_every`` > 1 runs that
    many iterations per device dispatch (lax.scan throughput mode).
    ``resume_state`` continues a checkpointed run: ``cfg.max_iter`` is the
    TOTAL budget and the loop restarts from ``resume_state.it``.
    """
    if resume_state is not None:
        from gvamp.linear import _check_resume_probe_cols
        _check_resume_probe_cols(resume_state, cfg, T=mp.T)
    state = (resume_state if resume_state is not None
             else init_state(mp, cfg, probs, vars_user))
    aux = make_aux(mp, cfg)
    chunk = max(1, int(sync_every))
    step = (make_step(mp, cfg) if chunk == 1
            else make_scan_step(make_step, mp, cfg, chunk))
    sqn = float(np.sqrt(mp.geno.N))

    def vprint(it, m):
        r2s = " ".join(f"{v:.4f}" for v in m["R2_train_1"])
        print(f"[multi it {it}] R2=[{r2s}] "
              f"gam1=[{' '.join(f'{v:.3g}' for v in m['gam1'])}] "
              f"stopped={m['stopped'].sum()}/{mp.T}", flush=True)

    state, history = _run_multi_loop(step, state, aux, cfg, chunk, mp,
                                     vprint if verbose else None, callbacks,
                                     make_single=lambda: make_step(mp, cfg))
    from gvamp import dist
    x_stored = dist.to_numpy(state.x1)[: mp.geno.M, :] / sqn
    return x_stored, state, history


# --------------------------------------------------------------------------
# multi-trait PROBIT (binary traits)
# --------------------------------------------------------------------------
#
# Same batching as the linear multi-trait engine, with the probit z-step:
# the erfcx-stable z-denoisers are elementwise and broadcast over a trailing
# trait axis directly; per-trait covariate Newton solves vmap over traits;
# the T LMMSE solves + T*P probes share one block-CG.  Per-trait semantics
# follow probit.py / the reference's infere_bin_class (vamp_probit.cpp).


class ProbitMultiState(NamedTuple):
    it: jax.Array
    x1: jax.Array        # [Mpad, T]
    x2: jax.Array
    r1: jax.Array
    r2: jax.Array
    z1: jax.Array        # [4, Nb, T]
    z2: jax.Array
    p1: jax.Array
    p2: jax.Array
    mu_probe: jax.Array  # [Mpad, T*P]
    gam1: jax.Array      # [T]
    gam2: jax.Array
    tau1: jax.Array
    tau2: jax.Array
    alpha1: jax.Array
    probs: jax.Array     # [T, L]
    vars: jax.Array
    cov_eff: jax.Array   # [C, T]
    stopped: jax.Array   # bool[T]
    mu_cg: jax.Array     # [Mpad, T] LMMSE-column CG warm starts
    gmu: jax.Array       # [Mpad, T+T*P] tracked warm-start Gram product
                         # (see linear.LinState.gmu)
    tau_gmu: jax.Array   # [T] the per-trait tau2 `gmu` was stored at


def init_probit_state(mp: MultiPhen, cfg, probs, vars_user,
                      n_cov: int = 0) -> ProbitMultiState:
    dt = mp.geno.dtype
    Mp, T, L = mp.geno.Mpad, mp.T, np.asarray(probs).shape[-1]
    zeros = jnp.zeros((Mp, T), dt)
    zn = jnp.zeros_like(mp.y)
    return ProbitMultiState(
        it=jnp.asarray(0), x1=zeros, x2=zeros, r1=zeros, r2=zeros,
        z1=zn, z2=zn, p1=zn, p2=zn,
        mu_probe=jnp.zeros((Mp, T * probe_cols(cfg)), dt),
        gam1=jnp.full((T,), cfg.gam1_init, dt),
        gam2=jnp.zeros((T,), dt),
        tau1=jnp.full((T,), cfg.gam1_init, dt),
        tau2=jnp.ones((T,), dt),
        alpha1=jnp.zeros((T,), dt),
        probs=jnp.broadcast_to(jnp.asarray(probs, dt), (T, L)),
        vars=jnp.broadcast_to(
            jnp.asarray(np.asarray(vars_user) * mp.geno.N, dt), (T, L)),
        cov_eff=jnp.zeros((max(n_cov, 1), T), dt),
        stopped=jnp.zeros((T,), bool),
        mu_cg=jnp.zeros((Mp, T), dt),
        gmu=jnp.zeros((Mp, T * (1 + probe_cols(cfg))), dt),
        tau_gmu=jnp.zeros((T,), dt))



def _make_x_denoiser(mp: MultiPhen, cfg):
    """Shared masked fixed-count x-denoising loop (probit/Huber variants):
    returns a fn (state, m_mask, it, live) -> (x1, gam1, alpha1, eta1,
    probs, vars) with reference damping applied (fixed rho)."""
    dt = mp.geno.dtype
    Mt = float(mp.geno.Mt)
    T = mp.T

    g1_t = jax.vmap(g1, in_axes=(1, 0, Prior(0, 0)), out_axes=1)
    g1d_t = jax.vmap(g1d, in_axes=(1, 0, Prior(0, 0)), out_axes=1)
    upd_t = jax.vmap(
        lambda r, g_, pr, mm: update_prior(
            r, g_, pr, mm, Mt, em_max_iter=cfg.em_max_iter,
            em_err_thr=cfg.em_err_thr, learn_vars=cfg.learn_vars),
        in_axes=(1, 0, Prior(0, 0), None))

    def denoise(state, m_mask, it, live):
        def revar_body(i, carry):
            x1, gam1, alpha1, eta1, probs, vars_, prev = carry
            pr = Prior(probs=probs, vars=vars_)
            act = (i == 0) | ((it > 1)
                              & (jnp.abs(gam1 - prev) >= cfg.revar_tol))
            x1n = g1_t(state.r1, gam1, pr) * m_mask[:, None]
            dn = g1d_t(state.r1, gam1, pr)
            alpha1n = jnp.sum(dn * m_mask[:, None], axis=0) / Mt
            eta1n = gam1 / alpha1n
            l2d = jnp.sum(jnp.square((x1n - state.r1) * m_mask[:, None]),
                          axis=0)
            gam1n = jnp.where(
                it > 1, _clamp_gamma(1.0 / (1.0 / eta1n + l2d / Mt)), gam1)
            pr2 = upd_t(state.r1, gam1n, pr, m_mask)
            sel = lambda n_, o: jnp.where(act, n_, o)
            selm = lambda n_, o: jnp.where(act[None, :], n_, o)
            actl = (act & (it > 1))[:, None]
            out = (selm(x1n, x1), sel(gam1n, gam1), sel(alpha1n, alpha1),
                   sel(eta1n, eta1), jnp.where(actl, pr2.probs, probs),
                   jnp.where(actl, pr2.vars, vars_), sel(gam1, prev))
            return _cast_like(out, carry)

        big = jnp.full((T,), jnp.inf, dt)
        carry = (state.x1, state.gam1, state.alpha1, jnp.zeros((T,), dt),
                 state.probs, state.vars, big)
        x1, gam1, alpha1, eta1, probs, vars_ = jax.lax.fori_loop(
            0, max(cfg.auto_var_max_iter, 1), revar_body, carry)[:6]
        pr1 = upd_t(state.r1, gam1, Prior(probs=probs, vars=vars_), m_mask)
        first = jnp.asarray((cfg.auto_var_max_iter == 0) | (it <= 1))
        probs = jnp.where(first, pr1.probs, probs)
        vars_ = jnp.where(first, pr1.vars, vars_)

        rho = jnp.asarray(cfg.rho, dt)
        damp = it > 1
        x1 = jnp.where(damp, rho * x1 + (1 - rho) * state.x1, x1)
        alpha1 = jnp.where(damp, rho * alpha1 + (1 - rho) * state.alpha1,
                           alpha1)
        x1 = jnp.where(live[None, :], x1, state.x1)
        gam1 = jnp.where(live, gam1, state.gam1)
        return x1, gam1, alpha1, eta1, probs, vars_

    return denoise


def _make_zmodel_lmmse(mp: MultiPhen, cfg, axm_fn, atxm_fn):
    """Shared z-model (probit/Huber) LMMSE tail: one T*(1+P)-column block-CG
    + Hutchinson alpha2 (guarded in (0,1)) + x/z extrinsic updates."""
    dt = mp.geno.dtype
    Mt = float(mp.geno.Mt)
    N = float(mp.geno.N)
    T = mp.T
    P_ = cfg.n_probes
    cols_t = np.arange(T)
    cols_tp = np.repeat(np.arange(T), P_)
    slq_on = cfg.use_slq and not cfg.red
    P_cg = probe_cols(cfg)
    cols_tpc = np.repeat(np.arange(T), P_cg)
    cols_all = np.concatenate([cols_t, cols_tpc])
    if slq_on:
        from gvamp import slq as _slq

    def lmmse(op, aux_bern, state_mu_probe, m_mask, it, p2f, tau2, gam2, r2,
              defl=None, gmu=None, state_mu_cg=None, tau_gmu=None,
              slq_basis=None):
        nb = mp.y.shape[1]
        v = tau2[None, :] * atxm_fn(op, p2f.reshape(4, nb, T), cols_t) \
            + gam2[None, :] * r2
        tau_cols = jnp.concatenate([tau2, tau2[cols_tpc]])
        gam2_cols = jnp.concatenate([gam2, gam2[cols_tpc]])
        diag_cols = (tau_cols * (N - 1.0) / N + gam2_cols)[None, :]

        def multb(Pk):
            return (tau_cols[None, :]
                    * atxm_fn(op, axm_fn(op, Pk, cols_all), cols_all)
                    + gam2_cols[None, :] * Pk)

        bern_tp = jnp.tile(aux_bern[:, :P_cg], (1, T))
        V = jnp.concatenate([v, bern_tp], axis=1)
        warm = gmu is not None and cfg.gram_refresh > 1
        mu_cg0 = (state_mu_cg if warm and state_mu_cg is not None
                  else jnp.zeros_like(v))
        mu0 = jnp.concatenate([mu_cg0, state_mu_probe], axis=1)
        precond = None
        if defl is not None:
            precond = cg.make_deflated_precond(
                defl[0], defl[1], tau_cols, gam2_cols, diag_cols)
        r0 = None
        if warm:
            # every column warm-starts from the previous solve with the
            # tracked Gram product (linear.py gmu; guards in
            # cg.tracked_warm_start): the init residual is elementwise
            # algebra except on refresh ticks
            tau_ref = jnp.concatenate([tau_gmu, tau_gmu[cols_tpc]])[None, :]
            mu0, r0 = cg.tracked_warm_start(
                V, mu0, gmu, tau_cols[None, :], tau_ref,
                gam2_cols[None, :], it, cfg.gram_refresh, multb)
        sol = cg.solve_block(multb, V, mu0, diag_cols, gam2_cols,
                             cfg.cg_max_iter,
                             modes=(0,) * T + (1,) * (T * P_cg),
                             err_tol=cfg.cg_err_tol,
                             onsager_tol=cfg.onsager_tol,
                                 plateau=cfg.cg_plateau,
                             precond=precond, r0=r0)
        gmu_new = cg.gram_from_exit(V, sol, tau_cols[None, :],
                                    gam2_cols[None, :])
        x2 = sol.mu[:, :T] * m_mask[:, None]
        invq = sol.mu[:, T:]
        if slq_on:
            # per-(trait, probe) SLQ quadrature at this iteration's
            # (tau2_t, gam2_t) shifts (linear.VampConfig.use_slq)
            quad = _slq.quad_inv(slq_basis, tau2[cols_tp],
                                 gam2[cols_tp]).reshape(T, P_).mean(axis=1)
        else:
            quad = jnp.sum(bern_tp * invq, axis=0).reshape(T, P_).mean(axis=1)
        alpha2 = gam2 * quad
        eps1 = 100.0 * jnp.finfo(dt).eps
        alpha2 = jnp.clip(alpha2, 1e-11, 1.0 - eps1)
        eta2 = gam2 / alpha2
        l2x2r2 = jnp.sum(jnp.square((x2 - r2) * m_mask[:, None]), axis=0)
        gam2 = jnp.where(it > 1,
                         _clamp_gamma(1.0 / (1.0 / eta2 + l2x2r2 / Mt)), gam2)
        r1 = ((x2 - alpha2[None, :] * r2)
              / (1.0 - alpha2)[None, :]) * m_mask[:, None]
        gam1_new = gam2 * (1.0 - alpha2) / alpha2

        z2 = axm_fn(op, x2, cols_t)
        z2f = z2.reshape(-1, T)
        beta2 = Mt / N * (1.0 - alpha2)
        return (sol, x2, invq, alpha2, gam2, r1, gam1_new, z2, z2f, beta2,
                gmu_new)

    return lmmse


def make_probit_step(mp: MultiPhen, cfg, n_cov: int = 0, jit: bool = True):
    from gvamp.probit import (g1_bin_class, g1d_bin_class, newton_cov)

    dt = mp.geno.dtype
    Mt = float(mp.geno.Mt)
    N = float(mp.geno.N)
    T = mp.T
    P_ = cfg.n_probes
    pv = cfg.probit_var
    axm_fn, atxm_fn = mp.fns()
    cols_t = np.arange(T)
    cols_tpc = np.repeat(np.arange(T), probe_cols(cfg))

    denoise_x = _make_x_denoiser(mp, cfg)
    lmmse_z = _make_zmodel_lmmse(mp, cfg, axm_fn, atxm_fn)
    newton_t = jax.vmap(
        lambda y_, gg_, Z_, eta0_, nm_: newton_cov(
            y_, gg_, Z_, eta0_, nm_, probit_var=pv,
            max_iter=cfg.newton_max_iter),
        in_axes=(1, 1, None, 1, None), out_axes=1)

    def step(state: ProbitMultiState, aux):
        op, m_mask = aux.op, aux.m_mask
        nmf = aux.n_mask.reshape(-1)                # [Nf]
        yf = aux.y.reshape(-1, T)                   # [Nf, T]
        it = state.it + 1
        state = state._replace(it=it)
        x1_prev = state.x1
        live = ~state.stopped

        # ---- covariate effects (it 1; vamp_probit.cpp:110-126) ------------
        cov_eff = state.cov_eff
        if n_cov > 0:
            gg = state.z1.reshape(-1, T)

            def solve_cov(_):
                return newton_t(yf, gg, aux.Z, jnp.zeros_like(cov_eff), nmf)

            cov_eff = jax.lax.cond(it == 1, solve_cov, lambda _: cov_eff, None)
            m_cov = jnp.matmul(aux.Z, cov_eff, precision=jax.lax.Precision.HIGHEST) \
                * nmf[:, None]       # [Nf, T]
        else:
            m_cov = jnp.zeros_like(yf)

        # ---- denoise x (shared masked revar loop) --------------------------
        x1, gam1, alpha1, eta1, probs, vars_ = denoise_x(
            state, m_mask, it, live)

        gam2 = _clamp_gamma(eta1 - gam1)
        r2 = ((eta1[None, :] * x1 - gam1[None, :] * state.r1)
              / gam2[None, :]) * m_mask[:, None]

        # ---- denoise z (vamp_probit.cpp:330-460) ---------------------------
        p1f = state.p1.reshape(-1, T)
        tau1 = state.tau1
        z1f = g1_bin_class(p1f, tau1[None, :], yf, m_cov, pv) * nmf[:, None]
        beta1 = jnp.sum(g1d_bin_class(p1f, tau1[None, :], yf, m_cov, pv)
                        * nmf[:, None], axis=0) / N
        zeta1 = tau1 / beta1
        l2zp = jnp.sum(jnp.square(z1f - p1f) * nmf[:, None], axis=0)
        tau1 = jnp.where(it > 1,
                         _clamp_gamma(1.0 / (1.0 / zeta1 + l2zp / N)), tau1)
        p2f = ((z1f - beta1[None, :] * p1f) / (1.0 - beta1)[None, :]) * nmf[:, None]
        tau2 = _clamp_gamma(tau1 * (1.0 - beta1) / beta1)

        # ---- LMMSE x + z (shared block-CG tail) ----------------------------
        nb = mp.y.shape[1]
        (sol, x2, invq, alpha2, gam2, r1, gam1_new, z2, z2f, beta2,
         gmu_new) = \
            lmmse_z(op, aux.bern, state.mu_probe, m_mask, it, p2f, tau2,
                    gam2, r2, defl=aux.defl, gmu=state.gmu,
                    state_mu_cg=state.mu_cg, tau_gmu=state.tau_gmu,
                    slq_basis=aux.slq)
        tau2_solve = tau2  # the tau the Gram product was stored at
        zeta2 = tau2 / beta2
        l2z2p2 = jnp.sum(jnp.square(z2f - p2f) * nmf[:, None], axis=0)
        tau2 = jnp.where(it > 1, 1.0 / (1.0 / zeta2 + l2z2p2 / N), tau2)
        p1_new = ((z2f - beta2[None, :] * p2f)
                  / (1.0 - beta2)[None, :]) * nmf[:, None]
        tau1_new = _clamp_gamma(tau2 * (1.0 - beta2) / beta2)
        # --stab-gamma geometric trust region on the per-trait gam1/tau1
        # recurrences (extension; see linear.VampConfig.stab_gamma)
        if cfg.stab_gamma < 1.0:
            s_ = jnp.asarray(cfg.stab_gamma, tau1_new.dtype)
            gam1_new = geo_damp(gam1_new, state.gam1, s_, it > 1)
            tau1_new = geo_damp(tau1_new, state.tau1, s_, it > 1)

        rel_change = jnp.sqrt(
            jnp.sum(jnp.square(x1_prev - x1), axis=0) /
            jnp.maximum(jnp.sum(jnp.square(x1_prev), axis=0), 1e-30))
        stopped = state.stopped | ((it > 1)
                                   & (rel_change < cfg.stop_criteria_thr))
        live_tp = live[np.asarray(cols_tpc)]

        def keep(new, old, mask):
            return jnp.where(mask, new, old)

        new_state = ProbitMultiState(
            it=it, x1=x1,
            x2=keep(x2, state.x2, live[None, :]),
            r1=keep(r1, state.r1, live[None, :]), r2=r2,
            z1=keep(z1f.reshape(4, nb, T), state.z1, live[None, None, :]),
            z2=keep(z2, state.z2, live[None, None, :]),
            p1=keep(p1_new.reshape(4, nb, T), state.p1, live[None, None, :]),
            p2=p2f.reshape(4, nb, T),
            mu_probe=keep(invq, state.mu_probe, live_tp[None, :]),
            gam1=keep(gam1_new, state.gam1, live),
            gam2=keep(gam2, state.gam2, live),
            tau1=keep(tau1_new, state.tau1, live),
            tau2=keep(tau2, state.tau2, live),
            alpha1=alpha1, probs=keep(probs, state.probs, live[:, None]),
            vars=keep(vars_, state.vars, live[:, None]),
            cov_eff=cov_eff, stopped=stopped,
            mu_cg=keep(sol.mu[:, :T], state.mu_cg, live[None, :]),
            gmu=keep(gmu_new, state.gmu,
                     jnp.concatenate([live, live_tp])[None, :]),
            tau_gmu=keep(tau2_solve, state.tau_gmu, live))
        metrics = {
            "it": it, "gam1": gam1_new, "gam2": gam2, "tau1": tau1_new,
            "tau2": tau2, "alpha1": alpha1, "alpha2": alpha2, "beta1": beta1,
            "beta2": beta2, "rel_change": rel_change,
            "cg_iters": sol.iters[:T], "cov_eff": cov_eff, "stopped": stopped,
        }
        return _cast_like(new_state, state), metrics

    return jax.jit(step) if jit else step


class ProbitMultiAux(NamedTuple):
    op: MultiOp
    y: jax.Array
    n_mask: jax.Array
    bern: jax.Array
    Z: jax.Array
    m_mask: jax.Array
    defl: object = None
    slq: object = None   # T*P-column SlqBasis (see MultiAux.slq) or None


def make_probit_aux(mp: MultiPhen, cfg) -> ProbitMultiAux:
    from gvamp.linear import make_bern_probe

    geno = mp.geno
    C = geno.covs.shape[1] if geno.covs is not None else 0
    nb = geno.layout.n_bytes
    Z = (geno.covs_planar().reshape(4 * nb, C) if C > 0
         else jnp.zeros((4 * nb, 1), geno.dtype))
    bern = make_bern_probe(geno, cfg.seed, cfg.n_probes)
    return ProbitMultiAux(
        op=mp.op, y=mp.filter_pheno(), n_mask=geno.n_mask_planar,
        bern=bern,
        Z=Z, m_mask=geno.m_mask, defl=_make_defl(mp, cfg),
        slq=_make_slq(mp, cfg, bern))


def infer_probit(mp: MultiPhen, cfg, probs, vars_user, verbose: bool = True,
                 callbacks=None, sync_every: int = 1, resume_state=None):
    """Joint multi-trait probit run; returns (x_stored [M, T], state, hist)."""
    n_cov = mp.geno.covs.shape[1] if mp.geno.covs is not None else 0
    if resume_state is not None:
        from gvamp.linear import _check_resume_probe_cols
        _check_resume_probe_cols(resume_state, cfg, T=mp.T)
    state = (resume_state if resume_state is not None
             else init_probit_state(mp, cfg, probs, vars_user, n_cov=n_cov))
    aux = make_probit_aux(mp, cfg)
    chunk = max(1, int(sync_every))
    step = (make_probit_step(mp, cfg, n_cov=n_cov) if chunk == 1
            else make_scan_step(make_probit_step, mp, cfg, chunk,
                                n_cov=n_cov))
    sqn = float(np.sqrt(mp.geno.N))

    def vprint(it, m):
        print(f"[multi-probit it {it}] "
              f"gam1=[{' '.join(f'{v:.3g}' for v in m['gam1'])}] "
              f"beta1=[{' '.join(f'{v:.3g}' for v in m['beta1'])}] "
              f"stopped={m['stopped'].sum()}/{mp.T}", flush=True)

    state, history = _run_multi_loop(
        step, state, aux, cfg, chunk, mp, vprint if verbose else None,
        callbacks, make_single=lambda: make_probit_step(mp, cfg, n_cov=n_cov))
    from gvamp import dist
    x_stored = dist.to_numpy(state.x1)[: mp.geno.M, :] / sqn
    return x_stored, state, history


# --------------------------------------------------------------------------
# multi-trait HUBER (robust regression)
# --------------------------------------------------------------------------


class HuberMultiState(NamedTuple):
    it: jax.Array
    x1: jax.Array
    x2: jax.Array
    r1: jax.Array
    r2: jax.Array
    z1: jax.Array
    z2: jax.Array
    p1: jax.Array
    p2: jax.Array
    mu_probe: jax.Array
    gam1: jax.Array
    gam2: jax.Array
    tau1: jax.Array
    tau2: jax.Array
    alpha1: jax.Array
    deltaH: jax.Array    # [T]
    probs: jax.Array
    vars: jax.Array
    key: jax.Array
    stopped: jax.Array
    mu_cg: jax.Array     # [Mpad, T] LMMSE-column CG warm starts
    gmu: jax.Array       # [Mpad, T+T*P] tracked warm-start Gram product
    tau_gmu: jax.Array   # [T] the per-trait tau2 `gmu` was stored at


def init_huber_state(mp: MultiPhen, cfg, probs, vars_user) -> HuberMultiState:
    dt = mp.geno.dtype
    Mp, T, L = mp.geno.Mpad, mp.T, np.asarray(probs).shape[-1]
    zeros = jnp.zeros((Mp, T), dt)
    zn = jnp.zeros_like(mp.y)
    return HuberMultiState(
        it=jnp.asarray(0), x1=zeros, x2=zeros, r1=zeros, r2=zeros,
        z1=zn, z2=zn, p1=zn, p2=zn,
        mu_probe=jnp.zeros((Mp, T * probe_cols(cfg)), dt),
        gam1=jnp.full((T,), cfg.gam1_init, dt),
        gam2=jnp.zeros((T,), dt),
        tau1=jnp.full((T,), cfg.gam1_init, dt),
        tau2=jnp.ones((T,), dt),
        alpha1=jnp.zeros((T,), dt),
        deltaH=jnp.full((T,), cfg.deltaH_init, dt),
        probs=jnp.broadcast_to(jnp.asarray(probs, dt), (T, L)),
        vars=jnp.broadcast_to(
            jnp.asarray(np.asarray(vars_user) * mp.geno.N, dt), (T, L)),
        key=jax.random.key(cfg.seed + 2),
        stopped=jnp.zeros((T,), bool),
        mu_cg=jnp.zeros((Mp, T), dt),
        gmu=jnp.zeros((Mp, T * (1 + probe_cols(cfg))), dt),
        tau_gmu=jnp.zeros((T,), dt))


def make_huber_step(mp: MultiPhen, cfg, jit: bool = True):
    from gvamp.robust import em_deltaH, g1_huber, g1d_huber_der

    dt = mp.geno.dtype
    Mt = float(mp.geno.Mt)
    N = float(mp.geno.N)
    T = mp.T
    P_ = cfg.n_probes
    axm_fn, atxm_fn = mp.fns()
    cols_t = np.arange(T)
    cols_tpc = np.repeat(np.arange(T), probe_cols(cfg))

    denoise_x = _make_x_denoiser(mp, cfg)
    lmmse_z = _make_zmodel_lmmse(mp, cfg, axm_fn, atxm_fn)
    em_t = jax.vmap(
        lambda k, p1_, t1_, y_, nm_: em_deltaH(
            k, p1_, t1_, y_, nm_, num_mc=cfg.mc_steps),
        in_axes=(0, 1, 0, 1, None))

    def step(state: HuberMultiState, aux):
        op, m_mask = aux.op, aux.m_mask
        nmf = aux.n_mask.reshape(-1)
        yf = aux.y.reshape(-1, T)
        it = state.it + 1
        state = state._replace(it=it)
        x1_prev = state.x1
        live = ~state.stopped

        # ---- denoise x (shared masked revar loop) --------------------------
        x1, gam1, alpha1, eta1, probs, vars_ = denoise_x(
            state, m_mask, it, live)

        gam2 = _clamp_gamma(eta1 - gam1)
        r2 = ((eta1[None, :] * x1 - gam1[None, :] * state.r1)
              / gam2[None, :]) * m_mask[:, None]

        # ---- denoise z with the Huber proximal ------------------------------
        p1f = state.p1.reshape(-1, T)
        tau1 = state.tau1
        delta = state.deltaH
        z1f = g1_huber(p1f, tau1[None, :], delta[None, :], yf) * nmf[:, None]
        beta1 = jnp.sum(g1d_huber_der(p1f, tau1[None, :], delta[None, :], yf)
                        * nmf[:, None], axis=0) / N
        zeta1 = tau1 / beta1
        l2zp = jnp.sum(jnp.square(z1f - p1f) * nmf[:, None], axis=0)
        tau1 = jnp.where(it >= 2,
                         _clamp_gamma(1.0 / (1.0 / zeta1 + l2zp / N)), tau1)

        key, sub = jax.random.split(state.key)
        delta = em_t(jax.random.split(sub, T), p1f, tau1, yf, nmf)

        p2f = ((z1f - beta1[None, :] * p1f) / (1.0 - beta1)[None, :]) * nmf[:, None]
        tau2 = _clamp_gamma(tau1 * (1.0 - beta1) / beta1)

        # ---- LMMSE x + z (shared block-CG tail) ----------------------------
        nb = mp.y.shape[1]
        (sol, x2, invq, alpha2, gam2, r1, gam1_new, z2,
         z2f, beta2, gmu_new) = lmmse_z(op, aux.bern, state.mu_probe,
                                        m_mask, it, p2f, tau2, gam2, r2,
                                        defl=aux.defl, gmu=state.gmu,
                                        state_mu_cg=state.mu_cg,
                                        tau_gmu=state.tau_gmu,
                                        slq_basis=aux.slq)
        tau2_solve = tau2  # the tau the Gram product was stored at
        zeta2 = tau2 / beta2
        l2z2p2 = jnp.sum(jnp.square(z2f - p2f) * nmf[:, None], axis=0)
        tau2 = jnp.where(it > 1, 1.0 / (1.0 / zeta2 + l2z2p2 / N), tau2)
        p1_new = ((z2f - beta2[None, :] * p2f)
                  / (1.0 - beta2)[None, :]) * nmf[:, None]
        tau1_new = _clamp_gamma(tau2 * (1.0 - beta2) / beta2)
        # --stab-gamma geometric trust region on the per-trait gam1/tau1
        # recurrences (extension; see linear.VampConfig.stab_gamma)
        if cfg.stab_gamma < 1.0:
            s_ = jnp.asarray(cfg.stab_gamma, tau1_new.dtype)
            gam1_new = geo_damp(gam1_new, state.gam1, s_, it > 1)
            tau1_new = geo_damp(tau1_new, state.tau1, s_, it > 1)

        rel_change = jnp.sqrt(
            jnp.sum(jnp.square(x1_prev - x1), axis=0) /
            jnp.maximum(jnp.sum(jnp.square(x1_prev), axis=0), 1e-30))
        stopped = state.stopped | ((it > 1)
                                   & (rel_change < cfg.stop_criteria_thr))
        live_tp = live[np.asarray(cols_tpc)]

        new_state = HuberMultiState(
            it=it, x1=x1,
            x2=jnp.where(live[None, :], x2, state.x2),
            r1=jnp.where(live[None, :], r1, state.r1), r2=r2,
            z1=jnp.where(live[None, None, :], z1f.reshape(4, nb, T), state.z1),
            z2=jnp.where(live[None, None, :], z2, state.z2),
            p1=jnp.where(live[None, None, :], p1_new.reshape(4, nb, T), state.p1),
            p2=p2f.reshape(4, nb, T),
            mu_probe=jnp.where(live_tp[None, :], invq, state.mu_probe),
            gam1=jnp.where(live, gam1_new, state.gam1),
            gam2=jnp.where(live, gam2, state.gam2),
            tau1=jnp.where(live, tau1_new, state.tau1),
            tau2=jnp.where(live, tau2, state.tau2),
            alpha1=alpha1,
            deltaH=jnp.where(live, delta, state.deltaH),
            probs=jnp.where(live[:, None], probs, state.probs),
            vars=jnp.where(live[:, None], vars_, state.vars),
            key=key, stopped=stopped,
            mu_cg=jnp.where(live[None, :], sol.mu[:, :T], state.mu_cg),
            gmu=jnp.where(jnp.concatenate([live, live_tp])[None, :],
                          gmu_new, state.gmu),
            tau_gmu=jnp.where(live, tau2_solve, state.tau_gmu))
        metrics = {
            "it": it, "gam1": gam1_new, "gam2": gam2, "tau1": tau1_new,
            "tau2": tau2, "alpha1": alpha1, "alpha2": alpha2, "beta1": beta1,
            "deltaH": delta, "rel_change": rel_change,
            "cg_iters": sol.iters[:T], "stopped": stopped,
        }
        return _cast_like(new_state, state), metrics

    return jax.jit(step) if jit else step


def infer_huber(mp: MultiPhen, cfg, probs, vars_user, verbose: bool = True,
                callbacks=None, sync_every: int = 1, resume_state=None):
    """Joint multi-trait Huber run; returns (x_stored [M, T], state, hist)."""
    if resume_state is not None:
        from gvamp.linear import _check_resume_probe_cols
        _check_resume_probe_cols(resume_state, cfg, T=mp.T)
    state = (resume_state if resume_state is not None
             else init_huber_state(mp, cfg, probs, vars_user))
    aux = make_probit_aux(mp, cfg)  # same fields (op/y/n_mask/bern/Z/m_mask)
    chunk = max(1, int(sync_every))
    step = (make_huber_step(mp, cfg) if chunk == 1
            else make_scan_step(make_huber_step, mp, cfg, chunk))
    sqn = float(np.sqrt(mp.geno.N))

    def vprint(it, m):
        print(f"[multi-huber it {it}] "
              f"gam1=[{' '.join(f'{v:.3g}' for v in m['gam1'])}] "
              f"deltaH=[{' '.join(f'{v:.2g}' for v in m['deltaH'])}] "
              f"stopped={m['stopped'].sum()}/{mp.T}", flush=True)

    state, history = _run_multi_loop(
        step, state, aux, cfg, chunk, mp, vprint if verbose else None,
        callbacks, make_single=lambda: make_huber_step(mp, cfg))
    from gvamp import dist
    x_stored = dist.to_numpy(state.x1)[: mp.geno.M, :] / sqn
    return x_stored, state, history
