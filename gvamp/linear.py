"""Linear-model EM-VAMP engine (the flagship path).

One fully-on-device jitted iteration reproducing the reference's
``infere_linear`` loop (vamp.cpp:190-803):

  denoising:  inner re-estimation loop alternating x1 = g1(r1, gam1),
              Onsager alpha1 = psum(sum g1d)/Mt, eta1 = gam1/alpha1,
              gam1 <- clamp(1/(1/eta1 + ||x1-r1||^2/Mt)) and an EM prior
              update (vamp.cpp:289-338); damping of x1/alpha1
              (vamp.cpp:348-414); adaptive rho (vamp.cpp:501-502);
              gam2 = eta1 - gam1, r2 = (eta1 x1 - gam1 r1)/gam2 with the
              optional lmmse-damp on gam2 (vamp.cpp:479-498).
  lmmse:      v = gamw A^T y + gam2 r2, warm-started preconditioned CG
              (vamp.cpp:556-597); Onsager alpha2 via the deterministic
              Bernoulli trace probe (g2d_onsager, vamp.cpp:871-889);
              gam2 re-estimate (it>2, vamp.cpp:691-693); gam1 = eta2 - gam2,
              r1 update; gamw EM update reusing the probe solution
              (updateNoisePrec, vamp.cpp:892-927).

Host <-> device traffic per iteration is one metrics pytree plus (optionally)
the estimate vectors for checkpoint dumps; every scalar recurrence, the CG
while-loop and the EM while-loop stay on device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from gvamp import cg
from gvamp.prior import (GAMMA_MAX, GAMMA_MIN, Prior, g1, g1d, update_prior)


def _clamp_gamma(x):
    return jnp.clip(x, GAMMA_MIN, GAMMA_MAX)


def geo_damp(new, old, s, active):
    """Geometric (log-domain) damping of a precision update:
    old^(1-s) * new^s where `active`, else `new` untouched.

    The standard VAMP stabilizer for the gam/tau recurrences — a
    multiplicative trust region bounding each iteration's log-step to s
    times the raw one.  s=1.0 is the identity (reference dynamics)."""
    damped = jnp.exp((1.0 - s) * jnp.log(jnp.maximum(old, GAMMA_MIN))
                     + s * jnp.log(jnp.maximum(new, GAMMA_MIN)))
    return jnp.where(active, damped, new)


def _cast_like(new, ref):
    """Cast a pytree to the dtypes of a reference pytree (loop-carry hygiene:
    weak-type promotion rules differ across environments)."""
    return jax.tree_util.tree_map(
        lambda n, r: jnp.asarray(n, r.dtype) if hasattr(r, "dtype") else n,
        new, ref)


@dataclasses.dataclass(frozen=True)
class VampConfig:
    """Engine options (defaults = reference options.hpp:107-142 + vamp.hpp)."""

    max_iter: int = 10
    rho: float = 0.15
    stop_criteria_thr: float = 1e-4
    em_max_iter: int = 2
    em_err_thr: float = 1e-2
    cg_max_iter: int = 60
    learn_vars: bool = True
    use_lmmse_damp: bool = False
    use_xxt: bool = False        # dual/N-space LMMSE (reference denoiserXXT.cpp)
    cg_err_tol_xxt: float = 1e-4  # CG_solverAAT tol (denoiserXXT.cpp:121)
    auto_var_max_iter: int = 5   # reference vamp.hpp:37
    revar_tol: float = 1e-3      # reference vamp.cpp:335
    seed: int = 1
    gam1_init: float = 1e-6     # main_real.cpp:66
    gamw_init: float = 2.0      # main_real.cpp:69-73 (h2 == -1)
    cg_err_tol: float = 1e-5
    onsager_tol: float = 1e-6    # probe-column quadform exit — only active
                                 # on the probe path (use_slq=False or red
                                 # mode).  The reference uses 1e-8
                                 # (vamp.cpp:1174-1193) — far below the
                                 # probe's own O(1/sqrt(Mt)) Hutchinson MC
                                 # noise; 1e-6 reproduces alpha2 to 6
                                 # decimals (round-4 study, test_round4).
                                 # With SLQ (default) there are no probe
                                 # columns to exit.
    n_probes: int = 1            # Onsager trace probes (reference uses 1;
                                 # extra probes ride the same block-CG pass)
    gamma_damp: float = 1.0      # gam2 damping inside the LMMSE block
                                 # (reference --gamma-damp, options.cpp:355;
                                 # application lines vamp.cpp:553-554,642-643)
    use_cross_val: bool = False  # held-out-R2 damping tuner (vamp.cpp:156-166,
                                 # 356-409; dormant in the reference:
                                 # use_cross_val=0 hardcoded at vamp.hpp:61)
    cv_max_retry: int = 25       # inner re-damping retries (vamp.cpp:365)
    deflate_k: int = 0           # spectral deflation of the CG operator:
                                 # precompute top-k eigenpairs of the FIXED
                                 # Gram A^T A once (k columns ride each wide
                                 # pass) and solve exactly on that subspace;
                                 # cuts CG iterations on LD-structured data
    deflate_iters: int = 8       # block power-iteration steps
    gram_refresh: int = 8        # the CG init residual is computed from the
                                 # warm start's TRACKED Gram product (exact
                                 # identity mult(mu)=V-r at the previous
                                 # exit, zero extra passes); every this-many
                                 # iterations the true init mult runs to
                                 # reset CG-recursion fp drift.  1 = always
                                 # compute the true init mult (the reference
                                 # behavior); only the standard primal path
                                 # tracks (red re-draws its operator, dual
                                 # mode has its own state)
    red: bool = False            # reduced-subset stochastic solves: each
                                 # iteration draws a random 10% sample window
                                 # and runs the LMMSE CG + Onsager probe +
                                 # gamw trace over it (reference --red,
                                 # vamp.cpp:561-596, 884, 907-916) — ~10x
                                 # cheaper packed passes inside the CG
    stab_gamma: float = 1.0      # geometric trust region on the gam1/tau1
                                 # recurrences (probit + Huber engines):
                                 # gam <- gam_old^(1-s) * gam_new^s.  1.0
                                 # (default) = reference dynamics.  s < 1
                                 # bounds the per-iteration log-step of the
                                 # precisions, rescuing the small-N /
                                 # heavy-tail runs where the reference's
                                 # unguarded alpha2->0 collapse at it 2
                                 # explodes gam1 by ~1e6 and the loop never
                                 # recovers (extension; no reference analog
                                 # — vamp_Huber.cpp:355 / vamp_probit.cpp:571
                                 # leave these unguarded)
    cg_plateau: int = 12         # CG stagnation exit: freeze a column after
                                 # this many consecutive CG iterations
                                 # without >=1% relative-residual
                                 # improvement (cg.solve_block plateau;
                                 # 0 = reference behavior, burn the full
                                 # budget).  Only fires on ill-conditioned
                                 # solves (z-model tau2 explosions) where
                                 # the max_iter iterate is no better than
                                 # the plateaued one — converging solves
                                 # never trigger it.
    use_slq: bool = True         # Onsager alpha2 + the noise-EM trace from
                                 # stochastic Lanczos quadrature (slq.py)
                                 # instead of per-iteration probe CG columns:
                                 # the Gram operator A^T A is FIXED for the
                                 # whole run and the probe RHS is fixed
                                 # (g2d_onsager, vamp.cpp:871-889), so ONE
                                 # k-step Lanczos pass at setup (slq_k wide
                                 # passes, amortized over the run) makes
                                 # u^T (tau G + gam2 I)^{-1} u and
                                 # u^T G (tau G + gam2 I)^{-1} u O(k) vector
                                 # math for ANY (tau, gam2) trajectory.  The
                                 # block CG then carries ONLY the LMMSE
                                 # column — probes set the block-CG pass
                                 # count at production shapes, so
                                 # steady-state passes drop.
                                 # The k-node Gauss rule equals what CG-k
                                 # from the same start vector would produce:
                                 # strictly tighter than the probe CG's
                                 # early exit.  Same deterministic u
                                 # (make_bern_probe) — the Hutchinson MC
                                 # error is unchanged.  red mode keeps
                                 # probes (its operator re-draws per
                                 # iteration).  Equality vs the probe path
                                 # is pinned in tests/test_slq_engines.py.
    slq_k: int = 32              # Lanczos steps (quadrature nodes)
    cg_extrapolate: bool = True  # secant-extrapolated CG warm start
                                 # (cg.extrapolate_pair): start the LMMSE
                                 # solve from mu1 + theta (mu1 - mu2) over
                                 # the last TWO exits, theta the per-column
                                 # closed-form least-squares minimizer of
                                 # the init residual — Gram linearity makes
                                 # both the start's Gram product and the
                                 # residual free (zero packed passes).
                                 # Cancels the first-order VAMP parameter
                                 # drift between solves, targeting a
                                 # steady-state block CG of ONE iteration
                                 # (2 packed reads/it) instead of two on
                                 # the bandwidth-bound configs.  The solve
                                 # still exits at the same cg_err_tol, so
                                 # accuracy class is unchanged.  Primal
                                 # two-pass tracked path only (not red /
                                 # dual).  No reference analog (the
                                 # reference cold-starts every CG,
                                 # vamp.cpp:594-596).  Default ON: config
                                 # B's steady-state CG dropped from 2
                                 # iterations to 1, and the production
                                 # recipe's 30-it end state stayed
                                 # IDENTICAL to 4 digits (corr/R2/gamw/
                                 # live components)
    fold_noise: bool = True      # fold the noise-EM pass into the CG exit:
                                 # resid2 = <mu, A^T A mu> - 2<mu, A^T y> +
                                 # |y|^2 and the Hutchinson trace correction
                                 # <u_j, A^T A q_j> both come from the exit
                                 # Gram identity mult(mu) = V - r (exact for
                                 # any mu), and z1 = A x1 rides the first CG
                                 # iteration's forward pass as an extra RHS
                                 # column — the separate wide pass over
                                 # [x2, invq, x1] (reference updateNoisePrec,
                                 # vamp.cpp:892-927) disappears: 5 -> 4
                                 # packed-matrix reads per iteration at
                                 # steady-state cg_it = 2.  Applies to the
                                 # standard primal two-pass path only (dual
                                 # mode already gets both for free; red's
                                 # windowed operator has its own fold).


def probe_cols(cfg: VampConfig) -> int:
    """Onsager probe COLUMNS riding the block CG: zero when SLQ supplies the
    trace quadratures (cfg.use_slq); red mode keeps the probe columns — its
    windowed operator re-draws every iteration, invalidating a fixed-Gram
    Lanczos basis."""
    return 0 if (cfg.use_slq and not cfg.red) else cfg.n_probes


def _check_resume_probe_cols(state, cfg, T: int = 1):
    """Fail fast with a clear message when a resume_state's probe-column
    width disagrees with the config it is being resumed under (a pre-SLQ
    checkpoint resumed with use_slq=True, or vice versa) — the shape
    mismatch would otherwise surface as an opaque CG carry error."""
    want = T * probe_cols(cfg)
    got = int(state.mu_probe.shape[-1])
    if got != want:
        raise ValueError(
            f"resume_state carries {got} probe column(s) but the resumed "
            f"config implies {want} (use_slq={cfg.use_slq}, red={cfg.red}, "
            f"n_probes={cfg.n_probes}); resume with the checkpoint's "
            f"original use_slq setting (cli --resume restores it "
            f"automatically)")


class LinState(NamedTuple):
    it: jax.Array
    x1: jax.Array
    x2: jax.Array
    r1: jax.Array
    r2: jax.Array
    z1: jax.Array            # [4, Nb] planar
    mu_cg: jax.Array         # warm start for the LMMSE CG (marker space)
    mu_cg_n: jax.Array       # warm start for the XXT CG (sample space)
    mu_probe: jax.Array      # warm starts for the Onsager probe CG [Mpad, P]
    mu_probe_n: jax.Array    # XXT-mode N-space probe warm starts [4, Nb, P]
    gam1: jax.Array
    gam2: jax.Array
    gamw: jax.Array
    eta1: jax.Array
    eta2: jax.Array
    alpha1: jax.Array
    alpha2: jax.Array
    rho: jax.Array
    probs: jax.Array
    vars: jax.Array
    cv_r2: jax.Array         # cross-val: last accepted held-out R2
    gmu: jax.Array           # A^T A [mu_cg | mu_probe] — the warm start's
                             # Gram product, carried across iterations so
                             # the CG init residual costs no packed pass
                             # (exact identity mult(mu) = V - r at exit;
                             # refreshed every cfg.gram_refresh iterations)
    gmu_n: jax.Array         # dual-mode analog: A A^T [mu_cg_n | mu_probe_n]
    mu_prevb: jax.Array      # the PREVIOUS iteration's exit block (one
                             # iteration older than mu_cg|mu_probe) and its
    gmu_prev: jax.Array      # tracked Gram product: the secant pair for
                             # cfg.cg_extrapolate (cg.extrapolate_pair) —
                             # zeros until two exits exist (theta guard)


def init_state(geno, cfg: VampConfig, probs, vars_user,
               r1_init: Optional[np.ndarray] = None,
               x1_init: Optional[np.ndarray] = None,
               gam1: Optional[float] = None,
               gamw: Optional[float] = None) -> LinState:
    """Build the initial state.

    `vars_user` are user-scale variances; multiplied by N here (the
    reference's vars *= N at infere entry, vamp.cpp:153-155).  `r1_init`
    (restart) and `x1_init` (init-est) are *stored-scale* estimates: they get
    multiplied by sqrt(N) (vamp.cpp:226-233, 244-258).
    """
    dt = geno.dtype
    Mp = geno.Mpad
    zeros_m = jnp.zeros((Mp,), dt)
    sqn = float(np.sqrt(geno.N))
    r1 = zeros_m if r1_init is None else geno.pad_m(np.asarray(r1_init) * sqn)
    x1 = zeros_m if x1_init is None else geno.pad_m(np.asarray(x1_init) * sqn)
    if x1_init is not None:
        r1 = x1
    return LinState(
        it=jnp.asarray(0),
        x1=x1, x2=zeros_m, r1=r1, r2=zeros_m,
        z1=jnp.zeros_like(geno.y_planar),
        mu_cg=zeros_m,
        mu_cg_n=jnp.zeros_like(geno.y_planar),
        mu_probe=jnp.zeros((Mp, probe_cols(cfg)), dt),
        mu_probe_n=jnp.zeros(geno.y_planar.shape + (probe_cols(cfg),), dt),
        gam1=jnp.asarray(cfg.gam1_init if gam1 is None else gam1, dt),
        gam2=jnp.asarray(0.0, dt),
        gamw=jnp.asarray(cfg.gamw_init if gamw is None else gamw, dt),
        eta1=jnp.asarray(0.0, dt), eta2=jnp.asarray(0.0, dt),
        alpha1=jnp.asarray(0.0, dt), alpha2=jnp.asarray(0.0, dt),
        rho=jnp.asarray(cfg.rho, dt),
        probs=jnp.asarray(probs, dt),
        vars=jnp.asarray(np.asarray(vars_user) * geno.N, dt),
        cv_r2=jnp.asarray(-1.0, dt),
        gmu=jnp.zeros((Mp, 1 + probe_cols(cfg)), dt),
        gmu_n=jnp.zeros(geno.y_planar.shape + (1 + probe_cols(cfg),), dt),
        mu_prevb=jnp.zeros((Mp, 1 + probe_cols(cfg)), dt),
        gmu_prev=jnp.zeros((Mp, 1 + probe_cols(cfg)), dt),
    )


def make_bern_probe(geno, seed: int, n_probes: int = 1) -> jax.Array:
    """Deterministic Rademacher probes u_j ~ +-1/sqrt(Mt) as [Mpad, P]
    (vamp.cpp:871-883).

    The reference seeds mt19937 with (seed + S) per rank and regenerates the
    SAME probe every iteration; we draw once from fold_in(seed, S) — same
    determinism contract, different (statistically equivalent) bit-stream.
    Extra probes (P > 1) sharpen the Hutchinson trace estimate at almost no
    cost: they ride the same wide-RHS block-CG passes.
    """
    key = jax.random.fold_in(jax.random.key(seed), geno.S)
    u = jax.random.rademacher(key, (geno.Mpad, n_probes), dtype=jnp.int8)
    return u.astype(geno.dtype) * geno.m_mask[:, None] / np.sqrt(geno.Mt)


class Aux(NamedTuple):
    """Per-run arrays threaded through the jitted step as arguments (NOT
    captured as jaxpr constants — XLA would constant-fold the packed-matrix
    decode otherwise)."""

    op: object            # BedOp / DenseOp pytree
    y: jax.Array          # filtered planar phenotype [4, Nb]
    bern: jax.Array       # Onsager probes [Mpad, P]
    aty: jax.Array        # A^T y, iteration-invariant (one pass, amortized)
    z_bern: jax.Array     # A @ probes [4, Nb, P], iteration-invariant
    frz: jax.Array        # freeze mask [Mpad]
    m_mask: jax.Array     # real-marker mask [Mpad]
    ts: jax.Array         # true signal (zeros when absent) [Mpad]
    xxt_diag_base: jax.Array  # sum_m A_planar^2 per slot (XXT preconditioner)
    hold: object          # HoldAux (cross-val) or None
    defl: object          # (V [Mpad, k], lam [k]) deflation basis or None
    slq: object = None    # slq.SlqBasis of the fixed Gram (A^T A primal /
                          # A A^T dual) in the probes' Krylov spaces, or None
                          # when cfg.use_slq is off / red mode


class HoldAux(NamedTuple):
    """Held-out sample window for the cross-validation damping tuner."""

    op: object            # BedOp of the holdout window
    y: jax.Array          # filtered planar holdout phenotype
    rescale: jax.Array    # sqrt(N_hold / N_train): train-scale prediction
    denom: jax.Array      # var(y_hold) * N_hold (reference vamp.cpp:382-383)


def make_aux(geno, cfg: VampConfig, freeze=None, true_signal=None,
             geno_hold=None) -> Aux:
    m_mask = geno.m_mask
    hold = None
    if geno_hold is not None:
        y_h = geno_hold.filter_pheno()
        yv = np.asarray(y_h).reshape(-1)
        # calc_stdev over the raw window INCLUDING zero-filled NA/pad slots,
        # matching the reference's y_cross stdev (vamp.cpp:377-383)
        n_h = geno_hold.N
        dense = geno_hold.deplanarize(np.asarray(y_h))[:n_h]
        var_h = float(np.var(dense, ddof=1))
        hold = HoldAux(
            op=geno_hold.op, y=y_h,
            rescale=jnp.asarray(np.sqrt(geno_hold.N / geno.N), geno.dtype),
            denom=jnp.asarray(var_h * n_h, geno.dtype))
    if cfg.use_xxt:
        # Jacobi diagonal of A A^T from people statistics: the reference's
        # tau*((n_i-1)/sig_i^2 + mu_i^2 n_i)/N + gam2 (denoiserXXT.cpp:60)
        # algebraically equals tau * sum_m value_im^2 / N + gam2.
        mave_p, msig_p, numb_p = geno.compute_people_statistics()
        sumsq = jnp.where(msig_p > 0, (numb_p - 1) / jnp.square(
            jnp.where(msig_p == 0, 1.0, msig_p)), 0.0)             + jnp.square(mave_p) * numb_p
        xxt_diag_base = sumsq.astype(geno.dtype) / geno.N
    else:
        xxt_diag_base = jnp.zeros_like(geno.y_planar)
    bern = make_bern_probe(geno, cfg.seed, cfg.n_probes)
    defl = None
    # red mode re-draws its sample window per iteration: the full-data
    # deflation basis would not match the windowed operator (phase_lmmse
    # skips it there), so skip the top_eigs setup cost entirely
    if cfg.deflate_k > 0 and not cfg.red:
        from gvamp.probit import _gram_mult
        defl = cg.top_eigs(_gram_mult(geno), geno.Mpad, cfg.deflate_k,
                           jax.random.fold_in(jax.random.key(cfg.seed), 7),
                           n_iter=cfg.deflate_iters, dtype=geno.dtype,
                           op=geno.op)
    z_bern = geno.axm(bern)
    slq_basis = None
    if cfg.use_slq and not cfg.red:
        # one-time Lanczos pass over the FIXED Gram in the probes' Krylov
        # spaces (cfg.slq_k wide passes, amortized over the run); the
        # [k, n, P] working basis is freed on return — only the O(k)
        # (nodes, weights) quadratures persist.  See VampConfig.use_slq.
        # The operator pytree is a jit ARGUMENT, never a closure constant
        # (a closed-over packed matrix would be embedded in the compiled
        # program — 10.74 GB at config B).
        from gvamp import slq as _slq
        axm_fn, atxm_fn = geno.fns_multi()
        if cfg.use_xxt:
            # dual/N-space basis over G_N = A A^T started at z_u = A u: the
            # Woodbury form alpha2 = 1 - gamw <z_u, Q_N^{-1} z_u> (see
            # phase_lmmse) is a quadrature of f(lam) = 1/(gamw lam + gam2)
            nb4 = int(np.prod(geno.y_planar.shape))

            def build_n(op_, U):
                def mult_n(X):
                    Xp = X.reshape((4, nb4 // 4, X.shape[1]))
                    return axm_fn(op_, atxm_fn(op_, Xp)).reshape(X.shape)

                return _slq.build(mult_n, U, cfg.slq_k)

            slq_basis = jax.jit(build_n)(
                geno.op, z_bern.reshape(nb4, cfg.n_probes))
        else:
            from gvamp.probit import make_slq_basis
            slq_basis = make_slq_basis(geno, cfg, bern)
    return Aux(
        op=geno.op,
        y=geno.filter_pheno(),
        bern=bern,
        aty=geno.atx(geno.filter_pheno()),
        z_bern=z_bern,
        # freeze: 1 = pinned coordinate, excluded from the Onsager sum and
        # damping (vamp.cpp:207-209,308,353)
        frz=geno.pad_m(freeze) if freeze is not None else jnp.zeros_like(m_mask),
        m_mask=m_mask,
        ts=geno.pad_m(true_signal) if true_signal is not None
           else jnp.zeros_like(m_mask),
        xxt_diag_base=xxt_diag_base,
        hold=hold,
        defl=defl,
        slq=slq_basis,
    )


def make_step(geno, cfg: VampConfig, init_est: bool = False,
              with_truth: bool = False, geno_hold=None, jit: bool = True,
              phased: bool = False):
    """Build the jitted per-iteration step: (state, aux) -> (state, metrics).

    With ``phased=True`` returns the ordered tuple of (name, phase_fn)
    sub-steps instead — the per-phase observability surface (reference
    MPI_Wtime spans, vamp.cpp:752-755); composing them in order is exactly
    the fused step."""
    dt = geno.dtype
    Mt = float(geno.Mt)
    N = float(geno.N)
    ax_fn, atx_fn = geno.fns()
    axm_fn, atxm_fn = geno.fns_multi()
    # noise-EM pass folding (see VampConfig.fold_noise); env kill switch for
    # A/B benchmarking of the folded vs the explicit-pass form
    fold_noise = (cfg.fold_noise and not cfg.use_xxt and not cfg.red
                  and os.environ.get("GVAMP_NOISE_PASS", "0") != "1")
    # SLQ trace quadratures (VampConfig.use_slq): the block CG carries only
    # the LMMSE column; alpha2 and the noise-EM trace correction come from
    # aux.slq.  red mode keeps the probe columns (windowed operator).
    slq_on = cfg.use_slq and not cfg.red
    P_cg = probe_cols(cfg)
    if slq_on:
        from gvamp import slq as _slq
    hold_ax = geno_hold.fns()[0] if geno_hold is not None else None
    if cfg.red:
        # reduced-subset window length: 10% of sample-word rows, tile-aligned
        # (reference LBglob = mbytes / 10, vamp.cpp:563)
        nw_total = geno.layout.n_words
        red_lbw = min(nw_total, max(32, (nw_total // 10) // 32 * 32))
        axm_w, atxm_w = geno.window_fns_multi(red_lbw)

    def denoise(state: LinState, aux: Aux):
        m_mask, frz = aux.m_mask, aux.frz
        live = m_mask * (1.0 - frz)
        it = state.it  # current iteration (1-based inside step)

        def revar_body(carry):
            i, x1, gam1, alpha1, eta1, probs, vars_, prev_gam1 = carry
            pr = Prior(probs=probs, vars=vars_)
            x1 = g1(state.r1, gam1, pr) * m_mask
            d = g1d(state.r1, gam1, pr)
            alpha1 = jnp.sum(d * live) / Mt            # psum via sharded sum
            eta1 = gam1 / alpha1
            l2diff = jnp.sum(jnp.square((x1 - state.r1) * m_mask))

            def reest(_):
                g_new = _clamp_gamma(1.0 / (1.0 / eta1 + l2diff / Mt))
                p2 = update_prior(state.r1, g_new, pr, m_mask, Mt,
                                  em_max_iter=cfg.em_max_iter,
                                  em_err_thr=cfg.em_err_thr,
                                  learn_vars=cfg.learn_vars)
                return g_new, p2.probs, p2.vars

            def keep(_):
                return gam1, probs, vars_

            gam1_new, probs, vars_ = jax.lax.cond(it > 1, reest, keep, None)
            out = (i + 1, x1, gam1_new, alpha1, eta1, probs, vars_, gam1)
            return _cast_like(out, carry)

        def revar_cond(carry):
            i, x1, gam1, alpha1, eta1, probs, vars_, prev_gam1 = carry
            not_converged = jnp.abs(gam1 - prev_gam1) >= cfg.revar_tol
            return (i < cfg.auto_var_max_iter) & ((i == 0) | (it > 1)) & \
                   ((i == 0) | not_converged)

        big = jnp.asarray(jnp.inf, dt)
        carry = (jnp.asarray(0), state.x1, state.gam1, state.alpha1,
                 state.eta1, state.probs, state.vars, big)
        _, x1, gam1, alpha1, eta1, probs, vars_ = jax.lax.while_loop(
            revar_cond, revar_body, carry)[:7]

        # damping (it > 1): frozen coords keep the raw g1 output
        damp = (it > 1)
        rho = state.rho
        x1_d = jnp.where(damp & (frz == 0), rho * x1 + (1 - rho) * state.x1, x1)
        alpha1_d = jnp.where(damp, rho * alpha1 + (1 - rho) * state.alpha1, alpha1)
        return x1, x1_d, gam1, alpha1, alpha1_d, eta1, probs, vars_

    # The iteration body is split into phase functions composed by the fused
    # step below; ``make_phased_step`` jits each phase separately so the CLI
    # can report per-phase wall-clock like the reference's MPI_Wtime spans
    # (vamp.cpp:432-433, 620, 637, 752-755).  The carry ``w`` is a plain dict
    # pytree threaded through the phases.

    def phase_denoise(state: LinState, aux: Aux):
        m_mask = aux.m_mask
        it = state.it + 1
        state = state._replace(it=it)
        x1_prev = state.x1

        x1_raw, x1, gam1, alpha1_raw, alpha1, eta1, probs, vars_ = \
            denoise(state, aux)
        if init_est:
            # first iteration keeps the injected estimate (vamp.cpp:295-296)
            x1 = jnp.where(it == 1, state.r1, x1)

        cv_r2 = state.cv_r2
        rho_cross = state.rho
        if cfg.use_cross_val:
            # within-iteration re-damping on held-out R2 (vamp.cpp:356-409):
            # while the held-out R2 drops below the last accepted value,
            # shrink rho_cross by 0.9 and re-damp x1 against the previous
            # iterate; alpha1 is then damped with the accepted rho_cross.
            hold = aux.hold

            def hold_r2(xc):
                z = hold_ax(hold.op, xc) * hold.rescale
                return 1.0 - jnp.sum(jnp.square(hold.y - z)) / hold.denom

            def cv_cond(c):
                i, rho_c, xc, prev, done = c
                return (i < cfg.cv_max_retry) & (~done)

            def cv_body(c):
                i, rho_c, xc, prev, done = c
                r2v = hold_r2(xc)
                accept = (r2v >= prev) | (it == 1)
                prev_new = jnp.where(accept, r2v, prev)
                rho_c2 = jnp.where(accept, rho_c, rho_c * 0.9)
                xc2 = jnp.where(accept, xc,
                                rho_c2 * x1_raw + (1 - rho_c2) * x1_prev)
                out = (i + 1, rho_c2, xc2, prev_new, accept)
                return _cast_like(out, c)

            c0 = (jnp.asarray(0), state.rho, x1, cv_r2, jnp.asarray(False))
            _, rho_cross, x1, cv_r2, _ = jax.lax.while_loop(
                cv_cond, cv_body, c0)
            alpha1 = jnp.where(it > 1,
                               rho_cross * alpha1_raw
                               + (1 - rho_cross) * state.alpha1, alpha1_raw)

        return {"it": it, "x1_prev": x1_prev, "x1": x1, "gam1": gam1,
                "alpha1": alpha1, "eta1": eta1, "probs": probs,
                "vars": vars_, "cv_r2": cv_r2, "rho_cross": rho_cross}

    def phase_project(w, state: LinState, aux: Aux):
        op, y, m_mask = aux.op, aux.y, aux.m_mask
        it, x1 = w["it"], w["x1"]
        gam1, alpha1, eta1 = w["gam1"], w["alpha1"], w["eta1"]
        probs, vars_ = w["probs"], w["vars"]

        # z1 = A x1 rides a later wide pass (phase_lmmse in dual mode,
        # phase_noise_em otherwise) — its only consumers are the R2_1
        # metric and the state dump, so deferring it saves one full HBM
        # pass per iteration.

        gam_before = state.gam2
        gam2 = _clamp_gamma(eta1 - gam1)
        r2 = ((eta1 * x1 - gam1 * state.r1) / gam2) * m_mask

        if cfg.use_lmmse_damp:
            xi = jnp.minimum(2.0 * state.rho, 1.0)
            gam2 = jnp.where(
                (it > 1) & (gam_before > 0),
                1.0 / jnp.square(xi / jnp.sqrt(gam2) + (1 - xi) / jnp.sqrt(gam_before)),
                gam2,
            )

        # adaptive rho (vamp.cpp:501-502); alpha2 from the previous iteration
        xi = jnp.minimum(2.0 * jnp.minimum(alpha1, state.alpha2), 1.0)
        rho = jnp.maximum(state.rho, xi)

        # prior update when the re-estimation loop is disabled or first iter
        def upd(_):
            p2 = update_prior(state.r1, gam1, Prior(probs, vars_), m_mask, Mt,
                              em_max_iter=cfg.em_max_iter,
                              em_err_thr=cfg.em_err_thr,
                              learn_vars=cfg.learn_vars)
            return p2.probs, p2.vars

        probs, vars_ = jax.lax.cond(
            (cfg.auto_var_max_iter == 0) | (it <= 1), upd,
            lambda _: (probs, vars_), None)

        l2y = jnp.sum(jnp.square(y))

        w = dict(w)
        w.update(gam2=gam2, r2=r2, rho=rho, probs=probs, vars=vars_,
                 l2y=l2y)
        return w

    def phase_lmmse(w, state: LinState, aux: Aux):
        op, y, bern, m_mask = aux.op, aux.y, aux.bern, aux.m_mask
        it, gam2, r2 = w["it"], w["gam2"], w["r2"]

        # ---------------- LMMSE ----------------
        # gamma_damp scales gam2 for the whole LMMSE block (v, diag, CG,
        # probe, alpha2) and is restored before the re-estimate
        # (vamp.cpp:553-554, 642-643)
        gamw = state.gamw
        gam2_eff = gam2 * cfg.gamma_damp
        diag = cg.jacobi_diag(gamw, gam2_eff, N)
        P = cfg.n_probes
        mu_probe_n_new = state.mu_probe_n
        if cfg.use_xxt:
            # dual / N-space solve (lmmse_denoiserAAT, denoiserXXT.cpp:31-50):
            # x2 = gamw A^T (gamw A A^T + gam2 I)^{-1} (y - A r2) + r2.
            # The Onsager probes ride the SAME N-space block CG via Woodbury
            # (no marker-space solve in dual mode — round-2 verdict C26):
            #   alpha2_j = gam2 <u_j, Q_M^{-1} u_j>
            #           = <u_j,u_j> - gamw <A u_j, Q_N^{-1} A u_j>
            #           = 1 - gamw <z_u_j, s_j>
            # with Q_N = gamw A A^T + gam2 I and z_u = A u precomputed in
            # aux.z_bern.  (The reference's g2d_onsagerAAT /
            # updateNoisePrecAAT, denoiserXXT.cpp:133-165, carry
            # inconsistent signs around the same identities; we implement
            # the exact Woodbury algebra, which matches the primal path to
            # the probe's MC accuracy.)
            nb4 = y.shape[0] * y.shape[1]
            # one wide pass: A r2 (the dual RHS) and A x1 (deferred z1)
            Vr = axm_fn(op, jnp.concatenate(
                [r2[:, None], w["x1"][:, None]], axis=1))
            v_n = y - Vr[..., 0]
            z1 = Vr[..., 1]
            z_bern_f = aux.z_bern.reshape(nb4, P)
            V_n = jnp.concatenate(
                [v_n.reshape(nb4, 1), z_bern_f[:, :P_cg]], axis=1)
            mu0_n = jnp.concatenate(
                [state.mu_cg_n.reshape(nb4, 1),
                 state.mu_probe_n.reshape(nb4, P_cg)], axis=1)

            # gamma_damp: the damped gam2_eff builds Q_N (the whole dual
            # LMMSE block), exactly like the primal branch below
            def mult_aat_b(U):
                Up = U.reshape((4, nb4 // 4, U.shape[1]))
                out = gamw * axm_fn(op, atxm_fn(op, Up)) + gam2_eff * Up
                return out.reshape(nb4, U.shape[1])

            diag_n = (gamw * aux.xxt_diag_base
                      + gam2_eff).reshape(nb4)[:, None]
            r0_n = None
            if cfg.gram_refresh > 1:
                # dual analog of the primal gmu tracking: state.gmu_n
                # carries A A^T mu0_n (exact at the previous exit) — same
                # shared guarded helper as the primal path
                mu0_n, r0_n = cg.tracked_warm_start(
                    V_n, mu0_n, state.gmu_n.reshape(nb4, 1 + P_cg), gamw, gamw,
                    gam2_eff, it, cfg.gram_refresh, mult_aat_b)
            sol = cg.solve_block(mult_aat_b, V_n, mu0_n, diag_n, gam2_eff,
                                 cfg.cg_max_iter, modes=(0,) + (1,) * P_cg,
                                 err_tol=cfg.cg_err_tol_xxt,
                                 onsager_tol=cfg.onsager_tol,
                                 plateau=cfg.cg_plateau, r0=r0_n)
            if cfg.gram_refresh > 1:
                w = dict(w)
                w.update(gmu_n=cg.gram_from_exit(V_n, sol, gamw, gam2_eff)
                         .reshape(y.shape + (1 + P_cg,)))
            sol0 = sol.mu[:, 0]
            x2 = (gamw * atx_fn(op, sol0.reshape(y.shape)) + r2) * m_mask
            if slq_on:
                # Woodbury + SLQ: alpha2 = 1 - gamw <z_u, Q_N^{-1} z_u>
                # with the quadrature on the dual basis (aux.slq over A A^T
                # started at z_u) — no probe columns in the dual CG
                alpha2 = jnp.mean(
                    1.0 - gamw * _slq.quad_inv(aux.slq, gamw, gam2_eff))
            else:
                alpha2 = jnp.mean(1.0 - gamw * jnp.sum(
                    z_bern_f * sol.mu[:, 1:], axis=0))
            # A x2 = y - gam2 s0 - r_cg0 EXACTLY for the returned s0 (the
            # identity folds the whole noise-EM matvec pass away, and the
            # trace correction is free: Mt (1 - alpha2) / gamw)
            ax2_exact = y - (gam2_eff * sol0
                             + sol.r[:, 0]).reshape(y.shape)
            invq = state.mu_probe      # unused in dual mode (kept in state)
            mu_cg_new, mu_cg_n_new = state.mu_cg, sol0.reshape(y.shape)
            mu_probe_n_new = sol.mu[:, 1:].reshape(y.shape + (P_cg,))
            cg_iters, cg_rel_err = sol.iters[0], sol.rel_err[0]
            probe_iters = (jnp.asarray(0, jnp.int32) if slq_on
                           else jnp.max(sol.iters[1:]))
            w = dict(w)
            w.update(ax2_exact=ax2_exact, z1=z1)
        else:
            # joint block solve: column 0 = LMMSE RHS (residual exit,
            # vamp.cpp:594-596), columns 1.. = Onsager probes (quadform
            # early-exit, vamp.cpp:871-889).  One wide pass per CG iteration.
            if cfg.red:
                # reduced-subset stochastic solves: draw this iteration's
                # sample window (rank-0-broadcast uniform SB in the
                # reference, vamp.cpp:561-578; deterministic fold_in here)
                nw = op.words.shape[0]
                lbw = red_lbw
                key = jax.random.fold_in(
                    jax.random.fold_in(jax.random.key(cfg.seed + 3), geno.S),
                    it)
                sbw = jax.random.randint(key, (), 0, (nw - lbw) // 32 + 1) * 32
                y_w = jax.lax.dynamic_slice(
                    y, (0, 4 * sbw), (4, 4 * lbw))
                v = gamw * atxm_w(op, y_w[:, :, None], sbw)[:, 0] \
                    + gam2_eff * r2
                multb = cg.make_lmmse_mult_block(
                    lambda o, X: axm_w(o, X, sbw),
                    lambda o, V_: atxm_w(o, V_, sbw), op, gamw, gam2_eff)
                diag = cg.jacobi_diag(gamw, gam2_eff, 16.0 * lbw)
                w = dict(w)
                w.update(red_sbw=sbw)
            else:
                v = gamw * aux.aty + gam2_eff * r2
                multb = cg.make_lmmse_mult_block(axm_fn, atxm_fn, op, gamw,
                                                 gam2_eff)
            # fold_noise: z1 = A x1 rides the first CG iteration's forward
            # pass; resid2/trace_corr come from the exit Gram identity in
            # phase_noise (two-pass routing only — the fused Gram kernel
            # never materializes the N-space intermediate)
            rider = w["x1"][:, None] if fold_noise else None
            rider_mult = (cg.make_lmmse_mult_block_rider(
                axm_fn, atxm_fn, op, gamw, gam2_eff) if fold_noise else None)
            V = jnp.concatenate([v[:, None], bern[:, :P_cg]], axis=1)
            mu0 = jnp.concatenate([state.mu_cg[:, None], state.mu_probe], axis=1)
            precond = None
            if cfg.deflate_k > 0 and not cfg.red:
                # red re-draws a 10% sample window per iteration, whose
                # Gram spectrum no longer matches the full-data eigenpairs
                # the deflation basis was built from — plain Jacobi is the
                # honest preconditioner for the windowed operator
                precond = cg.make_deflated_precond(
                    aux.defl[0], aux.defl[1], gamw, gam2_eff, diag)
            r0 = None
            if not cfg.red and cfg.gram_refresh > 1:
                # init residual from the TRACKED warm-start Gram product
                # (state.gmu = A^T A mu0, exact at the previous CG exit up
                # to recursion fp) via the shared guarded helper: true mult
                # on refresh ticks / cold gmu / non-finite carried state.
                # The Gram product is tau-free, and gamw moves slowly
                # between linear iterations, so tau_ref = tau_now (the
                # z-model tau-swing guard has nothing to catch here).
                gmu_c = state.gmu
                if cfg.cg_extrapolate:
                    # secant extrapolation over the last two exits: LS
                    # theta per column from Gram linearity, zero passes
                    mu0, gmu_c = cg.extrapolate_pair(
                        V, mu0, state.gmu, state.mu_prevb, state.gmu_prev,
                        gamw, gam2_eff)
                mu0, r0 = cg.tracked_warm_start(
                    V, mu0, gmu_c, gamw, gamw, gam2_eff, it,
                    cfg.gram_refresh, multb)
            sol = cg.solve_block(multb, V, mu0, diag, gam2_eff, cfg.cg_max_iter,
                                 modes=(0,) + (1,) * P_cg,
                                 err_tol=cfg.cg_err_tol,
                                 onsager_tol=cfg.onsager_tol,
                                 plateau=cfg.cg_plateau,
                                 precond=precond, r0=r0,
                                 rider=rider, rider_mult=rider_mult)
            if slq_on:
                # noise-EM trace correction Mt <u, G Q^{-1} u> as a
                # quadrature of f(lam) = lam/(gamw lam + gam2) on the fixed
                # Gram's Lanczos basis — zero probe columns, zero passes
                # (updateNoisePrec, vamp.cpp:907-916)
                w = dict(w)
                w.update(trace_corr_id=Mt * jnp.mean(
                    _slq.quad_ratio(aux.slq, gamw, gam2_eff)))
            if fold_noise:
                # exit Gram identity: gamw * A^T A mu = V - r - gam2 * mu,
                # EXACT for any mu (CG recursion invariant) — converged or
                # not, these equal what the explicit wide pass would compute
                # for the same mu/invq.  M-length dot products only.
                mu0 = sol.mu[:, 0]
                quad = (jnp.sum(mu0 * V[:, 0]) - jnp.sum(mu0 * sol.r[:, 0])
                        - gam2_eff * jnp.sum(jnp.square(mu0))) / gamw
                resid2_id = jnp.maximum(
                    quad - 2.0 * jnp.sum(mu0 * aux.aty) + w["l2y"], 0.0)
                w = dict(w)
                w.update(z1_rider=sol.rider_out[..., 0], resid2_id=resid2_id)
                if not slq_on:
                    tr = (jnp.sum(bern * bern, axis=0)
                          - jnp.sum(bern * sol.r[:, 1:], axis=0)
                          - gam2_eff * jnp.sum(bern * sol.mu[:, 1:], axis=0)
                          ) / gamw
                    w.update(trace_corr_id=Mt * jnp.mean(tr))
            x2 = sol.mu[:, 0] * m_mask
            invq = sol.mu[:, 1:]
            mu_cg_new, mu_cg_n_new = sol.mu[:, 0], state.mu_cg_n
            cg_iters, cg_rel_err = sol.iters[0], sol.rel_err[0]
            probe_iters = (jnp.asarray(0, jnp.int32) if slq_on
                           else jnp.max(sol.iters[1:]))
            if not cfg.red:
                # carry A^T A mu for the NEXT iteration's init residual:
                # mult(mu) = V - r at exit (CG invariant) — guarded divide
                # via the shared helper, no extra pass
                w = dict(w)
                w.update(gmu=cg.gram_from_exit(V, sol, gamw, gam2_eff))
                if cfg.cg_extrapolate:
                    # roll the secant pair: this iteration's START pair
                    # (the previous exit + its tracked Gram) becomes the
                    # one-older member
                    w.update(
                        mu_prevb=jnp.concatenate(
                            [state.mu_cg[:, None], state.mu_probe], axis=1),
                        gmu_prev=state.gmu)
            # Onsager alpha2 = gam2 * mean_j <u_j, Q^{-1} u_j>: the SLQ
            # quadrature of f(lam) = 1/(gamw lam + gam2) (same deterministic
            # u_j, g2d_onsager vamp.cpp:871-889) or the probe-CG Hutchinson
            if slq_on:
                alpha2 = gam2_eff * jnp.mean(
                    _slq.quad_inv(aux.slq, gamw, gam2_eff))
            else:
                alpha2 = gam2_eff * jnp.mean(jnp.sum(bern * invq, axis=0))
        eta2 = gam2 / alpha2

        # gam2 re-estimate (vamp.cpp:691-693)
        l2_x2r2 = jnp.sum(jnp.square((x2 - r2) * m_mask))
        gam2 = jnp.where(
            (cfg.auto_var_max_iter >= 1) & (it > 2),
            _clamp_gamma(1.0 / (1.0 / eta2 + l2_x2r2 / Mt)), gam2)

        gam1_new = _clamp_gamma(eta2 - gam2)
        r1 = ((eta2 * x2 - gam2 * r2) / gam1_new) * m_mask

        w = dict(w)
        w.update(x2=x2, invq=invq, alpha2=alpha2, eta2=eta2, gam2=gam2,
                 gam1_new=gam1_new, r1=r1, mu_cg=mu_cg_new,
                 mu_cg_n=mu_cg_n_new, mu_probe_n=mu_probe_n_new,
                 cg_iters=cg_iters, cg_rel_err=cg_rel_err,
                 probe_iters=probe_iters)
        return w

    def phase_noise(w, state: LinState, aux: Aux):
        op, y = aux.op, aux.y
        x2, invq = w["x2"], w["invq"]
        alpha2 = w["alpha2"]
        gamw = state.gamw

        # noise precision EM update (updateNoisePrec, vamp.cpp:892-927)
        if cfg.use_xxt:
            # both pieces come free from the dual solve: A x2 is exact via
            # the CG residual identity and the Hutchinson trace collapses to
            # Mt <u, A^T A Q_M^{-1} u> = Mt (1 - alpha2) / gamw
            ax2 = w["ax2_exact"]
            z1 = w["z1"]            # rode the dual-RHS pass (phase_lmmse)
            resid2 = jnp.sum(jnp.square(ax2 - y))
            trace_corr = Mt * (1.0 - alpha2) / gamw
        elif cfg.red:
            # full-data residual (reference updateNoisePrec keeps temp =
            # Ax(x2) unwindowed, vamp.cpp:897) + WINDOWED trace passes
            # (vamp.cpp:907-916): <u, Aw^T Aw q> = <Aw u, Aw q> in one
            # windowed wide pass over [invq | bern]; the deferred z1 = A x1
            # rides the full-data pass
            sbw = w["red_sbw"]
            Zf = axm_fn(op, jnp.concatenate(
                [x2[:, None], w["x1"][:, None]], axis=1))
            ax2 = Zf[..., 0]
            z1 = Zf[..., 1]
            resid2 = jnp.sum(jnp.square(ax2 - y))
            P = cfg.n_probes
            Zw = axm_w(op, jnp.concatenate([invq, aux.bern], axis=1), sbw)
            trace_corr = jnp.mean(
                jnp.sum(Zw[..., :P] * Zw[..., P:], axis=(0, 1))) * Mt
        elif fold_noise:
            # everything already fell out of the CG exit (phase_lmmse):
            # resid2/trace_corr via the Gram identity, z1 via the rider
            # column — NO packed pass in this phase
            z1 = w["z1_rider"]
            resid2 = w["resid2_id"]
            trace_corr = w["trace_corr_id"]
        else:
            # one wide pass computes A x2, A invq_j AND the deferred
            # z1 = A x1; the trace correction uses
            # <u_j, A^T A q_j> = <A u_j, A q_j>, A u_j precomputed in aux —
            # or the SLQ quadrature (phase_lmmse) when there are no probe
            # columns to forward
            Z2 = axm_fn(op, jnp.concatenate(
                [x2[:, None], invq, w["x1"][:, None]], axis=1))
            ax2 = Z2[..., 0]
            z1 = Z2[..., -1]
            resid2 = jnp.sum(jnp.square(ax2 - y))
            if slq_on:
                trace_corr = w["trace_corr_id"]
            else:
                trace_corr = jnp.mean(
                    jnp.sum(aux.z_bern * Z2[..., 1:-1], axis=(0, 1))) * Mt
        gamw_new = N / (resid2 + trace_corr)

        # train metrics (err_measures ind=1 after denoise, ind=2 after LMMSE)
        R2_1 = 1.0 - jnp.sum(jnp.square(y - z1)) / w["l2y"]
        R2_2 = 1.0 - resid2 / w["l2y"] if fold_noise and not cfg.use_xxt \
            else 1.0 - jnp.sum(jnp.square(y - ax2)) / w["l2y"]

        w = dict(w)
        w.update(gamw_new=gamw_new, R2_1=R2_1, R2_2=R2_2, z1=z1)
        return w

    def phase_finish(w, state: LinState, aux: Aux):
        it, x1, x1_prev = w["it"], w["x1"], w["x1_prev"]
        gam1, gam2, eta1, eta2 = w["gam1"], w["gam2"], w["eta1"], w["eta2"]
        alpha1, alpha2, rho = w["alpha1"], w["alpha2"], w["rho"]
        probs, vars_ = w["probs"], w["vars"]
        x2, r1, r2, invq = w["x2"], w["r1"], w["r2"], w["invq"]
        gamw_new, cv_r2 = w["gamw_new"], w["cv_r2"]
        cg_iters, cg_rel_err = w["cg_iters"], w["cg_rel_err"]
        probe_iters = w["probe_iters"]
        R2_1, R2_2 = w["R2_1"], w["R2_2"]

        # stopping criterion (vamp.cpp:741-749)
        rel_change = jnp.sqrt(
            jnp.sum(jnp.square(x1_prev - x1)) /
            jnp.maximum(jnp.sum(jnp.square(x1_prev)), 1e-300))

        metrics = {
            "it": it, "gam1": gam1, "gam2": gam2, "gamw": gamw_new,
            "eta1": eta1, "eta2": eta2, "alpha1": alpha1, "alpha2": alpha2,
            "rho": rho, "R2_train_1": R2_1, "R2_train_2": R2_2,
            "rel_change": rel_change, "cg_iters": cg_iters,
            "cg_rel_err": cg_rel_err, "probe_iters": probe_iters,
            "probs": probs, "vars": vars_,
        }
        if cfg.use_cross_val:
            metrics["cv_r2"] = cv_r2
            metrics["rho_cross"] = w["rho_cross"]
        if with_truth:
            ts = aux.ts
            sqn = jnp.sqrt(N)

            def diag_for(xh, rv, gam_true_scale):
                corr = jnp.sum(xh * ts) / jnp.sqrt(
                    jnp.sum(jnp.square(xh)) * jnp.sum(jnp.square(ts)))
                l2sig = jnp.sqrt(jnp.sum(jnp.square(xh / sqn - ts))
                                 / jnp.sum(jnp.square(ts)))
                tg = Mt / jnp.sum(jnp.square(rv - sqn * ts))
                return corr, l2sig, tg

            metrics["corr_x1"], metrics["l2_sig_err1"], metrics["true_gam2"] = \
                diag_for(x1, r2, None)
            metrics["corr_x2"], metrics["l2_sig_err2"], metrics["true_gam1"] = \
                diag_for(x2, r1, None)

        new_state = LinState(
            it=it, x1=x1, x2=x2, r1=r1, r2=r2, z1=w["z1"],
            mu_cg=w["mu_cg"], mu_cg_n=w["mu_cg_n"], mu_probe=invq,
            mu_probe_n=w["mu_probe_n"],
            gam1=w["gam1_new"], gam2=gam2, gamw=gamw_new, eta1=eta1,
            eta2=eta2, alpha1=alpha1, alpha2=alpha2, rho=rho, probs=probs,
            vars=vars_, cv_r2=cv_r2, gmu=w.get("gmu", state.gmu),
            gmu_n=w.get("gmu_n", state.gmu_n),
            mu_prevb=w.get("mu_prevb", state.mu_prevb),
            gmu_prev=w.get("gmu_prev", state.gmu_prev))
        return _cast_like(new_state, state), metrics

    phases = (("denoise", phase_denoise), ("z1_project", phase_project),
              ("lmmse_cg", phase_lmmse), ("noise_em", phase_noise),
              ("finish", phase_finish))

    def step(state: LinState, aux: Aux):
        w = phase_denoise(state, aux)
        w = phase_project(w, state, aux)
        w = phase_lmmse(w, state, aux)
        w = phase_noise(w, state, aux)
        return phase_finish(w, state, aux)

    if phased:
        return phases
    return jax.jit(step) if jit else step


def make_scan_step(geno, cfg: VampConfig, k: int, **kw):
    """k VAMP iterations per dispatch via lax.scan (throughput mode).

    One host round-trip per k iterations instead of per iteration — the
    per-dispatch latency dominates small problems.
    Returns (state, metrics) with every metric stacked along a leading [k]
    axis; semantics are identical to calling the single step k times.
    """
    raw = make_step(geno, cfg, jit=False, **kw)

    def multi(state, aux):
        def body(s, _):
            s2, m = raw(s, aux)
            return s2, m

        return jax.lax.scan(body, state, None, length=k)

    return jax.jit(multi)


def _phase_sync(tree) -> float:
    """Force completion of a phase output and return a wall-clock stamp.

    Fetches one scalar leaf, which waits for the phase like
    ``block_until_ready`` and works on any pytree."""
    leaves = jax.tree_util.tree_leaves(tree)
    for leaf in leaves:
        if hasattr(leaf, "ndim") and leaf.ndim == 0:
            float(leaf)
            break
    else:  # no scalar leaf: fetch one element
        float(jnp.sum(leaves[0].ravel()[:1]))
    import time as _t
    return _t.perf_counter()


def dispatch_chunk(step, single, make_single, state, aux, remaining, chunk):
    """One driver-loop dispatch with exact-max_iter semantics: a full scan
    chunk while the remaining budget allows, otherwise one single step
    (lazily built via ``make_single``) so state never overruns max_iter.
    Returns (state, metrics, k_got, single).  Shared by the linear, probit,
    robust and multi-trait driver loops."""
    if chunk > 1 and remaining < chunk:
        if single is None:
            single = make_single()
        state, metrics = single(state, aux)
        return state, metrics, 1, single
    state, metrics = step(state, aux)
    return state, metrics, chunk, single


def timed_step_from_phases(phases):
    """Compose (name, phase_fn) sub-steps into a per-phase-timed step.

    Each phase runs as its own dispatch with a host sync in between, so the
    reported ms include one dispatch latency each — use for observability,
    not for peak throughput (that is ``make_scan_step``).  Timings are
    attached to metrics as ``phase_ms_<name>``; the first iteration includes
    compilation.  Shared by the linear and probit engines.
    """
    jitted = [(nm, jax.jit(fn)) for nm, fn in phases]

    def step(state, aux):
        import time as _t
        timings = {}
        t = _t.perf_counter()
        nm0, f0 = jitted[0]
        w = f0(state, aux)
        t2 = _phase_sync(w)
        timings[nm0] = t2 - t
        t = t2
        for nm, fn in jitted[1:-1]:
            w = fn(w, state, aux)
            t2 = _phase_sync(w)
            timings[nm] = t2 - t
            t = t2
        nml, fl = jitted[-1]
        new_state, metrics = fl(w, state, aux)
        t2 = _phase_sync(metrics)
        timings[nml] = t2 - t
        for nm, dt in timings.items():
            metrics[f"phase_ms_{nm}"] = np.float64(dt * 1e3)
        return new_state, metrics

    return step


def make_timed_step(geno, cfg: VampConfig, **kw):
    """Per-phase-timed linear step (reference MPI_Wtime spans,
    vamp.cpp:752-755)."""
    return timed_step_from_phases(make_step(geno, cfg, phased=True, **kw))


def infer(geno, cfg: VampConfig, probs, vars_user,
          true_signal=None, freeze=None, callbacks=None,
          r1_init=None, x1_init=None, gam1=None, gamw=None,
          verbose: bool = True, sync_every: int = 1,
          phase_timers: bool = False, resume_state: LinState = None):
    """Run the full linear VAMP loop; returns (x1_hat_stored, history).

    ``x1_hat_stored`` is the /sqrt(N)-scaled estimate like the reference's
    return (vamp.cpp:802) and per-iteration .bin dumps.

    With ``cfg.use_cross_val`` the first 98% of sample-bytes train and the
    rest are held out for the within-iteration damping tuner
    (SB_cross = 0.98 * mbytes, vamp.cpp:158-166).

    ``sync_every`` > 1 runs chunks of that many iterations in ONE device
    dispatch (lax.scan, see make_scan_step) — per-iteration metrics are
    still recorded, but callbacks and the stopping check run per chunk.

    ``phase_timers`` dispatches each phase separately and records
    ``phase_ms_*`` per iteration (see make_timed_step); overrides
    ``sync_every``.
    """
    geno_hold = None
    if cfg.use_cross_val:
        sb_cross = int(0.98 * geno.layout.mbytes)
        geno_hold = geno.sample_window(sb_cross, geno.layout.mbytes - sb_cross)
        geno = geno.sample_window(0, sb_cross)
    if resume_state is not None:
        # full-state resume (--resume): cfg.max_iter is the TOTAL iteration
        # budget; the loop continues from resume_state.it with the exact
        # original step semantics (stopping criterion included)
        _check_resume_probe_cols(resume_state, cfg)
        state = resume_state
    else:
        state = init_state(geno, cfg, probs, vars_user,
                           r1_init=r1_init, x1_init=x1_init,
                           gam1=gam1, gamw=gamw)
    aux = make_aux(geno, cfg, freeze=freeze, true_signal=true_signal,
                   geno_hold=geno_hold)
    kw = dict(init_est=x1_init is not None,
              with_truth=true_signal is not None, geno_hold=geno_hold)
    chunk = 1 if phase_timers else max(1, int(sync_every))
    if phase_timers:
        step = make_timed_step(geno, cfg, **kw)
    else:
        step = (make_step(geno, cfg, **kw) if chunk == 1
                else make_scan_step(geno, cfg, chunk, **kw))
    tail_step = step if chunk == 1 else None
    history = []
    sqn = float(np.sqrt(geno.N))
    it = int(np.asarray(state.it))
    while it < cfg.max_iter:
        state, metrics, k_got, tail_step = dispatch_chunk(
            step, tail_step, lambda: make_step(geno, cfg, **kw),
            state, aux, cfg.max_iter - it, chunk)
        fetched = jax.device_get(metrics)
        if k_got == 1:
            chunk_ms = [{k: np.asarray(v) for k, v in fetched.items()}]
        else:
            chunk_ms = [{k: np.asarray(v)[i] for k, v in fetched.items()}
                        for i in range(k_got)]
        for m in chunk_ms:
            it += 1
            history.append(m)
            if verbose:
                print(f"[it {it}] gam1={m['gam1']:.6g} gam2={m['gam2']:.6g} "
                      f"gamw={m['gamw']:.6g} alpha1={m['alpha1']:.4g} "
                      f"alpha2={m['alpha2']:.4g} R2={m['R2_train_1']:.4f} "
                      f"rel={m['rel_change']:.3e} cg={int(m['cg_iters'])}",
                      flush=True)
                pk = [k for k in m if k.startswith("phase_ms_")]
                if pk:
                    # per-phase wall-clock (vamp.cpp:752-755 analog)
                    print("        " + "  ".join(
                        f"{k[len('phase_ms_'):]}={float(m[k]):.1f}ms"
                        for k in pk), flush=True)
            if it >= cfg.max_iter:
                break
        if callbacks:
            for cb in callbacks:
                cb(it, state, chunk_ms[-1], geno)
        if it > 1 and float(chunk_ms[-1]["rel_change"]) < cfg.stop_criteria_thr:
            if verbose:
                print(f"VAMP stopping criterion met (thr={cfg.stop_criteria_thr})")
            break
    from gvamp import dist
    x1_stored = dist.to_numpy(state.x1)[: geno.M] / sqn
    return x1_stored, state, history


def state_evolution(key, prior: Prior, gam1, rho,
                    prior_before: Prior, gam1_before, mt: int,
                    n_mc: int | None = None):
    """State-evolution prediction of (alpha1_bar, eta1_bar, gam2_bar).

    MC re-design of the reference diagnostic ``state_evo`` ind=1
    (vamp.cpp:1376-1401, dormant behind calc_state_evo=0 at vamp.hpp:38):
    draw beta ~ current prior, corrupt with N(0, 1/gam1) noise, average the
    damped denoiser derivative.  The ind=2 branch equals ``g2d_onsager`` and
    is covered by the in-loop probe estimate.
    """
    n_mc = n_mc or mt
    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)

    def draw_mix(kc, kn, pr):
        comp = jax.random.categorical(kc, jnp.log(pr.probs), shape=(n_mc,))
        return jax.random.normal(kn, (n_mc,)) * jnp.sqrt(pr.vars[comp])

    beta = draw_mix(k1, k2, prior)
    beta_b = draw_mix(k3, k4, prior_before)
    noise = jax.random.normal(k5, (n_mc,)) / jnp.sqrt(gam1)
    noise_b = jax.random.normal(k6, (n_mc,)) / jnp.sqrt(gam1_before)
    d = rho * g1d(beta + noise, gam1, prior) \
        + (1 - rho) * g1d(beta_b + noise_b, gam1_before, prior)
    alpha_bar = jnp.mean(d)
    eta_bar = gam1 / alpha_bar
    return alpha_bar, eta_bar, eta_bar - gam1
