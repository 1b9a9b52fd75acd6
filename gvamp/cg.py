"""Warm-started Jacobi-preconditioned conjugate gradient (marker space).

Solves (tau * A^T A + gam2 * I) x = v entirely on-device as a
``lax.while_loop`` — the device-side reshape of the reference's
``precondCG_solver`` (vamp.cpp:1120-1229).  Each iteration costs one
``ax`` + one ``atx`` pass over the packed matrix (lmmse_mult,
vamp.cpp:1074-1118); cross-shard reduction rides the psum inside ``ax``.

Two exit modes, as in the reference:
  * solver mode (``onsager=False``): relative residual ||r||/||v|| < 1e-5
    (vamp.cpp:1213-1223);
  * Onsager-probe mode (``onsager=True``): early-exit when the probe
    functional gam2 * <v, mu> stabilizes to 1e-8 relative change
    (vamp.cpp:1174-1193).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class CGResult(NamedTuple):
    mu: jax.Array
    iters: jax.Array
    rel_err: jax.Array
    r: jax.Array = None   # final residual V - Q mu (exact for ANY mu, so
                          # downstream identities like A x2 = y - gam2 mu - r
                          # hold regardless of convergence)
    rider_out: jax.Array = None  # A @ rider, captured on the first CG
                                 # iteration's forward pass (see solve_block)
    zmu: jax.Array = None        # tracked forward product A @ mu[:, 0] at
                                 # exit (fwd_mult tracking: zmu += alpha_0 *
                                 # A p_0 each iteration, zero extra reads)


def solve(
    lmmse_mult: Callable[[jax.Array], jax.Array],
    v: jax.Array,
    mu_start: jax.Array,
    diag: jax.Array,          # scalar or [M] Jacobi preconditioner
    gam2,
    max_iter: int,
    onsager: bool = False,
    err_tol: float = 1e-5,
    onsager_tol: float = 1e-8,
) -> CGResult:
    dt = v.dtype

    r0 = v - lmmse_mult(mu_start)
    z0 = r0 / diag
    norm_v = jnp.sqrt(jnp.sum(jnp.square(v)))

    class S(NamedTuple):
        i: jax.Array
        mu: jax.Array
        r: jax.Array
        z: jax.Array
        p: jax.Array
        rz: jax.Array
        prev_ons: jax.Array
        rel_err: jax.Array
        done: jax.Array

    s0 = S(jnp.asarray(0), mu_start, r0, z0, z0,
           jnp.sum(r0 * z0), jnp.asarray(0.0, dt),
           jnp.asarray(jnp.inf, dt), jnp.asarray(False))

    def cond(s: S):
        return (s.i < max_iter) & (~s.done)

    def body(s: S):
        d = lmmse_mult(s.p)
        alpha = s.rz / jnp.sum(d * s.p)
        mu = s.mu + alpha * s.p
        if onsager:
            ons = gam2 * jnp.sum(v * mu)
            rel = jnp.where(ons != 0, jnp.abs((ons - s.prev_ons) / ons), 1.0)
            ons_done = rel < onsager_tol
            prev_ons = ons
        else:
            ons_done = jnp.asarray(False)
            prev_ons = s.prev_ons
        r = s.r - alpha * d
        z = r / diag
        rz_new = jnp.sum(r * z)
        beta = rz_new / s.rz
        p = z + beta * s.p
        rel_err = jnp.sqrt(jnp.sum(jnp.square(r))) / norm_v
        done = ons_done | (rel_err < err_tol)
        out = S(s.i + 1, mu, r, z, p, rz_new, prev_ons, rel_err, done)
        return jax.tree_util.tree_map(
            lambda n, ref: jnp.asarray(n, ref.dtype), out, s)

    out = jax.lax.while_loop(cond, body, s0)
    return CGResult(mu=out.mu, iters=out.i, rel_err=out.rel_err, r=out.r)


def solve_block(
    mult_block: Callable[[jax.Array], jax.Array],
    V: jax.Array,             # [M, B] right-hand sides
    mu_start: jax.Array,      # [M, B]
    diag,                     # scalar or [M] Jacobi preconditioner
    gam2,
    max_iter: int,
    modes: tuple,             # per column: 0 = residual exit, 1 = onsager exit
    err_tol: float = 1e-5,
    onsager_tol: float = 1e-8,
    precond=None,             # optional R[M, B] -> Z[M, B] (replaces Jacobi)
    start_zero: bool = False,  # mu_start is literally 0: skip the init mult
    r0=None,                  # precomputed V - mult(mu_start): skip the init
                              # mult (callers track the warm start's Gram
                              # product across calls — see linear.py)
    rider=None,               # [M, R] extra columns whose FORWARD product
                              # A @ rider is needed by the caller: they ride
                              # the first CG iteration's wide ax pass (extra
                              # RHS width, NO extra packed-matrix read) —
                              # this is how linear.py gets z1 = A x1 without
                              # the separate noise-EM pass
    rider_mult=None,          # (P, X) -> (Q P, A X); required with rider
                              # (cg.make_lmmse_mult_block_rider)
    fwd_mult=None,            # (P) -> (Q P, A P): replaces mult_block and
                              # tracks the forward product of solution
                              # column 0 across iterations (zmu += alpha_0 *
                              # A p_0, the CG recursion applied in N-space) —
                              # this is how the z-model engines (probit/
                              # Huber) get z2 = A x2 without the separate
                              # post-solve forward pass
    zmu0=None,                # A @ mu_start[:, 0]; required with fwd_mult
                              # (zeros for a zero start; callers carry it
                              # across iterations like the tracked Gram
                              # product — see tracked_warm_start_fwd)
    plateau: int = 0,         # stagnation exit, windowed: every `plateau`
                              # iterations, a still-running column must have
                              # improved its BEST relative residual by at
                              # least 30% since the last window boundary or
                              # it freezes.  A sustained per-iteration rate
                              # of 0.97 (apparent condition number ~2e4+,
                              # >400 iterations to converge) fails the
                              # window; the engines' converging solves run
                              # at rates <= ~0.5 and clear it by orders of
                              # magnitude.  Best-so-far tracking makes the
                              # test immune to CG's residual-norm
                              # oscillation, and the fp floor needs no
                              # special case (a floored best stops
                              # improving).  0 = off (reference behavior:
                              # ill-conditioned z-model solves burn the full
                              # budget producing an iterate no better than
                              # the windowed one, vamp_Huber.cpp:313).
) -> CGResult:
    """Batched CG: each column runs its own CG recursion, but every iteration
    costs ONE wide-RHS pass over the packed matrix (axm+atxm) instead of one
    pass per column — the block reshape of the reference's two sequential
    ``precondCG_solver`` calls (LMMSE solve vamp.cpp:594-596 + Onsager probe
    vamp.cpp:871-889).  Converged columns freeze (alpha=0) while the rest
    keep iterating; the loop exits when all columns are done.
    """
    dt = V.dtype
    B = V.shape[1]
    modes = jnp.asarray(np.asarray(modes), jnp.int32)
    # diag: scalar, [M] (per-row Jacobi), or [1|M, B] (per-column operators)
    diag_c = jnp.asarray(diag, dt)
    diag_c = diag_c[:, None] if diag_c.ndim == 1 else diag_c
    gam2_b = jnp.asarray(gam2, dt) * jnp.ones((B,), dt)  # per-column quadform
    apply_m = precond if precond is not None else (lambda r: r / diag_c)

    # zero-start solves (probit/Huber LMMSE, vamp_probit.cpp:507) skip the
    # initialization mult: r0 = V exactly, saving one packed pass per call
    if r0 is None:
        r0 = V if start_zero else V - mult_block(mu_start)
    z0 = apply_m(r0)
    # all-zero RHS columns: solution is 0 exactly; guard the norm so the
    # relative residual stays finite and the done flag can fire
    norm_v2 = jnp.sum(jnp.square(V), axis=0)  # [B]
    norm_v = jnp.sqrt(jnp.where(norm_v2 == 0, 1.0, norm_v2))

    assert not (rider is not None and fwd_mult is not None), \
        "rider and fwd_mult tracking are mutually exclusive"
    if fwd_mult is not None and zmu0 is None:
        raise ValueError("fwd_mult tracking requires zmu0 = A @ mu_start[:, 0]")

    class S(NamedTuple):
        i: jax.Array
        mu: jax.Array         # [M, B]
        r: jax.Array
        z: jax.Array
        p: jax.Array
        rz: jax.Array         # [B]
        prev_ons: jax.Array   # [B]
        rel_err: jax.Array    # [B]
        done: jax.Array       # bool[B]
        iters: jax.Array      # int[B] per-column iteration counts
        zmu: jax.Array        # tracked A @ mu[:, 0] (dummy scalar when off)
        best: jax.Array       # [B] best rel_err so far (plateau tracking)
        win_best: jax.Array   # [B] best at the last window boundary

    # win_best starts at inf so the FIRST window boundary only records a
    # baseline and never fires: CG routinely makes zero residual-norm
    # progress for a dozen iterations on a perfectly convergent solve (the
    # spectrum-discovery transient) — earliest possible plateau exit is
    # therefore 2*plateau iterations
    rel0 = jnp.sqrt(jnp.sum(jnp.square(r0), axis=0)) / norm_v
    s0 = S(jnp.asarray(0), mu_start, r0, z0, z0,
           jnp.sum(r0 * z0, axis=0), jnp.zeros((B,), dt),
           jnp.full((B,), jnp.inf, dt), jnp.zeros((B,), bool),
           jnp.zeros((B,), jnp.int32),
           zmu0 if fwd_mult is not None else jnp.zeros((), dt),
           rel0, jnp.full((B,), jnp.inf, dt))

    def cond(s: S):
        return (s.i < max_iter) & (~jnp.all(s.done))

    def body_with(s: S, d, ap=None):
        pd = jnp.sum(d * s.p, axis=0)
        alpha = jnp.where(s.done | (pd == 0), 0.0,
                          s.rz / jnp.where(pd == 0, 1.0, pd))
        mu = s.mu + alpha[None, :] * s.p
        ons = gam2_b * jnp.sum(V * mu, axis=0)
        ons_rel = jnp.where(ons != 0, jnp.abs((ons - s.prev_ons) / ons), 1.0)
        r = s.r - alpha[None, :] * d
        z = apply_m(r)
        rz_new = jnp.sum(r * z, axis=0)
        beta = jnp.where(s.done | (s.rz == 0), 0.0,
                         rz_new / jnp.where(s.rz == 0, 1.0, s.rz))
        p = z + beta[None, :] * s.p
        rel_err = jnp.sqrt(jnp.sum(jnp.square(r), axis=0)) / norm_v
        done = s.done | jnp.where(modes == 1, ons_rel < onsager_tol,
                                  rel_err < err_tol)
        best = jnp.minimum(s.best, rel_err)
        win_best = s.win_best
        if plateau > 0:
            boundary = (s.i + 1) % plateau == 0
            done = done | (boundary & (best > 0.7 * s.win_best))
            win_best = jnp.where(boundary, best, s.win_best)
        zmu = s.zmu if ap is None else s.zmu + alpha[0] * ap[..., 0]
        out = S(s.i + 1, mu, r, z, p, rz_new, ons, rel_err, done,
                s.iters + (~s.done).astype(jnp.int32), zmu, best, win_best)
        return jax.tree_util.tree_map(
            lambda n, ref: jnp.asarray(n, ref.dtype), out, s)

    def body(s: S):
        if fwd_mult is not None:
            return body_with(s, *fwd_mult(s.p))
        return body_with(s, mult_block(s.p))

    ax_rider = None
    if rider is not None:
        # peel iteration 1: identical recursion, but the wide forward pass
        # also carries the rider columns.  Frozen/converged columns take
        # alpha = 0 steps, so peeling is exact even if the warm start already
        # satisfies every exit test (the pass still runs — same cost as the
        # separate pass it replaces, in the worst case).
        d0, ax_rider = rider_mult(s0.p, rider)
        s0 = body_with(s0, d0)
    out = jax.lax.while_loop(cond, body, s0)
    return CGResult(mu=out.mu, iters=out.iters, rel_err=out.rel_err, r=out.r,
                    rider_out=ax_rider,
                    zmu=out.zmu if fwd_mult is not None else None)


def tracked_warm_start(V, mu0_raw, gmu_raw, tau_now, tau_ref, gam2_cols,
                       it, refresh, multb):
    """Safe CG warm start from a tracked Gram product: (mu0, r0).

    ``gmu_raw`` claims to hold the pure Gram product of ``mu0_raw`` (stored
    by :func:`gram_from_exit` at the previous solve's exit, at scale
    ``tau_ref``); off refresh ticks the init residual is then elementwise
    algebra, no packed pass.  The stored product carries absolute float
    noise ~ eps*|V|/tau_ref, which reuse at ``tau_now`` amplifies by
    tau_now/tau_ref — z-model taus (probit/Huber) swing by orders of
    magnitude early on, and in float32 the amplified noise NaNs the whole
    loop (caught by the fuzz sweep).  Guards, all falling back to a true
    init mult with the warm start kept: non-finite carried state,
    tau_now > 4*tau_ref, unset tau_ref.  An all-zero warm start never pays
    the mult (r0 = V exactly, the zero-start fast path).
    """
    finite = jnp.all(jnp.isfinite(mu0_raw)) & jnp.all(jnp.isfinite(gmu_raw))
    mu0 = jnp.where(finite, mu0_raw, jnp.zeros_like(mu0_raw))
    zero = jnp.all(mu0 == 0)
    gmu = jnp.where(finite & ~zero, gmu_raw, jnp.zeros_like(gmu_raw))
    stale = jnp.any((tau_ref <= 0) | (tau_now > 4.0 * tau_ref))
    cold = jnp.all(gmu == 0) & jnp.any(mu0 != 0)
    need_mult = ((it % refresh == 0) | cold | stale) & ~zero
    r0 = jax.lax.cond(
        need_mult,
        lambda: V - multb(mu0),
        lambda: V - (tau_now * gmu + gam2_cols * mu0))
    return mu0, r0


def tracked_warm_start_fwd(V, mu0_raw, gmu_raw, zmu_raw, tau_now, tau_ref,
                           gam2_cols, it, refresh, multb_fwd):
    """tracked_warm_start plus the carried forward product zmu = A mu0[:, 0]
    (the z-model engines' z2 tracking): same guards, and the refresh-tick
    true init mult ALSO refreshes zmu from its forward half, so the tracked
    z2 drift resets on the same schedule as the Gram product's.

    Returns (mu0, r0, zmu0).
    """
    finite = (jnp.all(jnp.isfinite(mu0_raw)) & jnp.all(jnp.isfinite(gmu_raw))
              & jnp.all(jnp.isfinite(zmu_raw)))
    mu0 = jnp.where(finite, mu0_raw, jnp.zeros_like(mu0_raw))
    zero = jnp.all(mu0 == 0)
    gmu = jnp.where(finite & ~zero, gmu_raw, jnp.zeros_like(gmu_raw))
    zmu = jnp.where(finite & ~zero, zmu_raw, jnp.zeros_like(zmu_raw))
    stale = jnp.any((tau_ref <= 0) | (tau_now > 4.0 * tau_ref))
    cold = jnp.all(gmu == 0) & jnp.any(mu0 != 0)
    need_mult = ((it % refresh == 0) | cold | stale) & ~zero

    def true_mult():
        qp, ap = multb_fwd(mu0)
        return V - qp, ap[..., 0]

    r0, zmu0 = jax.lax.cond(
        need_mult, true_mult,
        lambda: (V - (tau_now * gmu + gam2_cols * mu0), zmu))
    return mu0, r0, zmu0


def extrapolate_pair(V, mu1, gmu1, mu2, gmu2, tau_now, gam2_cols,
                     theta_max: float = 1.5):
    """Least-squares secant extrapolation of the tracked warm start.

    The Gram product is LINEAR, so the extrapolated start
    ``mu0 = mu1 + theta (mu1 - mu2)`` has
    ``gram(mu0) = gmu1 + theta (gmu1 - gmu2)`` with zero packed passes, and
    the init residual is affine in theta: ``r(theta) = a - theta b`` with
    ``a = V - (tau gmu1 + gam2 mu1)`` (the plain warm start's residual) and
    ``b = tau (gmu1 - gmu2) + gam2 (mu1 - mu2)``.  The per-column
    ``theta* = <a,b>/<b,b>`` minimizes ``||r(theta)||`` in closed form —
    elementwise algebra only — so the tracked residual can only DROP below
    the plain warm start's (theta = 0 recovers it exactly).  When the VAMP
    parameter drift is smooth between iterations this cancels its
    first-order term, which is what keeps the steady-state block CG at one
    iteration instead of two (the 4-reads/iteration floor of bench config
    B).

    ``theta`` is clamped to [0, theta_max]: the carried Gram products hold
    CG-recursion fp noise, and the combination amplifies it by up to
    (1 + 2 theta) between gram_refresh resets, so the clamp bounds the
    worst-case growth.  Guards (theta = 0, i.e. the plain warm start): a
    non-finite or all-zero previous pair (first iterations, resume from a
    pre-extrapolation checkpoint), or a degenerate direction <b,b> ~ 0.

    Returns ``(mu0, gmu0)`` for :func:`tracked_warm_start`, whose own
    refresh/stale/cold guards then apply to the extrapolated pair.
    """
    ok = (jnp.all(jnp.isfinite(mu2)) & jnp.all(jnp.isfinite(gmu2))
          & jnp.any(mu2 != 0) & jnp.any(gmu2 != 0))
    dmu = mu1 - mu2
    dg = gmu1 - gmu2
    a = V - (tau_now * gmu1 + gam2_cols * mu1)
    b = tau_now * dg + gam2_cols * dmu
    ab = jnp.sum(a * b, axis=0)
    bb = jnp.sum(b * b, axis=0)
    tiny = jnp.finfo(V.dtype).tiny
    theta = jnp.where(ok & (bb > tiny),
                      jnp.clip(ab / jnp.where(bb > tiny, bb, 1.0),
                               0.0, theta_max),
                      0.0)
    return mu1 + theta[None, :] * dmu, gmu1 + theta[None, :] * dg


def gram_from_exit(V, sol, tau_now, gam2_cols):
    """Recover the pure Gram product of ``sol.mu`` from the CG exit
    residual: mult(mu) = V - r, so gram(mu) = (V - r - gam2*mu)/tau.
    The divide is guarded (tau ~ 0 would manufacture inf in float32);
    :func:`tracked_warm_start`'s tau-ratio guard rejects reuse of values
    stored at tiny tau anyway."""
    dt = V.dtype
    tau_safe = jnp.maximum(jnp.asarray(tau_now, dt),
                           jnp.sqrt(jnp.finfo(dt).tiny))
    return (V - sol.r - gam2_cols * sol.mu) / tau_safe


def make_lmmse_mult_block(axm_fn, atxm_fn, op, tau, gam2):
    """P[M, B] -> tau * A^T(A P) + gam2 * P: two wide passes per call, like
    the reference's lmmse_mult (vamp.cpp:1074-1118)."""

    def mult(P):
        return tau * atxm_fn(op, axm_fn(op, P)) + gam2 * P

    return mult


def make_lmmse_mult_block_fwd(axm_fn, atxm_fn, op, tau, gam2):
    """Two-pass lmmse mult exposing the forward intermediate:
    P -> (tau A^T(A P) + gam2 P, A P).  Used with solve_block's fwd_mult
    tracking so z2 = A x2 falls out of the CG recursion itself."""

    def mult(P):
        Z = axm_fn(op, P)
        return tau * atxm_fn(op, Z) + gam2 * P, Z

    return mult


def make_lmmse_mult_block_rider(axm_fn, atxm_fn, op, tau, gam2):
    """Two-pass lmmse mult that additionally returns the forward product of
    ``rider`` columns: (P, X) -> (tau A^T(A P) + gam2 P, A X).  The riders
    share the forward pass's packed-matrix read (extra RHS width only); the
    backward pass reads the matrix for the P columns alone."""

    def mult(P, X):
        B = P.shape[1]
        Z = axm_fn(op, jnp.concatenate([P, X], axis=1))
        return tau * atxm_fn(op, Z[..., :B]) + gam2 * P, Z[..., B:]

    return mult


def make_lmmse_mult(ax_fn, atx_fn, op, tau, gam2):
    """p -> tau * A^T(A p) + gam2 * p (reference lmmse_mult, vamp.cpp:1074)."""

    def mult(p):
        return tau * atx_fn(op, ax_fn(op, p)) + gam2 * p

    return mult


def jacobi_diag(tau, gam2, N):
    """tau*(N-1)/N + gam2 — the diagonal of the LMMSE operator under marker
    standardization (reference vamp.cpp:1137-1139)."""
    return tau * (N - 1.0) / N + gam2


def top_eigs(mult_ata, m: int, k: int, key, n_iter: int = 8, dtype=None,
             op=None):
    """Top-k eigenpairs of the FIXED Gram operator S = A^T A by orthogonal
    (block power) iteration — k columns ride each wide pass, so the whole
    factorization costs ~n_iter wide passes, amortized over every CG solve
    of the run (S's eigenvectors never change; only the scalars tau/gam2 in
    Q = tau S + gam2 I do).

    With ``op`` given, ``mult_ata(op, V)`` is used and the operator pytree
    enters the jitted program as an ARGUMENT — a closed-over packed matrix
    would be captured as a jaxpr constant and embedded in the compiled
    program (XLA then tries to constant-fold multi-GB decodes).

    Returns (V [m, k] orthonormal, lam [k]).
    """

    import jax

    dtype = dtype or jnp.float32
    V0 = jax.random.normal(key, (m, k), dtype)

    @functools.partial(jax.jit, static_argnums=(2,))
    def run(op_, V, n_it):
        mult = (mult_ata if op is None
                else functools.partial(mult_ata, op_))
        V, _ = jnp.linalg.qr(V)

        def body(_, V):
            W = mult(V)
            V, _ = jnp.linalg.qr(W)
            return V

        V = jax.lax.fori_loop(0, n_it, body, V)
        W = mult(V)
        lam = jnp.sum(V * W, axis=0)
        return V, lam

    return run(op, V0, n_iter)


def make_deflated_precond(V, lam, tau, gam2, diag):
    """Deflation preconditioner for Q = tau S + gam2 I given top eigenpairs
    of S: exact inverse on span(V), Jacobi on the complement.

        M^{-1} r = V ((V^T r) / (tau lam + gam2)) + (r - V V^T r) / diag

    SPD for positive (tau, gam2); cost per CG iteration = two skinny
    [m, k] matmuls, negligible next to a packed-matrix pass.

    ``tau``/``gam2`` may be scalars or per-column [B] vectors (the
    multi-trait block solve, where column j's operator is
    tau_j S + gam2_j I); V/lam stay shared across columns.
    """
    tau = jnp.asarray(tau)
    gam2 = jnp.asarray(gam2)
    if tau.ndim or gam2.ndim:
        # per-column: [k, B]
        inv_eig = 1.0 / (jnp.reshape(tau, (1, -1)) * lam[:, None]
                         + jnp.reshape(gam2, (1, -1)))
    else:
        inv_eig = 1.0 / (tau * lam + gam2)      # [k]

    mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)

    def apply(r):  # r: [m, B]
        c = mm(V.T, r)                       # [k, B]
        proj = mm(V, c)
        return mm(V, c * inv_eig[:, None] if inv_eig.ndim == 1
                  else c * inv_eig) + (r - proj) / diag

    return apply
