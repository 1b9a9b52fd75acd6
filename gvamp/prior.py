"""Spike-and-slab Gaussian-mixture prior: denoisers + EM adaptation.

Vectorized re-design of the reference's per-scalar loops:
  * g1 / g1d posterior mean & variance-derivative (vamp.cpp:805-869) as
    vectorized closed forms with the max-variance exponent shift;
  * EM prior update with component merging (vamp.cpp:929-1072).  The
    reference erases merged components from std::vectors; here the mixture
    lives in FIXED-SIZE slots and merging zeroes a slot's probability while
    duplicating the survivor's variance (so shapes stay static under jit and
    the max-variance shift is unaffected).

Scale convention: `vars` are in the *internal* scale (already multiplied by
N, mirroring vamp.cpp:153-155).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

GAMMA_MIN = 1e-11  # reference vamp.hpp:31
GAMMA_MAX = 1e11   # reference vamp.hpp:32
_SQRT_2PI = 2.5066282746310002


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Prior:
    probs: jax.Array  # f[L]; slot 0 = spike; merged slots have prob 0
    vars: jax.Array   # f[L]; slot 0 = 0; merged slots duplicate survivor var

    @property
    def L(self) -> int:
        return self.probs.shape[0]


def _resp_terms(r, gam1, prior: Prior):
    """Posterior responsibilities and shrinkages for the mixture denoiser.

    The reference evaluates g1 = r + sigma*pkd/pk and
    g1d = 1 + sigma*(pkdd/pk - (pkd/pk)^2) (vamp.cpp:805-869).  Those forms
    cancel catastrophically in f32 when sigma >> v (e.g. gam1=1e-8 at init),
    so we use the algebraically identical responsibility form instead:

        w_i  propto p_i / sqrt(v_i+sigma) * exp(shifted)     (responsibility)
        s_i  = v_i / (v_i + sigma)                           (shrinkage)
        g1   = r * sum_i w_i s_i
        g1d  = m + r^2 * (m*q - t),   m = sum w s, q = sum w/(v+sigma),
                                      t = sum w s/(v+sigma)

    every term is positive, no 1-minus-small cancellations.  The exponent is
    shifted by the max variance so the largest term is exp(0)
    (vamp.cpp:819-821).
    """
    sigma = 1.0 / gam1
    vmax = jnp.max(prior.vars)
    v = prior.vars[None, :]          # [1, L]
    p = prior.probs[None, :]
    r2 = jnp.square(r)[:, None]      # [M, 1]
    vps = v + sigma
    c = p / jnp.sqrt(vps) * jnp.exp(-0.5 * r2 * (vmax - v) / (vps * (vmax + sigma)))
    w = c / jnp.sum(c, axis=1, keepdims=True)
    s = v / vps
    m = jnp.sum(w * s, axis=1)
    q = jnp.sum(w / vps, axis=1)
    t = jnp.sum(w * s / vps, axis=1)
    return sigma, m, q, t


def g1(r: jax.Array, gam1, prior: Prior) -> jax.Array:
    """Posterior mean E[x | r, gam1] under the mixture prior (vamp.cpp:805)."""
    sigma, m, q, t = _resp_terms(r, gam1, prior)
    return jnp.where(jnp.abs(sigma) < 1e-10, r, r * m)


def g1d(r: jax.Array, gam1, prior: Prior) -> jax.Array:
    """d g1 / d r (reference vamp.cpp:836), responsibility form."""
    sigma, m, q, t = _resp_terms(r, gam1, prior)
    val = m + jnp.square(r) * (m * q - t)
    return jnp.where(jnp.abs(sigma) < 1e-10, jnp.ones_like(r), val)


def pip(r: jax.Array, gam1, prior: Prior) -> jax.Array:
    """Posterior inclusion probability P(x != 0 | r, gam1) per marker.

    An output the reference does not expose: the same posterior appears as
    `pin` inside updatePrior's EM (vamp.cpp:979) but is only consumed
    internally.  Evaluated at the final (r1, gam1) it is the standard
    fine-mapping PIP for the spike-and-slab posterior the denoiser
    marginalizes over.  Same max-variance exponent shift as `_resp_terms`;
    merged slots (prob 0) contribute nothing.  Slot 0 is the spike.
    """
    sigma = 1.0 / gam1
    vmax = jnp.max(prior.vars)
    v = prior.vars[None, :]
    p = prior.probs[None, :]
    r2 = jnp.square(r)[:, None]
    vps = v + sigma
    c = p / jnp.sqrt(vps) * jnp.exp(
        -0.5 * r2 * (vmax - v) / (vps * (vmax + sigma)))
    return 1.0 - c[:, 0] / jnp.sum(c, axis=1)


@functools.partial(jax.jit, static_argnames=("em_max_iter", "learn_vars"))
def update_prior(
    r1: jax.Array,        # f[Mpad], padded entries arbitrary (masked out)
    gam1,
    prior: Prior,
    m_mask: jax.Array,    # f[Mpad]: 1 on real markers
    mt,                   # total marker count across shards
    em_max_iter: int = 2,       # reference options.hpp EM_max_iter default
    em_err_thr: float = 1e-2,   # reference EM_err_thr default
    learn_vars: bool = True,
    merge_thr: float = 5e-1,    # reference vamp.cpp:1063
) -> Prior:
    """One call of the reference's updatePrior (vamp.cpp:929-1072).

    EM over (lambda, omegas, vars) with early stop on relative change of
    probs AND vars, followed by the close-variance merge pass.  Cross-shard
    reductions (lambda, res, res_gammas) are plain sums over the sharded
    marker axis — XLA inserts the all-reduce (the psum analog of the
    reference's MPI_Allreduce at vamp.cpp:990,1012-1013).
    """
    L = prior.L
    dt = prior.probs.dtype
    mt = jnp.asarray(mt, dt)
    noise_var = 1.0 / gam1
    r2 = jnp.square(r1)

    def em_body(carry):
        it, probs, vars_, dist = carry
        lam = 1.0 - probs[0]
        omegas = probs / jnp.where(lam == 0, 1.0, lam)  # slab omegas (slot0 unused)
        vmax = jnp.max(vars_)
        vs = vars_[None, 1:]  # slab variances [1, L-1]
        # responsibilities (slab), max-shifted exponent (vamp.cpp:961)
        num = (lam * omegas[None, 1:]
               * jnp.exp(-0.5 * r2[:, None] * (vmax - vs)
                         / ((vs + noise_var) * (vmax + noise_var)))
               / jnp.sqrt(vs + noise_var) / _SQRT_2PI)
        sum_num = jnp.sum(num, axis=1)                    # [M]
        beta = num / jnp.where(sum_num == 0, 1.0, sum_num)[:, None]
        gammas = (gam1 * r1)[:, None] / (1.0 / vs + gam1)  # posterior means
        v_post = 1.0 / (1.0 / vs + gam1)                   # [1, L-1]
        # inclusion probability (vamp.cpp:979)
        pin = 1.0 / (1.0 + (1.0 - lam) / jnp.sqrt(2.0 * jnp.pi * noise_var)
                     * jnp.exp(-0.5 * r2 * vmax / (noise_var * (noise_var + vmax)))
                     / jnp.where(sum_num == 0, 1.0, sum_num))
        pin = pin * m_mask
        sum_pin = jnp.sum(pin)                 # cross-shard sum (lambda_total)
        lam_new = sum_pin / mt
        res = jnp.sum(beta * pin[:, None], axis=0)                     # [L-1]
        res_g = jnp.sum(beta * (jnp.square(gammas) + v_post) * pin[:, None], axis=0)
        new_slab_vars = jnp.where(res > 0, res_g / jnp.where(res == 0, 1.0, res),
                                  vars_[1:])
        vars_new = vars_ if not learn_vars else vars_.at[1:].set(new_slab_vars)
        omg = res / jnp.where(sum_pin == 0, 1.0, sum_pin)
        probs_new = jnp.concatenate(
            [(1.0 - lam_new)[None], lam_new * omg]).astype(dt)
        vars_new = vars_new.astype(dt)
        dist_p = jnp.sqrt(jnp.sum(jnp.square(probs_new - probs))
                          / jnp.sum(jnp.square(probs_new)))
        dist_v = jnp.sqrt(jnp.sum(jnp.square(vars_new - vars_))
                          / jnp.sum(jnp.square(vars_new)))
        dist = jnp.maximum(dist_p, dist_v).astype(r1.dtype)
        return it + 1, probs_new, vars_new, dist.astype(dt)

    def em_cond(carry):
        it, _, _, dist = carry
        return (it < em_max_iter) & (dist >= em_err_thr)

    big = jnp.asarray(jnp.inf, dt)
    _, probs, vars_, _ = jax.lax.while_loop(
        em_cond, em_body, (0, prior.probs, prior.vars, big))

    # ---- merge close variances (vamp.cpp:1054-1071) ------------------------
    # fixed-slot version: merging k into j moves k's probability onto j and
    # duplicates j's variance into slot k (keeps jnp.max(vars) semantics).
    for j in range(L):
        for k in range(j + 1, L):
            both_alive = (probs[j] > 0) & (probs[k] > 0)
            denom = jnp.where(vars_[j] != 0, jnp.minimum(vars_[j], vars_[k]), 1e-7)
            close = jnp.abs(vars_[j] - vars_[k]) / denom < merge_thr
            do = both_alive & close
            probs = probs.at[j].set(jnp.where(do, probs[j] + probs[k], probs[j]))
            probs = probs.at[k].set(jnp.where(do, 0.0, probs[k]))
            vars_ = vars_.at[k].set(jnp.where(do, vars_[j], vars_[k]))

    return Prior(probs=probs, vars=vars_)


def initialize_prior(probs, vars_, N, Mt):
    """Default 23-component prior when none given (utilities.cpp:91-140).

    probs: geometric /2 slab with spike 1 - 50000/Mt; vars: 0 then 22
    log-spaced in [1e-5, 1e2], all divided by N (the returned vars are in the
    *user* scale; the engine multiplies by N at infer entry).
    """
    import numpy as np

    if probs is not None and len(probs) > 0:
        return np.asarray(probs, np.float64), np.asarray(vars_, np.float64)
    if Mt <= 50000:
        raise ValueError("No probs/vars specified and Mt <= 50000 "
                         "(reference utilities.cpp:96-99)")
    num_mix = 23
    p1 = min(50000.0 / Mt, 1.0) / (2.0 - 1.0 / 2.0**21)
    probs_out = [1.0 - 50000.0 / Mt] + [p1 / 2.0**i for i in range(num_mix - 1)]
    ratio = 10.0 ** (np.log10(1e2 / 1e-5) / (num_mix - 2))
    vars_out = [0.0] + [1e-5 * ratio**i for i in range(num_mix - 1)]
    return (np.asarray(probs_out, np.float64),
            np.asarray(vars_out, np.float64) / N)
