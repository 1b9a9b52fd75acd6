"""Stochastic Lanczos quadrature for the Onsager trace estimator.

The reference estimates ``alpha2 = gam2 * u^T (tau A^T A + gam2 I)^{-1} u``
with a Rademacher probe ``u`` solved by preconditioned CG every VAMP
iteration (g2d_onsager, vamp.cpp:871-889), and reuses the probe solution
for the noise-EM trace correction ``Mt * u^T A^T A Q^{-1} u``
(updateNoisePrec, vamp.cpp:892-927).  The probe RHS is FIXED for the whole
run (seeded per rank, vamp.cpp:875) and the operator changes only through
the scalar shifts (tau, gam2) — the textbook setting for Gauss/Lanczos
quadrature: tridiagonalize ``G = A^T A`` ONCE in the Krylov space of ``u``
(k packed passes at setup), then every iteration's bilinear forms

    u^T f(G) u  ~=  ||u||^2 * sum_i  w_i f(lam_i)

are O(k) vector math with ZERO passes over the packed matrix, for ANY
f(lam) = 1/(tau lam + gam2) or lam/(tau lam + gam2) — i.e. any (tau, gam2)
trajectory, any engine (linear gamw/gam2, probit/Huber tau2/gam2, all
traits of the multi-trait block, and the dual/XXT N-space analog).

Accuracy: the k-node Gauss rule equals the estimate CG itself would
produce after k iterations from the same start vector — running k=32 once
strictly dominates the reference's per-iteration probe CG (<=10 its at
tol 1e-8); the Hutchinson MC error across probe draws is unchanged (same
u).  Full reorthogonalization keeps the f32 recurrence honest; the basis
is discarded after the (nodes, weights) extraction.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


class SlqBasis(NamedTuple):
    """Gauss-quadrature view of C independent Krylov spaces: column j of
    the start block U spans its own space under its own (columnwise) SPD
    operator — probes, traits x probes, or dual-space probes."""

    lam: jax.Array     # [C, k] Ritz values (quadrature nodes), >= 0
    wts: jax.Array     # [C, k] (e1 . eigvec)^2 quadrature weights, sum ~ 1
    unorm2: jax.Array  # [C] squared norms of the start vectors


def lanczos_block(mult, U, k: int):
    """k-step Lanczos on C columnwise SPD operators, fully reorthogonalized.

    ``mult([n, C]) -> [n, C]`` applies operator j to column j (exactly the
    engines' block Gram mult without the scalar shifts).  ``U [n, C]`` are
    the start vectors.  Returns (alphas [k, C], betas [k, C], unorm2 [C]);
    betas[k-1] is computed but unused by the tridiagonal.

    Zero start columns and Krylov breakdown (beta ~ 0) degrade gracefully:
    the recurrence continues on a zero vector, alphas/betas stay 0, and the
    spurious lam=0 nodes get weight 0 in :func:`nodes_weights` (a zero
    off-diagonal decouples e1 from the trailing block).
    """
    n, C = U.shape
    dt = U.dtype
    unorm2 = jnp.sum(jnp.square(U), axis=0)
    inv0 = jnp.where(unorm2 > 0, 1.0 / jnp.sqrt(jnp.where(unorm2 == 0, 1.0,
                                                          unorm2)), 0.0)
    v0 = U * inv0[None, :]

    def step(carry, _):
        v, v_prev, beta_prev, basis, j = carry
        w = mult(v)
        alpha = jnp.sum(w * v, axis=0)
        w = w - alpha[None, :] * v - beta_prev[None, :] * v_prev
        # two rounds of classical Gram-Schmidt against the stored basis
        # (columns > j are zero and project to nothing)
        for _ in range(2):
            proj = jnp.einsum("knc,nc->kc", basis, w, precision=jax.lax.Precision.HIGHEST)
            w = w - jnp.einsum("knc,kc->nc", basis, proj,
                               precision=jax.lax.Precision.HIGHEST)
        beta = jnp.sqrt(jnp.sum(jnp.square(w), axis=0))
        # breakdown guard: relative to the start norm so the threshold
        # tracks the problem's scale
        tiny = beta <= 1e-7 * jnp.sqrt(jnp.maximum(unorm2, 1e-30))
        beta = jnp.where(tiny, 0.0, beta)
        v_next = jnp.where(tiny[None, :], 0.0,
                           w / jnp.where(tiny, 1.0, beta)[None, :])
        basis = jax.lax.dynamic_update_slice(
            basis, v[None], (j, jnp.int32(0), jnp.int32(0)))
        return (v_next, v, beta, basis, j + 1), (alpha, beta)

    basis0 = jnp.zeros((k, n, C), dt)
    init = (v0, jnp.zeros_like(v0), jnp.zeros((C,), dt), basis0,
            jnp.int32(0))
    _, (alphas, betas) = jax.lax.scan(step, init, None, length=k)
    return alphas, betas, unorm2


def nodes_weights(alphas, betas):
    """(lam [C, k], wts [C, k]) from the Lanczos tridiagonals.

    lam are the Ritz values clamped to >= 0 (G is PSD; f32 roundoff can
    push a node epsilon-negative, which would flip the sign of
    1/(tau lam + gam2) for small gam2), wts the squared first components
    of the eigenvectors.
    """
    T = _tridiag(alphas.T, betas.T)
    lam, S = jnp.linalg.eigh(T)
    return jnp.maximum(lam, 0.0), jnp.square(S[:, 0, :])


def _tridiag(a, b):
    """Dense [C, k, k] symmetric tridiagonal from diagonals a [C, k] and
    off-diagonals b[:, :k-1]."""
    C, k = a.shape
    T = jnp.zeros((C, k, k), a.dtype)
    ii = jnp.arange(k)
    T = T.at[:, ii, ii].set(a)
    if k > 1:
        jj = jnp.arange(k - 1)
        T = T.at[:, jj, jj + 1].set(b[:, :k - 1])
        T = T.at[:, jj + 1, jj].set(b[:, :k - 1])
    return T


def build(mult, U, k: int) -> SlqBasis:
    """Run the Lanczos pass and extract the quadrature: the one-time setup
    (k block passes over the packed matrix; the [k, n, C] basis is freed
    on return)."""
    alphas, betas, unorm2 = lanczos_block(mult, U, k)
    lam, wts = nodes_weights(alphas, betas)
    return SlqBasis(lam=lam, wts=wts, unorm2=unorm2)


def quad_inv(basis: SlqBasis, tau, gam2):
    """[C] estimates of u_j^T (tau G_j + gam2 I)^{-1} u_j.

    ``tau``/``gam2`` broadcast against [C, k]: scalars apply one shift to
    every column; [C]-shaped arrays (or [C, 1]) give per-column shifts
    (the multi-trait case).
    """
    tau = jnp.reshape(jnp.asarray(tau), (-1, 1))
    gam2 = jnp.reshape(jnp.asarray(gam2), (-1, 1))
    return basis.unorm2 * jnp.sum(
        basis.wts / (tau * basis.lam + gam2), axis=-1)


def quad_ratio(basis: SlqBasis, tau, gam2):
    """[C] estimates of u_j^T G_j (tau G_j + gam2 I)^{-1} u_j (the noise-EM
    trace correction's bilinear form, updateNoisePrec vamp.cpp:907-916)."""
    tau = jnp.reshape(jnp.asarray(tau), (-1, 1))
    gam2 = jnp.reshape(jnp.asarray(gam2), (-1, 1))
    return basis.unorm2 * jnp.sum(
        basis.wts * basis.lam / (tau * basis.lam + gam2), axis=-1)
