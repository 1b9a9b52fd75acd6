"""Packed-genotype matrix products: one GPU kernel family and its plain reference.

The standardized design matrix is, elementwise (reference data.cpp:891-921,
728-801):

    A[n, m] = (g_nm - mave_m) * nonmiss_nm * msig_m * scale,   scale = 1/sqrt(N)

with ``g`` the 2-bit dosage decode and ``nonmiss`` zero at the PLINK "01"
missing code.  Phenotype-NA masking (na_lut in the reference) is applied by
callers: ``ax`` output is multiplied by the planar NA mask and ``atx`` inputs
are pre-masked, matching the reference's scalar-path semantics
(data.cpp:959-989 applies na_lut inside Ax; ATx relies on filtered inputs,
data.cpp:728-801 + vamp.cpp:219).

Storage layout: packed words are kept **word-major**, ``uint32[Nw, M]``,
markers contiguous.  Byte ``j`` of word-row ``i`` is planar row ``4i+j`` and
bit-pair ``k`` of a byte is plane ``k`` (:class:`gvamp.ops.layout.
PlanarLayout`).  Decode is SWAR arithmetic on u32 words, the arithmetic
replacement for the reference's 1024-entry gather tables (dotp_lut.hpp).

Both implementations compute, in planar layout, for B right-hand columns:

    axm : z[k, p, j] = sum_m a_k[p, m] * W[m, j] - b_k[p, m] * U[m, j]
    atxm: av[m, j]   = sum_{k,p} a_k[p, m] * V[k, p, j]   (bv likewise on b)

with W = msig*X*scale and U = mave*W folded by the caller.  With
``complete=True`` (no missing call among real entries, the imputed-data
case) b is taken as 1: ``axm`` subtracts the column sums of U and ``atxm``
returns the column sums of V as ``bv`` (shape [B]).  Rows of padded
individuals and columns of padded markers are then undefined; every caller
masks them (na_planar on ax outputs and atx inputs, msig = 0 on pad markers).

* ``axm_xla`` / ``atxm_xla``: the plain reference.  A marker-blocked loop
  decodes a bounded block of markers to dense planes and contracts it at
  ``Precision.HIGHEST``, so memory stays bounded at biobank N.  It serves
  ``--backend xla``, ``--dtype float64`` and the tests' oracle.
* ``axm_pallas`` / ``atxm_pallas``: one Pallas kernel family on the Triton
  route.  Each program loads a tile of packed words once, decodes it in
  registers and contracts it on the int8 tensor cores against radix-127
  digits of the right-hand side, so the decoded planes never reach device
  memory.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_M1 = np.uint32(0x01010101)
_M3 = np.uint32(0x03030303)
_M5 = np.uint32(0x55555555)
PAD_WORD = 0x55555555  # four-byte run of the all-missing pad byte


def _swar(words, k: int):
    """SWAR decode of bit-pair plane k: u32 words -> (a, b) packed u32 bytes.

    Per byte lane: a = {2,0,1,0}[code], b = {1,0,1,1}[code] — the arithmetic
    replacement for the reference's dotp_lut_a / dotp_lut_b gather tables
    (dotp_lut.hpp:3,1030).
    """
    c = (words >> np.uint32(2 * k)) & _M3
    lo = c & _M1
    hi = (c >> np.uint32(1)) & _M1
    notlo = lo ^ _M1
    a = (notlo << np.uint32(1)) - (hi & notlo)
    b = hi | notlo
    return a, b


def two_sum(hi, lo, p):
    """Compensated accumulation (Knuth two-sum): (hi, lo) += p with the
    rounding error of the hi update captured exactly in lo.  hi + lo folded
    at higher precision recovers the f64-grade sum — the float32 stand-in
    for the reference's all-double sufficient-statistic accumulators
    (data.cpp:446-483, 1108-1226)."""
    s = hi + p
    bp = s - hi
    err = (hi - (s - bp)) + (p - bp)
    return s, lo + err


def nb_chunk(Nb: int, target: int = 8192) -> int:
    """Largest chunk length <= target dividing Nb (PlanarLayout guarantees
    Nb is a multiple of 128) — the N-axis split for compensated moments."""
    q = Nb // 128
    d = max(dd for dd in range(1, min(q, target // 128) + 1) if q % dd == 0)
    return 128 * d


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pad_to(x, axis: int, size: int, value=0):
    if x.shape[axis] == size:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, size - x.shape[axis])
    return jnp.pad(x, pad, constant_values=value)


# --------------------------------------------------------------------------
# Plain reference: marker-blocked decode-and-contract in XLA
# --------------------------------------------------------------------------


def decode_planar_dense(words: jax.Array, dtype=jnp.float32):
    """uint32[Nw, M] -> (a, b) dtype[4, Nb, M] planar-dense decode."""
    nw, m = words.shape
    a_pl, b_pl = [], []
    for k in range(4):
        a, b = _swar(words, k)
        # byte j of word-row i -> row 4i+j (little-endian)
        a8 = jax.lax.bitcast_convert_type(a.T, jnp.uint8)  # [M, Nw, 4]
        b8 = jax.lax.bitcast_convert_type(b.T, jnp.uint8)
        a_pl.append(a8.reshape(m, 4 * nw).T)
        b_pl.append(b8.reshape(m, 4 * nw).T)
    return (
        jnp.stack(a_pl).astype(dtype),
        jnp.stack(b_pl).astype(dtype),
    )


# decoded-plane budget of one reference block: 2 planes x [4, Nb, block]
_REF_BLOCK_BYTES = 1 << 28


def ref_block(nw: int, m: int, itemsize: int = 4) -> int:
    """Markers per reference block: a power of two whose decoded planes stay
    near _REF_BLOCK_BYTES, at most 512 and no wider than m needs."""
    cap = max(1, _REF_BLOCK_BYTES // (2 * 16 * nw * itemsize))
    block = 1
    while block * 2 <= min(cap, 512) and block < m:
        block *= 2
    return block


def _ref_setup(words, cols, dtype):
    nw, m = words.shape
    dt = jnp.dtype(dtype or jnp.float32)
    block = ref_block(nw, m, dt.itemsize)
    mp = _round_up(m, block)
    words = _pad_to(words, 1, mp, PAD_WORD)
    cols = [_pad_to(c.astype(dt), 0, mp) for c in cols]
    return words, cols, dt, block, mp // block


def axm_xla(words, W, U, complete: bool = False, dtype=None):
    """Reference block product z[4, Nb, B] = A_a W - A_b U (see module doc)."""
    nw = words.shape[0]
    B = W.shape[1]
    wp, (Wp, Up), dt, block, nblk = _ref_setup(words, [W, U], dtype)
    hp = jax.lax.Precision.HIGHEST

    def body(i, z):
        g = jax.lax.dynamic_slice(wp, (0, i * block), (nw, block))
        a, b = decode_planar_dense(g, dt)
        w = jax.lax.dynamic_slice(Wp, (i * block, 0), (block, B))
        z = z + jnp.einsum("knm,mj->knj", a, w, precision=hp)
        if not complete:
            u = jax.lax.dynamic_slice(Up, (i * block, 0), (block, B))
            z = z - jnp.einsum("knm,mj->knj", b, u, precision=hp)
        return z

    z = jax.lax.fori_loop(0, nblk, body, jnp.zeros((4, 4 * nw, B), dt))
    if complete:
        z = z - jnp.sum(U.astype(dt), axis=0)
    return z


def atxm_xla(words, V, complete: bool = False, dtype=None):
    """Reference transposed product (av[M, B], bv) (see module doc)."""
    nw, m = words.shape
    B = V.shape[2]
    wp, _, dt, block, nblk = _ref_setup(words, [], dtype)
    v = V.astype(dt)
    hp = jax.lax.Precision.HIGHEST

    def body(i, acc):
        av, bv = acc
        g = jax.lax.dynamic_slice(wp, (0, i * block), (nw, block))
        a, b = decode_planar_dense(g, dt)
        av = jax.lax.dynamic_update_slice(
            av, jnp.einsum("knm,knj->mj", a, v, precision=hp), (i * block, 0))
        if not complete:
            bv = jax.lax.dynamic_update_slice(
                bv, jnp.einsum("knm,knj->mj", b, v, precision=hp),
                (i * block, 0))
        return av, bv

    zero = jnp.zeros((nblk * block, B), dt)
    av, bv = jax.lax.fori_loop(0, nblk, body, (zero, zero))
    if complete:
        return av[:m], jnp.sum(v, axis=(0, 1))
    return av[:m], bv[:m]


# --------------------------------------------------------------------------
# GPU kernel family (Pallas, Triton route)
# --------------------------------------------------------------------------
#
# Decode.  One pass of SWAR arithmetic turns a packed word into 2-bit fields
# holding the dosage a (and, on the missing-call path, the indicator b) of
# all 16 genotypes; field (k, j) sits at bit 8j + 2k.  Extracting it is a
# shift, a mask and a narrowing to int8.  On complete data
# a = popcount(~code), four word operations for 16 genotypes.
#
# Grid.  Blocks run in parallel in no order, so the contraction axis is a
# loop inside each program and nothing carries over between programs.  axm
# programs own a tile of word rows; when those are too few to fill the card
# (small N), the marker axis is split across programs too and the partial
# sums are added in a second pass (plain adds, so results are run-to-run
# deterministic).  atxm programs own a tile of markers.
#
# Arithmetic.  Genotypes {0,1,2} are exact in int8, so the kernels multiply
# them on the int8 tensor cores against _NDIG radix-127 int8 digits of the
# float32 right-hand side (int32 accumulation is exact; the digits are
# folded outside).  Float32 FMAs in registers ran 3-5x (B=1) to 30-40x
# (B=32) slower on an H100 (PERF.md), since the decode already fills the
# integer and conversion units.

_NDIG = 4
# Worst-case digit-quantization error of a length-M dot against the integer
# LHS: |err| <= M * 2 * colmax / (2 * 127^NDIG) ~ M * colmax * 3.8e-9 at
# NDIG=4 (all-same-sign adversarial inputs; random signs give
# ~sqrt(M) * colmax * 3.8e-9).  On the missing-call path W and -U share one per-column
# scale (|U| <= 2|W|), which costs at most one bit of the 28.

# programs to aim for: a few waves over the 132 SMs of an H100
_GRID_TARGET = 512
# widest digit block one axm program accumulates (16 (k, j) accumulators of
# [tnw, C] int32 live in registers); wider right-hand sides are chunked
_AX_C_MAX = 64
_AT_C_MAX = 128


def _fields(g, complete: bool):
    """u32 words -> 2-bit fields of (a, b); b is None when complete."""
    if complete:
        ng = ~g
        return (ng & _M5) + ((ng >> np.uint32(1)) & _M5), None
    lo = g & _M5
    hi = (g >> np.uint32(1)) & _M5
    notlo = lo ^ _M5
    return (notlo << np.uint32(1)) - (hi & notlo), hi | notlo


def _extract(f, shift: int):
    """Field at ``shift`` of every word as int8."""
    x = (f >> np.uint32(shift)) & np.uint32(3) if shift else f & np.uint32(3)
    return x.astype(jnp.int8)


def _dot(a, b):
    return jax.lax.dot_general(a, b, (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)


def _ax_kernel(*refs, tm: int, steps: int, complete: bool):
    if complete:
        g_ref, w_ref, o_ref = refs
    else:
        g_ref, w_ref, u_ref, o_ref = refs
    tnw = g_ref.shape[0]
    C = w_ref.shape[1]

    def body(t, accs):
        m0 = pl.multiple_of(t * tm, tm)
        fa, fb = _fields(g_ref[:, pl.ds(m0, tm)], complete)
        w = w_ref[pl.ds(m0, tm), :]
        if not complete:
            u = u_ref[pl.ds(m0, tm), :]
        out = []
        for k in range(4):
            for j in range(4):
                s = 8 * j + 2 * k
                acc = accs[4 * k + j] + _dot(_extract(fa, s), w)
                if not complete:
                    acc = acc + _dot(_extract(fb, s), u)
                out.append(acc)
        return tuple(out)

    accs = jax.lax.fori_loop(0, steps, body,
                             (jnp.zeros((tnw, C), jnp.int32),) * 16)
    for k in range(4):
        for j in range(4):
            o_ref[k, j] = accs[4 * k + j]


def _at_kernel(*refs, tnw: int, steps: int, complete: bool):
    if complete:
        g_ref, v_ref, oa_ref = refs
    else:
        g_ref, v_ref, oa_ref, ob_ref = refs
    tm = g_ref.shape[1]
    C = v_ref.shape[2]

    def body(t, accs):
        i0 = pl.multiple_of(t * tnw, tnw)
        fa, fb = _fields(g_ref[pl.ds(i0, tnw), :], complete)
        acc_a, acc_b = accs
        for k in range(4):
            for j in range(4):
                s = 8 * j + 2 * k
                vt = v_ref[k, j, :, pl.ds(i0, tnw)]          # [C, tnw]
                acc_a = acc_a + _dot(vt, _extract(fa, s))
                if not complete:
                    acc_b = acc_b + _dot(vt, _extract(fb, s))
        return acc_a, acc_b

    zero = jnp.zeros((C, tm), jnp.int32)
    acc_a, acc_b = jax.lax.fori_loop(0, steps, body, (zero, zero))
    oa_ref[...] = acc_a
    if not complete:
        ob_ref[...] = acc_b


def _digit_scale(X, axis: int):
    m = jnp.max(jnp.abs(X.astype(jnp.float32)), axis=axis)
    return jnp.where(m == 0, 1.0, m) / 127.0


def _digits(X, s0, axis: int):
    """f32 X -> int8 digits stacked digit-major along ``axis`` (which holds
    the B columns; ``s0`` broadcasts against X)."""
    r = X.astype(jnp.float32)
    s = s0
    digs = []
    for _ in range(_NDIG):
        d = jnp.round(r / s)
        digs.append(d.astype(jnp.int8))
        r = r - d * s
        s = s / 127.0
    return jnp.concatenate(digs, axis=axis)


def _fold(Z, s0, B: int, axis: int):
    """int32 digit products, digit-major along ``axis`` -> f32 with B there."""
    Z = jnp.moveaxis(Z, axis, -1).astype(jnp.float32)
    out = Z[..., :B] * s0
    scale = s0
    for d in range(1, _NDIG):
        scale = scale / 127.0
        out = out + Z[..., d * B:(d + 1) * B] * scale
    return jnp.moveaxis(out, -1, axis)


def _width(B: int) -> int:
    """Padded digit width: a power of two, >= 16 for the tensor cores."""
    c = 16
    while c < _NDIG * B:
        c *= 2
    return c


def _fit(n: int, t: int, lo: int) -> int:
    """Largest power-of-two tile in [lo, t] dividing n (else lo: pad)."""
    while t > lo and n % t:
        t //= 2
    return t


def _chunked(call, B: int, bmax: int, axis: int):
    """Apply call(lo, hi) over column chunks of at most bmax and concatenate."""
    if B <= bmax:
        return call(0, B)
    outs = [call(lo, min(lo + bmax, B)) for lo in range(0, B, bmax)]
    return jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs, axis=axis), *outs)


# (tnw, tm, num_warps, num_stages) per padded digit width C, from a sweep on
# an H100 at N=327,680 x M=131,072 (PERF.md).  axm keeps 16 [tnw, C] int32
# accumulators live, so its row tile shrinks as C grows.
_AX_TILES = {16: (64, 64, 4, 3), 32: (64, 32, 4, 2), 64: (16, 64, 4, 2)}
# atxm: (complete, missing) tiles per C
_AT_TILES = {16: ((128, 64, 4, 2), (32, 64, 4, 3)),
             32: ((32, 64, 4, 2),) * 2,
             64: ((64, 64, 8, 2),) * 2,
             128: ((32, 64, 4, 2),) * 2}


@functools.partial(jax.jit, static_argnames=("complete", "interpret",
                                             "tiles"))
def axm_pallas(words, W, U, complete: bool = False, interpret: bool = False,
               tiles=None):
    """Kernel block product z[4, Nb, B] = A_a W - A_b U (see module doc).

    ``interpret=True`` runs the kernel in the Pallas interpreter (tests on
    a host without a GPU); ``tiles`` overrides (tnw, tm, warps, stages)."""
    B = W.shape[1]
    bmax = _AX_C_MAX // _NDIG
    if B > bmax:
        return _chunked(
            lambda lo, hi: axm_pallas(words, W[:, lo:hi], U[:, lo:hi],
                                      complete, interpret, tiles),
            B, bmax, 2)
    Nw, M = words.shape
    C = _width(B)
    tnw, tm, warps, stages = tiles or _AX_TILES[C]
    # tiles shrink to divisors where they can: padding copies the matrix
    tnw, tm = _fit(Nw, tnw, 16), _fit(M, tm, 32)
    nwp = _round_up(Nw, tnw)
    mp = _round_up(M, tm)
    # split markers across programs until the grid fills the card
    S = 1
    while (nwp // tnw) * S < _GRID_TARGET and (mp // tm) % (2 * S) == 0 \
            and mp // (2 * S) >= 4 * tm:
        S *= 2
    words_p = _pad_to(_pad_to(words, 0, nwp, PAD_WORD), 1, mp, PAD_WORD)
    W32 = _pad_to(W.astype(jnp.float32), 0, mp)
    s0 = _digit_scale(W32, 0)
    rhs = [W32]
    if not complete:
        # W and -U share one digit scale, so both products feed one int32
        # accumulator per output tile
        mU32 = _pad_to(-U.astype(jnp.float32), 0, mp)
        s0 = jnp.maximum(s0, _digit_scale(mU32, 0))
        rhs.append(mU32)
    rhs = [_pad_to(_digits(r, s0, 1), 1, C) for r in rhs]
    mc = mp // S
    out = pl.pallas_call(
        functools.partial(_ax_kernel, tm=tm, steps=mc // tm,
                          complete=complete),
        grid=(nwp // tnw, S),
        in_specs=[pl.BlockSpec((tnw, mc), lambda i, s: (i, s))]
        + [pl.BlockSpec((mc, C), lambda i, s: (s, 0))] * len(rhs),
        out_specs=pl.BlockSpec((None, 4, 4, tnw, C),
                               lambda i, s: (s, 0, 0, i, 0)),
        out_shape=jax.ShapeDtypeStruct((S, 4, 4, nwp, C), jnp.int32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=warps,
                                             num_stages=stages),
        interpret=interpret,
        name="gvamp_axm_complete" if complete else "gvamp_axm",
    )(words_p, *rhs)
    z = out[0]
    for s in range(1, S):      # second pass over the marker split, in order
        z = z + out[s]
    # (k, j, i, c) -> (k, 4i + j, c)
    z = jnp.transpose(z, (0, 2, 1, 3)).reshape(4, 4 * nwp, C)[:, :4 * Nw]
    z = _fold(z, s0, B, 2)
    if complete:
        z = z - jnp.sum(U.astype(jnp.float32), axis=0)
    return z


@functools.partial(jax.jit, static_argnames=("complete", "interpret",
                                             "tiles"))
def atxm_pallas(words, V, complete: bool = False, interpret: bool = False,
                tiles=None):
    """Kernel transposed product (av[M, B], bv) (see module doc)."""
    B = V.shape[2]
    bmax = _AT_C_MAX // _NDIG
    if B > bmax:
        return _chunked(
            lambda lo, hi: atxm_pallas(words, V[:, :, lo:hi], complete,
                                       interpret, tiles),
            B, bmax, -1)
    Nw, M = words.shape
    C = _width(B)
    tnw, tm, warps, stages = tiles or _AT_TILES[C][0 if complete else 1]
    tnw, tm = _fit(Nw, tnw, 32), _fit(M, tm, 32)
    nwp = _round_up(Nw, tnw)
    mp = _round_up(M, tm)
    words_p = _pad_to(_pad_to(words, 0, nwp, PAD_WORD), 1, mp, PAD_WORD)
    # V[k, 4i + j, b] -> digits of Vt[k, j, b, i]: per (k, j) a [C, Nw]
    # left operand
    V32 = V.astype(jnp.float32)
    s0 = _digit_scale(V32, (0, 1))
    Vt = jnp.transpose(V32.reshape(4, Nw, 4, B), (0, 2, 3, 1))
    lhs = _pad_to(_pad_to(_digits(Vt, s0[:, None], 2), 2, C), 3, nwp)
    n_out = 1 if complete else 2
    outs = pl.pallas_call(
        functools.partial(_at_kernel, tnw=tnw, steps=nwp // tnw,
                          complete=complete),
        grid=(mp // tm,),
        in_specs=[pl.BlockSpec((nwp, tm), lambda m: (0, m)),
                  pl.BlockSpec((4, 4, C, nwp), lambda m: (0, 0, 0, 0))],
        out_specs=[pl.BlockSpec((C, tm), lambda m: (0, m))] * n_out,
        out_shape=[jax.ShapeDtypeStruct((C, mp), jnp.int32)] * n_out,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=warps,
                                             num_stages=stages),
        interpret=interpret,
        name="gvamp_atxm_complete" if complete else "gvamp_atxm",
    )(words_p, lhs)

    def finish(o):
        return _fold(o[:, :M], s0, B, 0).T

    av = finish(outs[0])
    if complete:
        return av, jnp.sum(V32, axis=(0, 1))
    return av, finish(outs[1])
