"""LOO / LOCO association p-values over the packed genotype matrix.

Re-design of the reference's per-marker scalar loops (pvals_calc,
data.cpp:1108-1226; pvals_calc_LOCO, data.cpp:1235-1353) as blocked decode +
einsum passes.  Key algebra: with the marker-k contribution added back,

    y_mark = y_mod + s_k * value_k,   s_k = x1_k / sqrt(N),
    value_k = (a - mave_k) * msig_k * b * na,

every sufficient statistic expands into marker-linear contractions of the
decode (a, b) against the FIXED vectors {na, y_mod, y_mod^2} plus one
quadratic moment sum a^2*na — one pass over the packed matrix reproduces the
exact (sumx, sumsqx, sumxy, sumy, sumsqy, count) the reference accumulates
per marker.

Multiple estimates (the reference's nE batch, data.cpp:1155-1183) ride the
SAME decode pass: each extra estimate adds two contraction vectors
(y_mod_e, y_mod_e^2), so a 20-estimate ``--test-iter-range`` sweep costs one
``_moments`` pass + one wide ``axm`` pass instead of 20 re-streams.

The t-test itself is computed on the HOST in float64 REGARDLESS of the
engine dtype: the sufficient statistics are M-length, so the fold +
Student-t survival function (scipy.special.betainc — the double-precision
analog of the reference's boost students_t, utilities.cpp:321-334) cost
nothing, while the default f32 device dtype would flush two-sided p-values
below ~1e-38 to zero — fatal for biobank GWAS where top hits reach 1e-100s.

The device moments themselves are f64-grade at any N (the reference's
all-double accumulation, data.cpp:1108-1226): ``_moments`` splits the N
axis into chunks, contracts each chunk in f32 at precision HIGHEST, and
combines chunk partials with compensated two-sum — the (hi, lo) pairs fold
to float64 on host, so biobank-scale sums never see the plain-f32
~sqrt(N)*eps loss (pinned at N=327,680 in tests/test_pvals.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from gvamp.ops import matvec


@functools.partial(jax.jit, static_argnames=("block",))
def _moments(words, vecs, na, block=256):
    """One blocked decode pass with f64-grade N-axis accumulation.

    vecs: f[V, 4, Nb] contraction vectors. Returns six arrays
    (av_hi, av_lo, bv_hi, bv_lo, aa_hi, aa_lo) with hi+lo (folded in host
    float64 by :func:`_fold64`) = sum a * vecs[v], sum b * vecs[v], and
    sum a^2 * na.

    The reference accumulates every p-value moment in double
    (data.cpp:1108-1226).  In the default f32 engine dtype a plain einsum
    over N ~ 327k samples loses ~sqrt(N)*eps ~ 1e-4 relative (worse where
    default-precision f32 einsums use reduced-precision multiplies, such as
    TF32 on GPUs).  Here:
    within-chunk products/sums run in f32 at precision HIGHEST (true f32
    multiplies), the N axis is split into <=8192-slot chunks whose partials
    are accumulated across chunks with compensated two-sum — error
    ~ eps/sqrt(C) relative, pinned at production N by tests/test_pvals.py.
    """
    Nw, M = words.shape
    dt = vecs.dtype
    V, _, Nb = vecs.shape
    nc = matvec.nb_chunk(Nb)
    C = Nb // nc
    hp = jax.lax.Precision.HIGHEST
    vc = vecs.reshape(V, 4, C, nc)
    nac = na.reshape(4, C, nc)

    def body(i, acc):
        avh, avl, bvh, bvl, aah, aal = acc
        blk = jax.lax.dynamic_slice(words, (0, i * block), (Nw, block))
        a, b = matvec.decode_planar_dense(blk, dt)  # [4, Nb, blk]
        ac = a.reshape(4, C, nc, block)
        bc = b.reshape(4, C, nc, block)
        pav = jnp.einsum("kcnm,vkcn->cvm", ac, vc, precision=hp)
        pbv = jnp.einsum("kcnm,vkcn->cvm", bc, vc, precision=hp)
        paa = jnp.einsum("kcnm,kcn->cm", ac * ac, nac, precision=hp)

        def fold(carry, part):
            (ah, al), (bh, bl), (qh, ql) = carry
            pa, pb, pq = part
            ah, al = matvec.two_sum(ah, al, pa)
            bh, bl = matvec.two_sum(bh, bl, pb)
            qh, ql = matvec.two_sum(qh, ql, pq)
            return ((ah, al), (bh, bl), (qh, ql)), None

        zv = jnp.zeros((V, block), dt)
        zm = jnp.zeros((block,), dt)
        ((ah, al), (bh, bl), (qh, ql)), _ = jax.lax.scan(
            fold, ((zv, zv), (zv, zv), (zm, zm)), (pav, pbv, paa))
        j = i * block
        return (jax.lax.dynamic_update_slice(avh, ah, (0, j)),
                jax.lax.dynamic_update_slice(avl, al, (0, j)),
                jax.lax.dynamic_update_slice(bvh, bh, (0, j)),
                jax.lax.dynamic_update_slice(bvl, bl, (0, j)),
                jax.lax.dynamic_update_slice(aah, qh, (j,)),
                jax.lax.dynamic_update_slice(aal, ql, (j,)))

    zrow = (words[0, :] * np.uint32(0)).astype(dt)
    z2 = jnp.broadcast_to(zrow, (V, M))
    return jax.lax.fori_loop(0, M // block, body,
                             (z2, z2, z2, z2, zrow, zrow))


def _fold64(hi, lo) -> np.ndarray:
    """Host float64 fold of a compensated (hi, lo) device pair."""
    from gvamp import dist
    return (dist.to_numpy(hi).astype(np.float64)
            + dist.to_numpy(lo).astype(np.float64))


def _student_t_sf2_np(t: np.ndarray, df: np.ndarray) -> np.ndarray:
    """Two-sided Student-t p-value in float64 (reference linear_reg1d_pvals,
    utilities.cpp:321-334, whose boost students_t is double-precision).

    p = I_{df/(df+t^2)}(df/2, 1/2) — regularized incomplete beta."""
    from scipy.special import betainc
    t = np.asarray(t, np.float64)
    df = np.asarray(df, np.float64)
    x = df / (df + t * t)
    return betainc(df / 2.0, 0.5, x)


def _reg1d_pvals(sumx, sumsqx, sumxy, sumy, sumsqy, n):
    """1-D regression t-test in HOST float64 (all inputs np.float64).

    Matches the reference's double-precision linear_reg1d_pvals
    (utilities.cpp:321-334) even when the device moments were f32: the
    rxy -> t -> betainc chain is where f32 loses GWAS-scale p-values
    (underflow below ~1e-38, ~1e-7 precision), so it runs in f64 here."""
    # padded/degenerate markers (n = 0) divide to nan and fold to p = 1
    with np.errstate(divide="ignore", invalid="ignore"):
        s2y = (sumsqy - sumy * sumy / n) / (n - 1)
        s2x = (sumsqx - sumx * sumx / n) / (n - 1)
        sxy = (sumxy - sumx * sumy / n) / (n - 1)
        rxy = sxy / np.sqrt(s2x * s2y)
        t = rxy * np.sqrt((n - 2) / np.maximum(1.0 - rxy * rxy, 1e-300))
    p = _student_t_sf2_np(np.where(np.isfinite(t), t, 0.0), np.maximum(n - 2, 1.0))
    return np.where(np.isfinite(t), p, 1.0)


def _shared_stats(geno, a_na, b_na, aa):
    """(sumx, sumsqx, b_na) in host f64 from the na-contraction moments
    (all inputs already folded to np.float64 by :func:`_fold64`)."""
    from gvamp import dist
    mave = dist.to_numpy(geno.mave).astype(np.float64)
    msig = dist.to_numpy(geno.msig).astype(np.float64)
    sumx = msig * (a_na - mave * b_na)
    sumsqx = msig**2 * (aa - 2 * mave * a_na + mave**2 * b_na)
    return sumx, sumsqx, b_na, mave, msig


def loo_pvals_multi(geno, z1s_planar, x1s_internal):
    """LOO p-values for E estimates in ONE decode pass (reference
    pvals_calc's nE batch, data.cpp:1108-1226, nE loop at 1155-1183).

    z1s_planar: [4, Nb, E] forward products A @ x1_e;
    x1s_internal: [Mpad, E] internal-scale estimates.
    Returns float64[E, M] two-sided p-values.
    """
    from gvamp import dist
    E = int(x1s_internal.shape[1])
    na = geno.na_planar
    y = geno.filter_pheno()
    block = min(256, geno.Mpad)
    # vecs = [na, yc_1, yc_1^2, ..., yc_E, yc_E^2]
    ycs = [(y - z1s_planar[..., e]) * na for e in range(E)]
    vecs = jnp.stack([na.astype(geno.dtype)]
                     + [v for yc in ycs for v in (yc, yc * yc)])
    av_hi, av_lo, bv_hi, bv_lo, aa_hi, aa_lo = _moments(
        geno.words, vecs, na.astype(geno.dtype), block=block)
    avh = _fold64(av_hi, av_lo)
    bvh = _fold64(bv_hi, bv_lo)
    sumx, sumsqx, b_na, mave, msig = _shared_stats(
        geno, avh[0], bvh[0], _fold64(aa_hi, aa_lo))
    x1h = dist.to_numpy(x1s_internal).astype(np.float64)
    out = np.ones((E, geno.M), dtype=np.float64)
    for e in range(E):
        a_y, b_y, b_yy = avh[1 + 2 * e], bvh[1 + 2 * e], bvh[2 + 2 * e]
        vy = msig * (a_y - mave * b_y)       # sum value * y_target
        s = x1h[:, e] / np.sqrt(geno.N)      # marker-k add-back scale
        sumxy = vy + s * sumsqx
        sumy = b_y + s * sumx
        sumsqy = b_yy + 2 * s * vy + s**2 * sumsqx
        out[e] = _reg1d_pvals(sumx, sumsqx, sumxy, sumy, sumsqy,
                              b_na)[: geno.M]
    return out


def loo_pvals(geno, z1_planar, x1_internal):
    """LOO p-values (reference pvals_calc, data.cpp:1108-1226).

    z1_planar: A @ x1 (planar); x1_internal: internal-scale estimate [Mpad].
    Returns float64[M] two-sided p-values.
    """
    return loo_pvals_multi(geno, z1_planar[..., None],
                           x1_internal[:, None])[0]


def loco_pvals(geno, z1_planar, x1_internal, chroms, predictor_cb=None):
    """LOCO p-values (reference pvals_calc_LOCO, data.cpp:1235-1353).

    chroms: int[M] chromosome per local marker ('X' mapped to 23).  For each
    chromosome the genetic predictor y_chrom = A (x1 * 1[ch]) is one masked
    ``ax`` pass (replacing the reference's per-marker accumulation +
    MPI_Iallreduce, data.cpp:1285-1289); y_corr = y_mod + y_chrom feeds the
    same sufficient statistics, keeping only ch's markers.  The t-test runs
    on host in float64 (see module docstring).

    predictor_cb(ch, y_chrom_planar) is invoked per chromosome (for the
    reference's *_LOCO_chr_N.csv dumps).
    """
    from gvamp import dist
    y = geno.filter_pheno()
    na = geno.na_planar
    ym = (y - z1_planar) * na
    chroms_pad = np.zeros(geno.Mpad, dtype=np.int32)
    chroms_pad[: geno.M] = np.asarray(chroms)
    pvals = np.ones(geno.Mpad, dtype=np.float64)
    block = min(256, geno.Mpad)
    present = [ch for ch in range(1, 24) if (chroms_pad == ch).any()]
    if not present:
        return pvals[: geno.M]

    # ONE wide pass builds every chromosome's genetic predictor
    # (replacing the reference's per-chromosome accumulation +
    # MPI_Iallreduce, data.cpp:1285-1289)
    masks = np.stack([(chroms_pad == ch).astype(np.float64) for ch in present],
                     axis=1)
    y_chroms = geno.axm(x1_internal[:, None] * jnp.asarray(masks, geno.dtype))
    if predictor_cb is not None:
        for j, ch in enumerate(present):
            predictor_cb(ch, y_chroms[..., j])

    # ONE blocked decode pass accumulates all chromosomes' sufficient
    # statistics: vecs = [na, yc_1, yc_1^2, yc_2, yc_2^2, ...]
    ycs = [(ym + y_chroms[..., j]) * na for j in range(len(present))]
    vecs = jnp.stack([na.astype(geno.dtype)]
                     + [v for yc in ycs for v in (yc, yc * yc)])
    av_hi, av_lo, bv_hi, bv_lo, aa_hi, aa_lo = _moments(
        geno.words, vecs, na.astype(geno.dtype), block=block)
    avh = _fold64(av_hi, av_lo)
    bvh = _fold64(bv_hi, bv_lo)
    sumx, sumsqx, b_na, mave, msig = _shared_stats(
        geno, avh[0], bvh[0], _fold64(aa_hi, aa_lo))
    s = dist.to_numpy(x1_internal).astype(np.float64) / np.sqrt(geno.N)

    for j, ch in enumerate(present):
        a_y, b_y, b_yy = avh[1 + 2 * j], bvh[1 + 2 * j], bvh[2 + 2 * j]
        vy = msig * (a_y - mave * b_y)
        sumxy = vy + s * sumsqx
        sumy = b_y + s * sumx
        sumsqy = b_yy + 2 * s * vy + s**2 * sumsqx
        p = _reg1d_pvals(sumx, sumsqx, sumxy, sumy, sumsqy, b_na)
        sel = chroms_pad == ch
        pvals[sel] = p[sel]

    return pvals[: geno.M]
