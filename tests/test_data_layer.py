"""Data-layer tests: decode LUT semantics, stats, matvecs vs dense oracle.

Covers the reference's C1 (LUT decode), C3 (phenotype standardizer),
C6 (marker stats), C7 (people stats), C8/C9 (ATx/Ax) — SURVEY.md 2.1.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from gvamp.data import GenoBed, GenoDense
from gvamp.io import plink
from gvamp.ops.layout import PlanarLayout, CODE_TO_DOSAGE, CODE_TO_NONMISS

from helpers import KERNEL, DenseOracle, random_dataset


def make_bed(codes):
    M, N = codes.shape
    lay = PlanarLayout.create(N)
    by = np.zeros((M, lay.mbytes), dtype=np.uint8)
    for k in range(4):
        cols = np.arange(k, N, 4)
        by[:, (cols - k) // 4] |= (codes[:, cols].astype(np.uint8) << (2 * k))
    return by


def test_decode_all_256_bytes():
    """Every possible packed byte decodes to the reference LUT values."""
    lay = PlanarLayout.create(4)
    by = np.arange(256, dtype=np.uint8).reshape(256, 1)
    dose, nm = lay.dense_from_words(lay.pack_words(by))
    for byte in range(256):
        for k in range(4):
            code = (byte >> (2 * k)) & 3
            assert dose[byte, k] == CODE_TO_DOSAGE[code]
            assert nm[byte, k] == CODE_TO_NONMISS[code]


@pytest.mark.parametrize("N,M", [(61, 33), (256, 64), (1000, 40)])
def test_stats_and_matvec_vs_dense(N, M):
    rng = np.random.default_rng(42)
    codes, y = random_dataset(rng, N, M)
    oracle = DenseOracle(codes, y)
    geno = GenoBed.from_arrays(make_bed(codes), y, N=N, dtype=jnp.float64)

    assert geno.nonas == oracle.nonas
    np.testing.assert_allclose(geno.intercept, oracle.intercept, rtol=1e-12)
    np.testing.assert_allclose(geno.scale, oracle.scale, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(geno.mave)[:M], oracle.mave, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(geno.msig)[:M], oracle.msig, rtol=1e-10)

    x = rng.normal(size=geno.Mpad)
    x_np = np.array(x)
    x_np[M:] = 0
    z = geno.deplanarize(geno.ax(jnp.asarray(x)))
    np.testing.assert_allclose(z, oracle.ax(x_np[:M]), rtol=1e-8, atol=1e-10)

    v = rng.normal(size=N)
    r = np.asarray(geno.atx(geno.planarize(v)))
    np.testing.assert_allclose(r[:M], oracle.atx(v), rtol=1e-8, atol=1e-10)
    assert np.all(r[M:] == 0)


def test_adjointness():
    rng = np.random.default_rng(3)
    codes, y = random_dataset(rng, 130, 50)
    geno = GenoBed.from_arrays(make_bed(codes), y, N=130, dtype=jnp.float64)
    x = jnp.asarray(rng.normal(size=geno.Mpad) * np.asarray(geno.m_mask))
    v = geno.planarize(rng.normal(size=130))
    lhs = float(jnp.vdot(geno.ax(x), v * geno.na_planar))
    rhs = float(jnp.vdot(x, geno.atx(v)))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-10)


def test_phen_scaling_reference_semantics():
    """Phenotype is scaled but NOT centered; NA slots zeroed (data.cpp:171-186)."""
    y = np.array([1.0, 2.0, np.nan, 4.0, 10.0])
    codes = np.zeros((3, 5), dtype=np.uint8)
    geno = GenoBed.from_arrays(make_bed(codes), y, N=5, dtype=jnp.float64)
    nonas = 4
    avg = np.nanmean(y)
    sqn = np.sqrt((nonas - 1) / np.nansum((y - avg) ** 2))
    got = geno.deplanarize(geno.filter_pheno())
    np.testing.assert_allclose(got, np.where(np.isnan(y), 0.0, y * sqn), rtol=1e-12)


def test_people_statistics():
    rng = np.random.default_rng(7)
    N, M = 97, 29
    codes, y = random_dataset(rng, N, M)
    oracle = DenseOracle(codes, y)
    geno = GenoBed.from_arrays(make_bed(codes), y, N=N, dtype=jnp.float64)
    mave_p, msig_p, numb_p = (geno.deplanarize(t) for t in geno.compute_people_statistics())

    # dense reference (data.cpp:577-633)
    val = (oracle.a - oracle.mave[:, None]) * oracle.msig[:, None] * oracle.b * oracle.na[None, :]
    numb = (oracle.b * oracle.na[None, :]).sum(0)
    sum_v = val.sum(0)
    sumsq = (val**2).sum(0)
    mean = np.where(oracle.na > 0, sum_v / np.maximum(numb, 1), 0.0)
    prec = np.where(oracle.na > 0, (numb - 1) / (sumsq - numb * mean**2), 0.0)
    np.testing.assert_allclose(numb_p, numb * oracle.na, rtol=1e-8)
    np.testing.assert_allclose(mave_p, mean, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(msig_p, np.sqrt(np.maximum(prec, 0)), rtol=1e-5, atol=1e-8)


def test_bed_file_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    codes, y = random_dataset(rng, 37, 11)
    p = str(tmp_path / "t.bed")
    plink.write_bed(p, codes)
    slab = plink.read_bed_slab(p, 37, 11, 0)
    np.testing.assert_array_equal(slab, make_bed(codes))
    sub = plink.read_bed_slab(p, 37, 4, 5)
    np.testing.assert_array_equal(sub, make_bed(codes)[5:9])


def test_dense_container_matches_bed_when_no_missing():
    """GenoDense on the decoded dosage matrix == GenoBed (no genotype NAs)."""
    rng = np.random.default_rng(5)
    N, M = 64, 24
    codes = rng.choice([0, 2, 3], size=(M, N)).astype(np.uint8)
    y = rng.normal(size=N)
    dose = CODE_TO_DOSAGE[codes]
    bed = GenoBed.from_arrays(make_bed(codes), y, N=N, dtype=jnp.float64)
    dense = GenoDense.from_arrays(dose, y, N=N, dtype=jnp.float64)
    x = rng.normal(size=max(bed.Mpad, dense.Mpad))
    xb = jnp.asarray(x[: bed.Mpad] * np.asarray(bed.m_mask))
    xd = jnp.asarray(x[: dense.Mpad] * np.asarray(dense.m_mask))
    np.testing.assert_allclose(
        bed.deplanarize(bed.ax(xb)), dense.deplanarize(dense.ax(xd)), rtol=1e-8
    )
    v = rng.normal(size=N)
    np.testing.assert_allclose(
        np.asarray(bed.atx(bed.planarize(v)))[:M],
        np.asarray(dense.atx(dense.planarize(v)))[:M],
        rtol=1e-8,
    )


@pytest.mark.parametrize("backend", ["xla", pytest.param(KERNEL, id="pallas")])
def test_batched_matvec_matches_single(backend):
    """axm/atxm (wide-RHS block kernels) == column-wise ax/atx."""
    rng = np.random.default_rng(11)
    N, M, B = 130, 40, 3
    codes, y = random_dataset(rng, N, M)
    # the kernels are float32 only (int8 digits; float64 is refused)
    dt = jnp.float64 if backend == "xla" else jnp.float32
    geno = GenoBed.from_arrays(make_bed(codes), y, N=N, dtype=dt,
                               backend=backend)
    X = rng.normal(size=(geno.Mpad, B)) * np.asarray(geno.m_mask)[:, None]
    Z = np.asarray(geno.axm(jnp.asarray(X)))
    for j in range(B):
        zj = np.asarray(geno.ax(jnp.asarray(X[:, j])))
        np.testing.assert_allclose(Z[:, :, j], zj, rtol=2e-6, atol=1e-6)

    V = np.stack([np.asarray(geno.planarize(rng.normal(size=N)))
                  for _ in range(B)], axis=-1)
    R = np.asarray(geno.atxm(jnp.asarray(V)))
    for j in range(B):
        rj = np.asarray(geno.atx(jnp.asarray(V[:, :, j])))
        np.testing.assert_allclose(R[:, j], rj, rtol=2e-6, atol=1e-6)


def test_batched_matvec_dense_container():
    rng = np.random.default_rng(12)
    N, M, B = 48, 16, 2
    X = rng.normal(size=(M, N))
    y = rng.normal(size=N)
    dense = GenoDense.from_arrays(X, y, N=N, dtype=jnp.float64)
    XB = rng.normal(size=(dense.Mpad, B)) * np.asarray(dense.m_mask)[:, None]
    Z = np.asarray(dense.axm(jnp.asarray(XB)))
    for j in range(B):
        np.testing.assert_allclose(
            Z[:, :, j], np.asarray(dense.ax(jnp.asarray(XB[:, j]))), rtol=1e-9)
    V = np.stack([np.asarray(dense.planarize(rng.normal(size=N)))
                  for _ in range(B)], axis=-1)
    R = np.asarray(dense.atxm(jnp.asarray(V)))
    for j in range(B):
        np.testing.assert_allclose(
            R[:, j], np.asarray(dense.atx(jnp.asarray(V[:, :, j]))), rtol=1e-9)


def test_pallas_backend_under_mesh():
    """The kernels (Pallas interpreter) under shard_map on an 8-device mesh
    agree with the unsharded XLA path — validates the in/out specs the real
    multi-card run uses."""
    import jax

    rng = np.random.default_rng(19)
    N, M = 130, 40
    codes, y = random_dataset(rng, N, M)
    devs = jax.devices()[:8]
    mesh = jax.sharding.Mesh(np.array(devs), ("m",))
    g_sh = GenoBed.from_arrays(make_bed(codes), y, N=N,
                               backend=KERNEL, mesh=mesh)
    g_ref = GenoBed.from_arrays(make_bed(codes), y, N=N, dtype=jnp.float64,
                                backend="xla")
    x = rng.normal(size=g_sh.Mpad) * np.asarray(g_sh.m_mask)
    np.testing.assert_allclose(
        np.asarray(g_sh.ax(jnp.asarray(x))),
        np.asarray(g_ref.ax(jnp.asarray(x[: g_ref.Mpad]))), rtol=1e-5, atol=1e-7)
    v = g_sh.planarize(rng.normal(size=N))
    np.testing.assert_allclose(
        np.asarray(g_sh.atx(v))[: M],
        np.asarray(g_ref.atx(v))[: M], rtol=1e-5, atol=1e-7)
    X = rng.normal(size=(g_sh.Mpad, 2)) * np.asarray(g_sh.m_mask)[:, None]
    np.testing.assert_allclose(
        np.asarray(g_sh.axm(jnp.asarray(X))),
        np.asarray(g_ref.axm(jnp.asarray(X[: g_ref.Mpad]))), rtol=1e-5, atol=1e-7)


def test_no_missing_fast_path():
    """Complete (imputed) genotypes route through the complete-path kernels and
    match the general path."""
    rng = np.random.default_rng(29)
    N, M = 130, 40
    codes = rng.choice([0, 2, 3], size=(M, N)).astype(np.uint8)  # no code 1
    y = rng.normal(size=N)
    y[rng.choice(N, 9, replace=False)] = np.nan  # phenotype NAs still exist
    fast = GenoBed.from_arrays(make_bed(codes), y, N=N, backend=KERNEL)
    ref = GenoBed.from_arrays(make_bed(codes), y, N=N, dtype=jnp.float64,
                              backend="xla")
    assert fast.geno_complete and ref.geno_complete is True
    x = rng.normal(size=fast.Mpad) * np.asarray(fast.m_mask)
    np.testing.assert_allclose(np.asarray(fast.ax(jnp.asarray(x))),
                               np.asarray(ref.ax(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
    v = fast.planarize(rng.normal(size=N))
    np.testing.assert_allclose(np.asarray(fast.atx(v)),
                               np.asarray(ref.atx(v)), rtol=1e-5, atol=1e-6)
    X = rng.normal(size=(fast.Mpad, 2)) * np.asarray(fast.m_mask)[:, None]
    np.testing.assert_allclose(np.asarray(fast.axm(jnp.asarray(X))),
                               np.asarray(ref.axm(jnp.asarray(X))),
                               rtol=1e-5, atol=1e-6)
    V = np.stack([np.asarray(fast.planarize(rng.normal(size=N)))
                  for _ in range(2)], axis=-1)
    np.testing.assert_allclose(np.asarray(fast.atxm(jnp.asarray(V))),
                               np.asarray(ref.atxm(jnp.asarray(V))),
                               rtol=1e-5, atol=1e-6)
    # incomplete data must NOT take the fast path
    codes2, y2 = random_dataset(rng, N, M)
    g2 = GenoBed.from_arrays(make_bed(codes2), y2, N=N, backend=KERNEL)
    assert g2.geno_complete is False


def test_decode_utility_matches_layout_oracle():
    """ops.decode public API agrees with the layout dense oracle."""
    from gvamp.ops import decode

    rng = np.random.default_rng(31)
    N, M = 61, 9
    codes = rng.integers(0, 4, size=(M, N)).astype(np.uint8)
    lay = PlanarLayout.create(N)
    words = lay.pack_words(make_bed(codes))  # [M, Nw]
    a, b = decode.decode_planar(jnp.asarray(words))  # [4, M, Nb]
    dose, nm = lay.dense_from_words(words)
    p2o = lay.planar_to_orig()  # [4, Nb]
    for k in range(4):
        for p in range(lay.n_bytes):
            n = p2o[k, p]
            if n < 0:
                continue
            np.testing.assert_array_equal(np.asarray(a)[k, :, p], dose[:, n])
            np.testing.assert_array_equal(np.asarray(b)[k, :, p], nm[:, n])


def test_wide_kernel_column_chunking():
    """Right-hand sides wider than one program's digit block are split into
    column chunks and concatenated; each column matches its own call."""
    from gvamp.ops import matvec

    rng = np.random.default_rng(13)
    Nw, M = 32, 512
    words = jnp.asarray(rng.integers(0, 2**32, size=(Nw, M),
                                     dtype=np.uint64).astype(np.uint32))
    B = matvec._AX_C_MAX // matvec._NDIG + 7
    W = jnp.asarray(rng.standard_normal((M, B)), jnp.float32)
    U = W * 0.5
    za = np.asarray(matvec.axm_pallas(words, W, U, interpret=True))
    for j in (0, B - 1):
        ref = np.asarray(matvec.axm_pallas(words, W[:, j:j + 1],
                                           U[:, j:j + 1], interpret=True))
        np.testing.assert_allclose(za[..., j], ref[..., 0], rtol=1e-5,
                                   atol=1e-5)
    B = matvec._AT_C_MAX // matvec._NDIG + 5
    V = jnp.asarray(rng.standard_normal((4, 4 * Nw, B)), jnp.float32)
    av, bv = matvec.atxm_pallas(words, V, interpret=True)
    a1, b1 = matvec.atxm_pallas(words, V[:, :, -1:], interpret=True)
    np.testing.assert_allclose(np.asarray(av)[:, -1], np.asarray(a1)[:, 0],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(bv)[:, -1], np.asarray(b1)[:, 0],
                               rtol=1e-5, atol=1e-5)


def test_digit_transform_helpers_roundtrip():
    """_digits / _fold: the radix-127 int8 digits of a float32 block
    reconstruct it to digit precision, and _fold recombines digit products
    like a NumPy fold, at edge widths (B=1 and B=5) along either axis."""
    from gvamp.ops import matvec

    rng = np.random.default_rng(3)
    D = matvec._NDIG
    for B in (1, 5):
        X = jnp.asarray(rng.standard_normal((64, B)).astype(np.float32))
        s0 = matvec._digit_scale(X, 0)
        dig = matvec._digits(X, s0, 1)
        assert dig.shape == (64, D * B) and dig.dtype == jnp.int8
        s = np.asarray(s0, np.float64)
        rec = sum(np.asarray(dig, np.float64)[:, d * B:(d + 1) * B]
                  * (s / 127.0 ** d) for d in range(D))
        np.testing.assert_allclose(rec, np.asarray(X), rtol=0,
                                   atol=float(np.abs(X).max()) * 1e-7)
        Z = rng.integers(-1000, 1000, (D * B, 32))
        want = sum(Z[d * B:(d + 1) * B].astype(np.float64)
                   * (s[:, None] / 127.0 ** d) for d in range(D))
        got0 = np.asarray(matvec._fold(jnp.asarray(Z, jnp.int32), s0, B, 0))
        got1 = np.asarray(matvec._fold(jnp.asarray(Z.T, jnp.int32), s0, B, 1))
        np.testing.assert_allclose(got0, want, rtol=1e-6)
        np.testing.assert_allclose(got1, want.T, rtol=1e-6)
