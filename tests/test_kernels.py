"""The packed-operator kernel family (ops/matvec.py) and its routing.

On this CPU host the Triton kernels run in the Pallas interpreter; their
compiled form is checked by cross-lowering for CUDA here and by the ``gpu``
test and ``chip_smoke.py`` on a card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gvamp import runtime
from gvamp.data import GenoBed, _pick_backend
from gvamp.ops import matvec
from gvamp.ops.layout import PlanarLayout
from gvamp.options import Options
from helpers import KERNEL, random_dataset
from test_data_layer import make_bed

# unaligned on purpose: Nw = 21 word rows, M = 300 markers
N_ODD, M_ODD = 333, 300


def packed(rng, N, M, complete):
    """(words uint32[Nw, M], planar real-individual mask [4, Nb, 1])."""
    codes, _ = random_dataset(rng, N, M, miss_geno=0.0 if complete else 0.05)
    lay = PlanarLayout.create(N, word_align=1)
    words = jnp.asarray(lay.pack_words(make_bed(codes)).T)
    real = (lay.planar_to_orig() >= 0)[..., None]
    return words, real, lay


def rhs(rng, M, Nw, B, real):
    W = rng.standard_normal((M, B))
    U = W * rng.uniform(0.0, 2.0, (M, 1))
    V = rng.standard_normal((4, 4 * Nw, B)) * real
    return W, U, V


def rel(got, ref):
    """max |got - ref| over the column maxima of |ref|."""
    got = np.asarray(got, np.float64).reshape(-1, np.shape(ref)[-1])
    ref = np.asarray(ref, np.float64).reshape(-1, np.shape(ref)[-1])
    return float((np.abs(got - ref).max(0)
                  / np.maximum(np.abs(ref).max(0), 1e-300)).max())


@pytest.mark.parametrize("B", [1, 3, 70])
@pytest.mark.parametrize("complete", [True, False],
                         ids=["complete", "missing"])
@pytest.mark.parametrize("direction", ["ax", "atx"])
def test_kernel_matches_reference(direction, complete, B):
    """Interpreted kernel == blocked float64 reference on real rows, at an
    unaligned N and M (the wrappers pad to whole tiles) and widths that
    span one program (1, 3) and several column chunks (70)."""
    rng = np.random.default_rng(100 + B)
    words, real, _ = packed(rng, N_ODD, M_ODD, complete)
    W, U, V = rhs(rng, M_ODD, words.shape[0], B, real)
    if direction == "ax":
        got = matvec.axm_pallas(words, jnp.asarray(W, jnp.float32),
                                jnp.asarray(U, jnp.float32), complete,
                                interpret=True)
        ref = matvec.axm_xla(words, jnp.asarray(W), jnp.asarray(U), complete,
                             dtype=jnp.float64)
        err = rel(np.asarray(got) * real, np.asarray(ref) * real)
    else:
        av, bv = matvec.atxm_pallas(words, jnp.asarray(V, jnp.float32),
                                    complete, interpret=True)
        ar, br = matvec.atxm_xla(words, jnp.asarray(V), complete,
                                 dtype=jnp.float64)
        assert av.shape == (M_ODD, B)
        assert bv.shape == ((B,) if complete else (M_ODD, B))
        err = rel(av, ar)
        if complete:   # column sums of V: float32 sum of 1,332 terms
            np.testing.assert_allclose(bv, br, rtol=0,
                                       atol=1e-6 * np.abs(V).sum((0, 1)).max())
        else:
            err = max(err, rel(bv, br))
    # int8 digits (~1e-8 of the column max) + float32 folding/accumulation
    assert err < 2e-6, err


@pytest.mark.parametrize("complete", [True, False],
                         ids=["complete", "missing"])
@pytest.mark.parametrize("direction", ["ax", "atx"])
def test_reference_matches_numpy_f64(direction, complete, monkeypatch):
    """Blocked reference == dense float64 NumPy decode, with a block budget
    small enough to force several blocks and a padded last one."""
    monkeypatch.setattr(matvec, "_REF_BLOCK_BYTES", 64 * 2 * 16 * 21 * 8)
    assert matvec.ref_block(21, M_ODD, 8) == 64
    rng = np.random.default_rng(7)
    words, real, lay = packed(rng, N_ODD, M_ODD, complete)
    dose, nm = lay.dense_from_words(np.asarray(words).T)    # [M, N]
    W, U, V = rhs(rng, M_ODD, words.shape[0], 2, real)
    if complete:
        nm = np.ones_like(nm)
    if direction == "ax":
        z = matvec.axm_xla(words, jnp.asarray(W), jnp.asarray(U), complete,
                           dtype=jnp.float64)
        got = lay.deplanarize(np.moveaxis(np.asarray(z), -1, 0))  # [B, N]
        want = (dose.T @ W - nm.T @ U).T
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)
    else:
        av, bv = matvec.atxm_xla(words, jnp.asarray(V), complete,
                                 dtype=jnp.float64)
        v = lay.deplanarize(np.moveaxis(V, -1, 0)).T            # [N, B]
        np.testing.assert_allclose(np.asarray(av), dose @ v, rtol=1e-12,
                                   atol=1e-9)
        want_b = v.sum(0) if complete else nm @ v
        np.testing.assert_allclose(np.asarray(bv), want_b, rtol=1e-12,
                                   atol=1e-9)


@pytest.mark.parametrize("miss_geno", [0.0, 0.05], ids=["complete", "missing"])
def test_kernel_under_shard_map(miss_geno):
    """GenoBed.packed_products on the 8 virtual devices (kernel per shard,
    psum for ax) == the unsharded float64 reference container."""
    rng = np.random.default_rng(19)
    N, M = 130, 40
    codes, y = random_dataset(rng, N, M, miss_geno=miss_geno)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("m",))
    g_sh = GenoBed.from_arrays(make_bed(codes), y, N=N, backend=KERNEL,
                               mesh=mesh)
    g_ref = GenoBed.from_arrays(make_bed(codes), y, N=N, dtype=jnp.float64,
                                backend="xla")
    assert g_sh.geno_complete == (miss_geno == 0.0)
    X = rng.normal(size=(g_sh.Mpad, 3)) * np.asarray(g_sh.m_mask)[:, None]
    np.testing.assert_allclose(
        np.asarray(g_sh.axm(jnp.asarray(X, jnp.float32))),
        np.asarray(g_ref.axm(jnp.asarray(X[: g_ref.Mpad]))),
        rtol=1e-5, atol=1e-6)
    V = np.stack([np.asarray(g_sh.planarize(rng.normal(size=N)))
                  for _ in range(3)], axis=-1)
    np.testing.assert_allclose(
        np.asarray(g_sh.atxm(jnp.asarray(V, jnp.float32)))[:M],
        np.asarray(g_ref.atxm(jnp.asarray(V)))[:M], rtol=1e-5, atol=1e-6)


def test_marker_split_is_deterministic(monkeypatch):
    """Splitting the marker axis over programs (small N) changes only the
    summation grouping: results match the unsplit kernel."""
    rng = np.random.default_rng(3)
    words, real, _ = packed(rng, 64, 1024, False)
    W = jnp.asarray(rng.standard_normal((1024, 2)), jnp.float32)
    monkeypatch.setattr(matvec, "_GRID_TARGET", 1)
    z1 = np.asarray(matvec.axm_pallas(words, W, W, interpret=True))
    monkeypatch.setattr(matvec, "_GRID_TARGET", 1 << 20)
    z4 = np.asarray(matvec.axm_pallas(words, W, W, interpret=True))
    np.testing.assert_allclose(z4, z1, rtol=0, atol=1e-5 * np.abs(z1).max())


@pytest.mark.parametrize("where", ["data", "options"])
def test_pallas_refused_off_gpu(where):
    """--backend pallas needs a GPU: no silent interpreter or CPU fallback."""
    if where == "data":
        with pytest.raises(ValueError, match="needs a GPU"):
            _pick_backend("pallas", jnp.float32)
    else:
        with pytest.raises(SystemExit, match="needs a GPU"):
            Options.from_args(["--run-mode", "infere", "--bed-file", "x.bed",
                               "--phen-files", "x.phen", "--N", "10",
                               "--Mt", "5", "--backend", "pallas"]).check()


def test_auto_backend_resolution(monkeypatch):
    """auto: the XLA reference off the GPU and for float64, the kernel on a
    GPU at float32; the interpreter only when asked for by name."""
    assert _pick_backend("auto", jnp.float32) == "xla"
    assert _pick_backend("interpret", jnp.float32) == "interpret"
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert _pick_backend("auto", jnp.float32) == "pallas"
    assert _pick_backend("auto", jnp.float64) == "xla"
    with pytest.raises(ValueError, match="unknown backend"):
        _pick_backend("cuda", jnp.float32)


@pytest.mark.parametrize("case", ["env", "gpu", "cpu"])
def test_compile_cache_dir(case, monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins and nothing is set in code; otherwise
    a GPU run caches in the fixed .jax_cache at the checkout root, and a
    CPU run does not cache (reloaded XLA:CPU executables abort)."""
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    monkeypatch.delenv(runtime.CACHE_ENV, raising=False)
    if case == "env":
        monkeypatch.setenv(runtime.CACHE_ENV, str(tmp_path))
        assert runtime.enable_compile_cache() == str(tmp_path)
        assert calls == []
    elif case == "gpu":
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        path = runtime.enable_compile_cache()
        assert path == runtime.DEFAULT_CACHE_DIR
        assert path.endswith(".jax_cache")
        assert calls == [("jax_compilation_cache_dir", path)]
    else:
        assert runtime.enable_compile_cache() is None
        assert calls == []


@pytest.mark.parametrize("complete", [True, False],
                         ids=["complete", "missing"])
@pytest.mark.parametrize("direction", ["ax", "atx"])
def test_kernel_lowers_for_cuda(direction, complete):
    """The compiled (non-interpreted) kernels lower to Triton IR for CUDA at
    the biobank shape — catches primitives the Triton route cannot lower,
    without a GPU (the card's compiler itself runs in chip_smoke.py)."""
    from jax import export

    Nw, M, B = 20_480, 131_072, 3
    S = jax.ShapeDtypeStruct
    words = S((Nw, M), jnp.uint32)
    if direction == "ax":
        fn = jax.jit(lambda w, W, U: matvec.axm_pallas(w, W, U, complete))
        args = (words, S((M, B), jnp.float32), S((M, B), jnp.float32))
    else:
        fn = jax.jit(lambda w, V: matvec.atxm_pallas(w, V, complete))
        args = (words, S((4, 4 * Nw, B), jnp.float32))
    exp = export.export(
        fn, platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")])(*args)
    text = exp.mlir_module()
    assert "__gpu$xla.gpu.triton" in text
    assert f"gvamp_{direction}m" in text


@pytest.mark.gpu
def test_compiled_kernel_matches_reference(gpu):
    """On a card: the compiled kernels == the blocked reference."""
    rng = np.random.default_rng(5)
    for complete in (True, False):
        words, real, _ = packed(rng, 4096, 1024, complete)
        W, U, V = rhs(rng, 1024, words.shape[0], 3, real)
        f32 = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
        z = matvec.axm_pallas(words, f32(W), f32(U), complete)
        zr = matvec.axm_xla(words, f32(W), f32(U), complete)
        assert rel(np.asarray(z) * real, np.asarray(zr) * real) < 2e-5
        av, _ = matvec.atxm_pallas(words, f32(V), complete)
        ar, _ = matvec.atxm_xla(words, f32(V), complete)
        assert rel(av, ar) < 2e-5
