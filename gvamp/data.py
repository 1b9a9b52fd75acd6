"""Genotype/phenotype containers: the L2 data layer.

``GenoBed`` owns the packed 2-bit design matrix (word-major uint32, planar N
layout), per-marker statistics, the standardized phenotype and its NA mask,
and exposes the two matvecs ``ax``/``atx`` plus marker/people statistics —
the JAX re-design of the reference's ``data`` class (data.hpp:18-146).

Scaling conventions (parity-critical, reference data.cpp):
  * A[n,m] = (g - mave_m) * nonmiss * msig_m / sqrt(N)   (data.cpp:825-832)
  * mave   = mean of dosage over genotype-non-missing AND phenotype-non-NA
             individuals (data.cpp:446-476)
  * msig   = (1 / sd)^alpha_scale with sd over the same support and
             denominator (nonas - 1), nonas = phenotype-non-NA count
             (data.cpp:477-483)
  * phenotype is *scaled* by sqrt((nonas-1) / sum((y-mean)^2)) but NOT
    centered; NA slots are zeroed by the filter (data.cpp:171-186, 1065-1080)

``GenoDense`` is the dense (methylation) variant of the same interface
(reference data.cpp:241-278, 487-541, 1013-1045).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gvamp import native
from gvamp.io import plink
from gvamp.ops import matvec
from gvamp.ops.layout import PlanarLayout


# dense (methylation) products run in full float32, never TF32
_mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


BACKENDS = ("auto", "xla", "pallas", "interpret")


def _pick_backend(backend: str, dtype=jnp.float32) -> str:
    """Resolve the packed-operator backend.

    * ``pallas``: the GPU kernel family (ops/matvec.py, Triton route).  It
      needs a GPU, and it is float32 only: its right-hand sides become int8
      digits (~1e-7), a silent downgrade for an explicit ``--dtype float64``
      request, so both are refused here and in Options.check.
    * ``xla``: the blocked XLA reference (any platform, any dtype).
    * ``interpret``: the kernel family in the Pallas interpreter; only tests
      ask for it, since it is slow and meant for hosts without a GPU.
    * ``auto``: ``pallas`` on a GPU at float32, ``xla`` otherwise.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (one of {BACKENDS})")
    f64 = jnp.dtype(dtype) == jnp.float64
    if backend in ("pallas", "interpret") and f64:
        raise ValueError(
            "--backend pallas cannot honor --dtype float64: the kernels "
            "quantize right-hand sides to int8 digits (~1e-7).  Use "
            "--backend xla for true float64, or --dtype float32 with pallas.")
    on_gpu = jax.default_backend() == "gpu"
    if backend == "pallas" and not on_gpu:
        raise ValueError(
            f"--backend pallas needs a GPU (JAX platform: "
            f"{jax.default_backend()}); use --backend xla or auto")
    if backend != "auto":
        return backend
    return "pallas" if on_gpu and not f64 else "xla"


class BedOp(NamedTuple):
    """Packed-operator arrays as a pytree (safe to pass through jit)."""

    words: jax.Array       # uint32[Nw, Mpad]
    mave: jax.Array        # f[Mpad]
    msig: jax.Array        # f[Mpad]
    na_planar: jax.Array   # f[4, Nb]
    m_mask: jax.Array      # f[Mpad]


class DenseOp(NamedTuple):
    X: jax.Array           # f[Mpad, N]
    mave: jax.Array
    msig: jax.Array
    na_planar: jax.Array
    m_mask: jax.Array


@functools.partial(jax.jit, static_argnames=("block", "use64"))
def _marker_stats_kernel(words, na_planar, nonas, alpha_scale, block=512, use64=False):
    """Blocked two-moment pass over the packed matrix -> (mave, msig).

    Decodes ``block`` markers at a time (bounded memory) and reduces the three
    sufficient sums S_a = sum a*mask, S_b = sum b*mask, S_aa = sum a^2*mask;
    then mave = S_a/S_b and var = (S_aa - S_a^2/S_b) / (nonas-1), matching the
    reference's two-pass loop (data.cpp:446-483) algebraically.

    The reference accumulates these in double.  In the default f32 engine
    dtype the N axis is split into chunks whose partial sums combine with
    compensated two-sum (matvec.two_sum): the (hi, lo) pairs make the sums
    1-ulp accurate at ANY N before the mave/sumsqr algebra, instead of the
    plain-f32 ~N*eps worst-case drift at biobank scale.  The remaining error
    is the final-subtraction cancellation, bounded by eps * mean^2/var per
    marker — pinned against an np.float64 oracle at N=327,680 in
    tests/test_pvals.py.
    """
    dt = jnp.float64 if use64 else jnp.float32
    Nw, M = words.shape
    na = na_planar.astype(dt)  # [4, Nb]
    Nb = na.shape[1]
    nc = matvec.nb_chunk(Nb)
    C = Nb // nc

    def body(i, acc):
        sah, sal, sbh, sbl, qh_, ql_ = acc
        blk = jax.lax.dynamic_slice(words, (0, i * block), (Nw, block))
        a, b = matvec.decode_planar_dense(blk, dt)  # [4, Nb, block]
        am = a * na[:, :, None]
        bm = b * na[:, :, None]
        pa = jnp.sum(am.reshape(4, C, nc, block), axis=(0, 2))   # [C, block]
        pb = jnp.sum(bm.reshape(4, C, nc, block), axis=(0, 2))
        pq = jnp.sum((a * am).reshape(4, C, nc, block), axis=(0, 2))

        def fold(carry, part):
            (ah, al), (bh, bl), (ch, cl) = carry
            xa, xb, xq = part
            ah, al = matvec.two_sum(ah, al, xa)
            bh, bl = matvec.two_sum(bh, bl, xb)
            ch, cl = matvec.two_sum(ch, cl, xq)
            return ((ah, al), (bh, bl), (ch, cl)), None

        z = jnp.zeros((block,), dt)
        ((ah, al), (bh, bl), (ch, cl)), _ = jax.lax.scan(
            fold, ((z, z), (z, z), (z, z)), (pa, pb, pq))
        j = i * block
        return (jax.lax.dynamic_update_slice(sah, ah, (j,)),
                jax.lax.dynamic_update_slice(sal, al, (j,)),
                jax.lax.dynamic_update_slice(sbh, bh, (j,)),
                jax.lax.dynamic_update_slice(sbl, bl, (j,)),
                jax.lax.dynamic_update_slice(qh_, ch, (j,)),
                jax.lax.dynamic_update_slice(ql_, cl, (j,)))

    # derive the init carry from `words` so its shard_map varying-axis set
    # matches the body output (zeros alone would be replicated-typed)
    zeros = (words[0, :] * np.uint32(0)).astype(dt)
    sah, sal, sbh, sbl, qh, ql = jax.lax.fori_loop(
        0, M // block, body, (zeros,) * 6)
    sa = sah + sal       # correctly-rounded sums (lo absorbs the drift)
    sb = sbh + sbl
    mave = jnp.where(sb != 0, sa / jnp.where(sb == 0, 1.0, sb), 0.0)
    # sumsqr = S_aa - mave*S_a with the lo corrections applied AFTER the
    # cancelling hi subtraction (the hi terms carry the magnitude)
    sumsqr = (qh - mave * sah) + (ql - mave * sal)
    sd = jnp.sqrt(sumsqr / (nonas - 1.0))
    msig = jnp.where(sumsqr > 0, 1.0 / jnp.power(jnp.where(sumsqr <= 0, 1.0, sd), alpha_scale), 1.0)
    return mave, msig


@dataclasses.dataclass
class GenoBed:
    """Packed .bed container + standardized operator (marker-shardable)."""

    layout: PlanarLayout
    N: int          # individuals
    Mt: int         # total markers across all shards
    M: int          # markers owned by this container (== Mt single-host)
    S: int          # global offset of first owned marker
    Mpad: int       # padded marker count (tile/shard aligned)
    words: jax.Array          # uint32[Nw, Mpad]
    mave: jax.Array           # f[Mpad]
    msig: jax.Array           # f[Mpad]
    na_planar: jax.Array      # f[4, Nb] phenotype non-NA indicator
    y_planar: jax.Array       # f[4, Nb] standardized phenotype, NA slots zero
    nonas: int
    intercept: float
    scale: float
    alpha_scale: float = 1.0
    bim_path: str = ""
    mesh: Optional[Mesh] = None
    backend: str = "auto"
    dtype: jnp.dtype = jnp.float32
    covs: Optional[np.ndarray] = None  # [N, C] covariates (probit model)
    _chroms: Optional[np.ndarray] = None
    _complete: Optional[bool] = None   # no missing genotypes (lazy-computed)
    n_offset: int = 0  # first window individual (sample_window views only)

    # ---------------------------------------------------------------- build

    @classmethod
    def from_arrays(
        cls,
        bed_bytes: np.ndarray,   # uint8[M, mbytes]
        y_raw: np.ndarray,       # float64[N], NaN = missing
        N: int,
        Mt: int | None = None,
        S: int = 0,
        standardize_phen: bool = True,
        alpha_scale: float = 1.0,
        mesh: Optional[Mesh] = None,
        backend: str = "auto",
        dtype=jnp.float32,
        bim_path: str = "",
        word_align: int = 32,
        marker_align: int = 512,
    ) -> "GenoBed":
        M = bed_bytes.shape[0]
        Mt = M if Mt is None else Mt
        lay = PlanarLayout.create(N, word_align=word_align)

        n_shards = mesh.devices.size if mesh is not None else 1
        Mpad = _round_up(max(M, 1), marker_align * n_shards)
        # native OpenMP blocked-transpose repack (gvamp/native) with a
        # numpy fallback — the loader is the framework's C++ layer, mirroring
        # the reference's C++/MPI-IO read path (data.cpp:201-234)
        words_np = native.bed_to_words(bed_bytes, N, lay.n_words, Mpad)
        if words_np is None:
            words_np = np.full((lay.n_words, Mpad), 0x55555555, dtype=np.uint32)
            words_np[:, :M] = lay.pack_words(bed_bytes).T

        isna = np.isnan(y_raw)
        nonas = int((~isna).sum())
        if standardize_phen and nonas > 1:
            avg = float(np.nanmean(y_raw))
            sqn = float(np.sqrt((nonas - 1) / np.nansum((y_raw - avg) ** 2)))
        else:
            avg, sqn = 0.0, 1.0
        y = np.where(isna, 0.0, y_raw) * sqn  # scaled, NOT centered; NA -> 0
        na = (~isna).astype(np.float64)

        if mesh is not None:
            # global-array assembly: works for single- AND multi-process
            # meshes (each process materializes only its device shards)
            from gvamp import dist
            words_dev = dist.words_global_from_host(words_np, mesh)
        else:
            words_dev = jax.device_put(words_np)

        obj = cls(
            layout=lay, N=N, Mt=Mt, M=M, S=S, Mpad=Mpad,
            words=words_dev,
            mave=jnp.zeros((Mpad,), dtype), msig=jnp.zeros((Mpad,), dtype),
            na_planar=jnp.asarray(lay.planarize(na), dtype),
            y_planar=jnp.asarray(lay.planarize(y), dtype),
            nonas=nonas, intercept=avg, scale=sqn,
            alpha_scale=alpha_scale, bim_path=bim_path,
            mesh=mesh, backend=_pick_backend(backend, dtype), dtype=dtype,
        )
        obj.compute_marker_statistics()
        return obj

    @classmethod
    def from_device_words(cls, words: jax.Array, y_raw: np.ndarray, N: int,
                          M: int | None = None, Mt: int | None = None, S: int = 0,
                          standardize_phen: bool = True, alpha_scale: float = 1.0,
                          mesh: Optional[Mesh] = None, backend: str = "auto",
                          dtype=jnp.float32, bim_path: str = "") -> "GenoBed":
        """Build from an already-on-device uint32[Nw, Mpad] word matrix.

        For benchmarks / synthetic data: avoids shipping the packed matrix
        through the host.  The caller must pad correctly (0x55 words beyond
        the real markers / samples).
        """
        Nw, Mpad = words.shape
        lay = PlanarLayout.create(N)
        assert lay.n_words <= Nw, (lay.n_words, Nw)
        lay = PlanarLayout(N=N, n_words=Nw)
        M = Mpad if M is None else M
        Mt = M if Mt is None else Mt
        isna = np.isnan(y_raw)
        nonas = int((~isna).sum())
        if standardize_phen and nonas > 1:
            avg = float(np.nanmean(y_raw))
            sqn = float(np.sqrt((nonas - 1) / np.nansum((y_raw - avg) ** 2)))
        else:
            avg, sqn = 0.0, 1.0
        y = np.where(isna, 0.0, y_raw * sqn)
        na = (~isna).astype(np.float64)
        obj = cls(
            layout=lay, N=N, Mt=Mt, M=M, S=S, Mpad=Mpad, words=words,
            mave=jnp.zeros((Mpad,), dtype), msig=jnp.zeros((Mpad,), dtype),
            na_planar=jnp.asarray(lay.planarize(na), dtype),
            y_planar=jnp.asarray(lay.planarize(y), dtype),
            nonas=nonas, intercept=avg, scale=sqn, alpha_scale=alpha_scale,
            bim_path=bim_path, mesh=mesh, backend=_pick_backend(backend, dtype),
            dtype=dtype,
        )
        obj.compute_marker_statistics()
        return obj

    @classmethod
    def from_files(
        cls, bed_path: str, phen_path: str | None, N: int, Mt: int,
        S: int = 0, M: int | None = None, **kw,
    ) -> "GenoBed":
        M = Mt if M is None else M
        if phen_path:
            y, isna = plink.read_phen(phen_path)
            y = np.where(isna, np.nan, y)
            assert y.shape[0] == N, (y.shape, N)
        else:
            y = np.zeros(N)

        # fast path: native reader transposes straight from the file into the
        # planar word layout (no marker-major intermediate)
        lay = PlanarLayout.create(N, word_align=kw.get("word_align", 32))
        mesh = kw.get("mesh")
        n_shards = mesh.devices.size if mesh is not None else 1
        Mpad = _round_up(max(M, 1), kw.get("marker_align", 512) * n_shards)
        sub = {k: v for k, v in kw.items()
               if k in ("standardize_phen", "alpha_scale", "mesh",
                        "backend", "dtype", "bim_path")}
        if mesh is not None:
            # per-shard byte-range loading: each process reads only the
            # markers its devices own (MPI-IO slab-read analog,
            # data.cpp:201-234 -> gvamp.dist.load_bed_words_global)
            from gvamp import dist
            words = dist.load_bed_words_global(
                bed_path, N, M, S, lay.n_words, Mpad, mesh)
            return cls.from_device_words(words, y, N=N, M=M, Mt=Mt, S=S, **sub)
        words = native.read_bed_words(bed_path, N, M, S, lay.n_words, Mpad)
        if words is not None:
            import jax as _jax
            return cls.from_device_words(
                _jax.device_put(words), y, N=N, M=M, Mt=Mt, S=S, **sub)

        bed = plink.read_bed_slab(bed_path, N, M, S)
        return cls.from_arrays(bed, y, N=N, Mt=Mt, S=S, **kw)

    def sample_window(self, sb: int, lb: int) -> "GenoBed":
        """Sub-block of individuals [4*sb, 4*(sb+lb)) as a masked VIEW.

        The device-side reshape of the reference's (SB, LB) byte-window matvec
        arguments (data.cpp:728-801, 852), used by the cross-validation
        damping tuner (vamp.cpp:356-409) and the reduced-subset CG path
        (vamp.cpp:1096-1110).  Matches the reference's semantics: marker
        statistics stay those of the FULL data (windowed dot_product receives
        the full mave/msig, data.cpp:744-747) and the matvec scale becomes
        1/sqrt(4*lb) (data.cpp:825-832); the phenotype window keeps the
        full-data standardization.

        The view SHARES the packed words on device (no host round-trip, no
        second HBM copy — the r1 implementation repacked via NumPy, O(M*Nw)
        host traffic per window): out-of-window individuals are zeroed
        through the planar phenotype-NA mask, which every matvec already
        applies (ax outputs are multiplied by it; atx inputs are pre-masked).
        ``deplanarize`` shifts by ``n_offset`` so callers' ``[: win.N]``
        slicing sees window individuals at the origin, like a standalone
        container.
        """
        import copy

        nb = self.layout.n_bytes
        n_lo, n_hi = 4 * sb, min(4 * (sb + lb), self.N)
        cols = jnp.arange(nb)
        colmask = ((cols >= sb) & (cols < sb + lb)).astype(self.dtype)[None, :]
        win = copy.copy(self)
        win.N = n_hi - n_lo
        win.n_offset = n_lo
        win.na_planar = self.na_planar * colmask
        win.y_planar = self.y_planar * colmask
        win.nonas = int(np.asarray(jnp.sum(win.na_planar)))
        # full-data completeness implies window completeness (the converse
        # need not hold; the conservative inherit keeps the complete path
        # sound — an incomplete parent just uses the general kernels)
        win._complete = self.geno_complete
        return win

    def set_phen(self, y: np.ndarray, standardize: bool = False) -> None:
        """Replace the phenotype (simulation path; reference data.hpp:55 set_phen).

        Simulated phenotypes are used unstandardized (sim.cpp:219-221).
        """
        y = np.asarray(y, dtype=np.float64)
        if y.size == self.N:
            isna = np.isnan(y)
            self.nonas = int((~isna).sum())
            if standardize:
                avg = float(np.nanmean(y))
                sqn = float(np.sqrt((self.nonas - 1) / np.nansum((y - avg) ** 2)))
                self.intercept, self.scale = avg, sqn
                y = y * sqn
            yf = np.where(isna, 0.0, y)
            self.na_planar = jnp.asarray(self.layout.planarize((~isna).astype(np.float64)), self.dtype)
            self.y_planar = jnp.asarray(self.layout.planarize(yf), self.dtype)
        else:  # already planar-flat
            self.y_planar = jnp.asarray(y, self.dtype).reshape(4, self.layout.n_bytes)
        self.compute_marker_statistics()

    # ---------------------------------------------------------------- stats

    def marker_stats_for(self, na_planar, nonas):
        """(mave, msig) over an arbitrary phenotype-NA support — shared by the
        container's own stats and the multi-trait binder (multi.MultiPhen)."""
        use64 = self.dtype == jnp.float64
        # decode temporaries are 2 arrays x [4, Nb, block] floats: cap them
        # near 512 MB so biobank-scale N (Nb ~ 100k) fits next to a >10 GB
        # packed matrix in HBM
        nb = self.layout.n_bytes
        elt = 8 if use64 else 4
        cap = max(64, int(2 ** 29 // max(1, 2 * 4 * nb * elt)))
        block = min(512, self.Mpad, ((cap + 63) // 64) * 64)
        while self.Mpad % block:
            block //= 2
        if self.mesh is not None:
            stats = jax.jit(
                jax.shard_map(
                    lambda wd, na: _marker_stats_kernel(
                        wd, na, float(nonas), float(self.alpha_scale),
                        block=block, use64=use64),
                    mesh=self.mesh,
                    in_specs=(P(None, "m"), P(None, None)),
                    out_specs=P("m"), check_vma=False,
                )
            )
            mave, msig = stats(self.words, na_planar)
        else:
            mave, msig = _marker_stats_kernel(
                self.words, na_planar, float(nonas),
                float(self.alpha_scale), block=block, use64=use64)
        pad_mask = (jnp.arange(self.Mpad) < self.M)
        return (jnp.where(pad_mask, mave, 0.0).astype(self.dtype),
                jnp.where(pad_mask, msig, 0.0).astype(self.dtype))

    def compute_marker_statistics(self) -> None:
        self.mave, self.msig = self.marker_stats_for(self.na_planar, self.nonas)

    def compute_people_statistics(self):
        """Per-individual stats for the XXT preconditioner (data.cpp:558-716).

        Returns planar (mave_p, msig_p, numb_p) each f[4, Nb] where msig_p is
        sqrt((n_i-1)/(sum v^2 - n_i mean_i^2)) on non-NA slots, 0 elsewhere.
        """
        # sum_m value  where value = (a - mave)*msig*b per slot: fold msig/mave
        # into the standard a@w - b@u contraction (exact since a=0 wherever b=0)
        w = self.msig
        u = self.mave * self.msig
        sum_v = self._raw_ax_once(w, u)
        # count of genotype-non-missing markers per slot: a@0 - b@(-1) = sum b
        numb = self._raw_ax_once(jnp.zeros_like(w), -jnp.ones_like(u))
        # sum_m value^2 is quadratic in the decode -> dedicated blocked pass
        if self.mesh is not None:
            sumsq = jax.jit(
                jax.shard_map(
                    lambda wd, mv, ms: jax.lax.psum(_people_sumsq(wd, mv, ms), "m"),
                    mesh=self.mesh,
                    in_specs=(P(None, "m"), P("m"), P("m")),
                    out_specs=P(None, None), check_vma=False,
                )
            )(self.words, self.mave.astype(jnp.float32), self.msig.astype(jnp.float32))
        else:
            sumsq = _people_sumsq(self.words, self.mave.astype(jnp.float32),
                                  self.msig.astype(jnp.float32))
        na = self.na_planar
        numb = numb * na
        mave_p = jnp.where(numb > 0, sum_v * na / jnp.where(numb == 0, 1.0, numb), 0.0)
        denom = sumsq * na - numb * mave_p**2
        prec = jnp.where((na > 0) & (denom != 0), (numb - 1) / jnp.where(denom == 0, 1.0, denom), 0.0)
        msig_p = jnp.sqrt(jnp.maximum(prec, 0.0))
        return mave_p.astype(self.dtype), msig_p.astype(self.dtype), numb.astype(self.dtype)

    # ---------------------------------------------------------------- matvec

    @property
    def inv_sqrt_n(self) -> float:
        return 1.0 / float(np.sqrt(self.N))

    @property
    def op(self) -> "BedOp":
        """The operator arrays as a pytree — pass this THROUGH jit boundaries
        (capturing the packed words as jaxpr constants makes XLA try to
        constant-fold multi-GB decodes)."""
        return BedOp(words=self.words, mave=self.mave, msig=self.msig,
                     na_planar=self.na_planar, m_mask=self.m_mask)

    @property
    def geno_complete(self) -> bool:
        """True when no genotype is missing among real samples x markers.
        Imputed biobank data is complete; the products then skip the whole
        non-missing-indicator contraction (b = 1 collapses to sums)."""
        if self._complete is None:
            nm = self.n_mask_planar.astype(jnp.float32)[:, :, None]
            _, at = self.packed_products(complete=False)
            _, bv = jax.jit(at)(self.words, nm)
            # reduce on device: bv may be sharded across processes
            n, m = float(self.N), self.M
            ok = jax.jit(lambda b: jnp.all(jnp.where(
                jnp.arange(b.shape[0]) < m, b, n) == n))(bv[:, 0])
            self._complete = bool(np.asarray(ok))
        return self._complete

    def local_products(self, complete: Optional[bool] = None):
        """(axm, atxm) over one shard's packed words — the one place that
        picks the implementation (ops/matvec.py module doc):

            axm(words, W, U) -> z[4, Nb, B] = A_a W - A_b U
            atxm(words, V)   -> (av[M, B], bv), bv [M, B] or, on the
                                complete path, the column sums [B].
        """
        complete = self.geno_complete if complete is None else complete
        if self.backend == "xla":
            return (functools.partial(matvec.axm_xla, complete=complete,
                                      dtype=self.dtype),
                    functools.partial(matvec.atxm_xla, complete=complete,
                                      dtype=self.dtype))
        interpret = self.backend == "interpret"
        return (functools.partial(matvec.axm_pallas, complete=complete,
                                  interpret=interpret),
                functools.partial(matvec.atxm_pallas, complete=complete,
                                  interpret=interpret))

    def packed_products(self, complete: Optional[bool] = None):
        """local_products over the whole (possibly marker-sharded) matrix:
        under a mesh each device runs its slab and axm ends in a psum."""
        complete = self.geno_complete if complete is None else complete
        ax, at = self.local_products(complete)
        if self.mesh is None:
            return ax, at
        ax_sh = jax.shard_map(
            lambda g, W, U: jax.lax.psum(ax(g, W, U), "m"),
            mesh=self.mesh, in_specs=(P(None, "m"), P("m", None),
                                      P("m", None)),
            out_specs=P(None, None, None), check_vma=False)
        at_sh = jax.shard_map(
            at, mesh=self.mesh, in_specs=(P(None, "m"), P(None, None, None)),
            out_specs=(P("m", None), P(None) if complete else P("m", None)),
            check_vma=False)
        return ax_sh, at_sh

    def fns(self):
        """(ax_fn, atx_fn) with signatures (op, x) / (op, v_planar): the
        B=1 case of fns_multi."""
        axm_fn, atxm_fn = self.fns_multi()

        def ax_fn(op: BedOp, x):
            """A @ x -> planar [4, Nb] (reference Ax, data.cpp:848-1005):
            standardization, na_lut output masking, 1/sqrt(N), allreduce."""
            return axm_fn(op, x[:, None])[..., 0]

        def atx_fn(op: BedOp, v_planar):
            """A^T @ v -> [Mpad] (reference ATx/dot_product, data.cpp:728-835);
            input is NA-masked like the reference's filtered phenotypes."""
            return atxm_fn(op, v_planar[..., None])[:, 0]

        return ax_fn, atx_fn

    def fns_multi(self):
        """(axm_fn, atxm_fn) — B right-hand sides per decode pass.

        One pass over the packed matrix serves all B columns (block-CG,
        multi-trait, LOCO batching); signatures (op, X[Mpad, B]) ->
        z[4, Nb, B] and (op, V[4, Nb, B]) -> [Mpad, B].  The operator's
        statistics may be per column: ``mave``/``msig`` [Mpad] or [Mpad, B]
        and ``na_planar`` [4, Nb] or [4, Nb, B] (multi.MultiPhen).
        """
        dtype, scale = self.dtype, self.inv_sqrt_n
        ax_raw, at_raw = self.packed_products()

        def col(x):
            return x[:, None] if x.ndim == 1 else x

        def na3(na):
            return na[:, :, None] if na.ndim == 2 else na

        def axm_fn(op: BedOp, X):
            W = col(op.msig) * X.astype(op.msig.dtype)
            U = col(op.mave) * W
            z = ax_raw(op.words, W, U)
            return z.astype(dtype) * na3(op.na_planar) * scale

        def atxm_fn(op: BedOp, V):
            v = V.astype(dtype) * na3(op.na_planar)
            av, bv = at_raw(op.words, v)
            return ((av.astype(dtype) - col(op.mave) * bv.astype(dtype))
                    * col(op.msig) * scale)

        return axm_fn, atxm_fn

    def window_fns_multi(self, lbw: int):
        """(axm_w, atxm_w) over a DYNAMIC word-row window [sbw, sbw+lbw).

        The device-side reshape of the reference's (SB, LB) byte-window
        matvec arguments (data.cpp:728-801, 852) used by the reduced-subset
        CG path (--red, vamp.cpp:561-596, 1096-1110): each pass streams only
        ``lbw / n_words`` of the packed matrix.  ``sbw`` is a traced scalar
        (word-row offset, one word row = 4 planar bytes = 16 individuals),
        so the window can move every iteration inside one jitted step.
        Marker statistics stay those of the FULL data and the scale becomes
        1/sqrt(16*lbw) (data.cpp:825-832).

        Signatures: axm_w(op, X[Mpad, B], sbw) -> z[4, 4*lbw, B] and
        atxm_w(op, V[4, 4*lbw, B], sbw) -> [Mpad, B].
        """
        mesh, dtype = self.mesh, self.dtype
        lbw = int(lbw)
        scale = 1.0 / float(np.sqrt(16 * lbw))
        complete = self.geno_complete
        raw_ax, raw_atx = self.local_products(complete)

        def slice_words(words, sbw):
            return jax.lax.dynamic_slice(
                words, (sbw, 0), (lbw, words.shape[1]))

        def slice_na(na, sbw):
            return jax.lax.dynamic_slice(na, (0, 4 * sbw), (4, 4 * lbw))

        def ax_local(words, na, W, U, sbw):
            z = raw_ax(slice_words(words, sbw), W, U)
            return z.astype(dtype) * slice_na(na, sbw)[:, :, None]

        def atx_local(words, na, V, sbw):
            v = V.astype(dtype) * slice_na(na, sbw)[:, :, None]
            av, bv = raw_atx(slice_words(words, sbw), v)
            return av.astype(dtype), bv.astype(dtype)

        if mesh is not None:
            ax_sh = jax.shard_map(
                lambda w_, na, W, U, sbw: jax.lax.psum(
                    ax_local(w_, na, W, U, sbw), "m"),
                mesh=mesh,
                in_specs=(P(None, "m"), P(None, None), P("m", None),
                          P("m", None), P()),
                out_specs=P(None, None, None), check_vma=False)
            atx_sh = jax.shard_map(
                atx_local, mesh=mesh,
                in_specs=(P(None, "m"), P(None, None), P(None, None, None),
                          P()),
                out_specs=(P("m", None), P(None) if complete
                           else P("m", None)), check_vma=False)
        else:
            ax_sh, atx_sh = ax_local, atx_local

        def axm_w(op: BedOp, X, sbw):
            W = op.msig[:, None] * X.astype(op.msig.dtype)
            U = op.mave[:, None] * W
            return ax_sh(op.words, op.na_planar, W, U, sbw) * scale

        def atxm_w(op: BedOp, V, sbw):
            av, bv = atx_sh(op.words, op.na_planar, V, sbw)
            return (av - op.mave[:, None] * bv) * op.msig[:, None] * scale

        return axm_w, atxm_w

    def ax(self, x: jax.Array) -> jax.Array:
        ax_fn, _ = self.fns()
        return ax_fn(self.op, x)

    def atx(self, v_planar: jax.Array) -> jax.Array:
        _, atx_fn = self.fns()
        return atx_fn(self.op, v_planar)

    def axm(self, X: jax.Array) -> jax.Array:
        axm_fn, _ = self.fns_multi()
        return axm_fn(self.op, X)

    def atxm(self, V: jax.Array) -> jax.Array:
        _, atxm_fn = self.fns_multi()
        return atxm_fn(self.op, V)

    def _raw_ax_once(self, w, u):
        """Unscaled, unmasked sum_m a*w - b*u (people-stats helper)."""
        ax, _ = self.packed_products(complete=False)
        return jax.jit(ax)(self.words, w[:, None], u[:, None])[..., 0]

    def zx(self, eff: jax.Array) -> jax.Array:
        """Covariate matvec Z @ eff -> planar [4, Nb] (reference data.cpp:1050)."""
        z = self.covs_np @ np.asarray(eff)
        return jnp.asarray(self.layout.planarize(z), self.dtype)

    # ---------------------------------------------------------------- misc

    @property
    def covs_np(self) -> np.ndarray:
        assert self.covs is not None, "no covariates loaded"
        return self.covs

    def read_covariates(self, path: str, n_cov: int) -> None:
        self.covs = plink.read_covariates(path, n_cov)

    def chromosomes(self) -> np.ndarray:
        if self._chroms is None:
            assert self.bim_path, "no .bim file given"
            self._chroms = plink.read_chromosomes(self.bim_path, self.M, self.S)
        return self._chroms

    def filter_pheno(self) -> jax.Array:
        """NA-zeroed standardized phenotype, planar (reference data.cpp:1065)."""
        return self.y_planar * self.na_planar

    def planarize(self, v: np.ndarray) -> jax.Array:
        return jnp.asarray(self.layout.planarize(np.asarray(v)), self.dtype)

    def deplanarize(self, vp: jax.Array) -> np.ndarray:
        arr = self.layout.deplanarize(np.asarray(vp))
        # sample_window views: window individuals appear at the origin so
        # callers' [: self.N] slicing works like a standalone container
        return arr[self.n_offset:] if self.n_offset else arr

    def pad_m(self, x: np.ndarray, fill: float = 0.0) -> jax.Array:
        out = np.full((self.Mpad,), fill, dtype=np.float64)
        out[: self.M] = np.asarray(x)
        return jnp.asarray(out, self.dtype)

    @property
    def m_mask(self) -> jax.Array:
        """f[Mpad]: 1 on real markers, 0 on padding."""
        return (jnp.arange(self.Mpad) < self.M).astype(self.dtype)

    @property
    def n_mask_planar(self) -> jax.Array:
        """f[4, Nb]: 1 on real individuals (including phenotype-NA ones)."""
        return jnp.asarray(self.layout.planar_to_orig() >= 0, self.dtype)

    def covs_planar(self) -> jax.Array:
        """Covariates as planar [4, Nb, C] (zeros at padding slots)."""
        Z = self.covs_np  # [N, C]
        return jnp.asarray(self.layout.planarize(Z.T).transpose(1, 2, 0), self.dtype)


@functools.partial(jax.jit, static_argnames=("block",))
def _people_sumsq(words, mave, msig, block=0):
    """sum_m ((a - mave_m) * msig_m)^2 * b per planar slot -> f32[4, Nb]."""
    Nw, M = words.shape
    if not block:
        # cap decode temporaries (2 x [4, 4Nw, block] f32) near 512 MB for
        # biobank-scale N, like marker_stats_for
        cap = max(64, int(2 ** 29 // max(1, 2 * 16 * Nw * 4)))
        block = min(512, M, ((cap + 63) // 64) * 64)
        while M % block:
            block //= 2

    def body(i, acc):
        blk = jax.lax.dynamic_slice(words, (0, i * block), (Nw, block))
        mv = jax.lax.dynamic_slice(mave, (i * block,), (block,))
        ms = jax.lax.dynamic_slice(msig, (i * block,), (block,))
        a, b = matvec.decode_planar_dense(blk, jnp.float32)  # [4, Nb, blk]
        v = (a - mv[None, None, :]) * ms[None, None, :] * b
        return acc + jnp.sum(v * v, axis=2)

    nb4 = 4 * Nw
    acc = jnp.zeros((4, nb4), jnp.float32)
    return jax.lax.fori_loop(0, M // block, body, acc)


@dataclasses.dataclass
class GenoDense:
    """Dense design-matrix container (methylation path, reference
    data.cpp:241-278; matvecs data.cpp:770-788, 1010-1045).

    Keeps X as f32[M, N] on device; N-vectors use ORIGINAL order padded to
    the planar width so the engine sees the same [4, Nb] planar interface
    (the planar permutation is identity-equivalent for dense data: we simply
    planarize/deplanarize at the boundary like GenoBed).
    """

    layout: PlanarLayout
    N: int
    Mt: int
    M: int
    S: int
    Mpad: int
    X: jax.Array              # f[Mpad, N]
    mave: jax.Array
    msig: jax.Array
    na_planar: jax.Array
    y_planar: jax.Array
    nonas: int
    intercept: float
    scale: float
    alpha_scale: float = 1.0
    bim_path: str = ""
    mesh: Optional[Mesh] = None
    dtype: jnp.dtype = jnp.float32
    covs: Optional[np.ndarray] = None
    backend: str = "xla"
    _chroms: Optional[np.ndarray] = None

    @classmethod
    def from_arrays(cls, X: np.ndarray, y_raw: np.ndarray, N: int,
                    Mt: int | None = None, S: int = 0,
                    standardize_phen: bool = True, alpha_scale: float = 1.0,
                    mesh: Optional[Mesh] = None, dtype=jnp.float32,
                    bim_path: str = "", marker_align: int = 8, **_kw) -> "GenoDense":
        M = X.shape[0]
        Mt = M if Mt is None else Mt
        lay = PlanarLayout.create(N, word_align=8)
        n_shards = mesh.devices.size if mesh is not None else 1
        Mpad = _round_up(max(M, 1), marker_align * n_shards)
        Xp = np.zeros((Mpad, N))
        Xp[:M] = X

        isna = np.isnan(y_raw)
        nonas = int((~isna).sum())
        if standardize_phen and nonas > 1:
            avg = float(np.nanmean(y_raw))
            sqn = float(np.sqrt((nonas - 1) / np.nansum((y_raw - avg) ** 2)))
        else:
            avg, sqn = 0.0, 1.0
        y = np.where(isna, 0.0, y_raw) * sqn
        na = (~isna).astype(np.float64)

        na_dense = na  # [N]
        cnt = na_dense.sum()
        mave = (Xp * na_dense).sum(1) / cnt
        dev = (Xp - mave[:, None]) * na_dense
        sumsqr = (dev**2).sum(1)
        sd = np.sqrt(sumsqr / (nonas - 1.0))
        msig = np.where(sumsqr != 0, 1.0 / np.power(np.where(sd == 0, 1.0, sd), alpha_scale), 1.0)
        mave[M:] = 0.0
        msig[M:] = 0.0

        sharding = NamedSharding(mesh, P("m", None)) if mesh is not None else None
        return cls(
            layout=lay, N=N, Mt=Mt, M=M, S=S, Mpad=Mpad,
            X=jax.device_put(jnp.asarray(Xp, dtype), sharding),
            mave=jnp.asarray(mave, dtype), msig=jnp.asarray(msig, dtype),
            na_planar=jnp.asarray(lay.planarize(na), dtype),
            y_planar=jnp.asarray(lay.planarize(y), dtype),
            nonas=nonas, intercept=avg, scale=sqn, alpha_scale=alpha_scale,
            bim_path=bim_path, mesh=mesh, dtype=dtype,
        )

    @classmethod
    def from_files(
        cls, meth_path: str, phen_path: str | None, N: int, Mt: int,
        S: int = 0, M: int | None = None, **kw,
    ) -> "GenoDense":
        """Load a raw-double methylation slab + phenotype (reference
        read_methylation_data, data.cpp:241-278; only phenotype NAs are
        supported, matching the 'only non-missing methylation' restriction
        at data.cpp:498)."""
        M = Mt if M is None else M
        X = plink.read_meth_slab(meth_path, N, M, S)
        if phen_path:
            y, isna = plink.read_phen(phen_path)
            y = np.where(isna, np.nan, y)
            assert y.shape[0] == N, (y.shape, N)
        else:
            y = np.zeros(N)
        kw.pop("backend", None)  # dense path is plain XLA matmul
        return cls.from_arrays(X, y, N=N, Mt=Mt, S=S, **kw)

    @property
    def inv_sqrt_n(self) -> float:
        return 1.0 / float(np.sqrt(self.N))

    def _v_dense(self, v_planar):
        """planar [4, Nb] -> dense [N] via the fixed permutation (on device)."""
        idx = jnp.asarray(self.layout.orig_to_planar())
        return v_planar.reshape(-1)[idx]

    def _to_planar(self, v_dense):
        idx = jnp.asarray(self.layout.orig_to_planar())
        out = jnp.zeros((4 * self.layout.n_bytes,), v_dense.dtype)
        return out.at[idx].set(v_dense).reshape(4, self.layout.n_bytes)

    @property
    def op(self) -> DenseOp:
        return DenseOp(X=self.X, mave=self.mave, msig=self.msig,
                       na_planar=self.na_planar, m_mask=self.m_mask)

    def fns(self):
        dtype, scale = self.dtype, self.inv_sqrt_n
        idx = jnp.asarray(self.layout.orig_to_planar())
        nb = self.layout.n_bytes

        def ax_fn(op: DenseOp, x):
            w = op.msig * x.astype(dtype)
            z = _mm(op.X.T, w) - (op.mave * w).sum()
            zp = jnp.zeros((4 * nb,), z.dtype).at[idx].set(z).reshape(4, nb)
            return zp * op.na_planar * scale

        def atx_fn(op: DenseOp, v_planar):
            v = (v_planar * op.na_planar).reshape(-1)[idx]
            av = _mm(op.X, v)
            return (av - op.mave * v.sum()) * op.msig * scale

        return ax_fn, atx_fn

    def fns_multi(self):
        """Batched (B-column) variants; see GenoBed.fns_multi."""
        dtype, scale = self.dtype, self.inv_sqrt_n
        idx = jnp.asarray(self.layout.orig_to_planar())
        nb = self.layout.n_bytes

        def axm_fn(op: DenseOp, X):
            W = op.msig[:, None] * X.astype(dtype)           # [Mpad, B]
            Z = _mm(op.X.T, W) - (op.mave[:, None] * W).sum(0)   # [N, B]
            B = Z.shape[1]
            zp = jnp.zeros((4 * nb, B), Z.dtype).at[idx].set(Z).reshape(4, nb, B)
            return zp * op.na_planar[:, :, None] * scale

        def atxm_fn(op: DenseOp, V):
            v = (V * op.na_planar[:, :, None]).reshape(4 * nb, -1)[idx]  # [N, B]
            av = _mm(op.X, v)
            return (av - op.mave[:, None] * v.sum(0)) * op.msig[:, None] * scale

        return axm_fn, atxm_fn

    def ax(self, x):
        ax_fn, _ = self.fns()
        return ax_fn(self.op, x)

    def atx(self, v_planar):
        _, atx_fn = self.fns()
        return atx_fn(self.op, v_planar)

    def axm(self, X):
        axm_fn, _ = self.fns_multi()
        return axm_fn(self.op, X)

    def atxm(self, V):
        _, atxm_fn = self.fns_multi()
        return atxm_fn(self.op, V)

    def filter_pheno(self):
        return self.y_planar * self.na_planar

    def planarize(self, v):
        return jnp.asarray(self.layout.planarize(np.asarray(v)), self.dtype)

    def deplanarize(self, vp):
        return self.layout.deplanarize(np.asarray(vp))

    def pad_m(self, x, fill: float = 0.0):
        out = np.full((self.Mpad,), fill, dtype=np.float64)
        out[: self.M] = np.asarray(x)
        return jnp.asarray(out, self.dtype)

    @property
    def m_mask(self):
        return (jnp.arange(self.Mpad) < self.M).astype(self.dtype)

    def set_phen(self, y, standardize: bool = False):
        y = np.asarray(y, dtype=np.float64)
        isna = np.isnan(y)
        self.nonas = int((~isna).sum())
        if standardize:
            avg = float(np.nanmean(y))
            sqn = float(np.sqrt((self.nonas - 1) / np.nansum((y - avg) ** 2)))
            self.intercept, self.scale = avg, sqn
            y = y * sqn
        self.na_planar = jnp.asarray(self.layout.planarize((~isna).astype(np.float64)), self.dtype)
        self.y_planar = jnp.asarray(self.layout.planarize(np.where(isna, 0.0, y)), self.dtype)
        # marker stats depend on the phenotype NA mask (reference recomputes
        # them after every phen change, main_meth_ex.cpp -> data ctor)
        na = (~isna).astype(np.float64)
        X = np.asarray(self.X, np.float64)
        cnt = max(na.sum(), 1.0)
        mave = (X * na).sum(1) / cnt
        sumsqr = (((X - mave[:, None]) * na) ** 2).sum(1)
        sd = np.sqrt(sumsqr / max(self.nonas - 1.0, 1.0))
        msig = np.where(sumsqr != 0,
                        1.0 / np.power(np.where(sd == 0, 1.0, sd), self.alpha_scale), 1.0)
        mave[self.M:] = 0.0
        msig[self.M:] = 0.0
        self.mave = jnp.asarray(mave, self.dtype)
        self.msig = jnp.asarray(msig, self.dtype)

    @property
    def n_mask_planar(self):
        """f[4, Nb]: 1 on real individuals (API parity with GenoBed)."""
        return jnp.asarray(self.layout.planar_to_orig() >= 0, self.dtype)

    @property
    def covs_np(self):
        assert self.covs is not None, "no covariates loaded"
        return self.covs

    def read_covariates(self, path, n_cov):
        self.covs = plink.read_covariates(path, n_cov)

    def covs_planar(self):
        Z = self.covs_np
        return jnp.asarray(self.layout.planarize(Z.T).transpose(1, 2, 0),
                           self.dtype)

    def zx(self, eff):
        z = self.covs_np @ np.asarray(eff)
        return jnp.asarray(self.layout.planarize(z), self.dtype)

    def chromosomes(self):
        if self._chroms is None:
            assert self.bim_path
            self._chroms = plink.read_chromosomes(self.bim_path, self.M, self.S)
        return self._chroms
