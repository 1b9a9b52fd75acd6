"""Simulation toolkit: mixture signals, synthetic phenotypes, genotypes.

Re-designs the reference's simulation drivers (sim.cpp, sim_realistic.cpp,
sim_heavy_tails.cpp, sim_probit.cpp) and helpers (utilities.cpp:48-153) on
JAX PRNG keys: instead of rank-0 drawing with mt19937 and MPI_Send-ing the
signal to every rank (sim.cpp:150-202), every host derives the same stream
from the same key — replicated computation replaces the broadcast.
"""

from __future__ import annotations

import numpy as np


def simulate_mixture(rng: np.random.Generator, m: int, vars_, probs) -> np.ndarray:
    """Draw m iid samples from sum_j probs_j N(0, vars_j) (utilities.cpp:48-88).

    vars_[j] == 0 is the spike at zero.
    """
    vars_ = np.asarray(vars_, np.float64)
    probs = np.asarray(probs, np.float64)
    comp = rng.choice(len(probs), size=m, p=probs / probs.sum())
    std = np.sqrt(vars_[comp])
    return rng.standard_normal(m) * std


def noise_precision_from_snr(snr: float, vars_, probs, mt: int) -> float:
    """gamw from SNR and the prior's signal power (utilities.cpp:143-153)."""
    expe = float(np.dot(vars_, probs))
    return snr / mt / expe


def two_group_prior(mt: int, cv: int, h2: float):
    """The sim.cpp truth: vars {0, h2/CV}, probs {1-CV/Mt, CV/Mt} (sim.cpp:78-79)."""
    return ([0.0, h2 / cv], [1.0 - cv / mt, cv / mt])


# sim_realistic.cpp:88-89 — the reference's empirical truth mixture
REALISTIC_VARS_BASE = (0.0, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1)
REALISTIC_PROBS = (0.9595661, 0.0008876436, 0.0367001, 0.002712435,
                   0.0001066884, 8.915961e-6, 1.814535e-5)


def realistic_prior(mt: int, h2: float):
    """sim_realistic.cpp:88-95 — 7-component empirical truth mixture.

    vars_true = {0, 1e-6, ..., 1e-1} rescaled by h2 / expe_varg where
    expe_varg = Mt * sum_j probs_j * vars_j (sim_realistic.cpp:91-95), so the
    expected genetic variance over Mt markers equals h2 exactly.
    """
    expe_varg = mt * sum(p * v for p, v in
                         zip(REALISTIC_PROBS, REALISTIC_VARS_BASE))
    scale = h2 / expe_varg
    return ([v * scale for v in REALISTIC_VARS_BASE], list(REALISTIC_PROBS))


def heavy_tails_prior(mt: int, cv: int, h2: float):
    """sim_heavy_tails.cpp:87-89 — spike + 3 slabs with vars v, 10v, 100v."""
    v = h2 / cv / (1 + 10 + 100) * 3
    p = cv / mt / 3
    return ([0.0, v, 10 * v, 100 * v], [1 - cv / mt, p, p, p])


def random_genotypes(rng: np.random.Generator, m: int, n: int,
                     maf_range=(0.05, 0.5), miss_rate: float = 0.0) -> np.ndarray:
    """Binomial(2, maf) dosage codes uint8[M, N] in PLINK 2-bit encoding."""
    maf = rng.uniform(*maf_range, size=(m, 1))
    dose = rng.binomial(2, maf, size=(m, n))
    codes = np.where(dose == 2, 0, np.where(dose == 1, 2, 3)).astype(np.uint8)
    if miss_rate > 0:
        codes[rng.random((m, n)) < miss_rate] = 1
    return codes


def synth_words(N: int, M: int, seed: int = 0, miss: bool = False,
                chunk_cols: int = 4096):
    """Packed genotype words uint32[Nw, Mpad] synthesized on the device.

    Codes are uniform random bits with every "01" missing code remapped to
    "11", so the matrix is complete like imputed data.  With ``miss=True``
    about 1.6% of calls keep the missing code (an AND of four more random
    streams gates which "01"s survive): the real-cohort path.  Padded
    individuals and markers hold the all-missing pad code.  Generated in
    column chunks, since one jax.random.bits call over a multi-GB array
    runs out of memory on its temporaries."""
    import jax
    import jax.numpy as jnp
    from gvamp.ops.layout import PAD_BYTE, PlanarLayout

    lay = PlanarLayout.create(N)
    mpad = -(-M // 512) * 512
    chunk_cols = min(chunk_cols, mpad)
    assert mpad % chunk_cols == 0, (mpad, chunk_cols)
    # per word row: bits of real individuals kept, the rest set to "01"
    n = 16 * np.arange(lay.n_words)[:, None] + np.arange(16)[None, :]
    # individual 16i + r of word row i sits at bits 2r, 2r + 1
    field = np.uint32(3) << (2 * np.arange(16, dtype=np.uint32))
    keep = np.where(n < N, field[None, :], 0).sum(1).astype(np.uint32)
    pad = np.uint32(PAD_BYTE * 0x01010101)
    key = jax.random.key(seed)

    @jax.jit
    def gen(keep):
        def body(i, acc):
            def bits(s):
                return jax.random.bits(jax.random.fold_in(key, 5 * i + s),
                                       (lay.n_words, chunk_cols),
                                       dtype=jnp.uint32)
            raw = bits(0)
            lo = raw & np.uint32(0x55555555)
            hi = (raw >> np.uint32(1)) & np.uint32(0x55555555)
            is01 = lo & ~hi
            if miss:
                gate = np.uint32(0x55555555) & bits(1) & bits(2) & bits(3) \
                    & bits(4)
                is01 = is01 & ~gate
            w = raw | (is01 << np.uint32(1))
            w = (w & keep[:, None]) | (pad & ~keep[:, None])
            col = i * chunk_cols + jnp.arange(chunk_cols)[None, :]
            w = jnp.where(col < M, w, pad)
            return jax.lax.dynamic_update_slice(acc, w, (0, i * chunk_cols))
        out = jnp.zeros((lay.n_words, mpad), jnp.uint32)
        return jax.lax.fori_loop(0, mpad // chunk_cols, body, out)

    return gen(jnp.asarray(keep))


def simulate_linear_phenotype(geno, beta_true: np.ndarray, gamw: float,
                              rng: np.random.Generator) -> np.ndarray:
    """y = A (sqrt(N) beta_true) + N(0, 1/gamw) (sim.cpp:199-220).

    beta_true is in the stored/user scale; the sqrt(N) multiplication mirrors
    sim.cpp:222-224 before the matvec.
    """
    import jax.numpy as jnp

    x = geno.pad_m(beta_true * np.sqrt(geno.N))
    z = geno.deplanarize(geno.ax(jnp.asarray(x)))[: geno.N]
    noise = rng.standard_normal(geno.N) / np.sqrt(gamw)
    return z + noise


def simulate_probit_phenotype(geno, beta_true: np.ndarray, probit_var: float,
                              rng: np.random.Generator,
                              cov_effects: np.ndarray | None = None) -> np.ndarray:
    """Binary y: P(y=1) = Phi((g + Z eff)/sqrt(probit_var)) (sim_probit.cpp:191-205)."""
    import jax.numpy as jnp
    from scipy.stats import norm

    x = geno.pad_m(beta_true * np.sqrt(geno.N))
    g = geno.deplanarize(geno.ax(jnp.asarray(x)))[: geno.N]
    if cov_effects is not None and geno.covs is not None:
        g = g + geno.covs_np @ cov_effects
    u = rng.random(geno.N)
    return (u <= norm.cdf(g / np.sqrt(probit_var))).astype(np.float64)
