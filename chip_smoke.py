#!/usr/bin/env python3
"""Smoke test of the gVAMP engine on a GPU: the quickest proof it still runs.

    python chip_smoke.py               # one card: phases 1-5
    python chip_smoke.py --four-cards  # four cards: phase 6 only

Phases (one process; every number is printed beside the card's name and
power limit):

1. Device: JAX's default device must be a GPU; prints ``nvidia-smi``'s
   name and power limit.
2. Kernel parity at biobank width: packed words of N=327,680 x M=131,072
   (10.74 GB) synthesized on the card, complete and with ~1.6% missing
   calls.  The Triton kernels (``ax`` and ``atx`` at B = 1, 3, 32) against
   the blocked XLA reference (Precision.HIGHEST) on the card, and against
   a float64 NumPy decode on a 2,048-marker slab at full N.
3. CLI end to end (``gvamp.cli.main``, in-process): a seeded
   .bed/.bim/.phen of N=100,000 x M=32,768 written from packed bytes;
   linear with p-values, bin_class, robust, two-trait linear, and the
   linear model again with --dtype float64 --backend xla (the TF32 check).
4. Biobank N: the linear scan engine, 5 iterations at the phase-2 shape,
   complete and missing, on the kernel and on --backend xla.
5. N << M: dual (XXT) and primal linear engines at N=5,120 x M=524,288.
6. (--four-cards) the phase-4 problem marker-sharded over a 4-card mesh
   against the same problem on one card: linear, dual, probit and Huber
   steps, then the CLI over all visible cards.

The last line of standard output is one JSON object
``{"ok": true, "device": {"platform", "kind", "count"}}``; any failed check
raises, so the exit code is non-zero and that line is not printed.  Without
a GPU the script exits with code 2 before any phase.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

N_BIG, M_BIG = 327_680, 131_072       # bench config B: 10.74 GB packed
N_CLI, M_CLI = 100_000, 32_768        # ~0.82 GB .bed
N_X, M_X = 5_120, 524_288             # the N << M regime
SLAB = 2_048                          # float64 oracle slab (markers)

# Tolerances, as max |got - ref| over each column's max |ref|:
# * kernel vs the float32 HIGHEST reference: both accumulate in float32 in
#   different orders (sqrt(131,072) * 6e-8 ~ 2e-5); the int8 digits add at
#   most M * 3.8e-9 of the column max of the right-hand side (all-same-sign
#   worst case, ops/matvec.py), ~1e-8 relative for random signs.
TOL_REF = 2e-5
# * kernel vs float64 NumPy on the slab: int32 tile sums are exact, so only
#   the digit bound (2,048 * 3.8e-9) and float32 folding remain.
TOL_F64 = 1e-5
# * engine trajectories, kernel vs XLA reference (both float32): per-product
#   differences ~1e-6 compound through CG, EM and damping over 5 iterations.
TOL_TRAJ = 1e-3
# * gam1 after two steps, marker-sharded vs one card: sums run in another
#   order across shards and the kernel picks digit scales per shard; the
#   z-model engines' gam1 is small after two steps (probit ~3e-3) and
#   carries ~4e-4 relative reduction-order noise even in the XLA path.
TOL_SHARD = 5e-3
# * CLI linear runs over two iterations, relative difference of the noise
#   precision gamw and the Onsager alpha2 (the TF32 check):
#   - float32 run vs the same run under jax.default_matmul_precision
#     ("highest"): only a contraction without a pinned precision can change
#     (TF32 keeps 10 mantissa bits, ~5e-4 per product); pinned ones agree to
#     float32 rounding and autotuning order, ~1e-6.
TOL_TF32 = 1e-5
#   - float32 kernel vs float64 XLA reference: float32 itself departs from
#     float64 by up to ~1e-2 in alpha2 at iteration 1 (measured on the CPU,
#     where no TF32 exists: 1.0e-2 at N=8,000 x M=1,024).
TOL_F32_F64 = 3e-2
CORR_FLOOR = 0.9      # corr(estimate, true beta), CLI linear run

INTERPRET = False     # kernel in the Pallas interpreter (CPU rehearsal)
CARD = ""


def log(msg: str) -> None:
    print(f"{msg}  | {CARD}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def col_err(got, ref) -> float:
    got = np.asarray(got, np.float64).reshape(-1, np.shape(ref)[-1])
    ref = np.asarray(ref, np.float64).reshape(-1, np.shape(ref)[-1])
    den = np.maximum(np.abs(ref).max(axis=0), 1e-30)
    return float((np.abs(got - ref).max(axis=0) / den).max())


def timed(fn, *args):
    import jax
    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------- phase 2

def np_planes(words: np.ndarray):
    """float64 (a, b) [4, 4*Nw, m] decode of host words, independent of the
    package's decode: PLINK code tables applied to each 2-bit field."""
    from gvamp.ops.layout import CODE_TO_DOSAGE, CODE_TO_NONMISS
    nw, m = words.shape
    by = np.ascontiguousarray(words).view(np.uint8).reshape(nw, m, 4)
    by = by.transpose(0, 2, 1).reshape(4 * nw, m)          # row 4i + j
    codes = np.stack([(by >> (2 * k)) & 3 for k in range(4)])
    return CODE_TO_DOSAGE[codes], CODE_TO_NONMISS[codes]


def phase_kernel(N: int, M: int, widths=(1, 3, 32), slab: int = SLAB):
    import jax
    import jax.numpy as jnp
    from gvamp import sim
    from gvamp.ops import matvec
    from gvamp.ops.layout import PlanarLayout

    for path in ("complete", "missing"):
        complete = path == "complete"
        words = sim.synth_words(N, M, seed=11, miss=not complete)
        Nw, Mp = words.shape
        # rows of padded individuals are undefined on the complete path
        # (ops/matvec.py): compare real rows, feed zeros there
        real = (PlanarLayout(N=N, n_words=Nw).planar_to_orig() >= 0)[..., None]
        kax = jax.jit(lambda w, W, U: matvec.axm_pallas(
            w, W, U, complete, interpret=INTERPRET))
        kat = jax.jit(lambda w, V: matvec.atxm_pallas(
            w, V, complete, interpret=INTERPRET))
        rax = jax.jit(lambda w, W, U: matvec.axm_xla(w, W, U, complete))
        rat = jax.jit(lambda w, V: matvec.atxm_xla(w, V, complete))
        Bmax = max(widths)
        k = jax.random.split(jax.random.key(5), 3)
        W = jax.random.normal(k[0], (Mp, Bmax), jnp.float32)
        U = W * jax.random.uniform(k[1], (Mp, 1), jnp.float32, 0.0, 2.0)
        V = jax.random.normal(k[2], (4, 4 * Nw, Bmax), jnp.float32) * real
        for B in widths:
            args = (words, W[:, :B], U[:, :B])
            z, tk = timed(kax, *args)
            zr, tr = timed(rax, *args)
            e_ax = col_err(np.asarray(z) * real, np.asarray(zr) * real)
            (av, bv), tka = timed(kat, words, V[..., :B])
            (ar, br), tra = timed(rat, words, V[..., :B])
            e_at = max(col_err(av, ar), col_err(bv, br))
            log(f"[kernel] {path} B={B}: ax {tk * 1e3:.3f} ms (xla "
                f"{tr * 1e3:.3f}) err {e_ax:.2e}; atx {tka * 1e3:.3f} ms "
                f"(xla {tra * 1e3:.3f}) err {e_at:.2e}; tol {TOL_REF:.0e}")
            check(e_ax <= TOL_REF and e_at <= TOL_REF,
                  f"kernel != XLA reference ({path}, B={B})")
            del z, zr, av, bv, ar, br
        # float64 NumPy oracle on a marker slab at full N
        ws = words[:, :slab]
        a, b = np_planes(np.asarray(ws))
        Wn, Un = np.asarray(W[:slab], np.float64), np.asarray(U[:slab], np.float64)
        Vn = np.asarray(V, np.float64).reshape(-1, Bmax)
        a2, b2 = a.reshape(-1, slab), b.reshape(-1, slab)
        z64 = (a2 @ Wn - (0 if complete else b2 @ Un)).reshape(4, -1, Bmax)
        if complete:
            z64 = z64 - Un.sum(0)
        av64, bv64 = a2.T @ Vn, b2.T @ Vn
        del a, b, a2, b2
        for B in widths:
            z = kax(ws, W[:slab, :B], U[:slab, :B])
            av, bv = kat(ws, V[..., :B])
            e = max(col_err(np.asarray(z) * real, z64[..., :B] * real),
                    col_err(av, av64[:, :B]),
                    0.0 if complete else col_err(bv, bv64[:, :B]))
            log(f"[kernel] {path} B={B}: {slab}-marker slab vs float64 NumPy "
                f"err {e:.2e}; tol {TOL_F64:.0e}")
            check(e <= TOL_F64, f"kernel != float64 oracle ({path}, B={B})")
        del words, W, U, V


# ---------------------------------------------------------------- phase 3

def write_dataset(d: str, N: int, M: int, seed: int = 7):
    """Seeded .bed/.bim and phenotypes; returns (paths, beta_true)."""
    import jax.numpy as jnp
    from gvamp import sim
    from gvamp.data import GenoBed
    from gvamp.io import plink

    rng = np.random.default_rng(seed)
    mb = (N + 3) // 4

    def rbytes():
        return np.frombuffer(rng.bytes(M * mb), np.uint8).reshape(M, mb)

    # uniform 2-bit codes; "01" (missing) remapped to "11" except ~1.6%
    raw = rbytes()
    lo, hi = raw & 0x55, (raw >> 1) & 0x55
    gate = 0x55 & rbytes() & rbytes() & rbytes() & rbytes()
    bed = raw | (((lo & ~hi) & ~gate) << 1)
    if N % 4:
        bed[:, -1] &= np.uint8((1 << (2 * (N % 4))) - 1)
    paths = {k: os.path.join(d, f"smoke{k}") for k in
             (".bed", ".bim", ".phen", "_bin.phen", "_rob.phen", "_2.phen")}
    with open(paths[".bed"], "wb") as f:
        f.write(plink.BED_MAGIC)
        bed.tofile(f)
    plink.write_bim(paths[".bim"], np.repeat([1, 2], [M // 2, M - M // 2]))
    vars_t, probs_t = sim.two_group_prior(M, 500, 0.5)
    beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
    geno = GenoBed.from_arrays(bed, np.zeros(N), N=N, standardize_phen=False,
                               dtype=jnp.float32)
    y = sim.simulate_linear_phenotype(geno, beta, 2.0, rng)
    beta2 = sim.simulate_mixture(rng, M, vars_t, probs_t)
    y2 = sim.simulate_linear_phenotype(geno, beta2, 2.0, rng)
    del geno
    plink.write_phen(paths[".phen"], y)
    plink.write_phen(paths["_bin.phen"], (y > np.median(y)).astype(float))
    plink.write_phen(paths["_rob.phen"],
                     y + 0.3 * rng.standard_t(2.0, size=N))
    plink.write_phen(paths["_2.phen"], y2)
    return paths, beta, (probs_t, vars_t)


def phase_cli(N: int, M: int, iters: int = 5, devices: int = 1):
    from gvamp import cli
    from gvamp.io import vecio

    with tempfile.TemporaryDirectory(dir=os.getcwd()) as d:
        t0 = time.perf_counter()
        paths, beta, (probs, vars_) = write_dataset(d, N, M)
        log(f"[cli] wrote {N} x {M} .bed in {time.perf_counter() - t0:.1f} s")
        base = ["--run-mode", "infere", "--bed-file", paths[".bed"],
                "--bim-file", paths[".bim"], "--N", str(N), "--Mt", str(M),
                "--out-dir", d, "--devices", str(devices),
                "--probs", ",".join(map(str, probs)),
                "--vars", ",".join(map(str, vars_))]

        def run(name, *extra):
            t = time.perf_counter()
            out = cli.main(base + ["--out-name", name] + list(extra))
            log(f"[cli] {name}: {time.perf_counter() - t:.1f} s")
            return out

        x32, _, hist = run("lin", "--model", "linear", "--phen-files",
                           paths[".phen"], "--iterations", str(iters),
                           "--store-pvals", "1")
        r2 = [float(h["R2_train_1"]) for h in hist]
        corr = float(np.corrcoef(np.asarray(x32)[:M], beta)[0, 1])
        pv = vecio.read_bin_shard(os.path.join(d, "lin_pvals.bin"), M, 0)
        log(f"[cli] linear R2 {['%.4f' % r for r in r2]} corr(beta) "
            f"{corr:.4f} (floor {CORR_FLOOR}); p-values finite "
            f"{np.isfinite(pv).all()}")
        check(r2[-1] > r2[0], "R2 did not rise")
        check(corr > CORR_FLOOR, "estimate far from the true beta")
        check(np.isfinite(pv).all(), "non-finite p-values")

        if devices == 1:
            for model, phen in (("bin_class", "_bin.phen"),
                                ("robust", "_rob.phen")):
                res = run(model, "--model", model, "--phen-files",
                          paths[phen], "--iterations", "3")
                check(np.isfinite(np.asarray(res[0])).all(),
                      f"{model}: non-finite estimate")
            res = run("multi", "--model", "linear", "--phen-files",
                      paths[".phen"] + "," + paths["_2.phen"],
                      "--iterations", "3")
            check(np.isfinite(np.asarray(res[0])).all(),
                  "multi-trait: non-finite estimate")
            import jax

            def rel(h):
                return max(abs(float(hist[it][k]) - float(h[it][k]))
                           / abs(float(h[it][k]))
                           for k in ("gamw", "alpha2") for it in (0, 1))

            two = ["--model", "linear", "--phen-files", paths[".phen"],
                   "--iterations", "2"]
            with jax.default_matmul_precision("highest"):
                e_hi = rel(run("linhi", *two)[2])
            # float64 last: cli.main turns x64 on for the process
            e_64 = rel(run("lin64", *two, "--dtype", "float64",
                           "--backend", "xla")[2])
            jax.config.update("jax_enable_x64", False)
            log(f"[cli] linear gamw/alpha2 over 2 iterations: float32 vs "
                f"float32 at highest matmul precision rel diff {e_hi:.2e} "
                f"(tol {TOL_TF32:.0e}); vs float64 XLA {e_64:.2e} (tol "
                f"{TOL_F32_F64:.0e})")
            check(e_hi <= TOL_TF32, "an f32 contraction runs below full "
                                    "precision (TF32?)")
            check(e_64 <= TOL_F32_F64, "float32 run far from float64 run")


# ---------------------------------------------------------------- phase 4-6

def linear_problem(words, N: int, M: int, mesh=None, backends=("auto",),
                   seed: int = 0):
    """GenoBed containers sharing ``words`` plus a simulated phenotype."""
    from gvamp import sim
    from gvamp.data import GenoBed

    rng = np.random.default_rng(seed)
    genos = [GenoBed.from_device_words(words, np.zeros(N), N=N, M=M,
                                       standardize_phen=False, mesh=mesh,
                                       backend=be) for be in backends]
    vars_t, probs_t = sim.two_group_prior(M, 1000, 0.5)
    beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
    y = sim.simulate_linear_phenotype(genos[0], beta, 2.0, rng)
    for g in genos:
        g.set_phen(y)
    return genos, y, probs_t, vars_t


def run_scan(geno, cfg, probs, vars_, k: int):
    """k scanned iterations -> (per-iteration metrics, s/iteration)."""
    import jax
    from gvamp import linear

    state = linear.init_state(geno, cfg, probs, vars_)
    aux = linear.make_aux(geno, cfg)
    scan = linear.make_scan_step(geno, cfg, k)
    _, m = scan(state, aux)
    m = jax.device_get(m)
    t0 = time.perf_counter()
    jax.block_until_ready(scan(state, aux))
    return m, (time.perf_counter() - t0) / k


def phase_biobank(N: int, M: int, iters: int = 5):
    from gvamp import linear, sim

    cfg = linear.VampConfig(max_iter=iters, rho=0.15, gam1_init=1e-8,
                            gamw_init=2.0)
    for path in ("complete", "missing"):
        words = sim.synth_words(N, M, seed=2, miss=path == "missing")
        genos, _, probs, vars_ = linear_problem(
            words, N, M, backends=("auto", "xla"))
        (mk, tk), (mx, tx) = (run_scan(g, cfg, probs, vars_, iters)
                              for g in genos)
        e = max(col_err(np.asarray(mk[key])[:, None],
                        np.asarray(mx[key])[:, None])
                for key in ("gam1", "gamw"))
        log(f"[biobank] {path} N={N} M={M}: {genos[0].backend} "
            f"{tk:.4f} s/it, xla {tx:.4f} s/it; gam1 "
            f"{['%.4e' % g for g in mk['gam1']]}; gam1/gamw trajectory "
            f"diff {e:.2e} (tol {TOL_TRAJ:.0e})")
        check(np.isfinite(mk["gam1"]).all(), "non-finite gam1")
        check(e <= TOL_TRAJ, f"kernel and XLA trajectories differ ({path})")
        del genos, words


def phase_small_n(N: int, M: int, iters: int = 3):
    from gvamp import linear, sim

    words = sim.synth_words(N, M, seed=3)
    (geno,), _, probs, vars_ = linear_problem(words, N, M)
    for name, xxt in (("dual", True), ("primal", False)):
        cfg = linear.VampConfig(max_iter=iters, rho=0.15, gam1_init=1e-8,
                                gamw_init=2.0, use_xxt=xxt,
                                cg_extrapolate=not xxt)
        m, t = run_scan(geno, cfg, probs, vars_, iters)
        log(f"[N<<M] {name} N={N} M={M}: {t:.4f} s/it; R2 "
            f"{['%.4f' % r for r in m['R2_train_1']]}")
        check(np.isfinite(m["R2_train_1"]).all(), f"{name}: non-finite R2")


def phase_four_cards(N: int, M: int, n_dev: int = 4, cli_shape=(20_000, 8_192)):
    """Marker-sharded engines on an n_dev mesh vs the same problem on one."""
    import jax
    from jax.sharding import Mesh
    from gvamp import linear, probit, robust, sim

    devs = jax.devices()
    check(len(devs) >= n_dev, f"--four-cards needs {n_dev} devices")
    mesh = Mesh(np.array(devs[:n_dev]), ("m",))
    words = sim.synth_words(N, M, seed=4, miss=True)
    (g1,), y, probs, vars_ = linear_problem(words, N, M)
    from gvamp import dist
    words_sh = dist.words_global_from_host(np.asarray(words), mesh)
    (gm,), _, _, _ = linear_problem(words_sh, N, M, mesh=mesh)
    yb = (y > np.median(y)).astype(np.float64)
    cases = (("linear", linear, linear.VampConfig, y),
             ("dual", linear, lambda **kw: linear.VampConfig(
                 use_xxt=True, cg_extrapolate=False, **kw), y),
             ("probit", probit, probit.ProbitConfig, yb),
             ("huber", robust, robust.RobustConfig, y))
    for name, mod, mk_cfg, yy in cases:
        cfg = mk_cfg(max_iter=2, gam1_init=1e-8)
        gams, ts = [], []
        for g in (gm, g1):
            g.set_phen(yy)
            st = mod.init_state(g, cfg, probs, vars_)
            aux = mod.make_aux(g, cfg)
            step = mod.make_step(g, cfg)
            for _ in range(2):   # step 2 recompiles: the state's types change
                st, m = step(st, aux)
            gams.append(float(m["gam1"]))
            t0 = time.perf_counter()
            jax.block_until_ready(step(st, aux))
            ts.append(time.perf_counter() - t0)
        e = abs(gams[0] - gams[1]) / abs(gams[1])
        log(f"[{n_dev} cards] {name} N={N} M={M}: gam1 {gams[0]:.6e} vs one "
            f"card {gams[1]:.6e} (rel diff {e:.1e}, tol {TOL_SHARD:.0e}); "
            f"step 3 {ts[0]:.4f} s vs {ts[1]:.4f} s")
        check(np.isfinite(gams[0]) and e <= TOL_SHARD,
              f"{name}: sharded step differs from one card")
    del g1, gm, words, words_sh
    # the CLI's default mesh spans every visible card
    phase_cli(*cli_shape, iters=3, devices=0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the marker-sharded 4-card phase")
    args = ap.parse_args(argv)
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX default device: {dev})",
              file=sys.stderr)
        return 2
    from gvamp import runtime

    global CARD
    runtime.enable_compile_cache()
    CARD = runtime.card_info()
    print(CARD, flush=True)
    log(f"[device] {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards(N_BIG, M_BIG)
    else:
        for name, fn, shape in (("kernel", phase_kernel, (N_BIG, M_BIG)),
                                ("cli", phase_cli, (N_CLI, M_CLI)),
                                ("biobank", phase_biobank, (N_BIG, M_BIG)),
                                ("N<<M", phase_small_n, (N_X, M_X))):
            t = time.perf_counter()
            fn(*shape)
            log(f"[{name}] phase done in {time.perf_counter() - t:.1f} s")
    log(f"[total] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
