"""Round-3 feature tests: reference-grade option validation, a sweep
guaranteeing no flag is silently ignored, full-fidelity resume (linear and
probit), probit both-mode confusion matrix at the CLI, --red reduced-subset
solves, multi-trait scan-mode equality, and probit/Huber shard invariance
(the reference's collectives are model-agnostic, vamp_probit.cpp /
vamp_Huber.cpp reuse the same Ax/ATx)."""

import dataclasses
import pathlib
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gvamp import cli, linear, probit, robust, sim
from gvamp.data import GenoBed
from gvamp.options import Options
from gvamp.io import plink, vecio
from test_data_layer import make_bed
from test_linear_vamp import build_sim


# ---------------------------------------------------------------- options

BASE_ARGS = ["--run-mode", "infere", "--bed-file", "x.bed",
             "--phen-files", "x.phen", "--N", "100", "--Mt", "50"]


@pytest.mark.parametrize("args", [
    ["--run-mode", "infere", "--phen-files", "x.phen", "--N", "9", "--Mt", "9"],
    ["--run-mode", "infere", "--bed-file", "x.bed", "--phen-files", "p",
     "--Mt", "50"],                                     # missing --N
    ["--run-mode", "infere", "--bed-file", "x.bed", "--phen-files", "p",
     "--N", "100"],                                     # missing --Mt
    ["--run-mode", "infere", "--bed-file", "x.bed", "--N", "9", "--Mt", "9"],
    ["--run-mode", "test", "--N-test", "10", "--Mt-test", "10",
     "--estimate-file", "e.bin"],                       # missing test bed
    ["--run-mode", "test", "--bed-file-test", "x.bed", "--Mt-test", "10",
     "--estimate-file", "e.bin", "--phen-files-test", "p"],  # missing N-test
    BASE_ARGS + ["--rho", "0.0"],
    BASE_ARGS + ["--rho", "1.5"],
    BASE_ARGS + ["--iterations", "0"],
    BASE_ARGS + ["--CG-max-iter", "0"],
    BASE_ARGS + ["--h2", "1.5"],
    BASE_ARGS + ["--store-pvals", "7"],
    BASE_ARGS + ["--test-iter-range", "5,2"],
    BASE_ARGS + ["--probs", "0.5,0.5", "--vars", "0.0,0.1,0.2"],
    BASE_ARGS + ["--model", "bin_class", "--gamma-damp", "0.5"],
    BASE_ARGS + ["--stab-gamma", "0.0"],                # out of (0, 1]
    BASE_ARGS + ["--stab-gamma", "0.5"],                # linear-only reject
    BASE_ARGS + ["--model", "robust", "--red", "1"],
    BASE_ARGS + ["--model", "bin_class", "--use-XXT-denoiser", "1"],
    BASE_ARGS + ["--red", "1", "--use-XXT-denoiser", "1"],
    ["--run-mode", "infere", "--bed-file", "x.bed",
     "--phen-files", "a.phen,b.phen", "--N", "100", "--Mt", "50",
     "--red", "1"],                                     # multi-trait --red
])
def test_option_check_rejects(args):
    """Inconsistent flag sets fail fast with a message (check_options,
    options.cpp:444-492), never as a downstream shape error."""
    with pytest.raises(SystemExit):
        Options.from_args(args).check()


def test_option_check_accepts_valid():
    opt = Options.from_args(BASE_ARGS + ["--rho", "0.5"])
    opt.check()  # must not raise


def test_every_option_field_is_consumed():
    """Every Options field must be read somewhere outside options.py —
    the guard that would have caught the round-2 `--red` silent no-op
    (a flag that parses but changes nothing loses user intent)."""
    pkg = pathlib.Path(cli.__file__).parent
    src = "\n".join(
        p.read_text() for p in pkg.rglob("*.py") if p.name != "options.py")
    missing = []
    consumed_inside = {"out_dir", "out_name"}  # via the out_prefix property
    for f in dataclasses.fields(Options):
        if f.name in consumed_inside:
            continue
        # consumed as `opt.<name>` / `o.<name>` / keyword `<name>=`
        pat = rf"\.{re.escape(f.name)}\b"
        if not re.search(pat, src):
            missing.append(f.name)
    assert not missing, f"Options fields never read outside options.py: {missing}"


# ---------------------------------------------------------------- resume

@pytest.mark.slow
def test_resume_matches_uninterrupted_linear():
    """3 iterations + resume(3 more) == 6 uninterrupted iterations: the
    engine config and complete state round-trip through resume_state."""
    geno, beta, vars_t, probs_t = build_sim(N=400, M=200)
    cfg6 = linear.VampConfig(max_iter=6, rho=0.3, seed=5)
    xa, sa, ha = linear.infer(geno, cfg6, probs_t, vars_t, verbose=False)

    cfg3 = dataclasses.replace(cfg6, max_iter=3)
    xb3, sb3, _ = linear.infer(geno, cfg3, probs_t, vars_t, verbose=False)
    xb, sb, hb = linear.infer(geno, cfg6, probs_t, vars_t, verbose=False,
                              resume_state=sb3)
    np.testing.assert_allclose(xb, xa, rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(float(sb.gam1), float(sa.gam1), rtol=1e-10)
    assert len(hb) == 3  # only the resumed tail is re-run


@pytest.mark.slow
def test_resume_matches_uninterrupted_probit():
    rng = np.random.default_rng(3)
    N, M = 600, 150
    codes = sim.random_genotypes(rng, M, N)
    geno = GenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                               standardize_phen=False, dtype=jnp.float64)
    vars_t, probs_t = sim.two_group_prior(M, 15, 0.9)
    beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
    y = sim.simulate_probit_phenotype(geno, beta, 1.0, rng)
    geno.set_phen(y)

    cfg6 = probit.ProbitConfig(max_iter=6, rho=0.3, seed=2)
    xa, sa, _ = probit.infer(geno, cfg6, probs_t, vars_t, verbose=False)
    cfg3 = dataclasses.replace(cfg6, max_iter=3)
    _, sb3, _ = probit.infer(geno, cfg3, probs_t, vars_t, verbose=False)
    xb, sb, hb = probit.infer(geno, cfg6, probs_t, vars_t, verbose=False,
                              resume_state=sb3)
    np.testing.assert_allclose(xb, xa, rtol=1e-10, atol=1e-13)
    assert len(hb) == 3


@pytest.mark.slow
def test_resume_matches_uninterrupted_multi(tmp_path):
    """Multi-trait resume: 2 iterations + resume(2) == 4 uninterrupted,
    with the state round-tripped through the .npz checkpoint layer."""
    from gvamp import multi
    from gvamp.ckpt import save_state, load_state

    rng = np.random.default_rng(11)
    N, M, T = 300, 128, 2
    codes = sim.random_genotypes(rng, M, N, miss_rate=0.01)
    geno = GenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                               standardize_phen=False, dtype=jnp.float64)
    vars_t, probs_t = sim.two_group_prior(M, 10, 0.7)
    ys = []
    for _ in range(T):
        beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
        ys.append(sim.simulate_linear_phenotype(geno, beta, 1 / 0.3, rng))
    mp = multi.MultiPhen.build(geno, ys, standardize=False)

    cfg4 = linear.VampConfig(max_iter=4, rho=0.3, seed=7,
                             stop_criteria_thr=0.0)
    xa, sa, _ = multi.infer(mp, cfg4, probs_t, vars_t, verbose=False)

    cfg2 = dataclasses.replace(cfg4, max_iter=2)
    _, sb2, _ = multi.infer(mp, cfg2, probs_t, vars_t, verbose=False)
    ck = str(tmp_path / "multi.npz")
    save_state(ck, sb2, it=2, model="linear", T=T,
               cfg=dataclasses.asdict(cfg2))
    loaded, meta = load_state(ck, multi.MultiState)
    assert meta["T"] == T and meta["it"] == 2
    xb, sb, hb = multi.infer(mp, cfg4, probs_t, vars_t, verbose=False,
                             resume_state=loaded)
    np.testing.assert_allclose(xb, xa, rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(np.asarray(sb.gam1), np.asarray(sa.gam1),
                               rtol=1e-10)
    assert len(hb) == 2  # only the resumed tail is re-run


@pytest.mark.slow
def test_cli_multi_trait_resume(tmp_path):
    """CLI: multi-trait --checkpoint + run-mode restart --resume reaches
    the same iteration-4 per-trait estimates as an uninterrupted run."""
    rng = np.random.default_rng(31)
    N, M, T = 300, 96, 2
    codes = sim.random_genotypes(rng, M, N, miss_rate=0.01)
    bed = str(tmp_path / "m.bed")
    plink.write_bed(bed, codes)
    geno = GenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                               standardize_phen=False, dtype=jnp.float64)
    vars_t, probs_t = sim.two_group_prior(M, 10, 0.7)
    pfs = []
    for t in range(T):
        beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
        y = sim.simulate_linear_phenotype(geno, beta, 1 / 0.3, rng)
        pf = str(tmp_path / f"m{t}.phen")
        plink.write_phen(pf, y)
        pfs.append(pf)

    base = ["--model", "linear", "--bed-file", bed,
            "--phen-files", ",".join(pfs),
            "--N", str(N), "--Mt", str(M), "--rho", "0.3",
            "--dtype", "float64",
            "--probs", ",".join(map(str, probs_t)),
            "--vars", ",".join(map(str, vars_t)),
            "--out-dir", str(tmp_path), "--verbosity", "0"]
    cli.main(["--run-mode", "infere", "--iterations", "4",
              "--out-name", "full", "--checkpoint",
              str(tmp_path / "full.npz")] + base)
    cli.main(["--run-mode", "infere", "--iterations", "2",
              "--out-name", "half", "--checkpoint",
              str(tmp_path / "half.npz")] + base)
    cli.main(["--run-mode", "restart", "--iterations", "2",
              "--out-name", "res", "--resume",
              str(tmp_path / "half.npz")] + base)
    for t in range(T):
        e4 = vecio.read_bin_shard(str(tmp_path / f"full_phen{t}_it_4.bin"),
                                  M, 0)
        er = vecio.read_bin_shard(str(tmp_path / f"res_phen{t}_it_4.bin"),
                                  M, 0)
        np.testing.assert_allclose(er, e4, rtol=1e-8, atol=1e-12)

    # trait-count mismatch fails fast
    with pytest.raises(SystemExit):
        cli.main(["--run-mode", "restart", "--iterations", "1",
                  "--out-name", "bad", "--resume", str(tmp_path / "half.npz"),
                  "--model", "linear", "--bed-file", bed,
                  "--phen-files", pfs[0],
                  "--N", str(N), "--Mt", str(M), "--dtype", "float64",
                  "--probs", ",".join(map(str, probs_t)),
                  "--vars", ",".join(map(str, vars_t)),
                  "--out-dir", str(tmp_path), "--verbosity", "0"])


# ---------------------------------------------------------------- shard inv

def _probit_sim(mesh=None, N=500, M=256):
    rng = np.random.default_rng(9)
    codes = sim.random_genotypes(rng, M, N, miss_rate=0.01)
    geno = GenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                               standardize_phen=False, dtype=jnp.float64,
                               mesh=mesh)
    vars_t, probs_t = sim.two_group_prior(M, 15, 0.9)
    beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
    y = sim.simulate_probit_phenotype(geno, beta, 1.0, rng)
    geno.set_phen(y)
    return geno, vars_t, probs_t, y


def _mesh8():
    devs = jax.devices()
    assert len(devs) >= 8, "conftest must provide 8 virtual devices"
    return jax.sharding.Mesh(np.array(devs[:8]), ("m",))


@pytest.mark.slow
def test_probit_shard_invariance():
    """Probit results identical on 1 device and an 8-device marker mesh —
    the reference's collectives are model-agnostic (vamp_probit.cpp reuses
    the same Ax/ATx Allreduce as vamp.cpp)."""
    g1, vars_t, probs_t, _ = _probit_sim()
    g8, _, _, _ = _probit_sim(mesh=_mesh8())
    cfg = probit.ProbitConfig(max_iter=4, rho=0.3, seed=1)
    x1, s1, h1 = probit.infer(g1, cfg, probs_t, vars_t, verbose=False)
    x8, s8, h8 = probit.infer(g8, cfg, probs_t, vars_t, verbose=False)
    np.testing.assert_allclose(x1, x8, rtol=1e-8, atol=1e-12)
    for k in ("gam1", "tau1", "beta1"):
        np.testing.assert_allclose(float(h1[-1][k]), float(h8[-1][k]),
                                   rtol=1e-8)


@pytest.mark.slow
def test_huber_shard_invariance():
    g1, vars_t, probs_t, y = _probit_sim()
    g8, _, _, _ = _probit_sim(mesh=_mesh8())
    # reuse the genotypes with a continuous outlier-contaminated phenotype
    rng = np.random.default_rng(11)
    yc = rng.normal(size=g1.N) + np.where(rng.random(g1.N) < 0.05,
                                          rng.normal(scale=8, size=g1.N), 0.0)
    g1.set_phen(yc)
    g8.set_phen(yc)
    cfg = robust.RobustConfig(max_iter=4, rho=0.3, seed=1)
    x1, s1, h1 = robust.infer(g1, cfg, probs_t, vars_t, verbose=False)
    x8, s8, h8 = robust.infer(g8, cfg, probs_t, vars_t, verbose=False)
    np.testing.assert_allclose(x1, x8, rtol=1e-8, atol=1e-12)
    for k in ("gam1", "deltaH"):
        np.testing.assert_allclose(float(h1[-1][k]), float(h8[-1][k]),
                                   rtol=1e-8)


# ---------------------------------------------------------------- red

@pytest.mark.slow
def test_red_reduced_subset_converges():
    """--red draws a moving 10% sample window for the CG/probe/trace solves
    (vamp.cpp:561-596): noisier per-iteration, still recovers the signal."""
    rng = np.random.default_rng(17)
    N, M = 8192, 100   # big enough that the window (min 32 word-rows) < N
    codes = sim.random_genotypes(rng, M, N, miss_rate=0.0)
    geno = GenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                               standardize_phen=False, dtype=jnp.float64)
    vars_t, probs_t = sim.two_group_prior(M, 10, 0.8)
    beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
    y = sim.simulate_linear_phenotype(geno, beta, 5.0, rng)
    geno.set_phen(y)
    cfg = linear.VampConfig(max_iter=5, rho=0.3, seed=3, red=True)
    x_hat, state, hist = linear.infer(geno, cfg, probs_t, vars_t,
                                      verbose=False)
    assert np.isfinite(x_hat).all()
    corr = np.corrcoef(x_hat, beta)[0, 1]
    assert corr > 0.8, corr
    # the window actually moved off zero at least once across iterations
    lbw = geno.layout.n_words // 10 // 32 * 32
    assert 32 <= lbw < geno.layout.n_words


# ---------------------------------------------------------------- multi scan

@pytest.mark.slow
def test_multi_scan_equality():
    """sync-every=2 (lax.scan throughput mode) must equal per-iteration
    dispatch for the multi-trait linear engine."""
    from gvamp import multi
    rng = np.random.default_rng(5)
    N, M, T = 500, 128, 3
    codes = sim.random_genotypes(rng, M, N, miss_rate=0.02)
    geno = GenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                               standardize_phen=False, dtype=jnp.float64)
    vars_t, probs_t = sim.two_group_prior(M, 10, 0.8)
    ys = []
    for t in range(T):
        beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
        ys.append(sim.simulate_linear_phenotype(geno, beta, 5.0, rng))
    mp = multi.MultiPhen.build(geno, ys)
    cfg = linear.VampConfig(max_iter=4, rho=0.3, seed=2)
    xa, sa, ha = multi.infer(mp, cfg, probs_t, vars_t, verbose=False,
                             sync_every=1)
    xb, sb, hb = multi.infer(mp, cfg, probs_t, vars_t, verbose=False,
                             sync_every=2)
    np.testing.assert_allclose(xa, xb, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(sa.gam1), np.asarray(sb.gam1),
                               rtol=1e-9)


# ---------------------------------------------------------------- CLI probit

@pytest.mark.slow
def test_probit_both_mode_cm_and_resume(tmp_path, capsys):
    """CLI: probit both-mode prints the test-set confusion matrix
    (main_real_probit.cpp:220-313), and probit --resume continues to the
    same iteration-6 estimate as an uninterrupted run."""
    rng = np.random.default_rng(23)
    N, M, Ntest = 500, 120, 250
    codes = sim.random_genotypes(rng, M, N + Ntest, miss_rate=0.01)
    bed, bed_t = str(tmp_path / "b.bed"), str(tmp_path / "bt.bed")
    plink.write_bed(bed, codes[:, :N])
    plink.write_bed(bed_t, codes[:, N:])
    gtr = GenoBed.from_arrays(make_bed(codes[:, :N]), np.zeros(N), N=N,
                              standardize_phen=False, dtype=jnp.float64)
    gte = GenoBed.from_arrays(make_bed(codes[:, N:]), np.zeros(Ntest),
                              N=Ntest, standardize_phen=False,
                              dtype=jnp.float64)
    vars_t, probs_t = sim.two_group_prior(M, 10, 0.9)
    beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
    ytr = sim.simulate_probit_phenotype(gtr, beta, 0.5, rng)
    yte = sim.simulate_probit_phenotype(gte, beta, 0.5, rng)
    plink.write_phen(str(tmp_path / "b.phen"), ytr)
    plink.write_phen(str(tmp_path / "bt.phen"), yte)

    args = ["--run-mode", "both", "--model", "bin_class",
            "--bed-file", bed, "--phen-files", str(tmp_path / "b.phen"),
            "--N", str(N), "--Mt", str(M),
            "--bed-file-test", bed_t,
            "--phen-files-test", str(tmp_path / "bt.phen"),
            "--N-test", str(Ntest), "--Mt-test", str(M),
            "--iterations", "6", "--rho", "0.5", "--dtype", "float64",
            "--probs", ",".join(map(str, probs_t)),
            "--vars", ",".join(map(str, vars_t)),
            "--out-dir", str(tmp_path), "--out-name", "p6",
            "--checkpoint", str(tmp_path / "p6.npz"), "--verbosity", "0"]
    acc = cli.main(args)
    out = capsys.readouterr().out
    assert "TPR=" in out and "FPR=" in out
    assert acc > 0.55

    # interrupted twin: 3 iterations, then --resume for 3 more
    args3 = list(args)
    args3[args3.index("6")] = "3"
    args3[args3.index("p6")] = "p3"
    args3[args3.index(str(tmp_path / "p6.npz"))] = str(tmp_path / "p3.npz")
    cli.main(args3)
    argsr = ["--run-mode", "restart", "--model", "bin_class",
             "--bed-file", bed, "--phen-files", str(tmp_path / "b.phen"),
             "--N", str(N), "--Mt", str(M),
             "--iterations", "3", "--dtype", "float64",
             "--probs", ",".join(map(str, probs_t)),
             "--vars", ",".join(map(str, vars_t)),
             "--out-dir", str(tmp_path), "--out-name", "pr",
             "--resume", str(tmp_path / "p3.npz"), "--verbosity", "0"]
    cli.main(argsr)
    e6 = vecio.read_bin_shard(str(tmp_path / "p6_probit_it_6.bin"), M, 0)
    er = vecio.read_bin_shard(str(tmp_path / "pr_probit_it_6.bin"), M, 0)
    np.testing.assert_allclose(er, e6, rtol=1e-8, atol=1e-12)

    # resuming with the wrong --model fails fast
    bad = list(argsr)
    bad[bad.index("bin_class")] = "linear"
    with pytest.raises(SystemExit):
        cli.main(bad)


@pytest.mark.slow
def test_load_state_backfills_pre_round3_linear_checkpoint(tmp_path):
    """A checkpoint written before the round-3 state fields existed
    (mu_probe_n / gmu / gmu_n / warm-start fields) must load with safe
    cold-start defaults instead of raising."""
    from gvamp.ckpt import save_state, load_state

    geno, beta, vars_t, probs_t = build_sim(N=300, M=128)
    cfg = linear.VampConfig(max_iter=2, rho=0.3, seed=1)
    _, state, _ = linear.infer(geno, cfg, probs_t, vars_t, verbose=False)
    old_fields = [f for f in linear.LinState._fields
                  if f not in ("mu_probe_n", "gmu", "gmu_n")]
    pruned = {f: getattr(state, f) for f in old_fields}

    class OldState:  # save_state duck-types on _fields + iteration
        _fields = old_fields

        def __iter__(self):
            return iter(pruned[f] for f in old_fields)

    ck = str(tmp_path / "old.npz")
    save_state(ck, OldState(), it=2, model="linear",
               cfg=dataclasses.asdict(cfg))
    loaded, meta = load_state(ck, linear.LinState)
    assert meta["it"] == 2
    np.testing.assert_array_equal(np.asarray(loaded.x1),
                                  np.asarray(state.x1))
    assert np.asarray(loaded.gmu).shape == np.asarray(state.gmu).shape
    assert np.all(np.asarray(loaded.gmu) == 0)
    assert (np.asarray(loaded.mu_probe_n).shape
            == np.asarray(state.mu_probe_n).shape)
    # and the resumed engine runs (cold gmu -> true init mult on first solve)
    cfg4 = dataclasses.replace(cfg, max_iter=4)
    x, _, h = linear.infer(geno, cfg4, probs_t, vars_t, verbose=False,
                           resume_state=loaded)
    assert len(h) == 2 and np.isfinite(x).all()


@pytest.mark.slow
def test_probit_both_mode_multi_trait_with_covariates(tmp_path, capsys):
    """Multi-trait bin_class both-mode must score each trait with ITS OWN
    covariate-effect column (state.cov_eff is [C, T]; selecting nothing
    crashed planarize on an [N, T] array)."""
    rng = np.random.default_rng(77)
    N, M, T, C = 300, 96, 2, 2
    codes = sim.random_genotypes(rng, M, 2 * N, miss_rate=0.01)
    bed, bed_t = str(tmp_path / "c.bed"), str(tmp_path / "ct.bed")
    plink.write_bed(bed, codes[:, :N])
    plink.write_bed(bed_t, codes[:, N:])
    Z = rng.normal(size=(N, C))
    plink.write_covariates(str(tmp_path / "c.cov"), Z)
    gtr = GenoBed.from_arrays(make_bed(codes[:, :N]), np.zeros(N), N=N,
                              standardize_phen=False, dtype=jnp.float64)
    gte = GenoBed.from_arrays(make_bed(codes[:, N:]), np.zeros(N), N=N,
                              standardize_phen=False, dtype=jnp.float64)
    vars_t, probs_t = sim.two_group_prior(M, 10, 0.8)
    pfs, pfs_t = [], []
    for t in range(T):
        beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
        gtr.covs = Z
        ytr = sim.simulate_probit_phenotype(gtr, beta, 0.5, rng,
                                            np.array([0.25, -0.25]))
        yte = sim.simulate_probit_phenotype(gte, beta, 0.5, rng)
        p, pt = str(tmp_path / f"c{t}.phen"), str(tmp_path / f"ct{t}.phen")
        plink.write_phen(p, ytr)
        plink.write_phen(pt, yte)
        pfs.append(p)
        pfs_t.append(pt)

    scores = cli.main([
        "--run-mode", "both", "--model", "bin_class",
        "--bed-file", bed, "--phen-files", ",".join(pfs),
        "--N", str(N), "--Mt", str(M),
        "--cov-file", str(tmp_path / "c.cov"), "--C", str(C),
        "--bed-file-test", bed_t, "--phen-files-test", ",".join(pfs_t),
        "--N-test", str(N), "--Mt-test", str(M),
        "--iterations", "4", "--rho", "0.3", "--dtype", "float64",
        "--probs", ",".join(map(str, probs_t)),
        "--vars", ",".join(map(str, vars_t)),
        "--out-dir", str(tmp_path), "--out-name", "cb", "--verbosity", "0"])
    out = capsys.readouterr().out
    assert out.count("TPR=") == T
    assert len(scores) == T and all(np.isfinite(s) for s in scores)


@pytest.mark.slow
def test_sync_every_partial_chunk_stops_at_max_iter():
    """sync_every that does not divide max_iter must still stop state at
    EXACTLY max_iter (a full trailing scan chunk used to overrun it)."""
    from gvamp import multi

    geno, beta, vars_t, probs_t = build_sim(N=300, M=128)
    cfg = linear.VampConfig(max_iter=4, rho=0.3, seed=2,
                            stop_criteria_thr=0.0)
    x1, s1, h1 = linear.infer(geno, cfg, probs_t, vars_t, verbose=False)
    x3, s3, h3 = linear.infer(geno, cfg, probs_t, vars_t, verbose=False,
                              sync_every=3)
    assert int(np.asarray(s3.it)) == 4 and len(h3) == 4
    np.testing.assert_allclose(x3, x1, rtol=1e-12, atol=1e-15)

    y = np.asarray(geno.deplanarize(geno.y_planar))[: geno.N]
    mp = multi.MultiPhen.build(geno, [y, y], standardize=False)
    xm1, sm1, hm1 = multi.infer(mp, cfg, probs_t, vars_t, verbose=False)
    xm3, sm3, hm3 = multi.infer(mp, cfg, probs_t, vars_t, verbose=False,
                                sync_every=3)
    assert int(np.asarray(sm3.it)) == 4 and len(hm3) == 4
    np.testing.assert_allclose(xm3, xm1, rtol=1e-12, atol=1e-15)


@pytest.mark.slow
def test_resume_multi_zmodels_roundtrip(tmp_path):
    """ProbitMultiState / HuberMultiState checkpoint round-trip + resumed
    tail equality (the multi-linear test covers MultiState)."""
    from gvamp import multi, robust
    from gvamp.ckpt import save_state, load_state

    rng = np.random.default_rng(13)
    N, M, T = 300, 96, 2
    codes = sim.random_genotypes(rng, M, N, miss_rate=0.01)
    geno = GenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                               standardize_phen=False, dtype=jnp.float64)
    vars_t, probs_t = sim.two_group_prior(M, 10, 0.8)
    ys_bin, ys_lin = [], []
    for _ in range(T):
        beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
        ys_bin.append(sim.simulate_probit_phenotype(geno, beta, 1.0, rng))
        ys_lin.append(sim.simulate_linear_phenotype(geno, beta, 1 / 0.2,
                                                    rng))

    for model, ys, cfg_cls, state_cls, run in (
            ("bin_class", ys_bin, probit.ProbitConfig,
             multi.ProbitMultiState, multi.infer_probit),
            ("robust", ys_lin, robust.RobustConfig,
             multi.HuberMultiState, multi.infer_huber)):
        mp = multi.MultiPhen.build(geno, ys,
                                   standardize=(model != "bin_class"))
        cfg4 = cfg_cls(max_iter=4, rho=0.3, seed=5, stop_criteria_thr=0.0)
        xa, sa, _ = run(mp, cfg4, probs_t, vars_t, verbose=False)
        cfg2 = dataclasses.replace(cfg4, max_iter=2)
        _, sb2, _ = run(mp, cfg2, probs_t, vars_t, verbose=False)
        ck = str(tmp_path / f"{model}.npz")
        save_state(ck, sb2, it=2, model=model, T=T,
                   cfg=dataclasses.asdict(cfg2))
        loaded, meta = load_state(ck, state_cls)
        assert meta["T"] == T
        xb, sb, hb = run(mp, cfg4, probs_t, vars_t, verbose=False,
                         resume_state=loaded)
        np.testing.assert_allclose(xb, xa, rtol=1e-10, atol=1e-13,
                                   err_msg=model)
        assert len(hb) == 2, model


def test_load_state_backfills_multi_warm_start_fields(tmp_path):
    """Backfilled multi-trait warm-start fields must have the [Mp, T*P]
    / [Mp, T+T*P] / [T] shapes (not the single-trait ones)."""
    from gvamp import multi
    from gvamp.ckpt import save_state, load_state

    rng = np.random.default_rng(5)
    N, M, T = 200, 96, 3
    codes = sim.random_genotypes(rng, M, N)
    geno = GenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                               standardize_phen=False, dtype=jnp.float64)
    vars_t, probs_t = sim.two_group_prior(M, 8, 0.7)
    ys = [rng.standard_normal(N) for _ in range(T)]
    mp = multi.MultiPhen.build(geno, ys, standardize=False)
    cfg = linear.VampConfig(max_iter=1, rho=0.3, stop_criteria_thr=0.0)
    _, state, _ = multi.infer(mp, cfg, probs_t, vars_t, verbose=False)

    drop = ("mu_cg", "mu_probe", "gmu", "tau_gmu")
    fields = [f for f in multi.MultiState._fields if f not in drop]
    vals = {f: getattr(state, f) for f in fields}

    class OldState:
        _fields = fields

        def __iter__(self):
            return iter(vals[f] for f in fields)

    ck = str(tmp_path / "oldmulti.npz")
    save_state(ck, OldState(), it=1, model="linear", T=T,
               cfg=dataclasses.asdict(cfg))
    loaded, _ = load_state(ck, multi.MultiState)
    P = linear.probe_cols(cfg)  # 0 under the SLQ default, n_probes else
    assert np.asarray(loaded.mu_probe).shape == (geno.Mpad, T * P)
    assert np.asarray(loaded.gmu).shape == (geno.Mpad, T * (1 + P))
    assert np.asarray(loaded.tau_gmu).shape == (T,)
    # and the resumed engine accepts the backfilled state
    cfg2 = dataclasses.replace(cfg, max_iter=2)
    x, s2, h = multi.infer(mp, cfg2, probs_t, vars_t, verbose=False,
                           resume_state=loaded)
    assert len(h) == 1 and np.isfinite(x).all()
