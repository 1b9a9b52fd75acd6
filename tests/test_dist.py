"""Multi-process execution tests (VERDICT r1 missing item 1).

A real 2-process gloo-backed JAX cluster on localhost (2 virtual CPU devices
per process -> one global 4-device marker mesh), driven through the CLI with
``--distributed 1`` — the analog of the reference's ``mpirun -np K`` de-facto
distributed test (README.md:26).  Asserts:

  * per-process slab loading + global mesh reproduce the single-process
    estimates exactly (float64),
  * shard-wise dumps (dist.write_m_global) assemble into the same .bin
    layout the single-process run writes,
  * p-value output matches.

Also unit-tests divide_work against the reference block-partition semantics
(utilities.cpp:259-291).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from gvamp import dist, sim
from gvamp.io import plink, vecio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_divide_work_reference_semantics():
    starts, counts = dist.divide_work(11, 4)
    # 11 = 2+1, 2+1, 2+1? no: base=2 rem=3 -> [3,3,3,2]
    assert list(counts) == [3, 3, 3, 2]
    assert list(starts) == [0, 3, 6, 9]
    starts, counts = dist.divide_work(8, 4)
    assert list(counts) == [2, 2, 2, 2]
    assert int(starts[-1] + counts[-1]) == 8


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(5)
    N, M, CV, h2 = 400, 1500, 25, 0.8
    codes = sim.random_genotypes(rng, M, N, miss_rate=0.01)
    plink.write_bed(str(d / "t.bed"), codes)
    import jax.numpy as jnp
    from gvamp.data import GenoBed
    from tests_shim import make_bed_bytes
    geno = GenoBed.from_arrays(make_bed_bytes(codes), np.zeros(N), N=N,
                               standardize_phen=False, dtype=jnp.float64)
    vars_t, probs_t = sim.two_group_prior(M, CV, h2)
    beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
    y = sim.simulate_linear_phenotype(geno, beta, 1 / (1 - h2), rng)
    plink.write_phen(str(d / "t.phen"), y)
    return dict(dir=d, N=N, M=M, beta=beta, vars=vars_t, probs=probs_t)


def _cli_args(ds, out_name, iters=4):
    return ["--run-mode", "infere", "--model", "linear",
            "--bed-file", str(ds["dir"] / "t.bed"),
            "--phen-files", str(ds["dir"] / "t.phen"),
            "--N", str(ds["N"]), "--Mt", str(ds["M"]),
            "--iterations", str(iters), "--rho", "0.3",
            "--vars", ",".join(map(str, ds["vars"])),
            "--probs", ",".join(map(str, ds["probs"])),
            "--out-dir", str(ds["dir"]), "--out-name", out_name,
            "--dtype", "float64", "--store-pvals", "1"]


def _spawn(args, n_devices, extra_env=None):
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["JAX_PLATFORMS"] = ""
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra_env or {})
    code = ("import jax; jax.config.update('jax_platforms', 'cpu'); "
            "import sys; from gvamp import cli; cli.main(sys.argv[1:])")
    return subprocess.Popen([sys.executable, "-c", code] + args,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


@pytest.mark.slow
def test_two_process_matches_single_process(ds):
    iters = 4
    port = _free_port()
    # single-process (4 virtual devices, same mesh shape) reference run
    p = _spawn(_cli_args(ds, "single", iters), n_devices=4)
    out, _ = p.communicate(timeout=900)
    assert p.returncode == 0, out

    # two processes x 2 devices -> the same global 4-device mesh
    procs = [
        _spawn(_cli_args(ds, "multi", iters)
               + ["--distributed", "1",
                  "--coordinator", f"localhost:{port}",
                  "--n-processes", "2", "--process-id", str(i)],
               n_devices=2)
        for i in range(2)
    ]
    outs = [p.communicate(timeout=900)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o

    M = ds["M"]
    for it in range(1, iters + 1):
        single = vecio.read_bin_shard(str(ds["dir"] / f"single_it_{it}.bin"), M, 0)
        multi = vecio.read_bin_shard(str(ds["dir"] / f"multi_it_{it}.bin"), M, 0)
        np.testing.assert_allclose(multi, single, rtol=1e-8, atol=1e-12,
                                   err_msg=f"estimate mismatch at it {it}")
    # quality: the distributed estimate recovers the truth
    est = vecio.read_bin_shard(str(ds["dir"] / f"multi_it_{iters}.bin"), M, 0)
    corr = np.corrcoef(est, ds["beta"])[0, 1]
    assert corr > 0.8, corr
    # p-values written by the distributed run match the single run
    ps = vecio.read_bin_shard(str(ds["dir"] / "single_pvals.bin"), M, 0)
    pm = vecio.read_bin_shard(str(ds["dir"] / "multi_pvals.bin"), M, 0)
    np.testing.assert_allclose(pm, ps, rtol=1e-6, atol=1e-300)


@pytest.mark.slow
def test_two_process_multi_trait(ds):
    """Multi-process x multi-trait: 2-process mesh reproduces the
    single-process multi-trait per-trait estimates."""
    rng = np.random.default_rng(77)
    import jax.numpy as jnp
    from gvamp.data import GenoBed
    codes_geno = GenoBed.from_files(str(ds["dir"] / "t.bed"), None,
                                    N=ds["N"], Mt=ds["M"],
                                    standardize_phen=False,
                                    dtype=jnp.float64)
    beta2 = sim.simulate_mixture(rng, ds["M"], ds["vars"], ds["probs"])
    y2 = sim.simulate_linear_phenotype(codes_geno, beta2, 5.0, rng)
    plink.write_phen(str(ds["dir"] / "t2.phen"), y2)

    iters = 3
    args = _cli_args(ds, "mts", iters)
    i = args.index("--phen-files")
    args[i + 1] = f"{ds['dir'] / 't.phen'},{ds['dir'] / 't2.phen'}"
    args[args.index("--store-pvals") + 1] = "0"
    args[args.index("--store-pvals")] = "--store-pvals"

    p = _spawn(args, n_devices=4)
    out, _ = p.communicate(timeout=900)
    assert p.returncode == 0, out

    port = _free_port()
    margs = list(args)
    margs[margs.index("mts")] = "mtm"
    procs = [
        _spawn(margs + ["--distributed", "1",
                        "--coordinator", f"localhost:{port}",
                        "--n-processes", "2", "--process-id", str(i)],
               n_devices=2)
        for i in range(2)
    ]
    outs = [p.communicate(timeout=900)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o

    M = ds["M"]
    for t in range(2):
        s = vecio.read_bin_shard(
            str(ds["dir"] / f"mts_phen{t}_it_{iters}.bin"), M, 0)
        m = vecio.read_bin_shard(
            str(ds["dir"] / f"mtm_phen{t}_it_{iters}.bin"), M, 0)
        np.testing.assert_allclose(m, s, rtol=1e-8, atol=1e-12,
                                   err_msg=f"trait {t}")


@pytest.mark.slow
def test_two_process_checkpoint_no_deadlock(ds):
    """--checkpoint on a multi-process run: ckpt.save_state fetches every
    state field with dist.to_numpy, whose reshard of sharded fields is a
    COLLECTIVE all ranks must enter — a main-rank-only call deadlocks the
    cluster (round-3 review finding).  Multi-trait exercises _multi_dump_cb
    (dump branch + checkpoint branch); the checkpoint must land with
    meta it == iterations and resumable state."""
    iters = 2
    port = _free_port()
    ck = str(ds["dir"] / "ckpt_mt.npz")
    args = _cli_args(ds, "ckmt", iters)
    i = args.index("--phen-files")
    args[i + 1] = f"{ds['dir'] / 't.phen'},{ds['dir'] / 't.phen'}"
    args[args.index("--store-pvals") + 1] = "0"
    args += ["--checkpoint", ck]
    procs = [
        _spawn(args + ["--distributed", "1",
                       "--coordinator", f"localhost:{port}",
                       "--n-processes", "2", "--process-id", str(i)],
               n_devices=2)
        for i in range(2)
    ]
    # generous but bounded: a deadlock must fail the test, not hang pytest
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o
    from gvamp import ckpt, multi
    meta = ckpt.read_meta(ck)
    assert meta["model"] == "linear" and meta["T"] == 2
    assert int(meta["it"]) == iters
    state, meta2 = ckpt.load_state(ck, multi.MultiState)
    assert int(np.asarray(state.it)) == iters
    assert np.isfinite(np.asarray(state.x1)).all()
