"""Run-mode driver: the L5 entry point (python -m gvamp.cli ...).

Re-designs the reference executables (main_real.cpp, main_real_probit.cpp,
sim.cpp et al.) as one CLI with the same run modes:

  infere          fit the chosen model, dump per-iteration estimates
                  (main_real.cpp:34-128)
  test            R^2 sweep of stored estimates on a test set
                  (main_real.cpp:129-244; probit variant reports CM/TPR/FPR,
                  main_real_probit.cpp:117-157)
  both            infere then test with intercept/scale de-standardization
                  (main_real.cpp:245-330)
  restart         resume with gam1/gamw injected + r1 from an estimate file
                  (main_real.cpp:453-486)
  predict         per-individual prediction CSVs over an iteration range of
                  stored (Gibbs-format) estimates (main_real.cpp:487-551)
  predict_single  one prediction CSV from one estimate (main_real.cpp:552-594)
  pvals-calc      standalone LOO/LOCO association tests
                  (main_real.cpp:331-452; store-pvals: 0=both 1=LOO 2=LOCO)
  sim             simulate signal+phenotype from a .bed then infer (sim.cpp)

Single-process host with the device mesh doing the sharding: divide_work
(utilities.cpp:259-291) becomes the mesh partition of the padded marker axis.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

from gvamp import dist, runtime
from gvamp.ckpt import IterDumper, load_state, write_scalar_history
from gvamp.io import plink, vecio
from gvamp.options import Options
from gvamp.prior import initialize_prior


def _jax():
    import jax
    return jax


def _dtype(opt):
    import jax.numpy as jnp
    return jnp.float64 if opt.dtype == "float64" else jnp.float32


def _mesh(opt):
    import jax
    from jax.sharding import Mesh
    n = opt.devices or 0
    devs = jax.devices()
    if n <= 1 and len(devs) == 1:
        return None
    n = n or len(devs)
    return Mesh(np.array(devs[:n]), ("m",))


def _load_geno(opt: Options, test: bool = False):
    from gvamp.data import GenoBed, GenoDense
    bed = opt.bed_file_test if test else opt.bed_file
    phen = (opt.phen_files_test if test else opt.phen_files)
    phen = phen[0] if phen else None
    N = opt.N_test if test else opt.N
    Mt = opt.Mt_test if test else opt.Mt
    container = GenoDense if opt.type_data == "meth" else GenoBed
    # binary phenotypes stay raw 0/1: the reference's ctor scales them by
    # 1/sd before the (2y-1) denoiser logic (data.cpp:171-186 +
    # vamp_probit.cpp:678), distorting case weights — its own sim_probit
    # driver avoids the scaling via set_phen; we follow the sim semantics
    geno = container.from_files(
        bed, phen, N=N, Mt=Mt, alpha_scale=opt.alpha_scale,
        standardize_phen=(opt.model != "bin_class"),
        mesh=_mesh(opt), backend=opt.backend, dtype=_dtype(opt),
        bim_path=opt.bim_file)
    if opt.cov_file and opt.C > 0:
        geno.read_covariates(opt.cov_file, opt.C)
    return geno


def _prior(opt: Options, geno):
    return initialize_prior(opt.probs or None, opt.vars or None,
                            N=geno.N, Mt=geno.Mt)


def _true_signal(opt: Options, geno):
    if not opt.true_signal_files:
        return None
    return vecio.read_estimate(opt.true_signal_files[0], geno.M, geno.S)


def _common_cfg(opt: Options, gam1, default_gam1, gamw=None):
    """Engine-config kwargs shared by every model family."""
    kw = dict(
        max_iter=opt.iterations, rho=opt.rho,
        stop_criteria_thr=opt.stop_criteria_thr,
        em_max_iter=opt.EM_max_iter, em_err_thr=opt.EM_err_thr,
        cg_max_iter=opt.CG_max_iter, learn_vars=bool(opt.learn_vars),
        seed=opt.seed, deflate_k=opt.deflate_k,
        deflate_iters=opt.deflate_iters, cg_plateau=opt.cg_plateau,
        use_slq=bool(opt.use_slq), slq_k=opt.slq_k,
        # consumed by the z-model engines only; options.check rejects a
        # non-default value for --model linear
        stab_gamma=opt.stab_gamma,
        gam1_init=default_gam1 if gam1 is None else gam1)
    if gamw is not None:
        kw["gamw_init"] = gamw
    return kw


def run_inference(opt: Options, geno, gam1=None, gamw=None, r1_init=None):
    """Model dispatch (reference vamp::infere, vamp.cpp:149-183)."""
    probs, vars_user = _prior(opt, geno)
    ts = _true_signal(opt, geno)
    dump = IterDumper(opt.out_prefix, model=opt.model,
                      dump_every=opt.dump_every, checkpoint=opt.checkpoint)
    common = dict(verbose=opt.verbosity > 0, callbacks=[dump], true_signal=ts)

    if opt.model == "linear" and len(opt.phen_files) > 1:
        # multi-trait extension: all phenotypes in one run, sharing every
        # decode pass (gvamp/multi.py; the reference handles one
        # phenotype per run, main_real.cpp:52)
        from gvamp import linear, multi
        _check_multi_flags(opt)
        ys = []
        for pf in opt.phen_files:
            y, isna = plink.read_phen(pf)
            ys.append(np.where(isna, np.nan, y))
        cfg = linear.VampConfig(gamma_damp=opt.gamma_damp,
                                cg_extrapolate=opt.cg_extrapolate != 0,
                                **_common_cfg(
            opt, gam1, 1e-6, opt.gamw_default() if gamw is None else gamw))
        mp = multi.MultiPhen.build(geno, ys)
        x_est, state, hist = multi.infer(mp, cfg, probs, vars_user,
                                         verbose=opt.verbosity > 0,
                                         sync_every=opt.sync_every,
                                         callbacks=[_multi_dump_cb(
                                             opt, mp, cfg)])
        if hist and dist.is_main():
            _write_multi_scalar_history(opt.out_prefix, hist, mp.T)
        if opt.store_pvals:
            _store_pvals_multi(opt, geno, ys, state)
        if opt.store_pip:
            _store_pip(opt, geno, state, T=mp.T)
        return x_est, state, hist

    if opt.model == "linear":
        from gvamp import linear
        cfg = linear.VampConfig(
            use_lmmse_damp=bool(opt.use_lmmse_damp),
            use_xxt=bool(opt.use_XXT_denoiser),
            gamma_damp=opt.gamma_damp,
            red=bool(opt.red),
            use_cross_val=bool(opt.use_cross_val),
            cg_extrapolate=opt.cg_extrapolate != 0,  # -1 auto = on
            **_common_cfg(opt, gam1, 1e-6,
                          opt.gamw_default() if gamw is None else gamw))
        dump.meta = {"cfg": dataclasses.asdict(cfg)}
        freeze = None
        if opt.use_freeze:
            freeze = vecio.read_estimate(opt.freeze_index_file, geno.M, geno.S)
        x1_init = None
        if opt.init_est and opt.estimate_file:
            x1_init = vecio.read_estimate(opt.estimate_file, geno.M, geno.S)
        x_est, state, hist = linear.infer(
            geno, cfg, probs, vars_user, freeze=freeze,
            r1_init=r1_init, x1_init=x1_init,
            sync_every=opt.sync_every,
            phase_timers=bool(opt.phase_timers), **common)
        if hist and dist.is_main():
            write_scalar_history(opt.out_prefix, hist)
        if opt.state_evo and hist and dist.is_main():
            _print_state_evolution(geno, hist, opt.seed)
        if opt.store_pvals:
            _store_pvals_after_infer(opt, geno, state)
        if opt.store_pip:
            _store_pip(opt, geno, state)
        return x_est, state, hist

    if opt.model == "bin_class" and len(opt.phen_files) > 1:
        # multi-trait probit extension (gvamp/multi.py)
        from gvamp import multi, probit
        _check_multi_flags(opt)
        ys = []
        for pf in opt.phen_files:
            y, isna = plink.read_phen(pf)
            ys.append(np.where(isna, np.nan, y))
        cfg = probit.ProbitConfig(probit_var=opt.probit_var,
                                  **_common_cfg(opt, gam1, 1e-8))
        mp = multi.MultiPhen.build(geno, ys, standardize=False)
        res = multi.infer_probit(mp, cfg, probs, vars_user,
                                 verbose=opt.verbosity > 0,
                                 sync_every=opt.sync_every,
                                 callbacks=[_multi_dump_cb(
                                     opt, mp, cfg, tag="_probit")])
        if opt.store_pip:
            _store_pip(opt, geno, res[1], tag="_probit", T=mp.T)
        return res

    if opt.model == "bin_class":
        from gvamp import probit
        cfg = probit.ProbitConfig(probit_var=opt.probit_var,
                                  **_common_cfg(opt, gam1, 1e-8))
        dump.meta = {"cfg": dataclasses.asdict(cfg)}
        res = probit.infer(geno, cfg, probs, vars_user,
                           phase_timers=bool(opt.phase_timers),
                           sync_every=opt.sync_every, **common)
        if opt.store_pip:
            _store_pip(opt, geno, res[1], tag="_probit")
        return res

    if opt.model == "robust" and len(opt.phen_files) > 1:
        # multi-trait Huber extension (gvamp/multi.py)
        from gvamp import multi, robust
        _check_multi_flags(opt)
        ys = []
        for pf in opt.phen_files:
            y, isna = plink.read_phen(pf)
            ys.append(np.where(isna, np.nan, y))
        cfg = robust.RobustConfig(**_common_cfg(opt, gam1, 1e-8))
        mp = multi.MultiPhen.build(geno, ys)
        res = multi.infer_huber(mp, cfg, probs, vars_user,
                                verbose=opt.verbosity > 0,
                                sync_every=opt.sync_every,
                                callbacks=[_multi_dump_cb(
                                    opt, mp, cfg, tag="_robust")])
        if opt.store_pip:
            _store_pip(opt, geno, res[1], tag="_robust", T=mp.T)
        return res

    if opt.model == "robust":
        from gvamp import robust
        cfg = robust.RobustConfig(**_common_cfg(opt, gam1, 1e-8))
        dump.meta = {"cfg": dataclasses.asdict(cfg)}
        res = robust.infer(geno, cfg, probs, vars_user,
                           phase_timers=bool(opt.phase_timers),
                           sync_every=opt.sync_every, **common)
        if opt.store_pip:
            _store_pip(opt, geno, res[1], tag="_robust")
        return res

    raise SystemExit(f"invalid model {opt.model!r}")


def _check_multi_flags(opt):
    """Fail fast on flags the multi-trait engines do not support (the
    single-trait paths honor them; silently ignoring them would lose
    user intent — advisor finding r1)."""
    bad = [nm for nm, v in [
        ("--use-XXT-denoiser", opt.use_XXT_denoiser),
        ("--use-lmmse-damp", opt.use_lmmse_damp),
        ("--use-cross-val", opt.use_cross_val),
        ("--use-freeze", opt.use_freeze),
        ("--init-est", opt.init_est),
        ("--phase-timers", opt.phase_timers),
    ] if v]
    if bad:
        raise SystemExit(
            "multi-trait runs (multiple --phen-files) do not support: "
            + ", ".join(bad))


def _multi_dump_cb(opt, mp, cfg, tag=""):
    """Per-iteration callback for the multi-trait engines: per-trait
    reference-layout .bin estimate dumps + (optional) full-state .npz
    checkpoint carrying the engine config and trait count, so --resume
    reconstructs the EXACT original multi-trait run."""
    from gvamp.ckpt import save_state

    def cb(it, state, metrics, g):
        if opt.dump_every and it % opt.dump_every == 0:
            # to_numpy allgathers sharded arrays (all processes enter the
            # collective); one writer suffices
            x = dist.to_numpy(state.x1)[: g.M] / np.sqrt(g.N)
            if dist.is_main():
                for t in range(mp.T):
                    vecio.write_bin_shard(
                        f"{opt.out_prefix}_phen{t}{tag}_it_{it}.bin",
                        x[:, t], g.S)
        if opt.checkpoint:
            # all processes enter (save_state's field fetch is collective);
            # only the main process writes
            save_state(opt.checkpoint, state, it=it, model=opt.model,
                       T=mp.T, cfg=dataclasses.asdict(cfg))

    return cb


def _write_multi_scalar_history(prefix, hist, T):
    """Per-trait gam1s/gam2s/R2trains CSVs (vamp.cpp:778-794 per trait)."""
    from gvamp.ckpt import write_scalar_history
    keys = ("gam1", "gam2", "R2_train_1", "R2_train_2")
    for t in range(T):
        ht = []
        for h in hist:
            d = {}
            for k in keys:
                if k in h:
                    v = np.asarray(h[k])
                    d[k] = v[t] if v.ndim else v
            ht.append(d)
        write_scalar_history(f"{prefix}_phen{t}", ht)


def _store_pip(opt, geno, state, tag="", T=0):
    """--store-pip: per-marker posterior inclusion probabilities
    P(x != 0 | r1, gam1) at the final iterate (extension — the reference
    computes this posterior only internally, as `pin` in updatePrior's EM,
    vamp.cpp:979).  The engines run in the internal scale (r1 x sqrt(N),
    vars x N), in which the responsibility form is the actual posterior,
    so state fields feed prior.pip directly."""
    from gvamp import prior as pr

    def one(r1, gam1, probs, vars_, name):
        p = dist.to_numpy(pr.pip(r1, gam1, pr.Prior(probs=probs,
                                                    vars=vars_)))[: geno.M]
        if dist.is_main():
            vecio.write_bin_shard(name, p, geno.S)
            print(f"pip -> {name}")

    if T:
        for t in range(T):
            one(state.r1[:, t], state.gam1[t], state.probs[t], state.vars[t],
                f"{opt.out_prefix}_phen{t}{tag}_pip.bin")
    else:
        one(state.r1, state.gam1, state.probs, state.vars,
            f"{opt.out_prefix}{tag}_pip.bin")


def _print_state_evolution(geno, hist, seed):
    """--state-evo diagnostic: per-iteration SE predictions of
    (alpha1_bar, eta1_bar, gam2_bar) next to the measured values — the
    live version of the reference's dormant state_evo (vamp.cpp:1376-1411,
    calc_state_evo=0 at vamp.hpp:38).  Predictions use the prior/gam1
    carried in the metrics history, so this costs no extra engine passes."""
    import jax

    from gvamp.linear import state_evolution
    from gvamp.prior import Prior

    print("state evolution (predicted | measured):")
    for i in range(1, len(hist)):
        m, mp = hist[i], hist[i - 1]
        a_bar, eta_bar, gam2_bar = state_evolution(
            jax.random.fold_in(jax.random.key(seed + 11), i),
            Prior(m["probs"], m["vars"]), float(m["gam1"]), float(m["rho"]),
            Prior(mp["probs"], mp["vars"]), float(mp["gam1"]), geno.Mt)
        print(f"  it {int(m['it'])}: alpha1 {float(a_bar):.6f} | "
              f"{float(m['alpha1']):.6f}   eta1 {float(eta_bar):.6g} | "
              f"{float(m['eta1']):.6g}   gam2 {float(gam2_bar):.6g} | "
              f"{float(m['gam2']):.6g}")


def _store_pvals_multi(opt, geno, ys, state):
    """Per-trait end-of-run LOO (+LOCO) p-values for multi-trait runs."""
    from gvamp.ops import pvals as pv
    for t in range(len(ys)):
        geno.set_phen(ys[t], standardize=(opt.model != "bin_class"))
        z1_t, x1_t = state.z1[..., t], state.x1[:, t]
        p = pv.loo_pvals(geno, z1_t, x1_t)
        vecio.write_bin_shard(f"{opt.out_prefix}_phen{t}_pvals.bin", p, geno.S)
        print(f"pvals -> {opt.out_prefix}_phen{t}_pvals.bin")
        if opt.bim_file:
            ploco = pv.loco_pvals(
                geno, z1_t, x1_t, geno.chromosomes(),
                predictor_cb=_loco_predictor_writer(opt, geno, f"_phen{t}"))
            vecio.write_bin_shard(f"{opt.out_prefix}_phen{t}_pvals_LOCO.bin",
                                  ploco, geno.S)


def _store_pvals_after_infer(opt, geno, state):
    """End-of-run LOO (+LOCO if .bim) p-values (vamp.cpp:761-776)."""
    from gvamp.ops import pvals as pv
    p = pv.loo_pvals(geno, state.z1, state.x1)
    vecio.write_bin_shard(opt.out_prefix + "_pvals.bin", p, geno.S)
    print(f"pvals -> {opt.out_prefix}_pvals.bin")
    if opt.bim_file:
        ploco = pv.loco_pvals(
            geno, state.z1, state.x1, geno.chromosomes(),
            predictor_cb=_loco_predictor_writer(opt, geno))
        vecio.write_bin_shard(opt.out_prefix + "_pvals_LOCO.bin", ploco, geno.S)
        print(f"LOCO pvals -> {opt.out_prefix}_pvals_LOCO.bin")


def _loco_predictor_writer(opt, geno, tag=""):
    def cb(ch, y_chrom):
        full = np.zeros(4 * geno.layout.mbytes)
        full[: geno.N] = geno.deplanarize(y_chrom)[: geno.N]
        vecio.write_txt(f"{opt.out_prefix}{tag}_LOCO_chr_{ch}.csv", full)
    return cb


# --------------------------------------------------------------------------
# run modes
# --------------------------------------------------------------------------


def mode_infere(opt: Options):
    geno = _load_geno(opt)
    return run_inference(opt, geno)


def mode_restart(opt: Options):
    """gam1/gamw injected + r1 from estimate file (main_real.cpp:453-486)."""
    if opt.resume:
        return _resume_run(opt)
    geno = _load_geno(opt)
    r1 = vecio.read_estimate(opt.estimate_file, geno.M, geno.S)
    return run_inference(opt, geno, gam1=opt.gam1_init, gamw=opt.gamw_init,
                         r1_init=r1)


def _resume_multi(opt, geno, meta, cfg_d, probs, vars_user):
    """Resume a multi-trait checkpoint: rebuild the MultiPhen from the same
    --phen-files set and continue the joint run with the original config."""
    from gvamp import linear, multi, probit, robust
    from gvamp.ckpt import load_state

    model, T = meta.get("model", "linear"), int(meta["T"])
    if len(opt.phen_files) != T:
        raise SystemExit(
            f"FATAL  : checkpoint {opt.resume} holds {T} traits; pass the "
            f"same {T} --phen-files to resume (got {len(opt.phen_files)})")
    ys = []
    for pf in opt.phen_files:
        y, isna = plink.read_phen(pf)
        ys.append(np.where(isna, np.nan, y))
    mp = multi.MultiPhen.build(geno, ys,
                               standardize=(model != "bin_class"))
    if model == "linear":
        cfg, state_cls, run = (linear.VampConfig(**cfg_d), multi.MultiState,
                               multi.infer)
        tag = ""
    elif model == "bin_class":
        cfg, state_cls, run = (probit.ProbitConfig(**cfg_d),
                               multi.ProbitMultiState, multi.infer_probit)
        tag = "_probit"
    elif model == "robust":
        cfg, state_cls, run = (robust.RobustConfig(**cfg_d),
                               multi.HuberMultiState, multi.infer_huber)
        tag = "_robust"
    else:
        raise SystemExit(f"cannot resume model {model!r}")
    state, _ = load_state(opt.resume, state_cls)
    # budget --iterations more device iterations from the state's OWN
    # counter: checkpoints written by older scan-mode runs could carry
    # meta it < state.it (mid-chunk stop), which would silently short
    # the resumed run
    cfg = dataclasses.replace(cfg,
                              max_iter=int(np.asarray(state.it))
                              + opt.iterations)
    x_est, state, hist = run(
        mp, cfg, probs, vars_user, resume_state=state,
        verbose=opt.verbosity > 0, sync_every=opt.sync_every,
        callbacks=[_multi_dump_cb(opt, mp, cfg, tag=tag)])
    if hist and model == "linear" and dist.is_main():
        _write_multi_scalar_history(opt.out_prefix, hist, mp.T)
    return x_est, state, hist


def _resume_run(opt: Options):
    """Full-state resume from an .npz checkpoint (extension beyond the
    reference's estimate-file restart): the engine kind and its COMPLETE
    config come back from the checkpoint metadata, so the resumed run
    continues with the exact original semantics (EM budget, damping, flags,
    stopping criterion) for --iterations more iterations."""
    from gvamp.ckpt import read_meta

    meta = read_meta(opt.resume)
    model = meta.get("model", "linear")
    if model != opt.model:
        raise SystemExit(
            f"FATAL  : checkpoint {opt.resume} was written by --model {model};"
            f" pass the same --model to resume (got {opt.model})")
    geno = _load_geno(opt)
    cfg_d = dict(meta.get("cfg", {}))
    if cfg_d:
        # pre-SLQ checkpoints (round <= 4) predate the use_slq field: their
        # states carry n_probes probe columns, so the resumed config must
        # keep the probe path — resume restores the EXACT original
        # configuration, and the new default (use_slq=True) would shrink
        # mu_probe/gmu to zero columns and break the state shapes
        cfg_d.setdefault("use_slq", False)
        # same policy for the secant warm start (round 5): resume restores
        # the EXACT original configuration (a pre-round-5 run did not
        # extrapolate; its state lacks a meaningful secant pair anyway —
        # load_state zero-fills it)
        cfg_d.setdefault("cg_extrapolate", False)
    probs, vars_user = _prior(opt, geno)
    start_it = int(meta.get("it", 0))
    cfg_d["max_iter"] = start_it + opt.iterations

    if int(meta.get("T", 1)) > 1:
        return _resume_multi(opt, geno, meta, cfg_d, probs, vars_user)

    if model == "linear":
        from gvamp import linear as eng
        cfg = eng.VampConfig(**cfg_d) if cfg_d.keys() - {"max_iter"} else \
            eng.VampConfig(max_iter=cfg_d["max_iter"], rho=opt.rho,
                           cg_max_iter=opt.CG_max_iter, seed=opt.seed)
        state_cls = eng.LinState
    elif model == "bin_class":
        from gvamp import probit as eng
        cfg = eng.ProbitConfig(**cfg_d)
        state_cls = eng.ProbitState
    elif model == "robust":
        from gvamp import robust as eng
        cfg = eng.RobustConfig(**cfg_d)
        state_cls = eng.RobustState
    else:
        raise SystemExit(f"cannot resume model {model!r}")
    state, _ = load_state(opt.resume, state_cls)
    dump = IterDumper(opt.out_prefix, model=model, dump_every=opt.dump_every,
                      checkpoint=opt.checkpoint,
                      meta={"cfg": dataclasses.asdict(cfg)})
    x_est, state, hist = eng.infer(
        geno, cfg, probs, vars_user, resume_state=state, callbacks=[dump],
        verbose=opt.verbosity > 0, sync_every=opt.sync_every,
        phase_timers=bool(opt.phase_timers))
    if hist and dist.is_main():
        write_scalar_history(opt.out_prefix, hist)
    return x_est, state, hist


def _series_paths(path, lo, hi):
    """Per-iteration estimate paths from one example path.

    The reference derives the series by splicing the iteration number into the
    file name (main_real.cpp:160-181).  Parse ``it_{N}.`` anchored to the
    BASENAME (a directory or stem containing "it" must not confuse it); when
    the example has no iteration tag, append ``_it_{N}`` before the extension.
    """
    import os
    import re
    d, base = os.path.split(path)
    m = re.search(r"^(?P<stem>.*it_)\d+\.(?P<ext>[^.]+)$", base)
    if m:
        fmt = m.group("stem") + "{it}." + m.group("ext")
    else:
        root, ext = os.path.splitext(base)
        fmt = root + "_it_{it}" + ext
    return [os.path.join(d, fmt.format(it=it)) for it in range(lo, hi + 1)]


def _estimate_series(opt, M, S, tag=""):
    """Yield (it, x_est) over the test iteration range (main_real.cpp:160-181).

    ``tag`` selects a multi-trait series (our ``_phen{t}`` naming) by
    splicing it before the ``it_`` tag of each derived path.
    """
    lo, hi = opt.test_iter_range
    path = opt.estimate_file
    if lo == -1:
        yield -1, vecio.read_estimate(_tagged(path, tag), M, S)
        return
    for it, p in zip(range(lo, hi + 1), _series_paths(path, lo, hi)):
        yield it, vecio.read_estimate(_tagged(p, tag), M, S)


def _tagged(path, tag):
    """Insert a trait tag before the trailing ``_it_{N}`` (or extension)."""
    if not tag:
        return path
    import os
    import re
    d, base = os.path.split(path)
    m = re.search(r"^(?P<stem>.*?)(?P<it>_(?:probit_|robust_)?it_\d+)?\.(?P<ext>[^.]+)$", base)
    return os.path.join(
        d, f"{m.group('stem')}{tag}{m.group('it') or ''}.{m.group('ext')}")


def _trait_tags(opt, test=False):
    """('' ,) for single-trait; ('_phen0', '_phen1', ...) for multi-trait —
    the series tags written by the multi-trait infere dumps."""
    phens = (opt.phen_files_test if test else opt.phen_files) or opt.phen_files
    if len(phens) <= 1:
        return [("", phens[0] if phens else None)]
    return [(f"_phen{t}", pf) for t, pf in enumerate(phens)]


def mode_test(opt: Options):
    """R2 / confusion sweep over a stored estimate series
    (main_real.cpp:129-244; probit variant main_real_probit.cpp:117-157).
    Multi-trait runs evaluate each trait's ``_phen{t}`` series in turn
    (extension: the reference handles one phenotype per run)."""
    geno = _load_geno(opt, test=True)
    import jax.numpy as jnp
    traits = _trait_tags(opt, test=True)
    results = []
    for tag, pf in traits:
        if len(traits) > 1:
            y_raw, isna = plink.read_phen(pf)
            geno.set_phen(np.where(isna, np.nan, y_raw),
                          standardize=(opt.model != "bin_class"))
            print(f"trait {tag or pf}:")
        y_pl = geno.filter_pheno()
        y = np.asarray(geno.deplanarize(y_pl))[: geno.N]
        best, best_it = -np.inf, -1
        sqn = np.sqrt(geno.N)
        # scores are computed ON DEVICE and fetched as scalars: fetching the
        # N-length prediction per stored iteration moves megabytes per sweep
        # step through the (slow) device link at biobank scale
        m_cov_pl = None
        if opt.model == "bin_class":
            m_cov = np.zeros(geno.N)
            if opt.cov_estimate_file and opt.C:
                eff = vecio.read_estimate(opt.cov_estimate_file, opt.C, 0)
                m_cov = geno.covs_np @ eff
            m_cov_pl = geno.planarize(m_cov)
        sd = np.std(y, ddof=1)
        for it, est in _estimate_series(opt, geno.M, geno.S, tag=tag):
            z = geno.ax(geno.pad_m(est * sqn))
            if opt.model == "bin_class":
                tpr, fpr, acc = _score_bin_class(geno, z, m_cov_pl)
                print(f"it {it}: TPR={tpr:.4f} FPR={fpr:.4f} acc={acc:.4f}")
                score = acc
            else:
                err2 = float(jnp.sum(jnp.square(y_pl - z)))
                score = 1.0 - err2 / (sd * sd * geno.N)
                print(f"it {it}: R2 = {score:.6f}")
            if score > best:
                best, best_it = score, it
        print(f"max score = {best:.6f} at it = {best_it}")
        results.append((best, best_it))
    return results if len(traits) > 1 else results[0]


def _score_bin_class(geno_t, z_planar, m_cov_planar):
    """Confusion-matrix scoring of a probit prediction on a test container
    (main_real_probit.cpp:131-157, 220-313): classify by
    normal_cdf(z + Z cov_eff) >= 0.5 and report TPR/FPR/accuracy."""
    import jax.numpy as jnp
    from gvamp.ops.special import normal_cdf
    nm = geno_t.n_mask_planar > 0
    y_pl = geno_t.filter_pheno()
    pred = (normal_cdf(z_planar + m_cov_planar) >= 0.5) & nm
    truth = (y_pl >= 0.5) & nm
    tp, fp, fn, tn = (int(v) for v in _jax().device_get(jnp.stack([
        jnp.sum(pred & truth), jnp.sum(pred & ~truth & nm),
        jnp.sum(~pred & truth & nm), jnp.sum(~pred & ~truth & nm),
    ])))
    tpr = tp / max(tp + fn, 1)
    fpr = fp / max(fp + tn, 1)
    acc = (tp + tn) / geno_t.N
    return tpr, fpr, acc


def mode_both(opt: Options):
    """infere on train, then test-set scoring (main_real.cpp:245-330):
    linear/robust report R^2 with train intercept/scale de-standardization;
    bin_class reports the probit confusion matrix / TPR / FPR on the test
    set (main_real_probit.cpp:220-313).  Multi-trait runs score each trait
    against its own test phenotype (extension)."""
    geno = _load_geno(opt)
    x_est, state, hist = run_inference(opt, geno)
    x_est = np.asarray(x_est)
    traits = _trait_tags(opt, test=True)
    multi = x_est.ndim == 2
    # per-trait train standardization (the multi-trait binder standardizes
    # each phenotype like the single-trait loader; recompute here)
    scales = []
    if multi:
        for _, pf in _trait_tags(opt, test=False):
            yt, isna = plink.read_phen(pf)
            y_v = np.where(isna, np.nan, yt)
            avg = float(np.nanmean(y_v))
            sqn_t = float(np.sqrt(((~isna).sum() - 1)
                                  / np.nansum((y_v - avg) ** 2)))
            scales.append((avg, sqn_t))
    else:
        scales = [(geno.intercept, geno.scale)]
    geno_t = _load_geno(opt, test=True)
    sqn = np.sqrt(geno_t.N)
    bin_class = opt.model == "bin_class"
    eff_all = None
    if bin_class and opt.C > 0 and getattr(state, "cov_eff", None) is not None:
        # fixed covariate effects learned at it 1 carry to the test set
        # (main_real_probit.cpp:241-258); requires the test covariate rows.
        # Multi-trait state carries one effect column per trait ([C, T]).
        eff_all = np.asarray(state.cov_eff)[: opt.C]
    scores = []
    for t, (tag, pf) in enumerate(traits):
        if multi:
            y_raw, isna = plink.read_phen(pf)
            geno_t.set_phen(np.where(isna, np.nan, y_raw),
                            standardize=not bin_class)
        est_t = x_est[:, t] if multi else x_est
        z_pl = geno_t.ax(geno_t.pad_m(est_t[: geno_t.M] * sqn))
        if bin_class:
            m_cov = np.zeros(geno_t.N)
            if eff_all is not None:
                if (geno_t.covs is not None
                        and geno_t.covs_np.shape[0] == geno_t.N):
                    eff_t = eff_all[:, t] if eff_all.ndim == 2 else eff_all
                    m_cov = geno_t.covs_np @ eff_t
                else:
                    # the reference indexes --cov-file by the scored
                    # dataset's individuals (test mode reads it into
                    # dataset_test, main_real_probit.cpp:123; its both mode
                    # even applies TRAIN rows, :274-276) — a silent drop
                    # here would skew TPR/FPR with no trace
                    have = (geno_t.covs_np.shape[0]
                            if geno_t.covs is not None else 0)
                    print(f"WARNING: learned covariate effects NOT applied "
                          f"to test predictions — --cov-file has {have} "
                          f"rows, test set has {geno_t.N} individuals",
                          flush=True)
            tpr, fpr, acc = _score_bin_class(geno_t, z_pl,
                                             geno_t.planarize(m_cov))
            print(f"test{tag and f' ({tag})' or ''}: TPR={tpr:.4f} "
                  f"FPR={fpr:.4f} acc={acc:.4f}")
            scores.append(acc)
            continue
        intercept, scale = scales[min(t, len(scales) - 1)]
        z = geno_t.deplanarize(z_pl)[: geno_t.N]
        z = intercept + scale * z
        y = np.asarray(geno_t.deplanarize(geno_t.filter_pheno()))[: geno_t.N]
        err2 = float(np.sum((y - z) ** 2))
        sd = np.std(y, ddof=1)
        r2 = 1.0 - err2 / (sd * sd * geno_t.N)
        print(f"test R2{tag and f' ({tag})' or ''} = {r2:.6f}")
        scores.append(r2)
    return scores if multi else scores[0]


def mode_pvals_calc(opt: Options):
    """LOO/LOCO p-values for stored estimates (main_real.cpp:331-452).
    Multi-trait: each trait's series is residualized against its own
    phenotype and written with the ``_phen{t}`` tag (extension)."""
    import jax.numpy as jnp

    from gvamp.ops import pvals as pv
    geno = _load_geno(opt)
    sqn = np.sqrt(geno.N)
    traits = _trait_tags(opt)
    for ttag, pf in traits:
        if len(traits) > 1:
            y_raw, isna = plink.read_phen(pf)
            geno.set_phen(np.where(isna, np.nan, y_raw),
                          standardize=(opt.model != "bin_class"))
        series = [(it, geno.pad_m(est * sqn))
                  for it, est in _estimate_series(opt, geno.M, geno.S,
                                                  tag=ttag)]
        tags = [ttag + (f"_it_{it}" if it != -1 else "") for it, _ in series]
        # the whole estimate series batches into ONE axm pass + ONE
        # moments pass (reference nE batch, data.cpp:1155-1183) instead
        # of re-streaming the packed matrix per stored iteration
        x1s = jnp.stack([x1 for _, x1 in series], axis=1)
        z1s = geno.axm(x1s)
        if opt.store_pvals in (0, 1):
            ps = pv.loo_pvals_multi(geno, z1s, x1s)
            for tag, p in zip(tags, ps):
                vecio.write_bin_shard(f"{opt.out_prefix}{tag}_pvals.bin", p,
                                      geno.S)
        if opt.bim_file and opt.store_pvals in (0, 2):
            for e, (tag, (it, x1)) in enumerate(zip(tags, series)):
                p = pv.loco_pvals(
                    geno, z1s[..., e], x1, geno.chromosomes(),
                    predictor_cb=_loco_predictor_writer(opt, geno, tag))
                vecio.write_bin_shard(f"{opt.out_prefix}{tag}_pvals_LOCO.bin",
                                      p, geno.S)


def mode_predict(opt: Options, single: bool = False):
    from gvamp.data import GenoBed
    geno = GenoBed.from_files(
        opt.bed_file_test, None, N=opt.N_test, Mt=opt.Mt_test,
        alpha_scale=opt.alpha_scale, mesh=_mesh(opt), backend=opt.backend,
        dtype=_dtype(opt), standardize_phen=False)
    sqn = np.sqrt(geno.N)
    if single:
        est = vecio.read_estimate(opt.estimate_file, geno.M, geno.S)
        z = geno.deplanarize(geno.ax(geno.pad_m(est * sqn)))
        full = np.zeros(4 * geno.layout.mbytes)
        full[: geno.N] = z[: geno.N]
        vecio.write_txt(opt.out_prefix + "_predict.csv", full)
        return
    # Gibbs-estimate naming: <stem>temp_<it>_<it>_gibbs_est.<ext>
    # (main_real.cpp:519-521)
    lo, hi = opt.test_iter_range
    path = opt.estimate_file
    dot = path.find(".")
    ext = path[dot + 1:]
    stem = path[: path.rfind("temp")]
    zs = []
    for it in range(lo, hi + 1):
        est = vecio.read_estimate(f"{stem}temp_{it}_{it}_gibbs_est.{ext}",
                                  geno.M, geno.S)
        zs.append(geno.deplanarize(geno.ax(geno.pad_m(est * sqn)))[: geno.N])
    zs = np.stack(zs, axis=1)  # [N, n_iters]
    if opt.predict_format == "matrix":
        # one CSV, row per test individual, column per iteration — the
        # batched alternative to the reference's file-per-individual quirk
        np.savetxt(f"{opt.out_prefix}_predict_matrix.csv", zs, delimiter=",")
        return
    # reference-faithful: N_test files (main_real.cpp:538-545)
    if geno.N > 10000:
        print(f"WARNING: --predict-format per-individual writes {geno.N} "
              "files (reference main_real.cpp:538-545 behavior); use "
              "--predict-format matrix for one CSV", flush=True)
    for i in range(geno.N):
        vecio.write_txt(f"{opt.out_prefix}_predict_{i}.csv", zs[i])


def mode_sim(opt: Options):
    """Simulation drivers: simulate truth + phenotype on a real .bed/.meth,
    save them, then infer with truth-aware diagnostics.

    --sim-model selects the recipe: default = 2-component truth {0, h2/CV}
    (sim.cpp:78-79), realistic = 7-component empirical mixture
    (sim_realistic.cpp:88-95), heavy-tails = spike + {v,10v,100v} slabs
    (sim_heavy_tails.cpp:87-89), probit = binary link sampling with
    alternating +-0.25 covariate effects (sim_probit.cpp:170-205).
    """
    from gvamp import sim
    geno = _load_geno(opt)
    rng = np.random.default_rng(opt.seed)
    h2 = opt.h2 if opt.h2 != -1 else 0.5
    cv = opt.CV or max(geno.Mt // 100, 1)
    if opt.sim_model == "realistic":
        vars_t, probs_t = sim.realistic_prior(geno.Mt, h2)
    elif opt.sim_model == "heavy-tails":
        vars_t, probs_t = sim.heavy_tails_prior(geno.Mt, cv, h2)
    else:
        vars_t, probs_t = sim.two_group_prior(geno.Mt, cv, h2)

    cov_eff = None
    if opt.sim_model == "probit" and opt.cov_file and opt.C > 0:
        geno.read_covariates(opt.cov_file, opt.C)
        # alternating -0.25/+0.25 effects (sim_probit.cpp:177-178)
        cov_eff = (2.0 * (np.arange(opt.C) % 2) - 1.0) * 0.25

    if opt.true_signal_files:
        beta = vecio.read_estimate(opt.true_signal_files[0], geno.M, geno.S)
        y = vecio.read_txt_shard(opt.phen_files[0], geno.N, 0)
    else:
        beta = sim.simulate_mixture(rng, geno.M, vars_t, probs_t)
        if opt.sim_model == "probit":
            y = sim.simulate_probit_phenotype(geno, beta, opt.probit_var, rng,
                                              cov_effects=cov_eff)
        else:
            gamw = 1.0 / (1.0 - h2)
            y = sim.simulate_linear_phenotype(geno, beta, gamw, rng)
        vecio.write_bin_shard(opt.out_prefix + "_beta_true.bin", beta, geno.S)
        vecio.write_txt(opt.out_prefix + "_y.txt", y)
    geno.set_phen(y)
    opt2 = opt
    if not opt.vars and opt.num_mix_comp > 1:
        # the reference sim drivers build the INIT prior from a CVhat
        # heuristic when L = --num-mix-comp is given (sim_probit.cpp:53-77):
        # spike 1 - CVhat/Mt, slab probs geometric /2, vars 0.01/CVhat * 10^i
        L = opt.num_mix_comp
        cvhat = max(cv // 2, 1)
        prob_eq = cvhat / geno.Mt / (2.0 - 1.0 / 2.0 ** (L - 1))
        min_vars = 0.01 / cvhat
        probs_i = [1.0 - cvhat / geno.Mt]
        vars_i = [0.0]
        curr_var, pe = min_vars, prob_eq
        for _ in range(1, L):
            probs_i.append(pe)
            vars_i.append(curr_var)
            curr_var *= 10.0
            pe /= 2.0
        opt2 = Options(**{**vars(opt), "vars": vars_i, "probs": probs_i})
    elif not opt.vars:
        opt2 = Options(**{**vars(opt), "vars": list(vars_t),
                          "probs": list(probs_t)})
    opt2.true_signal_files = []
    probs, vars_user = _prior(opt2, geno)
    ts = beta

    if opt.sim_model == "probit":
        from gvamp import probit
        cfg = probit.ProbitConfig(
            max_iter=opt.iterations, rho=opt.rho, cg_max_iter=opt.CG_max_iter,
            stop_criteria_thr=opt.stop_criteria_thr, seed=opt.seed,
            probit_var=opt.probit_var, gam1_init=1e-8,
            em_max_iter=opt.EM_max_iter, em_err_thr=opt.EM_err_thr,
            learn_vars=bool(opt.learn_vars))
        dump = IterDumper(opt.out_prefix, model="bin_class",
                          dump_every=opt.dump_every)
        x_est, state, hist = probit.infer(geno, cfg, probs, vars_user,
                                          true_signal=ts, callbacks=[dump],
                                          verbose=opt.verbosity > 0)
        if dist.is_main():
            write_scalar_history(opt.out_prefix, hist)
        return x_est

    from gvamp import linear
    cfg = linear.VampConfig(
        max_iter=opt.iterations, rho=opt.rho, cg_max_iter=opt.CG_max_iter,
        stop_criteria_thr=opt.stop_criteria_thr, seed=opt.seed,
        gam1_init=1e-8, gamw_init=2.0,
        em_max_iter=opt.EM_max_iter, em_err_thr=opt.EM_err_thr,
        learn_vars=bool(opt.learn_vars))
    dump = IterDumper(opt.out_prefix, model="linear", dump_every=opt.dump_every)
    x_est, state, hist = linear.infer(geno, cfg, probs, vars_user,
                                      true_signal=ts, callbacks=[dump],
                                      verbose=opt.verbosity > 0)
    if dist.is_main():
        write_scalar_history(opt.out_prefix, hist)
    return x_est


MODES = {
    "infere": mode_infere,
    "test": mode_test,
    "both": mode_both,
    "restart": mode_restart,
    "pvals-calc": mode_pvals_calc,
    "predict": lambda o: mode_predict(o, single=False),
    "predict_single": lambda o: mode_predict(o, single=True),
    "sim": mode_sim,
}


def main(argv=None):
    opt = Options.from_args(argv)
    if opt.dtype == "float64":
        import jax
        jax.config.update("jax_enable_x64", True)
    if opt.distributed:
        # MPI_Init analog: join the multi-process cluster BEFORE any device
        # use; jax.devices() then spans all processes and _mesh() builds the
        # global marker-sharded mesh (gvamp/dist.py)
        # one card per process: no process reserves memory on another's
        local = opt.local_device if opt.local_device >= 0 else (
            opt.process_id if opt.process_id >= 0 else None)
        rank = dist.initialize(
            opt.coordinator or None,
            opt.n_processes or None,
            opt.process_id if opt.process_id >= 0 else None,
            local_device_ids=None if local is None else [local])
        if rank != 0:
            # rank-0-gated logging, like the reference's rank-0 std::cout
            opt.verbosity = 0
    runtime.enable_compile_cache()
    if opt.profile_dir:
        # structured hardware trace (the jax.profiler complement to the
        # --phase-timers wall-clock spans): view with tensorboard/xprof
        import jax
        with jax.profiler.trace(opt.profile_dir):
            out = MODES[opt.run_mode](opt)
    else:
        out = MODES[opt.run_mode](opt)
    if opt.distributed:
        dist.barrier("run-end")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
