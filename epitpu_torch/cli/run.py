"""Config-driven experiment runner (torch counterpart of ``epitpu.cli.run``):
generate the dataset, self-size N if asked, run PMMH in checkpointed
segments with live progress (or ABC rejection), write the reference's
artifact layout and print the report JSON, then optionally forecast, map
the likelihood surface, plot, or run a whole sweep.

    python -m epitpu_torch.cli.run --preset sir_underreported --device cuda --no-plots
    python -m epitpu_torch.cli.run --config my_experiment.json --device cpu
    python -m epitpu_torch.cli.run --sweep tmps --iters 200

Artifacts land in ``<out_dir>/<name>/run<i>/*.csv`` and
``<graphs_dir>/<name>/run<i>/*.png``, both relative to the working
directory by default.  The device is an argument (``--device``, default
``cuda``); ``cuda`` without a GPU raises, it never falls back to the CPU.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time

import numpy as np
import torch

from .. import profiling
from ..device import resolve_device, synchronize
from .configs import (
    ABCConfig,
    DataConfig,
    ExperimentConfig,
    MCMCConfig,
    noise_sweep,
    pobs_sweep,
    tmps_sweep,
)


def build_model(cfg: ExperimentConfig):
    from ..models import seir_model, sir_model, sir_subgroups_model

    if cfg.model == "sir":
        return sir_model()
    if cfg.model == "seir":
        return seir_model()
    if cfg.model in ("sir_subgroups", "sir_subgroups2"):
        return sir_subgroups_model(
            k=cfg.subgroups,
            aggregated_obs=(cfg.model == "sir_subgroups2" or cfg.data.aggregate_obs),
        )
    raise ValueError(f"unknown model {cfg.model!r}")


def generate_dataset(cfg: ExperimentConfig):
    """ODE ground truth plus observation thinning with
    ``np.random.default_rng(cfg.data.seed)``: binomial, Gaussian, or none.
    Returns ``(y float32 [T, obs_dim], latent [T, C])``."""
    from ..ode import (
        seir_simulate_discrete,
        sir_simulate_discrete,
        sir_subgroups_simulate_discrete,
    )

    d = cfg.data
    t = np.linspace(0, d.t_max, d.grid_points)
    if cfg.model == "sir":
        _, latent, _ = sir_simulate_discrete(tuple(d.y0), t, *d.theta_true)
        latent_obs = latent
    elif cfg.model == "seir":
        _, latent, _ = seir_simulate_discrete(tuple(d.y0), t, *d.theta_true)
        latent_obs = latent
    elif cfg.model in ("sir_subgroups", "sir_subgroups2"):
        k = cfg.subgroups
        y0 = np.asarray(d.y0, dtype=float).reshape(k, 3)
        beta = np.asarray(d.theta_true[: k * k], dtype=float).reshape(k, k)
        gamma = float(d.theta_true[k * k])
        _, latent, _ = sir_subgroups_simulate_discrete(y0, t, beta, gamma)
        if cfg.model == "sir_subgroups2":
            # observations summed over groups (reference pmcmc.py:172-175)
            latent_obs = sum(latent[:, 3 * g: 3 * (g + 1)] for g in range(k))
        else:
            latent_obs = latent
    else:
        raise ValueError(f"unknown model {cfg.model!r}")

    rng = np.random.default_rng(d.seed)
    if d.observation == "binomial":
        y = rng.binomial(np.round(latent_obs).astype(int), d.obs_param)
    elif d.observation == "gaussian":
        y = rng.normal(latent_obs, d.obs_param * latent_obs + 1e-4)
    else:
        y = latent_obs
    return y.astype(np.float32), latent


def population_and_mu(cfg: ExperimentConfig):
    """The filter's ``n_population`` and ``mu``: explicit ``MCMCConfig``
    values win, else derived from ``data.y0`` (population sum, initial
    infected), per group for subgroup models (epitpu/cli/run.py:299-317)."""
    m = cfg.mcmc
    if cfg.model.startswith("sir_subgroups"):
        y0 = np.asarray(cfg.data.y0, dtype=float).reshape(cfg.subgroups, 3)
        n_population = np.asarray(
            y0.sum(axis=1) if m.n_population is None else m.n_population, np.float32)
        mu = np.asarray(y0[:, 1] if m.mu is None else m.mu, np.float32)
        return n_population, mu
    n_population = (float(np.sum(cfg.data.y0)) if m.n_population is None
                    else float(m.n_population))
    mu = (float(cfg.data.y0[1] if cfg.model == "sir" else cfg.data.y0[2])
          if m.mu is None else float(m.mu))
    return n_population, mu


def pmmh_arguments(cfg: ExperimentConfig, model, obs, y, device):
    """The ``particle_mcmc_chains`` keyword arguments that ``cfg`` names,
    as epitpu's runner builds them (epitpu/cli/run.py:276-375), for data
    ``y`` on ``device`` with seed ``cfg.seed``:

    * theta0 is ``mcmc.theta0`` or ``data.theta_true``, with
      ``data.obs_param`` appended when ``infer_obs_param``; the proposal
      covariance ``mcmc.sigma0``.  A ``warm_start_dir`` replaces both by
      the reference's warm restart from that run directory;
    * with ``auto_particles`` the particle count is self-sized first by
      ``tune_particles`` at theta0 (split into model theta and reporting
      probability when p is inferred).

    Returns ``(kwargs, tuned_sd)``; ``tuned_sd`` is None without
    ``auto_particles``."""
    from ..rng import PhiloxStream
    from ..smc import tune_particles

    m = cfg.mcmc
    device = torch.device(device)
    sigma0 = m.sigma0
    if cfg.warm_start_dir:
        from ..io import warm_start

        ws_theta, ws_sigma = warm_start(cfg.warm_start_dir)
        theta0 = [float(v) for v in ws_theta]
        sigma0 = ws_sigma.tolist()
    else:
        theta0 = list(m.theta0 if m.theta0 is not None else cfg.data.theta_true)
        if m.infer_obs_param:
            theta0 = theta0 + [cfg.data.obs_param]
    n_population, mu = population_and_mu(cfg)
    n_particles, tuned_sd = m.n_particles, None
    if m.auto_particles is not None:
        if m.infer_obs_param:
            probe_theta, probe_obs = theta0[:-1], float(theta0[-1])
        else:
            probe_theta, probe_obs = theta0, cfg.data.obs_param
        n_particles, tuned_sd = tune_particles(
            model, obs, torch.as_tensor(y, dtype=torch.float32, device=device),
            probe_theta, probe_obs, PhiloxStream(cfg.seed + 5, device),
            torch.Generator(device=device).manual_seed(cfg.seed + 4),
            target_sd=float(m.auto_particles), n_population=n_population, mu=mu,
            steps_per_unit=m.steps_per_unit, sampler=m.sampler,
            resample_every=m.resample_every, resample_threshold=m.resample_threshold,
        )
    kwargs = dict(
        parameters=theta0, h=m.h, seed=cfg.seed, device=device, n_chains=m.n_chains,
        adaptive=m.adaptive, adapt_start=m.resolved_adapt_start(), sigma=sigma0,
        n_iters=m.n_iters, obs_param=cfg.data.obs_param,
        infer_obs_param=m.infer_obs_param, n_particles=n_particles,
        n_population=n_population, mu=mu, steps_per_unit=m.steps_per_unit,
        resampling=m.resampling, resample_threshold=m.resample_threshold,
        resample_every=m.resample_every, sampler=m.sampler,
        target_acceptance=m.target_acceptance, pooled_adaptation=m.pooled_adaptation,
        store_trajectories=m.store_trajectories, log_every=m.log_every,
    )
    return kwargs, tuned_sd


def chain_result(result, c=0):
    """Chain ``c`` of a chain-batched ``PMMHResult`` as a one-chain result:
    every tensor, the final state and its Welford statistics included,
    sliced to ``[c:c+1]`` (a leading chain axis of one)."""
    if isinstance(result, torch.Tensor):
        return result[c:c + 1]
    return dataclasses.replace(result, **{
        f.name: chain_result(getattr(result, f.name), c)
        for f in dataclasses.fields(result)
    })


def _require_plots(cfg):
    """Fail before any work when plots are asked for without matplotlib."""
    if cfg.make_plots:
        from ..viz import pyplot

        pyplot()


def _np(t):
    return t.detach().cpu().numpy()


def run_abc(cfg: ExperimentConfig, verbose=True, device="cuda"):
    """ABC rejection (reference tests/simulated_data.py:39-54): uniform
    priors, accept below the threshold, save the posterior as JSON and plot
    the chains, pairs and trajectory fan."""
    from ..abc import abc_rejection
    from ..diag import summarize_chain
    from ..io import save_dataset

    device = resolve_device(device)
    _require_plots(cfg)
    model = build_model(cfg)
    y, latent = generate_dataset(cfg)
    out_root = os.path.join(cfg.out_dir, cfg.name)
    os.makedirs(out_root, exist_ok=True)
    save_dataset(os.path.join(out_root, "dataset.csv"), y)

    a = cfg.abc
    priors = {name: (a.prior_lo, a.prior_hi) for name in model.theta_names}
    synchronize(device)
    t0 = time.time()
    with _profiled(cfg.profile_dir, device, "abc_trace.json"):
        result = abc_rejection(
            model, cfg.seed, torch.from_numpy(y).to(device), n_samples=a.n_samples,
            threshold=a.threshold, priors=priors, batch_size=a.batch_size,
            steps_per_unit=a.steps_per_unit,
        )
    elapsed = time.time() - t0

    with open(os.path.join(out_root, "posterior.json"), "w") as f:
        json.dump({k: v.tolist() for k, v in result.posterior.items()}, f)
    thetas = np.stack([result.posterior[n] for n in model.theta_names], axis=1)
    report = {
        "name": cfg.name,
        "algo": "abc",
        "samples": int(thetas.shape[0]),
        "trials": int(result.trials),
        "acceptance": result.acceptance_rate,
        "seconds": elapsed,
        "samples_per_s": thetas.shape[0] / elapsed,
        "summary": summarize_chain(thetas, list(model.theta_names)),
    }
    if cfg.make_plots:
        from ..viz import pair_plot, trace_plots, trajectory_fan

        gdir = os.path.join(cfg.graphs_dir, cfg.name, "run1")
        trace_plots(thetas, gdir, list(model.theta_names))
        pair_plot(thetas, gdir, list(model.theta_names))
        trajectory_fan(result.trajectories, gdir, observed=y, latent_truth=latent)
    if verbose:
        print(json.dumps(report, indent=2, default=float))
    return result, report


def _check_resumable(ck, cfg):
    from ..io import WRITER

    if ck.n_iters != cfg.mcmc.n_iters:
        raise ValueError(
            f"checkpoint was written for n_iters={ck.n_iters}, config asks for "
            f"{cfg.mcmc.n_iters}"
        )
    if ck.writer != WRITER:
        raise ValueError(
            f"checkpoint master key was written by {ck.writer}, whose random "
            f"streams differ from {WRITER}'s: it cannot continue this run"
        )
    if ck.seed != cfg.seed:
        raise ValueError("checkpoint master key does not match this config's seed")


def _run_pmmh_segmented(cfg, sampler_fn, model, obs, y, kwargs, out_root, verbose=True):
    """PMMH in ``cfg.checkpoint_every``-row segments (one segment when
    checkpointing is off).  After each segment: save a resumable
    checkpoint and print a progress line.  Segments concatenate to the
    unsegmented run bit for bit; ``cfg.resume`` continues from
    ``<out_root>/checkpoint.npz``.  The history stays on the device."""
    from ..io import load_pmmh_checkpoint, save_pmmh_checkpoint
    from ..mcmc import PMMHResult

    m = cfg.mcmc
    device = kwargs["device"]
    seg = cfg.checkpoint_every if cfg.checkpoint_every > 0 else m.n_iters
    ckpt_path = os.path.join(out_root, "checkpoint.npz")

    state, hist, rows = None, None, 0  # hist: (thetas, lls, trajs) [M, rows, ...]
    if cfg.resume:
        ck = load_pmmh_checkpoint(ckpt_path, device)
        if ck is not None:
            _check_resumable(ck, cfg)
            state = ck.state
            hist = tuple(torch.as_tensor(a, device=device)
                         for a in (ck.thetas, ck.log_likelihoods, ck.sampled_trajs))
            rows = int(state.step[0]) + 1
            if verbose:
                print(f"[pmmh] resuming {cfg.name} from checkpoint at iter "
                      f"{rows}/{m.n_iters}", flush=True)

    t_start = time.time()
    while rows < m.n_iters:
        seg_len = min(seg, m.n_iters - rows)
        result = sampler_fn(model, obs, y, init_state=state, segment_len=seg_len, **kwargs)
        new = (result.thetas, result.log_likelihoods, result.sampled_trajs)
        hist = new if hist is None else tuple(
            torch.cat([h, n], dim=1) for h, n in zip(hist, new))
        state = result.final_state
        rows += seg_len
        if cfg.checkpoint_every > 0:
            save_pmmh_checkpoint(ckpt_path, state, cfg.seed, m.n_iters, *hist,
                                 meta={"name": cfg.name})
        if verbose and (cfg.checkpoint_every > 0 or rows < m.n_iters):
            acc = _np(state.acceptances).astype(float) / max(rows, 1)
            th = _np(state.theta)
            print(
                f"[pmmh] {cfg.name}: iter {rows}/{m.n_iters}  "
                f"elapsed={time.time() - t_start:.1f}s  "
                f"acc_ratio={float(np.mean(acc)):.3f}  "
                f"theta_mean=[{', '.join(f'{v:.4g}' for v in th.mean(axis=0))}]  "
                f"log_zeta_mean={float(np.mean(_np(state.log_likelihood))):.3f}",
                flush=True,
            )
    synchronize(device)
    return PMMHResult(thetas=hist[0], log_likelihoods=hist[1], sampled_trajs=hist[2],
                      acceptances=state.acceptances, final_state=state)


@contextlib.contextmanager
def _profiled(profile_dir, device, trace_name):
    """With ``profile_dir``, the block under ``torch.profiler`` (CPU and, on
    a GPU, CUDA activity) and the program's span recording; then writes the
    Chrome trace as ``profile_dir/trace_name`` and the spans, counters and
    clock anchor as ``profile_dir/spans.json``.  Without it, nothing."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profiling.recording() as rec, profile(activities=activities) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, trace_name))
    with open(os.path.join(profile_dir, "spans.json"), "w") as f:
        json.dump(rec.to_json(), f)


def run_experiment(cfg: ExperimentConfig, verbose=True, device="cuda"):
    """Run ``cfg`` on ``device``; returns ``(result, report)`` with the
    result's tensors on the device."""
    if cfg.algo == "abc":
        return run_abc(cfg, verbose=verbose, device=device)
    from .. import mcmc
    from ..diag import (
        acceptance_rate,
        ess,
        ess_rank,
        gelman_rubin,
        gelman_rubin_rank,
        pool_chains,
        summarize_chain,
    )
    from ..io import save_dataset, save_pmmh_run
    from ..observe import get_observation_model
    from ..rng import PhiloxStream

    device = resolve_device(device)
    _require_plots(cfg)
    model = build_model(cfg)
    y, latent = generate_dataset(cfg)
    out_root = os.path.join(cfg.out_dir, cfg.name)
    os.makedirs(out_root, exist_ok=True)
    save_dataset(os.path.join(out_root, "dataset.csv"), y)

    m = cfg.mcmc
    obs = get_observation_model("gaussian" if cfg.data.observation == "gaussian"
                                else "binomial")
    y_dev = torch.from_numpy(y).to(device)
    kwargs, tuned_sd = pmmh_arguments(cfg, model, obs, y_dev, device)
    n_particles = kwargs["n_particles"]
    n_population, mu = kwargs["n_population"], kwargs["mu"]
    if tuned_sd is not None:
        met = tuned_sd <= float(m.auto_particles)
        if verbose or not met:
            note = "" if met else (
                "  WARNING: target missed even at the max_particles cap; expect "
                "sticky pseudo-marginal mixing")
            print(f"[pmmh] {cfg.name}: auto_particles -> N={n_particles} "
                  f"(sd(logZ)={tuned_sd:.2f} {'<=' if met else '>'} {m.auto_particles})"
                  f"{note}", flush=True)

    synchronize(device)
    t0 = time.time()
    with _profiled(cfg.profile_dir, device, "pmmh_trace.json"):
        result = _run_pmmh_segmented(cfg, mcmc.particle_mcmc_chains, model, obs, y_dev,
                                     kwargs, out_root, verbose=verbose)
    elapsed = time.time() - t0
    total_iters = m.n_chains * m.n_iters

    names = list(model.theta_names)
    if m.infer_obs_param:
        names.append("p_obs")
    comp_names = [
        {"s": "susceptible", "e": "exposed", "i": "infected", "r": "recovered"}.get(c, c)
        for c in model.compartments
    ]
    thetas, lls, trajs = (_np(result.thetas), _np(result.log_likelihoods),
                          _np(result.sampled_trajs))

    # the reference's one run<i>/ directory per chain, for the first 3 chains
    # past 8 chains; the whole chain set then goes into chains.npz
    n_ref_dirs = m.n_chains if m.n_chains <= 8 else 3
    for c in range(n_ref_dirs):
        save_pmmh_run(os.path.join(out_root, f"run{c + 1}"), thetas[c], lls[c], trajs[c],
                      compartment_names=comp_names)
    if m.n_chains > n_ref_dirs:
        # unlike epitpu (run.py:428-433), stored trajectories are kept too
        stored = dict(sampled_trajs=trajs) if m.store_trajectories else {}
        np.savez_compressed(os.path.join(out_root, "chains.npz"), thetas=thetas,
                            log_likelihoods=lls, **stored)

    report = {
        "name": cfg.name,
        "iters_total": total_iters,
        "n_particles": n_particles,
        # a non-finite sd is written as null, which strict JSON readers accept
        **({"auto_particles_sd": tuned_sd if math.isfinite(tuned_sd) else None}
           if tuned_sd is not None else {}),
        "seconds": elapsed,
        "iters_per_s": total_iters / elapsed,
        "acceptance": [acceptance_rate(thetas[c]) for c in range(m.n_chains)],
        # burn-in per chain before pooling
        "summary": summarize_chain(pool_chains(thetas, burn_in=max(1, m.n_iters // 10)),
                                   names),
    }
    if m.n_chains >= 2:
        chains = thetas[:, m.n_iters // 5:, :]
        report["gelman_rubin"] = gelman_rubin(chains).tolist()
        report["ess"] = np.asarray(ess(chains)).tolist()
        report["gelman_rubin_rank"] = gelman_rubin_rank(chains).tolist()
        report["ess_rank"] = np.asarray(ess_rank(chains)).tolist()

    gdir = os.path.join(cfg.graphs_dir, cfg.name, "run1")
    if cfg.forecast_horizon > 0:
        # posterior-predictive forecast from chain 0 (reference
        # tests/pred_tmps.py:55-104)
        if not m.store_trajectories:
            raise SystemExit(
                "--forecast needs stored trajectories (the forecast continues "
                "each draw from its last filtered state); set "
                "mcmc.store_trajectories=true"
            )
        first = chain_result(result, 0)
        burn = max(1, m.n_iters // 5)
        thin = max(1, (m.n_iters - burn) // 200)
        thinned = dataclasses.replace(
            first, thetas=first.thetas[:, burn:], sampled_trajs=first.sampled_trajs[:, burn:],
            log_likelihoods=first.log_likelihoods[:, burn:])
        fc = _np(mcmc.forecast_from_result(
            model, PhiloxStream(cfg.seed + 1, device), thinned, cfg.forecast_horizon,
            infer_obs_param=m.infer_obs_param, thin=thin, steps_per_unit=m.steps_per_unit,
        ))
        np.save(os.path.join(out_root, "forecast.npy"), fc)
        if cfg.make_plots:
            from ..viz import forecast_fan

            forecast_fan(_np(thinned.sampled_trajs[0])[::thin], fc[:, 1:], gdir, truth=None)

    if cfg.surface_points > 0:
        # likelihood map over the first two theta components around
        # theta_true, the others pinned there (reference
        # tests/testing_sbgrps.py:35-49)
        from ..diag import high_likelihood_map, likelihood_surface, theta_grid

        tt = np.asarray(cfg.data.theta_true, dtype=float)
        if tt.shape[0] < 2:
            raise SystemExit(
                "--surface needs a model with at least 2 theta components "
                f"(got theta_true={tt.tolist()}): the surface is a 2-D grid over "
                "the first two components"
            )
        span = cfg.surface_span
        ranges = [(max(1e-3, tt[0] - span), tt[0] + span),
                  (max(1e-3, tt[1] - span), tt[1] + span)]
        grid2 = theta_grid(ranges, cfg.surface_points)
        if tt.shape[0] > 2:
            rest = np.broadcast_to(tt[2:], (grid2.shape[0], tt.shape[0] - 2))
            grid_full = np.concatenate([grid2, rest], axis=1).astype(np.float32)
        else:
            grid_full = grid2
        surf = likelihood_surface(
            model, obs, cfg.seed + 2, y_dev, grid_full, obs_param=cfg.data.obs_param,
            n_particles=m.n_particles, n_population=n_population, mu=mu,
            steps_per_unit=m.steps_per_unit, device=device,
        )
        np.savetxt(os.path.join(out_root, "surface.csv"),
                   np.concatenate([grid2, surf[:, None]], axis=1), delimiter=",",
                   header=f"{names[0]},{names[1]},log_likelihood")
        mask, _ = high_likelihood_map(grid_full, surf, quantile=0.5)
        report["surface"] = {
            "points": int(grid2.shape[0]),
            "argmax_theta": grid2[
                int(np.nanargmax(np.where(np.isfinite(surf), surf, -np.inf)))].tolist(),
            "high_likelihood_count": int(mask.sum()),
        }
        if cfg.make_plots:
            from ..viz import surface_heatmap

            surface_heatmap(grid2, surf, gdir, names=names[:2], truth=tt[:2].tolist())

    if cfg.plot_particles:
        # one filter at the posterior-mean theta: particle clouds and
        # ancestry (reference tests/test_particles.py:78-95)
        from ..smc import particle_filter
        from ..viz import particle_cloud_plot

        theta_mean = thetas[:, max(1, m.n_iters // 5):, :].mean((0, 1))
        if m.infer_obs_param:
            viz_theta, viz_obs_param = theta_mean[:-1], float(theta_mean[-1])
        else:
            viz_theta, viz_obs_param = theta_mean, cfg.data.obs_param
        pf = particle_filter(
            model, obs, y_dev, torch.as_tensor(viz_theta[None], dtype=torch.float32,
                                               device=device),
            viz_obs_param, PhiloxStream(cfg.seed + 3, device),
            torch.Generator(device=device).manual_seed(cfg.seed + 3),
            n_particles=min(m.n_particles, 256), n_population=n_population, mu=mu,
            steps_per_unit=m.steps_per_unit,
        )
        report["particle_plot"] = particle_cloud_plot(pf.hidden[0], pf.ancestry[0], gdir)

    if cfg.make_plots:
        from ..viz import multi_chain_traces, plot_pmmh_suite

        plot_pmmh_suite(
            chain_result(result, 0), gdir, theta_names=names,
            latent_truth=latent if latent.shape[1] == len(comp_names) else None,
            compartment_names=comp_names, burn_in=min(100, m.n_iters // 5),
        )
        if m.n_chains >= 2:
            multi_chain_traces(thetas, gdir, names, suffix="_chains")

    if verbose:
        print(json.dumps(report, indent=2, default=float))
    return result, report


# convergence gate of a sweep level: rank-normalized split R-hat below 1.1
# and rank ESS above 100 for every theta component (Vehtari et al. 2021;
# the classic estimators when the rank ones are absent)
CONVERGED_MAX_RHAT = 1.1
CONVERGED_MIN_ESS = 100.0


def run_sweep(sweep_name, cfgs, verbose=True, device="cuda"):
    """Every level of a sweep, then the reference's cross-level analysis
    (tests/test_noise.py:113-116, test_under.py:118-122,
    test_timepoints.py:98-101): posterior MSE against theta_true, ESS,
    acceptance and the convergence gate per level, in
    ``<out_dir>/<sweep_name>/sweep_summary.json`` and a comparison plot."""
    from ..diag import pool_chains, posterior_mse

    cfgs = list(cfgs)
    levels = []
    for cfg in cfgs:
        t_level = time.perf_counter()
        result, report = run_experiment(cfg, verbose=verbose, device=device)
        wall_s = time.perf_counter() - t_level
        post = pool_chains(_np(result.thetas), burn_in=max(1, cfg.mcmc.n_iters // 10))
        true = list(cfg.data.theta_true)
        pmse = [posterior_mse(t, post[:, j]) for j, t in enumerate(true)]
        rhat, essv = report.get("gelman_rubin"), report.get("ess")
        rhat_gate = report.get("gelman_rubin_rank") or rhat
        ess_gate = report.get("ess_rank") or essv
        converged = (
            bool(max(rhat_gate) < CONVERGED_MAX_RHAT and min(ess_gate) > CONVERGED_MIN_ESS)
            if rhat_gate and ess_gate else None
        )
        levels.append({
            "name": cfg.name,
            "level": cfg.name.rsplit("_", 1)[-1],  # the suffix the sweep appends
            "n_particles": report.get("n_particles"),
            "theta_true": true,
            "pmse": pmse,
            "pmse_mean": float(np.mean(pmse)),
            "acceptance": report["acceptance"],
            "ess": essv,
            "ess_rank": report.get("ess_rank"),
            "gelman_rubin": rhat,
            "gelman_rubin_rank": report.get("gelman_rubin_rank"),
            "converged": converged,
            "summary": report["summary"],
            "wall_s": wall_s,
            "iters_per_s": cfg.mcmc.n_iters * cfg.mcmc.n_chains / wall_s,
        })

    out_root = os.path.join(cfgs[0].out_dir, sweep_name)
    os.makedirs(out_root, exist_ok=True)
    summary = {
        "sweep": sweep_name,
        "convergence_criteria": {"max_rhat": CONVERGED_MAX_RHAT,
                                 "min_ess": CONVERGED_MIN_ESS},
        "wall_note": (
            "wall_s/iters_per_s wrap run_experiment: the first level of a sweep "
            "also builds the CUDA kernel when no earlier call in the process "
            "did, so its throughput under-reports relative to later levels"
        ),
        "levels": levels,
    }
    with open(os.path.join(out_root, "sweep_summary.json"), "w") as f:
        json.dump(summary, f, indent=2, default=float)
    if cfgs[0].make_plots:
        from ..viz import sweep_comparison_plot

        sweep_comparison_plot(levels, os.path.join(cfgs[0].graphs_dir, sweep_name))
    if verbose:
        print(json.dumps(summary, indent=2, default=float))
    return summary


SWEEPS = {"noise": noise_sweep, "pobs": pobs_sweep, "tmps": tmps_sweep}


def _subgroup_data():
    return DataConfig(
        y0=(2000.0, 30.0, 0.0, 3000.0, 40.0, 0.0),
        theta_true=(5.0, 2.0, 1.0, 3.0, 0.5),
        t_max=10,
        observation="binomial",
        obs_param=0.1,
    )


# the presets of epitpu/cli/run.py:703-806, field for field
PRESETS = {
    "sir_underreported": lambda: ExperimentConfig(
        name="sir_underreported",
        data=DataConfig(observation="binomial", obs_param=0.1),
        mcmc=MCMCConfig(n_iters=1000, h=0.05, n_particles=100, n_chains=3),
    ),
    # 2,048 chains x N self-sized from 16, pooled adaptive h=0.6,
    # resample_every=4, theta only
    "production": lambda: ExperimentConfig(
        name="production",
        data=DataConfig(observation="binomial", obs_param=0.1),
        mcmc=MCMCConfig(
            n_iters=2000, h=0.6, n_particles=16, n_chains=2048,
            auto_particles=1.0,
            adaptive=True, adapt_start=16, pooled_adaptation=True,
            resample_every=4, sampler="fast_rbg",
            store_trajectories=False,
        ),
    ),
    # Gaussian observations, noise sd 0.1 x the count
    "sir_noisy": lambda: ExperimentConfig(
        name="sir_noisy",
        data=DataConfig(observation="gaussian", obs_param=0.1),
        mcmc=MCMCConfig(n_iters=1000, h=0.05, n_particles=100, n_chains=3),
    ),
    # the reporting probability inferred as a third theta component
    "sir_infer_p": lambda: ExperimentConfig(
        name="sir_infer_p",
        data=DataConfig(observation="binomial", obs_param=0.1),
        mcmc=MCMCConfig(
            n_iters=1000, h=0.02, n_particles=100, n_chains=3,
            infer_obs_param=True,
        ),
    ),
    "seir_underreported": lambda: ExperimentConfig(
        name="seir_underreported",
        model="seir",
        data=DataConfig(
            y0=(4800.0, 0.0, 20.0, 0.0),
            theta_true=(4.0, 1.0, 1.0),
            observation="binomial",
            obs_param=0.1,
        ),
        mcmc=MCMCConfig(n_iters=1000, h=0.02, n_particles=100, n_chains=3),
    ),
    "sir_abc": lambda: ExperimentConfig(
        name="sir_abc",
        algo="abc",
        data=DataConfig(observation="none"),
        abc=ABCConfig(n_samples=100, threshold=150.0, prior_lo=0.0,
                      prior_hi=5.0),
    ),
    # per-group observations (reference ModelType.SIR_SUBGROUPS)
    "sir_subgroups": lambda: ExperimentConfig(
        name="sir_subgroups",
        model="sir_subgroups",
        subgroups=2,
        data=_subgroup_data(),
        mcmc=MCMCConfig(n_iters=500, h=0.02, n_particles=100, n_chains=2),
    ),
    # observations summed over groups (reference ModelType.SIR_SUBGROUPS2)
    "sir_subgroups2": lambda: ExperimentConfig(
        name="sir_subgroups2",
        model="sir_subgroups2",
        subgroups=2,
        data=_subgroup_data(),
        mcmc=MCMCConfig(n_iters=500, h=0.02, n_particles=100, n_chains=2),
    ),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", choices=sorted(PRESETS), default=None)
    ap.add_argument("--config", type=str, default=None, help="JSON config path")
    ap.add_argument("--sweep", choices=sorted(SWEEPS), default=None)
    ap.add_argument("--dump-config", action="store_true")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to run on (default cuda; cuda without a GPU "
                    "raises, it never falls back to the CPU)")
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--chains", type=int, default=None)
    ap.add_argument("--particles", type=int, default=None)
    ap.add_argument("--no-plots", action="store_true",
                    help="write no figures (needed where matplotlib is not installed)")
    ap.add_argument("--surface", type=int, default=None, metavar="P",
                    help="also evaluate the filter likelihood on a PxP grid of the "
                    "first two theta components around theta_true: surface.csv + heatmap")
    ap.add_argument("--resample-every", type=int, default=None, metavar="K",
                    help="resample only on every K-th observation step (weights "
                    "carried between)")
    ap.add_argument("--resample-threshold", type=float, default=None, metavar="ALPHA",
                    help="resample only when the particle ESS < ALPHA*N (1.0 = always)")
    ap.add_argument("--auto-particles", type=float, default=None, metavar="SD",
                    help="self-size the particle count before the run: double N from "
                    "16 until the filter's log-likelihood sd at theta0 is under SD "
                    "(overrides --particles)")
    ap.add_argument("--target-acceptance", type=float, default=None, metavar="A",
                    help="Robbins-Monro tuning of the proposal scale toward this "
                    "acceptance rate")
    ap.add_argument("--plot-particles", action="store_true",
                    help="run one filter at the posterior-mean theta and plot its "
                    "particle clouds and ancestry")
    ap.add_argument("--forecast", type=int, default=None, metavar="HORIZON",
                    help="posterior-predictive forecast this many time units past the data")
    ap.add_argument("--warm-start", type=str, default=None, metavar="RUN_DIR",
                    help="seed theta0/sigma0 from a previous run directory")
    ap.add_argument("--checkpoint-every", type=int, default=None, metavar="K",
                    help="run in K-iteration segments, saving a resumable checkpoint "
                    "and printing progress after each")
    ap.add_argument("--resume", action="store_true",
                    help="continue bit for bit from <out>/<name>/checkpoint.npz")
    ap.add_argument("--log-every", type=int, default=None, metavar="K",
                    help="print a telemetry line every K iterations (chain-aggregated "
                    "for many-chain runs)")
    ap.add_argument("--profile", type=str, default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace of the sampler to "
                    "DIR/pmmh_trace.json (DIR/abc_trace.json for ABC) and the "
                    "program's spans and counters to DIR/spans.json; a span's "
                    "perf_counter ns + anchor[0][0] - anchor[0][1] is Unix ns, "
                    "and Unix ns = the trace's baseTimeNanoseconds + ts * 1000")
    ap.add_argument("--multihost", action="store_true",
                    help="join a multi-process group before running (env triple "
                    "EPITPU_COORDINATOR/EPITPU_NUM_PROCESSES/EPITPU_PROCESS_ID, or "
                    "torchrun's variables; see epitpu_torch.dist.multihost): one process "
                    "a card; only rank 0 runs, on its card for a bare --device cuda")
    args = ap.parse_args(argv)

    if args.multihost:
        # before any work, as epitpu's runner joins its runtime.  The runner
        # passes no mesh, so the other ranks would only repeat rank 0's run
        # and must not write its artifacts (epitpu/dist/multihost.py:17-18):
        # they stop here
        from ..dist.multihost import initialize_multihost, is_primary_host, local_rank

        initialize_multihost()
        if not is_primary_host():
            return 0
        if args.device == "cuda":
            args.device = f"cuda:{local_rank()}"

    if args.sweep:
        cfgs = []
        for cfg in SWEEPS[args.sweep]():
            _apply_overrides(cfg, args)
            cfgs.append(cfg)
        run_sweep(args.sweep, cfgs, device=args.device)
        return 0

    if args.config:
        with open(args.config) as f:
            cfg = ExperimentConfig.from_json(f.read())
    else:
        cfg = PRESETS[args.preset or "sir_underreported"]()
    _apply_overrides(cfg, args)
    if args.dump_config:
        print(cfg.to_json())
        return 0
    run_experiment(cfg, device=args.device)
    return 0


def _apply_overrides(cfg, args):
    if args.iters is not None:
        cfg.mcmc.n_iters = args.iters
    if args.chains is not None:
        cfg.mcmc.n_chains = args.chains
    if args.particles is not None:
        cfg.mcmc.n_particles = args.particles
    if args.no_plots:
        cfg.make_plots = False
    if args.resample_threshold is not None:
        cfg.mcmc.resample_threshold = args.resample_threshold
    if args.resample_every is not None:
        cfg.mcmc.resample_every = args.resample_every
    if args.surface is not None:
        cfg.surface_points = args.surface
    if args.plot_particles:
        cfg.plot_particles = True
    if args.target_acceptance is not None:
        cfg.mcmc.target_acceptance = args.target_acceptance
    if args.auto_particles is not None:
        cfg.mcmc.auto_particles = args.auto_particles
    if args.forecast is not None:
        cfg.forecast_horizon = args.forecast
    if args.warm_start is not None:
        cfg.warm_start_dir = args.warm_start
    if args.checkpoint_every is not None:
        cfg.checkpoint_every = args.checkpoint_every
    if args.resume:
        cfg.resume = True
    if args.log_every is not None:
        cfg.mcmc.log_every = args.log_every
    if args.profile is not None:
        cfg.profile_dir = args.profile


if __name__ == "__main__":
    sys.exit(main())
