"""epitpu_torch's experiment runner against epitpu's: configs and presets
key for key, the artifact layout and report of one run on the same config,
sweeps, the Gaussian and inferred-p presets, and the port's deliberate
differences (null sd, trajectories in chains.npz)."""
import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

from epitpu.cli import configs as jconfigs
from epitpu.cli import run as jrun
from epitpu_torch import smc
from epitpu_torch.cli import (PRESETS, SWEEPS, build_model, generate_dataset, main,
                               pmmh_arguments, run_experiment, run_sweep)
from epitpu_torch.cli import configs as tconfigs
from epitpu_torch.diag import ess_rank
from epitpu_torch.mcmc import particle_mcmc_chains
from epitpu_torch.models import sir_model
from epitpu_torch.observe import get_observation_model

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data", "sir_underreported")


def _tiny(pkg, out, name="tiny", **kw):
    """tests/test_cli.py's _tiny_cfg in either package."""
    return pkg.ExperimentConfig(**{
        "name": name,
        "data": pkg.DataConfig(t_max=6, observation="binomial", obs_param=0.1),
        "mcmc": pkg.MCMCConfig(n_iters=40, h=0.05, n_particles=32, n_chains=2,
                               steps_per_unit=5),
        "out_dir": os.path.join(out, "data"),
        "graphs_dir": os.path.join(out, "graphs"),
        "make_plots": False,
        **kw,
    })


def _full(pkg, out):
    """One run through every optional stage: 3 chains x 100 iterations,
    forecast, a 3x3 surface and plots."""
    cfg = _tiny(pkg, out, forecast_horizon=3, surface_points=3, make_plots=True)
    cfg.mcmc.n_iters, cfg.mcmc.n_chains = 100, 3
    return cfg


def _last_json(out):
    """The last JSON object printed (indent=2) in ``out``."""
    lines = out.splitlines()
    start = len(lines) - 1 - lines[::-1].index("{")
    return json.loads("\n".join(lines[start:]))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, _, names in os.walk(root) for n in names)


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    """The same full config through epitpu's runner and the port's (CPU)."""
    out_j = str(tmp_path_factory.mktemp("epitpu"))
    out_t = str(tmp_path_factory.mktemp("port"))
    res_j, rep_j = jrun.run_experiment(_full(jconfigs, out_j), verbose=False)
    res_t, rep_t = run_experiment(_full(tconfigs, out_t), verbose=False, device="cpu")
    return dict(out_j=out_j, out_t=out_t, res_j=res_j, rep_j=rep_j, res_t=res_t, rep_t=rep_t)


# ---- configs ----------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(jrun.PRESETS))
def test_preset_json_equals_epitpu(name):
    assert sorted(PRESETS) == sorted(jrun.PRESETS)
    port, ref = PRESETS[name]().to_json(), jrun.PRESETS[name]().to_json()
    assert json.loads(port) == json.loads(ref)
    assert port == ref


@pytest.mark.parametrize("argv", [
    ["--preset", "production"],
    ["--preset", "sir_infer_p", "--iters", "7", "--chains", "2", "--no-plots", "--log-every",
     "3", "--checkpoint-every", "5", "--resume", "--surface", "4", "--forecast", "2",
     "--auto-particles", "1.5", "--target-acceptance", "0.3", "--resample-every", "2",
     "--resample-threshold", "0.5", "--plot-particles", "--warm-start", "run1",
     "--profile", "prof", "--particles", "9"],
], ids=["preset", "every_override"])
def test_dump_config_equals_epitpu(argv, capsys):
    assert main(argv + ["--dump-config", "--device", "cpu"]) == 0
    port = capsys.readouterr().out
    assert jrun.main(argv + ["--dump-config"]) == 0
    assert port == capsys.readouterr().out


def test_config_json_round_trips_across_packages():
    cfg = jrun.PRESETS["sir_subgroups"]()
    cfg.mcmc.sigma0 = [[0.1, 0.0], [0.0, 0.2]]
    cfg.mcmc.theta0 = (1.0, 2.0)
    port = tconfigs.ExperimentConfig.from_json(cfg.to_json())
    assert isinstance(port.mcmc, tconfigs.MCMCConfig)
    assert port.to_json() == cfg.to_json()


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_sweeps_equal_epitpu(name):
    port = [c.to_json() for c in SWEEPS[name]()]
    ref = [c.to_json() for c in jrun.SWEEPS[name]()]
    assert port == ref and len(port) in (3, 5, 6)
    names = [c.name for c in tconfigs.sweep(tconfigs.ExperimentConfig(), "data.obs_param", [1, 2])]
    assert names == ["sir_underreported_obs_param_1", "sir_underreported_obs_param_2"]


# ---- pmmh_arguments: epitpu/cli/run.py:276-375 --------------------------------

def test_pmmh_arguments_inferred_p_warm_start_and_sigma(tmp_path):
    cfg = PRESETS["sir_infer_p"]()
    model, obs = build_model(cfg), get_observation_model("binomial")
    y, _ = generate_dataset(cfg)
    kw, _ = pmmh_arguments(cfg, model, obs, y, "cpu")
    assert kw["parameters"] == [2.0, 1.0, 0.1] and kw["infer_obs_param"] is True
    assert kw["sigma"] is None and kw["h"] == 0.02
    cfg.mcmc.theta0, cfg.mcmc.sigma0 = (1.5, 0.5), [[0.2, 0.0, 0.0]] * 3
    kw, _ = pmmh_arguments(cfg, model, obs, y, "cpu")
    assert kw["parameters"] == [1.5, 0.5, 0.1] and kw["sigma"] == [[0.2, 0.0, 0.0]] * 3
    # the reference's warm restart replaces theta0 and sigma0
    from epitpu.io import save_pmmh_run as j_save_run
    from epitpu.io import warm_start as j_warm_start

    rng = np.random.default_rng(0)
    th = rng.normal([2.0, 1.0, 0.1], 0.05, size=(300, 3))
    j_save_run(str(tmp_path / "run1"), th, rng.normal(size=300), np.zeros((300, 0, 0)))
    cfg.warm_start_dir = str(tmp_path / "run1")
    kw, _ = pmmh_arguments(cfg, model, obs, y, "cpu")
    ref_theta, ref_sigma = j_warm_start(cfg.warm_start_dir)
    np.testing.assert_array_equal(kw["parameters"], ref_theta)
    np.testing.assert_array_equal(kw["sigma"], ref_sigma)


def test_tune_probe_splits_inferred_p(monkeypatch):
    """With p inferred, N is tuned at the model theta and p = theta0[-1]
    (epitpu/cli/run.py:327-331), with the resample threshold (:339)."""
    seen = {}

    def spy(model, obs, y, theta, obs_param, stream, gen, **kw):
        seen.update(theta=list(theta), obs_param=obs_param, **kw)
        return 64, 0.5

    monkeypatch.setattr(smc, "tune_particles", spy)
    cfg = PRESETS["sir_infer_p"]()
    cfg.mcmc.auto_particles, cfg.mcmc.resample_threshold = 1.0, 0.5
    cfg.data.obs_param = 0.2
    model, obs = build_model(cfg), get_observation_model("binomial")
    kw, sd = pmmh_arguments(cfg, model, obs, generate_dataset(cfg)[0], "cpu")
    assert seen["theta"] == [2.0, 1.0] and seen["obs_param"] == 0.2
    assert seen["resample_threshold"] == 0.5
    assert (kw["n_particles"], sd) == (64, 0.5)


# ---- the runner against epitpu's ----------------------------------------------

def test_run_writes_epitpu_layout_and_report_keys(both_runs):
    files_j = _files(both_runs["out_j"])
    files_t = _files(both_runs["out_t"])
    assert files_t == files_j
    assert "data/tiny/forecast.npy" in files_t and "graphs/tiny/run1/surface.png" in files_t
    assert sorted(both_runs["rep_t"]) == sorted(both_runs["rep_j"])
    assert sorted(both_runs["rep_t"]["surface"]) == sorted(both_runs["rep_j"]["surface"])
    th = np.loadtxt(os.path.join(both_runs["out_t"], "data/tiny/run2/thetas.csv"), delimiter=",")
    np.testing.assert_array_equal(th, both_runs["res_t"].thetas[1].numpy())
    fc = np.load(os.path.join(both_runs["out_t"], "data/tiny/forecast.npy"))
    assert fc.shape[1:] == (4, 3) and np.all(fc.sum(-1) == 4820.0)
    surf = np.loadtxt(os.path.join(both_runs["out_t"], "data/tiny/surface.csv"), delimiter=",")
    assert surf.shape == (9, 3)


def test_run_posterior_means_agree_with_epitpu(both_runs):
    """Pooled posterior means after a 20 % burn-in agree within 4 combined
    Monte-Carlo standard errors (rank ESS of each package's own chains)."""
    th_j = np.asarray(both_runs["res_j"].thetas, np.float64)[:, 20:]
    th_t = both_runs["res_t"].thetas.double().numpy()[:, 20:]
    assert th_t.shape == th_j.shape == (3, 80, 2)

    def mean_se(th):
        flat = th.reshape(-1, 2)
        return flat.mean(0), flat.std(0) / np.sqrt(np.asarray(ess_rank(th)))

    (m_j, se_j), (m_t, se_t) = mean_se(th_j), mean_se(th_t)
    assert np.all(np.abs(m_t - m_j) <= 4 * np.sqrt(se_j ** 2 + se_t ** 2) + 0.05), (m_t, m_j)
    for name in ("beta", "gamma"):
        assert abs(both_runs["rep_t"]["summary"][name]["mean"]
                   - both_runs["rep_j"]["summary"][name]["mean"]) < 1.0


def test_run_sweep_summary_keys_equal_epitpu(tmp_path, both_runs):
    def levels(pkg, runner, out, values, **kw):
        base = _tiny(pkg, str(out))
        cfgs = list(pkg.sweep(base, "data.obs_param", values))
        return runner("mini", cfgs, verbose=False, **kw)

    port = levels(tconfigs, run_sweep, tmp_path / "t", [0.1, 0.3], device="cpu")
    ref = levels(jconfigs, jrun.run_sweep, tmp_path / "j", [0.3])
    assert sorted(port) == sorted(ref)
    assert [sorted(lv) for lv in port["levels"]] == [sorted(ref["levels"][0])] * 2
    assert [lv["level"] for lv in port["levels"]] == ["0.1", "0.3"]
    assert port["convergence_criteria"] == ref["convergence_criteria"]
    for lv in port["levels"]:
        assert len(lv["pmse"]) == 2 and all(np.isfinite(lv["pmse"]))
        assert lv["converged"] in (True, False)
    with open(tmp_path / "t" / "data" / "mini" / "sweep_summary.json") as f:
        assert json.load(f)["sweep"] == "mini"


@pytest.mark.parametrize("preset", ["sir_noisy", "sir_infer_p"])
def test_gaussian_and_inferred_p_presets_run(preset, tmp_path):
    cfg = PRESETS[preset]()
    cfg.mcmc.n_iters, cfg.mcmc.n_particles, cfg.mcmc.steps_per_unit = 30, 32, 5
    cfg.data.t_max, cfg.make_plots = 6, False
    cfg.out_dir = str(tmp_path / "data")
    res, rep = run_experiment(cfg, verbose=False, device="cpu")
    d = 3 if preset == "sir_infer_p" else 2
    assert res.thetas.shape == (3, 30, d) and bool(torch.isfinite(res.log_likelihoods).all())
    assert list(rep["summary"]) == ["beta", "gamma", "p_obs"][:d]
    if preset == "sir_infer_p":
        p = res.thetas[..., 2]
        assert bool(((p >= 0) & (p <= 1)).all())
        assert 0.0 < rep["summary"]["p_obs"]["mean"] < 0.5


def test_many_chains_collapse_to_chains_npz_with_trajectories(tmp_path):
    """Past 8 chains only run1..run3 are written; chains.npz holds every
    chain, and (unlike epitpu, run.py:428-433) the stored trajectories."""
    cfg = _tiny(tconfigs, str(tmp_path))
    cfg.mcmc.n_chains, cfg.mcmc.n_iters = 9, 20
    res, _ = run_experiment(cfg, verbose=False, device="cpu")
    root = tmp_path / "data" / "tiny"
    assert (root / "run3").is_dir() and not (root / "run4").exists()
    z = np.load(root / "chains.npz")
    assert z["thetas"].shape == (9, 20, 2) and z["log_likelihoods"].shape == (9, 20)
    np.testing.assert_array_equal(z["sampled_trajs"], res.sampled_trajs.numpy())
    assert z["sampled_trajs"].shape == (9, 20, 7, 3)


def test_infinite_tuned_sd_is_written_as_null(tmp_path, monkeypatch, capsys):
    """epitpu writes Infinity (run.py:439), which strict JSON rejects."""
    monkeypatch.setattr(smc, "tune_particles", lambda *a, **k: (32, math.inf))
    cfg = _tiny(tconfigs, str(tmp_path))
    cfg.mcmc.auto_particles, cfg.mcmc.n_iters = 1.0, 6
    _, rep = run_experiment(cfg, verbose=True, device="cpu")
    assert rep["auto_particles_sd"] is None and rep["n_particles"] == 32
    out = capsys.readouterr().out
    assert "WARNING: target missed" in out
    printed = _last_json(out)
    assert printed["auto_particles_sd"] is None
    json.dumps(rep, allow_nan=False, default=float)


def test_forecast_rejected_without_trajectories(tmp_path):
    cfg = _tiny(tconfigs, str(tmp_path))
    cfg.mcmc.store_trajectories, cfg.forecast_horizon = False, 3
    with pytest.raises(SystemExit, match="store_trajectories"):
        run_experiment(cfg, verbose=False, device="cpu")


def test_main_on_cpu_writes_layout_and_cuda_without_gpu_raises(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    argv = ["--preset", "sir_underreported", "--iters", "12", "--chains", "2",
            "--particles", "16", "--no-plots"]
    assert main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    report = _last_json(out)
    assert report["iters_total"] == 24 and "gelman_rubin_rank" in report
    for f in ("dataset.csv", "run1/thetas.csv", "run2/sampled_trajs_infected.csv"):
        assert (tmp_path / "data" / "sir_underreported" / f).exists(), f
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            main(argv + ["--device", "cuda"])


@pytest.mark.parametrize("algo", ["pmmh", "abc"])
def test_profile_writes_the_programs_spans_beside_the_trace(tmp_path, monkeypatch, capsys, algo):
    """``--profile DIR`` writes the Chrome trace and ``spans.json``: the
    spans, counters and clock anchor, each span on its trace twin within
    2 ms through the anchor."""
    monkeypatch.chdir(tmp_path)
    prof = tmp_path / "prof"
    if algo == "pmmh":
        assert main(["--preset", "sir_underreported", "--iters", "3", "--chains", "2",
                     "--particles", "8", "--no-plots", "--profile", str(prof),
                     "--device", "cpu"]) == 0
    else:
        cfg = PRESETS["sir_abc"]()
        cfg.abc.n_samples, cfg.abc.threshold, cfg.abc.batch_size = 4, 400.0, 128
        cfg.make_plots, cfg.profile_dir = False, str(prof)
        run_experiment(cfg, verbose=False, device="cpu")
    with open(prof / "spans.json") as f:
        doc = json.load(f)
    with open(prof / f"{algo}_trace.json") as f:
        trace = json.load(f)
    (w0, p0), (w1, p1) = doc["anchor"]
    assert doc["fields"] == ["name", "start_ns", "end_ns", "parent", "id"]
    names = [s[0] for s in doc["spans"]]
    twins = sorted(trace["baseTimeNanoseconds"] + float(e["ts"]) * 1e3
                   for e in trace["traceEvents"]
                   if e.get("cat") == "user_annotation" and e.get("name") == f"{algo}_call")
    calls = [w0 + (s[1] - p0) * (w1 - w0) / (p1 - p0) for s in doc["spans"]
             if s[0] == f"{algo}_call"]
    assert len(calls) == len(twins) == 1 and abs(calls[0] - twins[0]) <= 2e6
    if algo == "pmmh":
        assert [s[4] for s in doc["spans"] if s[0] == "pmmh_row"] == [1, 2]
        assert names.count("pf_weight") == 3 * 14 and doc["counters"] == {}
    else:
        assert doc["counters"]["abc.batches"] == names.count("abc_batch_launch") >= 1
        assert doc["counters"]["abc.host_copies"] >= 3


def test_chain_result_slices_every_leaf():
    from epitpu_torch.cli import chain_result

    y = torch.from_numpy(np.loadtxt(os.path.join(DATA, "dataset.csv"), delimiter=",")
                         .astype(np.float32))
    res = particle_mcmc_chains(sir_model(), get_observation_model("binomial"), y,
                               [2.0, 1.0], 0.05, seed=2, n_chains=3, n_iters=4,
                               n_particles=16, steps_per_unit=5, adaptive=True, adapt_start=1)
    one = chain_result(res, 1)
    assert one.thetas.shape == (1, 4, 2) and one.sampled_trajs.shape == (1, 4, 15, 3)
    assert torch.equal(one.final_state.welford.m2, res.final_state.welford.m2[1:2])
    assert torch.equal(one.final_state.step, res.final_state.step[1:2])
    for f in dataclasses.fields(one.final_state):
        v = getattr(one.final_state, f.name)
        if isinstance(v, torch.Tensor):
            assert v.shape[0] == 1, f.name
