"""The tau-leap kernel for any compartment model, on the CPU: the rate trace
(``epitpu_torch/ops/rate_trace.py``) against each model's own ``rate_fn``,
the generated C++ functor compiled by the host's g++ against ``rate_fn`` and
the twin's update, the routes of ``tauleap_cuda.route``, the generated
build's text and C signature; a user SIRS model end to end against epitpu
(``tests/test_models.py:111-191``), ``advance`` over any ``t_span``; and
the entry points and fields epitpu has that the port lacked
(``systematic_resample_scatter``, ``particle_mcmc``,
``terminal_compartments``, the subpackages' exports).  The kernel itself
runs only on a card: its test is marked ``cuda`` and skips here."""
import concurrent.futures
import ctypes
import dataclasses
import importlib
import os
import shutil
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import epitpu.models as jmodels
from epitpu.models import base as jbase
from epitpu.sim import advance as jadvance
from epitpu_torch.abc import abc_rejection
from epitpu_torch.io import dataset_from_csv
from epitpu_torch.mcmc import particle_mcmc, particle_mcmc_chains
from epitpu_torch.models import base as tbase
from epitpu_torch.models import seir_model, sir_model, sir_subgroups_model
from epitpu_torch.observe import get_observation_model
from epitpu_torch.ops import _build, rate_trace, tauleap_cuda
from epitpu_torch.rng import PhiloxStream
from epitpu_torch.sim import advance, exact_advance, simulate, substep
from epitpu_torch.smc import (get_resampler, particle_filter, systematic_resample,
                              systematic_resample_scatter)

torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(__file__), "..", "data", "sir_underreported")

# the user SIRS model of tests/test_models.py:126-152, one table for both packages
SIRS = dict(name="sirs", compartments=("s", "i", "r"),
            stoich=[[-1, 1, 0], [0, -1, 1], [1, 0, -1]], source=[0, 1, 2], theta_dim=3,
            theta_names=("beta", "gamma", "omega"), terminal_compartments=(1,))
SIRS_THETA = np.array([2.0, 1.0, 0.3], np.float32)


def _sirs_rates_torch(x, theta):
    beta, gamma, omega = theta[..., 0], theta[..., 1], theta[..., 2]
    s, i, r = x.unbind(-1)
    n = s + i + r
    return torch.stack([beta * s * i / torch.clamp(n, min=1.0), gamma * i, omega * r], dim=-1)


def _sirs_rates_jax(x, theta):
    beta, gamma, omega = theta[..., 0], theta[..., 1], theta[..., 2]
    s, i, r = x[..., 0], x[..., 1], x[..., 2]
    n = s + i + r
    return jnp.stack([beta * s * i / jnp.maximum(n, 1.0), gamma * i, omega * r], axis=-1)


def _sirs_init(generator, shape, n_population=500.0, mu=20.0):
    rate = torch.full(tuple(shape), float(mu), dtype=torch.float32, device=generator.device)
    i0 = torch.poisson(rate, generator=generator)
    return torch.stack([float(n_population) - i0, i0, torch.zeros_like(i0)], dim=-1)


def sirs_model():
    return tbase.make_model(rate_fn=_sirs_rates_torch, init_fn=_sirs_init, **SIRS)


def _jsirs_model():
    return jbase.make_model(rate_fn=_sirs_rates_jax, **SIRS)


def _sis():
    return tbase.make_model("sis", ("s", "i"), [[-1, 1], [1, -1]], [0, 1],
                            lambda x, th: x * th, 2, ("beta", "gamma"))


def _competing():
    """tests/test_torch_tauleap.py:193: I leaves by recovery or death."""

    def rates(x, theta):
        n = x.sum(-1)
        return torch.stack([theta[..., 0] * x[..., 0] * x[..., 1] / n,
                            theta[..., 1] * x[..., 1], theta[..., 2] * x[..., 1]], -1)

    return tbase.make_model("sird", ("s", "i", "r", "d"),
                            [[-1, 1, 0, 0], [0, -1, 1, 0], [0, -1, 0, 1]],
                            [0, 1, 1], rates, 3, ("beta", "gamma", "delta"))


def _sir_exp():
    """SIR whose recovery rate is exp(log gamma) * i: a transcendental."""

    def rates(x, theta):
        n = torch.sum(x, dim=-1)
        return torch.stack([theta[..., 0] * x[..., 0] * x[..., 1] / n,
                            torch.exp(theta[..., 1]) * x[..., 1]], -1)

    return tbase.make_model("sir_exp", ("s", "i", "r"), [[-1, 1, 0], [0, -1, 1]], [0, 1],
                            rates, 2, ("beta", "log_gamma"))


MODELS = {
    "sir": sir_model,
    "seir": seir_model,
    "sub2_T": lambda: sir_subgroups_model(2),
    "sub2_F": lambda: sir_subgroups_model(2, reference_dynamics=False),
    "sub3": lambda: sir_subgroups_model(3),
    "sub8": lambda: sir_subgroups_model(8),
    "sub12": lambda: sir_subgroups_model(12),
    "sub20": lambda: sir_subgroups_model(20),
    "sirs": sirs_model,
    "sis": _sis,
}


def _lanes(model, b, seed):
    """Seeded lanes with integer counts and a non-empty first compartment."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 3000, size=(b, model.num_compartments)).astype(np.float32)
    x[:, 0] += 1.0
    th = rng.uniform(0.1, 5.0, size=(b, model.theta_dim)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(th)


# ---- the trace ---------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MODELS))
def test_trace_equals_rate_fn(name):
    model = MODELS[name]()
    prog = rate_trace.trace_rates(model)
    x, th = _lanes(model, 256, 0)
    got = prog.evaluate(x, th)
    want = model.rate_fn(x, th)
    assert got.shape == want.shape == (256, model.num_reactions)
    assert torch.equal(got, want)
    assert len(prog.outputs) == model.num_reactions


@pytest.mark.parametrize("name,want", [
    ("sir", 6), ("seir", 8), ("sirs", 8),
    *[(f"sub{k}_T" if k == 2 else f"sub{k}", 2 * k * k + 5 * k - 1) for k in (2, 3, 8, 12, 20)],
])
def test_operations_count_each_op_once(name, want):
    """The traced program's operations count work that reactions share (the
    population sum) once a lane, as the hand count of chip_smoke's bound:
    SIR 2 adds for N, 3 for beta s i / N, 1 for gamma i; K groups 3K - 1 for
    N, 2K + 1 per infection, K recoveries; SIRS SIR's 6, the clamp of N
    and omega r."""
    assert rate_trace.trace_rates(MODELS[name]()).operations() == want


@pytest.mark.parametrize("rates,op", [
    (lambda x, th: th * x.sum(0, keepdim=True)[..., :2], "sum"),  # over the lanes
    (lambda x, th: torch.sort(x, dim=-1).values[..., :2] * th, "sort"),
])
def test_unsupported_ops_raise_naming_the_op(rates, op):
    model = tbase.make_model("bad", ("s", "i", "r"), [[-1, 1, 0], [0, -1, 1]], [0, 1],
                             rates, 2, ("a", "b"))
    with pytest.raises(NotImplementedError, match=rf"aten op aten\.{op}"):
        rate_trace.trace_rates(model)


# ---- the generated functor, compiled for the host ----------------------------

HARNESS = r"""
extern "C" void rates(const float* x, const float* th, float* out, int lanes, int d) {
  for (int b = 0; b < lanes; ++b) {
    float xs[GeneratedModel::kC];
    for (int c = 0; c < GeneratedModel::kC; ++c) xs[c] = x[b * GeneratedModel::kC + c];
    for (int r = 0; r < GeneratedModel::kR; ++r) {
      float coef[GeneratedModel::kCoef];
      GeneratedModel::load(th + b * d, r, coef);
      out[b * GeneratedModel::kR + r] = GeneratedModel::rate(xs, coef, r);
    }
  }
}
extern "C" void apply(float* x, const float* e, int lanes) {
  for (int b = 0; b < lanes; ++b) {
    float xs[GeneratedModel::kC], es[GeneratedModel::kR];
    for (int c = 0; c < GeneratedModel::kC; ++c) xs[c] = x[b * GeneratedModel::kC + c];
    for (int r = 0; r < GeneratedModel::kR; ++r) es[r] = e[b * GeneratedModel::kR + r];
    GeneratedModel::apply(xs, es);
    for (int c = 0; c < GeneratedModel::kC; ++c) x[b * GeneratedModel::kC + c] = xs[c];
  }
}
extern "C" int source(int r) { return GeneratedModel::src(r); }
"""


def _host_functor(model, tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on PATH to compile the generated functor for the host")
    src = tmp_path / "functor.cpp"
    src.write_text(rate_trace.functor_source(model) + HARNESS)
    lib = tmp_path / "functor.so"
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-shared", "-fPIC", "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def _call_rates(lib, model, x, th):
    x = np.ascontiguousarray(x.numpy())
    th = np.ascontiguousarray(th.numpy())
    out = np.zeros((x.shape[0], model.num_reactions), np.float32)
    lib.rates(x.ctypes.data_as(ctypes.c_void_p), th.ctypes.data_as(ctypes.c_void_p),
              out.ctypes.data_as(ctypes.c_void_p), x.shape[0], model.theta_dim)
    return out


@pytest.mark.parametrize("name", ["sir", "seir", "sub3", "sub20", "sirs"])
def test_generated_functor_on_host_equals_rate_fn_and_update(name, tmp_path):
    model = MODELS[name]()
    lib = _host_functor(model, tmp_path)
    x, th = _lanes(model, 256, 1)
    np.testing.assert_array_equal(_call_rates(lib, model, x, th), model.rate_fn(x, th).numpy())
    assert [lib.source(r) for r in range(model.num_reactions)] == model.source.tolist()
    # apply(): the twin's stoichiometry update for given event counts
    e = torch.from_numpy(np.random.default_rng(2).integers(
        0, 50, size=(256, model.num_reactions)).astype(np.float32))
    want = substep(model, x, th, 0.05, lambda n, p, slot: e).numpy()
    got = np.ascontiguousarray(x.numpy().copy())
    ev = np.ascontiguousarray(e.numpy())
    lib.apply(got.ctypes.data_as(ctypes.c_void_p), ev.ctypes.data_as(ctypes.c_void_p), 256)
    np.testing.assert_array_equal(got, want)


def test_generated_functor_with_exp_holds_to_one_ulp(tmp_path):
    model = _sir_exp()
    lib = _host_functor(model, tmp_path)
    x, th = _lanes(model, 256, 3)
    th[:, 1] = th[:, 1] - 2.5  # log gamma around 0
    got = _call_rates(lib, model, x, th)
    np.testing.assert_array_max_ulp(got, model.rate_fn(x, th).numpy(), maxulp=1)


# ---- routing, the build's text and its C signature ---------------------------

@pytest.mark.parametrize("name,want", [
    ("sir", "hand"), ("seir", "hand"), ("sub2_T", "hand"), ("sub2_F", "hand"),
    ("sub8", "hand"), ("sub9", "generated"), ("sirs", "generated"),
    ("sir_without_spec", "generated"), ("competing", "plain"),
])
def test_route(name, want):
    model = {"sub9": lambda: sir_subgroups_model(9), "competing": _competing,
             "sir_without_spec": lambda: dataclasses.replace(sir_model(), kernel=None),
             }.get(name, MODELS.get(name))()
    assert tauleap_cuda.route(model) == want


FAKE_NVCC = r"""
import os, sys, time
here = os.path.dirname(os.path.abspath(sys.argv[0]))
args = sys.argv[1:]
out, src = args[args.index("-o") + 1], args[-1]
text = open(src).read()
with open(os.path.join(here, f"run-{os.getpid()}"), "w") as f:
    f.write(os.path.abspath(src))
deadline = time.time() + 60
while len([n for n in os.listdir(here) if n.startswith("run-")]) < 2:
    if time.time() > deadline:
        sys.exit("the other build never started")
    time.sleep(0.01)
srcs = {open(os.path.join(here, n)).read() for n in os.listdir(here) if n.startswith("run-")}
if len(srcs) != 2:
    sys.exit(f"two builds compile one source file {srcs}")
if "epi_traj_generated" not in text or open(src).read() != text:
    sys.exit(f"{src} is not the generated source, or changed while it was compiled")
with open(out, "w") as f:
    f.write(text)
"""


def test_build_generated_from_two_threads_at_once(tmp_path, monkeypatch):
    """Two builds of one functor at once (two ranks of a sharded run): each
    nvcc run reads a source of its own, and the build leaves the library and
    ``<hash>.cu`` in place, nothing else."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\n{FAKE_NVCC}")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "GENERATED_INFO", {})
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    functor = rate_trace.functor_source(sirs_model())
    start = threading.Barrier(2)

    def build():
        start.wait()
        return _build.build_generated(functor)

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        paths = [f.result() for f in [pool.submit(build) for _ in range(2)]]
    out = _build.generated_path(functor)
    assert paths == [out, out]
    assert len([n for n in os.listdir(bin_dir) if n.startswith("run-")]) == 2
    src = out.with_name(out.name[len("libepitpu_gen-"):-len(".so")] + ".cu")
    assert out.read_text() == src.read_text() == _build.generated_source(functor)
    assert sorted(os.listdir(tmp_path / "build")) == sorted([out.name, src.name])
    assert _build.GENERATED_INFO[str(out)]["path"] == str(out)


def test_generated_text_is_stable():
    a = _build.generated_path(rate_trace.functor_source(sir_model()))
    b = _build.generated_path(rate_trace.functor_source(dataclasses.replace(sir_model(),
                                                                            kernel=None)))
    assert a == b and a.parent == _build.BUILD_DIR and a.name.startswith("libepitpu_gen-")
    assert a != _build.generated_path(rate_trace.functor_source(sirs_model()))


@pytest.mark.parametrize("k", [12, 20])
def test_launch_geometry_past_a_warp(k):
    """Past 16 reactions a lane keeps one warp (its R threads, at most 32,
    the warp's other threads owning no lane), and past 32 thread t draws
    reactions t, t + 32, ...: every (lane, reaction) exactly once."""
    r = 2 * k
    for lanes in (1, 31, 33, 513, 32768):
        g, t, nb = tauleap_cuda.launch_geometry(r, lanes)
        assert g == min(32, r) and (nb - 1) * t < lanes * 32 <= nb * t
        tid = np.arange(nb * t, dtype=np.int64)
        lane, slot = tid // 32, tid % 32
        hits = np.zeros(lanes * r, np.int64)
        for p in range(-(-r // g)):
            q = slot + p * g
            live = (lane < lanes) & (slot < g) & (q < r)
            hits += np.bincount(lane[live] * r + q[live], minlength=lanes * r)
        assert (hits == 1).all()


def test_ablation_anchors_are_found():
    """k4_ablation.py edits copies of the kernel sources at anchor texts;
    every variant's edits must still apply."""
    import k4_ablation

    for name in k4_ablation.EDITS:
        srcs = k4_ablation.variant_sources(name)
        assert set(srcs) == set(_build.SOURCES)


# ---- SIRS end to end against epitpu (tests/test_models.py:153-191) -----------

def test_sirs_advance_matches_exact_ssa_and_epitpu():
    tm, jm = sirs_model(), _jsirs_model()
    n_runs = 192
    x0 = np.broadcast_to(np.array([480.0, 20.0, 0.0], np.float32), (n_runs, 3)).copy()
    xt = advance(tm, torch.from_numpy(x0), torch.from_numpy(SIRS_THETA), PhiloxStream(0),
                 steps_per_unit=40, t_span=3.0).numpy()
    x_exact = exact_advance(tm, torch.Generator().manual_seed(1), torch.from_numpy(x0),
                            torch.from_numpy(SIRS_THETA), 3.0, 20000).numpy()
    x_jax = np.asarray(jadvance(jm, jax.random.PRNGKey(0), jnp.asarray(x0),
                                jnp.asarray(SIRS_THETA), 3.0, 40))
    assert np.abs(xt.mean(0) - x_exact.mean(0)).max() < 15.0
    assert np.abs(xt.mean(0) - x_jax.mean(0)).max() < 15.0
    assert xt[:, 0].mean() > 10.0  # susceptibles replenished
    np.testing.assert_array_equal(xt.sum(-1), 500.0)


def _sirs_data():
    lat = simulate(sirs_model(), torch.tensor([480.0, 20.0, 0.0]),
                   torch.from_numpy(SIRS_THETA), PhiloxStream(2), 7, 20).numpy()
    rng = np.random.default_rng(5)
    return torch.from_numpy(rng.binomial(np.round(lat).astype(int), 0.3).astype(np.float32))


def test_sirs_filter_and_pmmh_run():
    tm, y = sirs_model(), _sirs_data()
    obs = get_observation_model("binomial")
    res = particle_filter(tm, obs, y, torch.from_numpy(SIRS_THETA)[None], 0.3, PhiloxStream(3),
                          torch.Generator().manual_seed(3), n_particles=128, n_population=500.0,
                          mu=20.0, steps_per_unit=10)
    assert np.isfinite(float(res.log_likelihood[0]))
    r = particle_mcmc(tm, obs, 4, y, SIRS_THETA, 0.05, n_iters=30, obs_param=0.3,
                      n_particles=64, n_population=500.0, mu=20.0, steps_per_unit=5,
                      n_init_attempts=2, device="cpu")
    th = r.thetas.numpy()
    assert th.shape == (30, 3) and np.isfinite(th).all()


def test_sirs_abc_runs_on_the_twin():
    tm = sirs_model()
    lat = simulate(tm, torch.tensor([480.0, 20.0, 0.0]), torch.from_numpy(SIRS_THETA),
                   PhiloxStream(6), 7, 20)
    priors = {"beta": (0.0, 5.0), "gamma": (0.0, 5.0), "omega": (0.0, 1.0)}
    res = abc_rejection(tm, 7, lat, 8, 60.0, priors, batch_size=256, steps_per_unit=10,
                        device="cpu")
    assert res.backend == "cpu"
    assert res.trajectories.shape == (8, 8, 3)
    assert all(v.shape == (8,) and np.isfinite(v).all() for v in res.posterior.values())


# ---- advance over any span; nothing moves at one unit ------------------------

def test_advance_t_span():
    m = sir_model()
    x = torch.from_numpy(np.broadcast_to(np.array([4800.0, 20.0, 0.0], np.float32),
                                         (64, 3)).copy())
    th = torch.tensor([2.0, 1.0])
    one = advance(m, x, th, PhiloxStream(9))
    assert torch.equal(one, advance(m, x, th, PhiloxStream(9), t_span=1.0))
    assert torch.equal(one, simulate(m, x, th, PhiloxStream(9), 1)[-1])
    assert torch.equal(one, tauleap_cuda.simulate_lanes(m, x, th.expand(64, 2).contiguous(),
                                                        9, 0, 1, 20, True))
    # 3 units of 40 substeps: the substeps of a 3-unit trajectory
    three = advance(m, x, th, PhiloxStream(9), steps_per_unit=40, t_span=3.0)
    assert torch.equal(three, simulate(m, x, th, PhiloxStream(9), 3, 40)[-1])
    half = advance(m, x, th, PhiloxStream(9), t_span=0.5)
    assert torch.equal(half, tauleap_cuda.simulate_lanes_reference(
        m, x, th.expand(64, 2), 9, 0, 1, 10, True, dt=0.05))
    with pytest.raises(ValueError, match="no substep"):
        advance(m, x, th, PhiloxStream(9), t_span=0.01)


# ---- systematic_scatter, particle_mcmc, terminal_compartments, exports -------

def test_scatter_resampling_equals_systematic():
    g = torch.Generator().manual_seed(0)
    for n in (16, 100, 300):
        logw = torch.randn(64, n, generator=g) * 2.0
        u = torch.rand(64, 1, generator=g)
        want, dw = systematic_resample(u, logw)
        got, dg = systematic_resample_scatter(u, logw)
        assert torch.equal(got, want) and torch.equal(dg, dw)
    logw[3] = -float("inf")
    got, dg = get_resampler("systematic_scatter")(u, logw)
    assert bool(dg[3]) and torch.equal(got[3], torch.arange(300))
    with pytest.raises(ValueError, match="systematic_scatter"):
        get_resampler("bogus")


def _chains(resampling, **kw):
    y = dataset_from_csv(os.path.join(DATA, "dataset.csv"), device="cpu")
    return particle_mcmc_chains(sir_model(), get_observation_model("binomial"), y, [2.0, 1.0],
                                0.05, seed=11, device="cpu", n_chains=3, n_iters=20,
                                n_particles=16, steps_per_unit=4, n_init_attempts=2,
                                resampling=resampling, **kw)


def test_pmmh_with_scatter_resampling_equals_systematic():
    a, b = _chains("systematic"), _chains("systematic_scatter")
    assert torch.equal(a.thetas, b.thetas)
    assert torch.equal(a.log_likelihoods, b.log_likelihoods)
    assert torch.equal(a.sampled_trajs, b.sampled_trajs)


def test_particle_mcmc_is_chain_zero_and_segments_concatenate():
    """tests/test_pmmh.py:379-390 on the port's one-chain entry point."""
    y = dataset_from_csv(os.path.join(DATA, "dataset.csv"), device="cpu")
    obs = get_observation_model("binomial")
    kw = dict(n_iters=40, n_particles=32, steps_per_unit=4, n_init_attempts=2,
              target_acceptance=0.3, device="cpu")
    full = particle_mcmc(sir_model(), obs, 12, y, [2.0, 1.0], 0.05, **kw)
    chains = particle_mcmc_chains(sir_model(), obs, y, [2.0, 1.0], 0.05, seed=12,
                                  n_chains=1, **kw)
    assert full.thetas.shape == (40, 2) and full.sampled_trajs.shape == (40, 15, 3)
    assert torch.equal(full.thetas, chains.thetas[0])
    assert torch.equal(full.log_likelihoods, chains.log_likelihoods[0])
    assert torch.equal(full.sampled_trajs, chains.sampled_trajs[0])
    assert full.acceptance_rate() == chains.acceptance_rate()[0]
    seg1 = particle_mcmc(sir_model(), obs, 12, y, [2.0, 1.0], 0.05, segment_len=20, **kw)
    seg2 = particle_mcmc(sir_model(), obs, 12, y, [2.0, 1.0], 0.05,
                         init_state=seg1.final_state, segment_len=20, **kw)
    assert int(seg1.final_state.step) == 19
    assert torch.equal(torch.cat([seg1.thetas, seg2.thetas]), full.thetas)
    with pytest.raises(ValueError, match="chain-batched"):
        particle_mcmc(sir_model(), obs, 12, y, [2.0, 1.0], 0.05, pooled_adaptation=True, **kw)


@pytest.mark.parametrize("name,kw", [("sir_model", {}), ("seir_model", {}),
                                     ("sir_subgroups_model", {"k": 3})])
def test_terminal_compartments_match_epitpu(name, kw):
    import epitpu_torch.models as tmodels

    want = getattr(jmodels, name)(**kw).terminal_compartments
    assert getattr(tmodels, name)(**kw).terminal_compartments == want
    assert sirs_model().terminal_compartments == _jsirs_model().terminal_compartments == (1,)


# names epitpu exports that the port leaves out on purpose (ROADMAP Queue 1):
# TPU dispatch switches that mean nothing on the card
OMITTED = {"ops": {"pallas_advance_available", "pallas_simulate", "pallas_simulate_supported"}}
SUBPACKAGES = ("abc", "cli", "diag", "dist", "io", "mcmc", "models", "observe", "ode", "ops",
               "sim", "smc", "viz")


@pytest.mark.parametrize("pkg", SUBPACKAGES)
def test_exports_cover_epitpu(pkg):
    ref = importlib.import_module(f"epitpu.{pkg}")
    port = importlib.import_module(f"epitpu_torch.{pkg}")
    missing = set(ref.__all__) - set(getattr(port, "__all__", ()))
    assert missing == OMITTED.get(pkg, set())
    assert all(hasattr(port, n) for n in getattr(port, "__all__", ()))


# ---- on the card -------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sub12", "sub20", "sirs"])
def test_generated_kernel_matches_twin_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    m = MODELS[name]()
    for b in (1, 31, 33, 513, 4096):
        x0, th = (a.cuda() for a in _lanes(m, b, b))
        before = _build.LAUNCHES["generated"]
        k = tauleap_cuda.simulate_lanes(m, x0, th, 3, 1, 2, 1)
        p = tauleap_cuda.simulate_lanes_reference(m, x0, th, 3, 1, 2, 1)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["generated"] == before + 1
        assert float((k == p).all(-1).all(-1).float().mean()) >= 0.999
