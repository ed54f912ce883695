"""epitpu_torch samplers, tau-leap simulation and the K4 kernel's plain twin
against epitpu (the XLA path and the Pallas kernel's jnp helpers), on the
same numpy inputs.  The CUDA kernel itself runs only on a card: its test is
marked ``cuda`` and skips here."""
import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epitpu.models import base as jbase
from epitpu.models import sir_model as jsir_model
from epitpu.ops import tauleap_pallas as jpallas
from epitpu.sim import samplers as jsamplers
from epitpu.sim import simulate as jsimulate
from epitpu_torch.io import dataset_from_csv
from epitpu_torch.mcmc import particle_mcmc_chains
from epitpu_torch.models import base as tbase
from epitpu_torch.models import seir_model, sir_model, sir_subgroups_model
from epitpu_torch.observe import get_observation_model
from epitpu_torch.ops import _build, tauleap_cuda
from epitpu_torch.rng import PhiloxStream
from epitpu_torch.sim import advance, binomial_from_draws, simulate
from epitpu_torch.sim import tauleap as ttauleap
from epitpu_torch.sim.samplers import (SMALL_K, _binomial_small_exact, exact_binomial,
                                       fast_binomial)

torch.set_num_threads(1)


def _draw_inputs(seed, size=200_000):
    rng = np.random.default_rng(seed)
    n = rng.integers(0, 5001, size=size).astype(np.float32)
    # hazards spanning both regimes, the p > 1/2 flip and the endpoints
    p = np.concatenate([
        10 ** rng.uniform(-5, 0, size=size - 4), [0.0, 1.0, 0.5, 0.75],
    ]).astype(np.float32)
    u = rng.uniform(0, 1, size=size).astype(np.float32)
    z = rng.standard_normal(size=size).astype(np.float32)
    return u, z, n, p


def _jax_law(small, large, u, z, n, p):
    """The composition of epitpu.sim.samplers.fast_binomial after its draws."""
    n, p, u, z = map(jnp.asarray, (n, p, u, z))
    p = jnp.clip(p, 0.0, 1.0)
    flip = p > 0.5
    p_eff = jnp.where(flip, 1.0 - p, p)
    x = jnp.where(n * p_eff < jsamplers.SMALL_MEAN_MAX,
                  small(u, n, p_eff), large(z, n, p_eff))
    x = jnp.where(flip, n - x, x)
    x = jnp.where(p == 0.0, 0.0, x)
    return np.asarray(jnp.where(p == 1.0, n, x))


@pytest.mark.parametrize("helpers", [
    (jsamplers._binomial_small_exact, jsamplers._binomial_normal_cf),
    (jpallas._binomial_small_exact, jpallas._binomial_normal_cf),
], ids=["xla_samplers", "pallas_helpers"])
def test_binomial_from_draws_matches_epitpu(helpers):
    u, z, n, p = _draw_inputs(0)
    ref = _jax_law(*helpers, u, z, n, p)
    got = binomial_from_draws(*(torch.from_numpy(a) for a in (u, z, n, p))).numpy()
    same = np.mean(got == ref)
    assert same >= 0.999, same
    assert np.max(np.abs(got - ref)) <= 1.0
    assert got[-4] == 0 and got[-3] == n[-3]


def test_fast_and_exact_binomial_moments():
    n = torch.full((20_000, 2), 400.0)
    p = torch.tensor([[0.01, 0.3]]).expand(20_000, 2)
    fast = fast_binomial(3, 0, 0, n, p)
    exact = exact_binomial(torch.Generator().manual_seed(0), n, p)
    for x in (fast, exact):
        torch.testing.assert_close(x.mean(0), torch.tensor([4.0, 120.0]), rtol=0.03, atol=0.1)
        torch.testing.assert_close(x.var(0), torch.tensor([3.96, 84.0]), rtol=0.08, atol=0.2)


def _cloud(b):
    return np.broadcast_to(np.array([4800.0, 20.0, 0.0], np.float32), (b, 3)).copy()


def test_reference_matches_epitpu_simulate_moments():
    """The plain twin against epitpu's XLA simulate, the path that validates
    the Pallas kernel off TPU (tests/test_ops.py:60-80 tolerances)."""
    b = 2048
    x0 = _cloud(b)
    theta = np.broadcast_to(np.array([2.0, 1.0], np.float32), (b, 2)).copy()
    out_t = tauleap_cuda.simulate_lanes(sir_model(), torch.from_numpy(x0),
                                        torch.from_numpy(theta), 1, 0, 8, 20).numpy()
    out_x = np.swapaxes(np.asarray(jsimulate(
        jsir_model(), jax.random.PRNGKey(0), jnp.asarray(x0), jnp.array([2.0, 1.0]), 8, 20
    )), 0, 1)
    assert out_t.shape == out_x.shape == (b, 9, 3)
    np.testing.assert_array_equal(out_t.sum(-1), 4820.0)
    np.testing.assert_array_equal(out_t, np.round(out_t))
    np.testing.assert_array_equal(out_t[:, 0], x0)
    for t in (2, 5, 8):
        np.testing.assert_allclose(out_t[:, t].mean(0), out_x[:, t].mean(0), rtol=0.06, atol=3.0)
        np.testing.assert_allclose(out_t[:, t].std(0), out_x[:, t].std(0), rtol=0.3, atol=3.0)


def test_reference_per_lane_theta():
    """A (0, 0) lane stays frozen while (2, 1) lanes evolve in one call."""
    b = 256
    theta = torch.tensor([2.0, 1.0]).repeat(b, 1)
    theta[::2] = 0.0
    out = tauleap_cuda.simulate_lanes(sir_model(), torch.from_numpy(_cloud(b)),
                                      theta, 9, 0, 5, 10).numpy()
    frozen = out[::2]
    np.testing.assert_array_equal(frozen, np.broadcast_to(frozen[:, :1], frozen.shape))
    moving = out[1::2]
    assert np.any(moving[:, -1] != moving[:, 0])
    assert np.all(np.diff(moving[..., 0], axis=1) <= 0)


def test_reference_deterministic_per_seed_and_offset():
    args = (sir_model(), torch.from_numpy(_cloud(64)), torch.tensor([[2.0, 1.0]] * 64))
    a = tauleap_cuda.simulate_lanes(*args, 5, 0, 4, 5)
    assert torch.equal(a, tauleap_cuda.simulate_lanes(*args, 5, 0, 4, 5))
    assert not torch.equal(a, tauleap_cuda.simulate_lanes(*args, 6, 0, 4, 5))
    assert not torch.equal(a, tauleap_cuda.simulate_lanes(*args, 5, 1, 4, 5))


def test_cpu_tensors_never_launch_the_kernel():
    before = dict(_build.LAUNCHES)
    m = sir_model()
    x = torch.from_numpy(_cloud(32)).reshape(4, 8, 3)
    advance(m, x, torch.tensor([[2.0, 1.0]] * 4)[:, None, :], PhiloxStream(0))
    tauleap_cuda.simulate_lanes(m, x.reshape(32, 3), torch.ones(32, 2), 0, 0, 2, 3)
    assert _build.LAUNCHES == before


def test_other_devices_raise_instead_of_falling_back():
    m = sir_model()
    x = torch.empty(8, 3, device="meta")
    with pytest.raises(ValueError, match="no tau-leap kernel"):
        tauleap_cuda.simulate_lanes(m, x, torch.empty(8, 2, device="meta"), 0, 0, 1, 20)
    with pytest.raises(ValueError):
        tauleap_cuda.simulate_lanes(m, torch.zeros(8, 2), torch.zeros(8, 2), 0, 0, 1, 20)
    with pytest.raises(TypeError):
        tauleap_cuda.simulate_lanes(m, torch.zeros(8, 3, dtype=torch.float64),
                                    torch.zeros(8, 2), 0, 0, 1, 20)


def test_nvcc_command_targets_hopper_without_fast_math():
    cmd = _build.nvcc_command("nvcc", [_build.CSRC / "tauleap.cu"], "/x/lib.so")
    joined = " ".join(cmd)
    assert "arch=compute_90a,code=sm_90a" in joined
    assert "--use_fast_math" not in joined and "-use_fast_math" not in joined
    assert "-shared" in cmd and "--fmad=false" in cmd
    assert _build.library_path().parent == _build.BUILD_DIR
    assert (_build.CSRC / "tauleap.cu").exists()


def test_advance_and_simulate_layouts():
    m = sir_model()
    x = torch.from_numpy(_cloud(24)).reshape(3, 8, 3)
    theta = torch.tensor([[2.0, 1.0], [0.0, 0.0], [3.0, 0.5]])
    s = PhiloxStream(4)
    x1 = advance(m, x, theta[:, None, :], s)
    assert x1.shape == (3, 8, 3) and s.offset == 1
    torch.testing.assert_close(x1[1], x[1])  # zero rates: frozen chain
    traj = simulate(m, x, theta[:, None, :], s, 3)
    assert traj.shape == (4, 3, 8, 3)
    torch.testing.assert_close(traj[0], x)
    ex = simulate(m, x, theta[:, None, :], s, 2, sampler="exact",
                  generator=torch.Generator().manual_seed(0))
    assert ex.shape == (3, 3, 8, 3) and torch.all(ex.sum(-1) == 4820)
    with pytest.raises(ValueError):
        advance(m, x, theta[:, None, :], s, sampler="bogus")


def _competing(module, lib):
    """I leaves by recovery or death: two reactions share source I."""

    def rates(x, theta):
        n = x.sum(-1)
        return lib.stack([theta[..., 0] * x[..., 0] * x[..., 1] / n,
                          theta[..., 1] * x[..., 1], theta[..., 2] * x[..., 1]], -1)

    return module.make_model("sird", ("s", "i", "r", "d"),
                             [[-1, 1, 0, 0], [0, -1, 1, 0], [0, -1, 0, 1]],
                             [0, 1, 1], rates, 3, ("beta", "gamma", "delta"))


def test_competing_hazards_match_epitpu_moments():
    tm = _competing(tbase, torch)
    jm = _competing(jbase, jnp)
    assert not tm.sources_unique
    b = 2048
    x0 = np.broadcast_to(np.array([4800.0, 20.0, 0.0, 0.0], np.float32), (b, 4)).copy()
    th = np.array([2.0, 0.8, 0.2], np.float32)
    out_t = simulate(tm, torch.from_numpy(x0), torch.from_numpy(th), PhiloxStream(2), 6, 10).numpy()
    out_x = np.asarray(jsimulate(jm, jax.random.PRNGKey(1), jnp.asarray(x0), jnp.asarray(th), 6, 10))
    np.testing.assert_array_equal(out_t.sum(-1), 4820.0)
    for t in (2, 4, 6):
        np.testing.assert_allclose(out_t[t].mean(0), out_x[t].mean(0), rtol=0.06, atol=3.0)
        np.testing.assert_allclose(out_t[t].std(0), out_x[t].std(0), rtol=0.3, atol=3.0)


# ---- the kernel's design, checked through its twin and its launch shape ----

def _small_draws(seed, size=100_000):
    """(u, n, p) for the small regime: means log-uniform up to 8, with
    slices at n = 0, p = 0, p near 1e-7, means just below 8, u = 0 and
    u at its largest value."""
    rng = np.random.default_rng(seed)
    n = rng.integers(1, 5001, size=size).astype(np.float32)
    lam = 10 ** rng.uniform(-6, np.log10(8.0), size=size)
    p = (lam / n).astype(np.float32)
    u = rng.uniform(0, 1, size=size).astype(np.float32)
    q = size // 20
    n[:q] = 0.0
    p[q:2 * q] = 0.0
    p[2 * q:3 * q] = (1e-7 * rng.uniform(0.5, 2.0, q)).astype(np.float32)
    p[3 * q:4 * q] = (8.0 / n[3 * q:4 * q] * (1 - 1e-6 * rng.uniform(0.1, 1.0, q))).astype(
        np.float32)
    u[4 * q:5 * q] = 0.0
    u[5 * q:6 * q] = np.float32(1.0) - np.float32(2 ** -23)
    return u, n, np.minimum(p, np.float32(0.5))


def _early_exit(u, n, pmf, ratio):
    """csrc/tauleap.cu's small-regime loop on scalars: it stops at the first
    term with u < cdf.  Returns (x, terms evaluated)."""
    cdf = pmf
    x = np.float32(0.0)
    terms = 0
    for k in range(SMALL_K - 1):
        if not u >= cdf:
            break
        x += np.float32(1.0)
        terms += 1
        pmf = max(pmf * (n - np.float32(k)) / (np.float32(k) + np.float32(1.0)) * ratio,
                  np.float32(0.0))
        cdf = cdf + pmf
    if u >= cdf:
        x += np.float32(1.0)
    return min(x, n), terms


def test_early_exit_cdf_equals_the_full_loop():
    """Stopping the inverse-CDF loop at the first u < cdf gives the x of all
    SMALL_K terms (cdf never decreases), for 10^5 draws; ``count_terms``
    counts the terms the early exit evaluates."""
    u, n, p = _small_draws(0)
    ut, nt, pt = map(torch.from_numpy, (u, n, p))
    want = _binomial_small_exact(ut, nt, pt).numpy()
    # the loop's first term and ratio, in the twin's own operations
    ps = torch.clamp(pt, 0.0, 1.0 - 1e-7)
    ratio = (ps / (1.0 - ps)).numpy()
    pmf = torch.exp(nt * torch.log1p(-ps)).numpy()
    got, terms = zip(*(_early_exit(*a) for a in zip(u, n, pmf, ratio)))
    np.testing.assert_array_equal(np.asarray(got, np.float32), want)
    x, counted = _binomial_small_exact(ut, nt, pt, count_terms=True)
    assert torch.equal(x, torch.from_numpy(want))
    np.testing.assert_array_equal(counted.numpy(), np.asarray(terms, np.float32))
    work = {}
    binomial_from_draws(ut, torch.zeros_like(ut), nt, pt, work)
    assert work == {"draws": len(u), "small": len(u), "terms": sum(terms)}
    assert 0 < np.mean(terms) < 8 and max(terms) == SMALL_K - 1


KERNEL_MODELS = {
    "sir": sir_model,
    "seir": seir_model,
    "sir_subgroups_3": lambda: sir_subgroups_model(3),
    "sir_subgroups_2_textbook": lambda: sir_subgroups_model(2, reference_dynamics=False),
}


def _lane_inputs(model, b, seed):
    """Lanes across an epidemic: per group 20-1,500 infected of 4,820 (SEIR:
    an exposed share too); theta around the presets' truths."""
    rng = np.random.default_rng(seed)
    groups = model.kernel.k if model.kernel.family == "sir_subgroups" else 1
    i0 = rng.integers(20, 1500, size=(b, groups)).astype(np.float32)
    if model.kernel.family == "seir":
        x0 = np.stack([4820 - 2 * i0[:, 0], i0[:, 0], i0[:, 0], 0 * i0[:, 0]], -1)
        th = rng.uniform([3.0, 0.7, 0.7], [5.0, 1.3, 1.3], size=(b, 3))
    else:
        x0 = np.stack([4820 - i0, i0, 0 * i0], -1).reshape(b, -1)
        th = rng.uniform(0.5, 3.0, size=(b, model.theta_dim))
    return (torch.from_numpy(x0.astype(np.float32)),
            torch.from_numpy(th.astype(np.float32)))


@pytest.mark.parametrize("name", sorted(KERNEL_MODELS))
def test_twin_final_only_is_the_last_row(name):
    model = KERNEL_MODELS[name]()
    x0, th = _lane_inputs(model, 40, 1)
    full = tauleap_cuda.simulate_lanes_reference(model, x0, th, 5, 2, 3, 4)
    last = tauleap_cuda.simulate_lanes_reference(model, x0, th, 5, 2, 3, 4, final_only=True)
    assert last.shape == (40, model.num_compartments)
    assert torch.equal(last, full[:, -1])
    assert torch.equal(tauleap_cuda.simulate_lanes(model, x0, th, 5, 2, 3, 4, True), last)


@pytest.mark.parametrize("name", sorted(KERNEL_MODELS))
@pytest.mark.parametrize("final_only", [False, True])
def test_twin_theta_per_chain_equals_expanded_theta(name, final_only):
    """``lanes_per_theta = N`` with one theta row per chain: the call with
    every row repeated N times, bit for bit."""
    model = KERNEL_MODELS[name]()
    x0, th = _lane_inputs(model, 48, 2)
    chain_th = th[::8].contiguous()  # 6 chains x 8 lanes
    expanded = chain_th.repeat_interleave(8, dim=0)
    a = tauleap_cuda.simulate_lanes(model, x0, chain_th, 7, 1, 2, 5, final_only, 8)
    b = tauleap_cuda.simulate_lanes(model, x0, expanded, 7, 1, 2, 5, final_only)
    assert torch.equal(a, b)


def test_lanes_per_theta_checks():
    m = sir_model()
    x0, th = _lane_inputs(m, 12, 3)
    with pytest.raises(ValueError, match="does not divide"):
        tauleap_cuda.simulate_lanes(m, x0, th[:3], 0, 0, 1, 2, lanes_per_theta=5)
    with pytest.raises(ValueError, match="theta must be"):
        tauleap_cuda.simulate_lanes(m, x0, th[:4], 0, 0, 1, 2, lanes_per_theta=4)
    with pytest.raises(ValueError, match="does not divide"):
        tauleap_cuda.simulate_lanes(m, x0, th, 0, 0, 1, 2, lanes_per_theta=0)


@pytest.mark.parametrize("theta_shape,rows,per_row", [
    ((3, 1, 2), 3, 8),  # one row per chain: read as it is
    ((2,), 1, 24),  # one theta for every lane
    ((1, 1, 2), 1, 24),
    ((3, 8, 2), 24, 1),  # one row per lane
    ((1, 8, 2), 24, 1),  # broadcast over the leading dim: expanded
])
def test_lanes_reads_one_theta_row_per_chain(theta_shape, rows, per_row):
    x = torch.from_numpy(_cloud(24)).reshape(3, 8, 3)
    th = torch.arange(int(np.prod(theta_shape)), dtype=torch.float32).reshape(theta_shape)
    xb, th_rows, lpt, lead = ttauleap._lanes(x, th)
    assert xb.shape == (24, 3) and lead == (3, 8)
    assert th_rows.shape == (rows, 2) and lpt == per_row
    want = th.expand(3, 8, 2).reshape(24, 2)
    assert torch.equal(th_rows.repeat_interleave(lpt, dim=0), want)


def _power_of_two_geometry(reactions, lanes, sms=132):
    """The launch shape of lanes in groups of the next power of two >= R
    threads: the packed map's own shape at every power-of-two R."""
    g = min(1 << (reactions - 1).bit_length(), 32)
    t = next((t for t in (256, 128, 64) if -(-lanes * g // t) >= sms), 32)
    return g, t, max(1, -(-lanes * g // t))


def _thread_map(group, threads, blocks):
    """The kernel's map (csrc/tauleap_kernel.cuh, part (a)) of every launched
    thread: its warp, its lane, its first reaction and whether it owns a
    lane at all (the warp's first 32 // group x group threads)."""
    tid = np.arange(blocks * threads, dtype=np.int64)
    warp, t = tid // 32, tid % 32
    per_warp = 32 // group
    return warp, warp * per_warp + t // group, t % group, t // group < per_warp


@pytest.mark.parametrize("family,k", [("sir", 1), ("seir", 1)]
                         + [("sir_subgroups", k) for k in range(1, 9)]
                         + [("reactions", r) for r in (5, 7)])
def test_launch_geometry_covers_every_lane_once(family, k):
    """Every (lane, reaction) has exactly one thread, a lane's R threads lie
    in one warp, a warp holds floor(32 / R) lanes, the warp's other threads
    own no lane, no block is empty, blocks shrink only while a launch would
    fill fewer blocks than the card has SMs, and a power-of-two R keeps the
    shape of a group of the next power of two."""
    if family == "reactions":
        r = k
    else:
        r = {"sir": sir_model, "seir": seir_model,
             "sir_subgroups": lambda: sir_subgroups_model(k)}[family]().num_reactions
    per_warp = 32 // r
    for lanes in list(range(1, 1001)) + [30, 200, 300, 512, 32768, 65536, 524288]:
        g, t, nb = tauleap_cuda.launch_geometry(r, lanes)
        assert g == r and t in (32, 64, 128, 256)
        warps = -(-lanes // per_warp)
        assert (nb - 1) * t < warps * 32 <= nb * t
        if t > 32:
            assert nb >= 132
        if t < 256:
            assert -(-warps * 32 // (2 * t)) < 132
        if r & (r - 1) == 0:
            assert (g, t, nb) == _power_of_two_geometry(r, lanes)
        warp, lane, slot, owned = _thread_map(g, t, nb)
        live = owned & (lane < lanes)
        counts = np.bincount(lane[live] * r + slot[live], minlength=lanes * r)
        assert counts.shape == (lanes * r,) and (counts == 1).all()
        assert (warp[live] == lane[live] // per_warp).all()
        assert (np.bincount(warp[owned], minlength=nb * t // 32) == per_warp * r).all()
        assert (np.bincount(warp[~owned], minlength=nb * t // 32) == 32 - per_warp * r).all()
    assert tauleap_cuda.launch_geometry(2, 512) == (2, 32, 32)
    assert tauleap_cuda.launch_geometry(2, 32768) == (2, 256, 256)
    assert tauleap_cuda.launch_geometry(3, 65536) == (3, 256, 820)


# ---- the filter path: the chains must not move -----------------------------

# sha256 of the thetas of _filter_chains("cpu"), recorded on the tree before
# the kernel's redesign; the law, the twin and the filter's draws are unchanged
FILTER_CHAINS_SHA256 = "62554f4f86b2583c743c171f64be1613ce402a36b3ea664396d4ff573f1d13d9"


def _filter_chains(device):
    y = dataset_from_csv(os.path.join(os.path.dirname(__file__), "..", "data",
                                      "sir_underreported", "dataset.csv"), device=device)
    res = particle_mcmc_chains(sir_model(), get_observation_model("binomial"), y, [2.0, 1.0],
                               0.6, seed=2026, device=device, n_chains=4, n_iters=30,
                               obs_param=0.1, n_particles=16, adaptive=True, adapt_start=10,
                               pooled_adaptation=True, resample_every=4,
                               store_trajectories=False)
    return hashlib.sha256(res.thetas.cpu().numpy().tobytes()).hexdigest()


def test_filter_path_chains_do_not_move():
    """SIR, 4 chains x 16 particles, 30 iterations through ``advance``
    (final state only, one theta row per chain): the recorded chains."""
    assert _filter_chains("cpu") == FILTER_CHAINS_SHA256


@pytest.mark.cuda
def test_filter_path_chains_kernel_equal_twin_on_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    before = tauleap_cuda.launches()
    kernel = _filter_chains("cuda")
    assert tauleap_cuda.launches() > before
    monkeypatch.setattr(tauleap_cuda, "simulate_lanes", tauleap_cuda.simulate_lanes_reference)
    assert _filter_chains("cuda") == kernel


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(KERNEL_MODELS))
def test_kernel_matches_twin_on_card(name):
    """Both modes, ragged lane counts included, after one substep."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    m = KERNEL_MODELS[name]()
    for b in (1, 31, 33, 513, 4096):
        x0, th = (a.cuda() for a in _lane_inputs(m, b, b))
        before = tauleap_cuda.launches()
        k = tauleap_cuda.simulate_lanes(m, x0, th, 3, 1, 2, 1)
        p = tauleap_cuda.simulate_lanes_reference(m, x0, th, 3, 1, 2, 1)
        kf = tauleap_cuda.simulate_lanes(m, x0, th[:1].contiguous(), 3, 1, 2, 1, True, b)
        pf = tauleap_cuda.simulate_lanes_reference(m, x0, th[:1], 3, 1, 2, 1, True, b)
        torch.cuda.synchronize()
        assert tauleap_cuda.launches() == before + 2
        assert float((k == p).all(-1).all(-1).float().mean()) >= 0.999
        assert float((kf == pf).all(-1).float().mean()) >= 0.999
