"""SEIR and K-group SIR in epitpu_torch against epitpu on the same numpy
inputs: rates, structure, initial clouds, the tau-leap kernel's plain twin
and the particle filter.  The CUDA instantiations run only on a card: their
tests are marked ``cuda`` and skip here."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epitpu.models import seir_model as jseir_model
from epitpu.models import sir_subgroups_model as jsub_model
from epitpu.observe import get_observation_model as jobs
from epitpu.sim import simulate as jsimulate
from epitpu.smc import filter as jfilter
from epitpu_torch.cli import PRESETS, build_model, generate_dataset, population_and_mu
from epitpu_torch.mcmc import posterior_forecast
from epitpu_torch.models import KernelSpec, make_model, seir_model, sir_model
from epitpu_torch.models import sir_subgroups_model
from epitpu_torch.observe import get_observation_model
from epitpu_torch.ops import _build, tauleap_cuda
from epitpu_torch.rng import PhiloxStream
from epitpu_torch.smc import particle_filter

torch.set_num_threads(1)

# name -> (port model, epitpu model)
PAIRS = {
    "seir": (seir_model, jseir_model, {}),
    **{f"sub{k}_{'T' if t else 'F'}": (sir_subgroups_model, jsub_model,
                                        dict(k=k, reference_dynamics=t))
       for k in (1, 2, 3) for t in (True, False)},
    "sub2_aggregated": (sir_subgroups_model, jsub_model, dict(k=2, aggregated_obs=True)),
}


def _pair(name):
    port, ref, kw = PAIRS[name]
    return port(**kw), ref(**kw)


def _states(model, n, seed):
    """Random integer states with a non-empty first compartment."""
    rng = np.random.default_rng(seed)
    c = model.num_compartments
    x = rng.integers(0, 3000, size=(n, c)).astype(np.float32)
    x[:, 0] += 1.0  # a non-empty population
    return x


def _thetas(model, n, seed):
    rng = np.random.default_rng(seed + 1)
    return rng.uniform(0.1, 5.0, size=(n, model.theta_dim)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_rates_and_structure_match_epitpu(name):
    tm, jm = _pair(name)
    assert tm.name == jm.name and tm.compartments == jm.compartments
    assert tm.theta_names == jm.theta_names and tm.theta_dim == jm.theta_dim
    assert tm.obs_dim == jm.obs_dim
    np.testing.assert_array_equal(tm.stoich, jm.stoich)
    np.testing.assert_array_equal(tm.source, jm.source)
    x, th = _states(tm, 256, 0), _thetas(tm, 256, 0)
    got = tm.rate_fn(torch.from_numpy(x), torch.from_numpy(th)).numpy()
    ref = np.asarray(jm.rate_fn(jnp.asarray(x), jnp.asarray(th)))
    assert got.shape == ref.shape == (256, tm.num_reactions)
    # an explicit left-to-right force sum against einsum: rounding only
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tm.observe_map(torch.from_numpy(x)).numpy(),
                                  np.asarray(jm.observe_map(jnp.asarray(x))))


def test_kernel_descriptors():
    assert sir_model().kernel == KernelSpec("sir")
    assert seir_model().kernel == KernelSpec("seir", 1, False)
    assert sir_subgroups_model(3, reference_dynamics=False).kernel == \
        KernelSpec("sir_subgroups", 3, False)
    # the aggregated observation has the per-group model's dynamics
    assert sir_subgroups_model(2, aggregated_obs=True).kernel == sir_subgroups_model(2).kernel
    assert tauleap_cuda.hand_args(sir_subgroups_model(8)) == (2, 8, 1)
    assert tauleap_cuda.hand_args(seir_model()) == (1, 1, 0)
    # past MAX_GROUPS subgroups, and a user model, take the generated functor
    more = sir_subgroups_model(tauleap_cuda.MAX_GROUPS + 1)
    assert tauleap_cuda.route(more) == "generated"
    with pytest.raises(ValueError, match="no hand-written functor"):
        tauleap_cuda.hand_args(more)
    user = make_model("sis", ("s", "i"), [[-1, 1], [1, -1]], [0, 1],
                      lambda x, th: x * th, 2, ("beta", "gamma"))
    assert tauleap_cuda.route(user) == "generated"
    with pytest.raises(ValueError, match="no hand-written functor"):
        tauleap_cuda.hand_args(user)


@pytest.mark.parametrize("name", ["seir", "sub2_T", "sub3_F"])
def test_initial_cloud_is_poisson_per_group(name):
    """I0 ~ Poisson(mu_g) per group, S0 = N_g - I0, the rest 0; moments of
    both packages' clouds within Monte-Carlo error of the law's."""
    tm, jm = _pair(name)
    n = 20_000
    if name == "seir":
        pops, mus, i_cols = np.array([4820.0]), np.array([20.0]), [2]
        pop_arg, mu_arg = 4820.0, 20.0
    else:
        k = tm.kernel.k
        pops = np.array([2030.0, 3040.0, 1500.0][:k])
        mus = np.array([30.0, 40.0, 5.0][:k])
        i_cols = [3 * g + 1 for g in range(k)]
        pop_arg, mu_arg = pops.tolist(), torch.from_numpy(mus)
    got = tm.init_fn(torch.Generator().manual_seed(0), (n,), pop_arg, mu_arg).numpy()
    ref = np.asarray(jm.init_fn(jax.random.PRNGKey(0), n, np.asarray(pop_arg, np.float32),
                                np.asarray(mu_arg, np.float32)))
    assert got.shape == ref.shape == (n, tm.num_compartments)
    for x in (got, ref):
        for g, (col, mu, pop) in enumerate(zip(i_cols, mus, pops)):
            i0 = x[:, col]
            assert abs(i0.mean() - mu) <= 4 * np.sqrt(mu / n)
            assert abs(i0.var() - mu) <= 4 * np.sqrt((mu + 2 * mu * mu) / n)
            s_col = 0 if name == "seir" else 3 * g
            np.testing.assert_array_equal(x[:, s_col], pop - i0)
        others = np.delete(x, i_cols + ([0] if name == "seir" else
                                        [3 * g for g in range(len(pops))]), axis=1)
        assert (others == 0).all()


@pytest.mark.parametrize("name", ["seir", "sub2_T", "sub2_F"])
def test_twin_matches_epitpu_simulate_moments(name):
    """The kernel's plain twin against epitpu's XLA simulate, the path that
    validates the Pallas kernel off TPU (the tolerances of
    test_reference_matches_epitpu_simulate_moments)."""
    tm, jm = _pair(name)
    b = 2048
    if name == "seir":
        x0 = np.array([4800.0, 0.0, 20.0, 0.0], np.float32)
        theta = np.array([4.0, 1.0, 1.0], np.float32)
    else:
        k = tm.kernel.k
        x0 = np.array([2000.0, 30.0, 0.0, 3000.0, 40.0, 0.0, 1500.0, 5.0, 0.0][:3 * k],
                      np.float32)
        theta = np.concatenate([np.array([[5.0, 2.0, 0.5], [1.0, 3.0, 1.0],
                                          [0.5, 1.0, 2.0]])[:k, :k].reshape(-1),
                                [0.5]]).astype(np.float32)
    xb = np.broadcast_to(x0, (b, x0.size)).copy()
    th = np.broadcast_to(theta, (b, theta.size)).copy()
    got = tauleap_cuda.simulate_lanes(tm, torch.from_numpy(xb), torch.from_numpy(th),
                                      3, 0, 8, 20).numpy()
    ref = np.swapaxes(np.asarray(jsimulate(jm, jax.random.PRNGKey(3), jnp.asarray(xb),
                                           jnp.asarray(theta), 8, 20)), 0, 1)
    assert got.shape == ref.shape == (b, 9, x0.size)
    np.testing.assert_array_equal(got, np.round(got))
    np.testing.assert_array_equal(got[:, 0], xb)
    groups = 1 if name == "seir" else tm.kernel.k
    pops = xb.reshape(b, groups, -1).sum(-1)
    np.testing.assert_array_equal(got.reshape(b, 9, groups, -1).sum(-1), pops[:, None]
                                  .repeat(9, 1))
    for t in (2, 5, 8):
        np.testing.assert_allclose(got[:, t].mean(0), ref[:, t].mean(0), rtol=0.06, atol=3.0)
        np.testing.assert_allclose(got[:, t].std(0), ref[:, t].std(0), rtol=0.3, atol=3.0)


@pytest.mark.parametrize("preset", ["seir_underreported", "sir_subgroups", "sir_subgroups2"])
def test_filter_logz_matches_epitpu(preset):
    """64 log-likelihood estimates at the preset's truth from each package
    (N=32, the preset's vector population and mu for subgroups): means
    within 4 combined standard errors."""
    cfg = PRESETS[preset]()
    tm = build_model(cfg)
    jm = (jseir_model() if cfg.model == "seir" else
          jsub_model(k=cfg.subgroups, aggregated_obs=cfg.model == "sir_subgroups2"))
    y, _ = generate_dataset(cfg)
    pop, mu = population_and_mu(cfg)
    theta = np.asarray(cfg.data.theta_true, np.float32)
    reps, n = 64, 32
    keys = jax.random.split(jax.random.PRNGKey(7), reps)
    o = jobs("binomial")
    ref = np.asarray(jax.jit(jax.vmap(lambda key: jfilter.particle_filter(
        jm, o, key, jnp.asarray(y), jnp.asarray(theta), 0.1, n_particles=n,
        n_population=jnp.asarray(pop), mu=jnp.asarray(mu), record_history=False,
    ).log_likelihood))(keys), np.float64)
    got = particle_filter(
        tm, get_observation_model("binomial"), torch.from_numpy(y),
        torch.from_numpy(theta).expand(reps, theta.size), 0.1, PhiloxStream(7),
        torch.Generator().manual_seed(7), n_particles=n, n_population=pop, mu=mu,
        record_history=False,
    ).log_likelihood.double().numpy()
    assert np.isfinite(ref).all() and np.isfinite(got).all()
    se = np.sqrt(ref.var(ddof=1) / reps + got.var(ddof=1) / reps)
    assert abs(ref.mean() - got.mean()) <= 4 * se, (ref.mean(), got.mean(), se)


@pytest.mark.parametrize("name", ["seir", "sub2_T"])
def test_forecast_continues_each_family(name):
    """posterior_forecast needs nothing per model: every draw continues its
    own state under its own theta, per-group populations conserved."""
    tm, _ = _pair(name)
    groups = 1 if name == "seir" else tm.kernel.k
    x = torch.from_numpy(_states(tm, 64, 2))
    th = torch.from_numpy(_thetas(tm, 64, 2))
    fc = posterior_forecast(tm, PhiloxStream(4), th, x, 3, 10)
    assert fc.shape == (64, 4, tm.num_compartments)
    torch.testing.assert_close(fc[:, 0], x)
    pops = x.reshape(64, groups, -1).sum(-1)
    assert torch.equal(fc.reshape(64, 4, groups, -1).sum(-1), pops[:, None].expand(64, 4, groups))
    assert torch.any(fc[:, -1] != fc[:, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["seir", "sub2_T", "sub2_F", "sub8_T"])
def test_kernel_family_matches_twin_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    m = seir_model() if name == "seir" else sir_subgroups_model(
        int(name[3]), reference_dynamics=name.endswith("T"))
    g = torch.Generator().manual_seed(0)
    b = 4096
    x0 = torch.randint(0, 1500, (b, m.num_compartments), generator=g).float()
    x0[:, 0] += 1000.0
    th = torch.rand(b, m.theta_dim, generator=g) * 3
    x0, th = x0.cuda(), th.cuda()
    before = _build.LAUNCHES[m.kernel.family]
    k = tauleap_cuda.simulate_lanes(m, x0, th, 3, 1, 2, 1)
    p = tauleap_cuda.simulate_lanes_reference(m, x0, th, 3, 1, 2, 1)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[m.kernel.family] == before + 1
    assert float((k == p).all(-1).all(-1).float().mean()) >= 0.999
