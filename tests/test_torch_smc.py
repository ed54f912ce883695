"""epitpu_torch resampling, path sampling and particle filter against
epitpu: exact where both are fed the same uniforms and histories, within
Monte-Carlo error for the filter's log-likelihood."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epitpu.models import sir_model as jsir_model
from epitpu.observe import get_observation_model as jobs
from epitpu.smc import filter as jfilter
from epitpu.smc import paths as jpaths
from epitpu.smc import resample as jres
from epitpu_torch.io import dataset_from_csv
from epitpu_torch.models import sir_model
from epitpu_torch.ops.resample_cuda import systematic_step_reference
from epitpu_torch.observe import get_observation_model
from epitpu_torch.rng import PhiloxStream
from epitpu_torch.smc import (
    multinomial_resample,
    normalized_weights,
    particle_filter,
    sample_path,
    systematic_resample,
    walk_path,
)
from epitpu_torch.smc import resample as tres

torch.set_num_threads(1)

DATASET = os.path.join(os.path.dirname(__file__), "..", "data", "sir_underreported",
                       "dataset.csv")


def _logw(shape, seed):
    rng = np.random.default_rng(seed)
    lw = rng.normal(0.0, 3.0, size=shape).astype(np.float32)
    lw[..., rng.integers(0, shape[-1], 3)] = -np.inf
    return lw


@pytest.mark.parametrize("n", [16, 100, 1000])
@pytest.mark.parametrize("kind", ["systematic", "multinomial"])
def test_ancestors_equal_epitpu_given_same_uniforms(kind, n):
    """n = 16 takes the compare-reduce, 100 and 1000 searchsorted."""
    lw = _logw((4, n), n)
    key = jax.random.PRNGKey(n)
    if kind == "systematic":
        ref, _ = jres.systematic_resample(key, jnp.asarray(lw))
        u = jax.random.uniform(key, shape=(4, 1))
        got, degen = systematic_resample(torch.from_numpy(np.array(u)), torch.from_numpy(lw))
    else:
        ref, _ = jres.multinomial_resample(key, jnp.asarray(lw))
        u = jax.random.uniform(key, shape=(4, n))
        got, degen = multinomial_resample(torch.from_numpy(np.array(u)), torch.from_numpy(lw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert not degen.any()


@pytest.mark.parametrize("n", [1, 16, 33, 1000, 4096])
def test_resampling_kernels_twin_equals_epitpu_given_same_uniforms(n):
    """The resampling kernel's plain twin (``ops.resample_cuda``) draws
    epitpu's ancestors from epitpu's uniforms where every running sum is
    exact (weights 2^-e or 0), in any order of summation."""
    rng = np.random.default_rng(n)
    e = rng.integers(0, 9, size=(5, n))
    lw = (-e * np.log(2.0)).astype(np.float32)
    lw[rng.random((5, n)) < 0.1] = -np.inf
    lw[:, rng.integers(0, n)] = 0.0
    lw[4] = -np.inf  # degenerate: identity
    key = jax.random.PRNGKey(n)
    ref, ref_degen = jres.systematic_resample(key, jnp.asarray(lw))
    u = torch.from_numpy(np.array(jax.random.uniform(key, shape=(5, 1))))
    x = torch.arange(5 * n * 3, dtype=torch.float32).reshape(5, n, 3)
    anc, x_res, _ = systematic_step_reference(torch.from_numpy(lw), u, x)
    np.testing.assert_array_equal(anc.numpy(), np.asarray(ref))
    assert np.asarray(ref_degen).tolist() == [False] * 4 + [True]
    assert torch.equal(x_res, torch.gather(x, 1, anc[..., None].expand(5, n, 3)))


def test_searchsorted_and_compare_reduce_agree(monkeypatch):
    lw = torch.from_numpy(_logw((3, 48), 5))
    u = torch.rand(3, 1, generator=torch.Generator().manual_seed(1))
    a, _ = systematic_resample(u, lw)
    monkeypatch.setattr(tres, "COMPARE_REDUCE_MAX_N", 8)
    b, _ = systematic_resample(u, lw)
    assert torch.equal(a, b)


def test_degenerate_gives_identity_and_flag():
    lw = torch.full((2, 10), -float("inf"))
    lw[1, 3] = 0.0
    for fn, k in ((systematic_resample, 1), (multinomial_resample, 10)):
        anc, degen = fn(torch.rand(2, k), lw)
        assert degen.tolist() == [True, False]
        assert anc[0].tolist() == list(range(10))
        assert (anc[1] == 3).all()
    w, lse, degen = normalized_weights(lw)
    torch.testing.assert_close(w[0], torch.full((10,), 0.1))
    assert degen.tolist() == [True, False] and float(lse[1]) == 0.0


def test_normalized_weights_match_epitpu():
    lw = _logw((5, 64), 3)
    w_j, lse_j, d_j = jres.normalized_weights(jnp.asarray(lw))
    w, lse, d = normalized_weights(torch.from_numpy(lw))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), rtol=1e-6)
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_j))


@pytest.mark.parametrize("weighted", [False, True])
def test_path_walk_equals_epitpu(weighted):
    rng = np.random.default_rng(4)
    t, n = 9, 32
    hidden = rng.integers(0, 5000, size=(t, n, 3)).astype(np.float32)
    ancestry = rng.integers(0, n, size=(t, n)).astype(np.int32)
    logw = rng.normal(size=n).astype(np.float32) if weighted else None
    key = jax.random.PRNGKey(3)
    ref = jpaths.sample_path(key, jnp.asarray(hidden), jnp.asarray(ancestry),
                             None if logw is None else jnp.asarray(logw))
    j_last = (jax.random.categorical(key, jnp.asarray(logw)) if weighted
              else jax.random.randint(key, (), 0, n))
    got = walk_path(torch.from_numpy(hidden), torch.from_numpy(ancestry).long(),
                    torch.tensor(int(j_last)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_sample_path_batched_over_chains():
    rng = np.random.default_rng(5)
    hidden = torch.from_numpy(rng.integers(0, 99, size=(3, 6, 8, 3)).astype(np.float32))
    anc = torch.from_numpy(rng.integers(0, 8, size=(3, 6, 8)))
    g = torch.Generator().manual_seed(0)
    paths = sample_path(g, hidden, anc, torch.zeros(3, 8))
    assert paths.shape == (3, 6, 3)
    for c in range(3):
        j = int((hidden[c, -1] == paths[c, -1]).all(-1).nonzero()[0])
        torch.testing.assert_close(walk_path(hidden[c], anc[c], torch.tensor(j)), paths[c])


@pytest.mark.parametrize("n,every,threshold", [(16, 1, 1.0), (16, 4, 1.0),
                                               (100, 1, 1.0), (100, 4, 1.0),
                                               (100, 1, 0.5)])
def test_filter_logz_matches_epitpu(n, every, threshold):
    """64 independent log-likelihood estimates at the truth from each
    package: means within 4 combined standard errors, sd ratio in
    [0.7, 1.4]."""
    y = dataset_from_csv(DATASET, device="cpu")
    reps = 64
    keys = jax.random.split(jax.random.PRNGKey(n + every), reps)
    m, o = jsir_model(), jobs("binomial")
    ref = np.asarray(jax.jit(jax.vmap(lambda k: jfilter.particle_filter(
        m, o, k, jnp.asarray(y.numpy()), jnp.array([2.0, 1.0]), 0.1, n_particles=n,
        resample_every=every, resample_threshold=threshold, record_history=False,
    ).log_likelihood))(keys), np.float64)
    got = particle_filter(
        sir_model(), get_observation_model("binomial"), y,
        torch.tensor([[2.0, 1.0]]).expand(reps, 2), 0.1, PhiloxStream(n + every),
        torch.Generator().manual_seed(n), n_particles=n, resample_every=every,
        resample_threshold=threshold, record_history=False,
    ).log_likelihood.double().numpy()
    assert np.isfinite(ref).all() and np.isfinite(got).all()
    se = np.sqrt(ref.var(ddof=1) / reps + got.var(ddof=1) / reps)
    assert abs(ref.mean() - got.mean()) <= 4 * se, (ref.mean(), got.mean(), se)
    assert 0.7 <= got.std(ddof=1) / ref.std(ddof=1) <= 1.4


@pytest.mark.parametrize("every", [1, 4])
def test_degenerate_data_gives_neg_inf_never_nan(every):
    y = np.zeros((5, 3), np.float32)
    y[2] = [10_000.0, 0.0, 0.0]  # more reported than the population
    ref = jfilter.particle_filter(jsir_model(), jobs("binomial"), jax.random.PRNGKey(0),
                                  jnp.asarray(y), jnp.array([2.0, 1.0]), 0.1,
                                  n_particles=32, resample_every=every)
    res = particle_filter(sir_model(), get_observation_model("binomial"),
                          torch.from_numpy(y), torch.tensor([[2.0, 1.0]] * 3), 0.1,
                          PhiloxStream(0), torch.Generator().manual_seed(0),
                          n_particles=32, resample_every=every)
    assert np.isneginf(float(ref.log_likelihood)) and bool(ref.degenerate)
    assert torch.isneginf(res.log_likelihood).all() and res.degenerate.all()
    for t in (res.log_zetas, res.hidden, res.final_logw):
        assert not torch.isnan(t).any()


def test_filter_history_shapes_and_timing():
    y = dataset_from_csv(DATASET, device="cpu")
    x0 = sir_model().init_fn(torch.Generator().manual_seed(0), (2, 24), 4820, 20.0)
    res = particle_filter(sir_model(), get_observation_model("binomial"), y,
                          torch.tensor([[2.0, 1.0], [1.5, 0.8]]), torch.tensor([0.1, 0.2]),
                          PhiloxStream(1), torch.Generator().manual_seed(1),
                          n_particles=24, x0=x0, resample_every=4)
    t = y.shape[0]
    assert res.hidden.shape == (2, t, 24, 3) and res.ancestry.shape == (2, t, 24)
    assert res.log_zetas.shape == (2, t) and (res.log_zetas[:, 0] == 0).all()
    assert torch.equal(res.hidden[:, 0], x0) and (res.ancestry[:, 0] == 0).all()
    # steps 1, 2 are off the every-4 schedule: identity ancestry
    assert torch.equal(res.ancestry[:, 1], torch.arange(24).expand(2, 24))
    torch.testing.assert_close(torch.logsumexp(res.final_logw, -1), torch.zeros(2),
                               atol=1e-5, rtol=0)
    # Y[T-1] never enters the likelihood (reference timing)
    y2 = y.clone()
    y2[-1] = 0.0
    again = particle_filter(sir_model(), get_observation_model("binomial"), y2,
                            torch.tensor([[2.0, 1.0], [1.5, 0.8]]), torch.tensor([0.1, 0.2]),
                            PhiloxStream(1), torch.Generator().manual_seed(1),
                            n_particles=24, x0=x0, resample_every=4)
    assert torch.equal(again.log_likelihood, res.log_likelihood)
