"""The tau-leap kernel's (K4's) profiling counters: ``k4.launches`` one a
launch of any family or generated functor, ``k4.thread_slots`` and
``k4.reaction_slots`` the draw slots of a launch's threads and those its
reactions fill (``tauleap_cuda.draw_slots`` over ``launch_geometry``: the
threads of the warps that hold lanes, floor(32 / R) lanes a warp); the
CPU's twin and the plain route count none.  The card's tests run with
``--noconftest``: this file imports neither JAX nor epitpu."""
import pytest
import torch

from epitpu_torch import profiling
from epitpu_torch.models import seir_model, sir_model
from epitpu_torch.ops import _build, tauleap_cuda

K4_COUNTERS = ("k4.launches", "k4.thread_slots", "k4.reaction_slots")
LANES = 2048 * 32  # seir_binomial.chains2048: 2,048 chains x 32 particles


@pytest.mark.parametrize("reactions,group,passes", [(2, 2, 1), (3, 3, 1), (5, 5, 1), (6, 6, 1),
                                                    (7, 7, 1), (10, 10, 1), (33, 32, 2)])
def test_draw_slots_follow_the_launch_geometry(reactions, group, passes):
    """A lane's group is one thread a reaction, at most a warp, and a warp
    holds floor(32 / group) lanes; past a warp a thread draws in passes, a
    slot each.  A launch's thread slots are those of the warps that hold
    lanes: its idle slots are the last warp's empty lane places, the
    threads that no lane owns, and a lane's slots past its reactions."""
    per_warp = 32 // group
    for lanes in (1, 33, LANES):
        g, _, _ = tauleap_cuda.launch_geometry(reactions, lanes)
        assert g == group
        threads, drawn = tauleap_cuda.draw_slots(reactions, lanes, g)
        warps = -(-lanes // per_warp)
        assert threads == warps * 32 * passes and drawn == lanes * reactions
        empty = warps * per_warp - lanes
        assert 0 <= empty < per_warp
        assert threads - drawn == (empty * group * passes + warps * (32 - per_warp * group) * passes
                                   + lanes * (group * passes - reactions))


def test_a_seir_launch_packs_ten_lanes_a_warp():
    g, _, _ = tauleap_cuda.launch_geometry(seir_model().num_reactions, LANES)
    assert g == 3 and tauleap_cuda.draw_slots(3, LANES, g) == (209728, 196608)
    g, _, _ = tauleap_cuda.launch_geometry(sir_model().num_reactions, LANES)
    threads, drawn = tauleap_cuda.draw_slots(2, LANES, g)
    assert threads == drawn


def test_the_counters_are_declared_and_every_k4_key_counts_a_launch():
    assert set(K4_COUNTERS) <= set(profiling.COUNTERS)
    for key in tauleap_cuda.KERNEL_PATHS:
        assert _build.PROFILED[key] == "k4.launches"
    assert "plain" not in _build.PROFILED


def test_the_twin_on_the_cpu_counts_nothing():
    model = seir_model()
    gen = torch.Generator().manual_seed(3)
    x0 = model.init_fn(gen, (4, 8), 4820.0, 20.0).reshape(32, 4).contiguous()
    theta = torch.tensor([[4.0, 1.0, 1.0]]).expand(4, 3).contiguous()
    with profiling.recording() as rec:
        tauleap_cuda.simulate_lanes(model, x0, theta, 11, 0, 1, 2, final_only=True,
                                    lanes_per_theta=8)
    assert not set(K4_COUNTERS) & set(rec.counters)


# ---- on the card ------------------------------------------------------------------

def _filter_step(model, theta_row, chains=2048, particles=32):
    """One filter step's launch at ``chains x particles`` inside a recording:
    its counters and ``_build.LAUNCHES``' K4 launches."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    x0 = model.init_fn(gen, (chains, particles), 4820.0, 20.0).reshape(-1, model.num_compartments)
    theta = torch.tensor(theta_row, device="cuda").expand(chains, len(theta_row)).contiguous()
    before = tauleap_cuda.launches()
    with profiling.recording() as rec:
        tauleap_cuda.simulate_lanes(model, x0.contiguous(), theta, 11, 0, 1, 20,
                                    final_only=True, lanes_per_theta=particles)
    torch.cuda.synchronize()
    return rec.counters, tauleap_cuda.launches() - before


@pytest.mark.cuda
def test_a_seir_filter_step_counts_its_launch_and_slots_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    counters, launched = _filter_step(seir_model(), (4.0, 1.0, 1.0))
    assert launched == 1
    assert {k: counters.get(k) for k in K4_COUNTERS} == {
        "k4.launches": 1, "k4.thread_slots": 209728, "k4.reaction_slots": 196608}


@pytest.mark.cuda
def test_a_sir_filter_step_leaves_no_thread_idle_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    counters, launched = _filter_step(sir_model(), (2.0, 1.0), particles=16)
    assert launched == 1 and counters["k4.launches"] == 1
    idle_pct = 100.0 * (1.0 - counters["k4.reaction_slots"] / counters["k4.thread_slots"])
    assert idle_pct == 0.0
