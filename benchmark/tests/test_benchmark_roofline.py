"""``benchmark/roofline.py`` counts K4's work as the twin counts it."""
from __future__ import annotations

import pytest
import torch

from benchmark import roofline
from benchmark.reference import model_sir, tauleap


@pytest.mark.parametrize("lanes,units,seed", [(37, 2, 5), (256, 6, 2 ** 40 + 3)])
def test_the_count_is_the_twins_at_small_shapes(lanes, units, seed):
    """At two small shapes, the reference draws the same counts as the
    program's plain twin of K4, the draws' regimes and CDF terms are the
    twin's, and ``roofline.ops`` with the per-draw mean of that count gives
    chip_smoke's operation count (rates 6 + 2 R updates a lane-substep, then
    the draws)."""
    from epitpu_torch.models import sir_model
    from epitpu_torch.ops.tauleap_cuda import simulate_lanes_reference

    g = torch.Generator().manual_seed(seed % 1000)
    x0 = model_sir.initial_cloud(g, (lanes,), 4820.0, 20.0)
    theta = 3.0 * torch.rand((lanes, 2), generator=g)
    twin_work, ref_work = {}, {}
    twin = simulate_lanes_reference(sir_model(), x0, theta, seed, 3, units, 20, work=twin_work)
    ref = tauleap.simulate(model_sir, x0, theta, seed, 3, units, 20, False, work=ref_work)
    assert torch.equal(twin, ref)
    assert twin_work == ref_work
    per_draw = roofline.draw_ops(twin_work) / twin_work["draws"]
    substeps = units * 20
    smoke = lanes * substeps * (6 + 2 * 2) + roofline.draw_ops(twin_work)
    assert roofline.ops(lanes, substeps, 2, 1, per_draw) == pytest.approx(smoke, rel=1e-12)


def test_rate_operations_follow_the_group_count():
    assert [roofline.rate_ops(k) for k in (1, 2, 8)] == [6, 17, 167]


def test_bound_is_the_larger_of_compute_and_bandwidth():
    assert roofline.bound_s(roofline.PEAK_OPS, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, roofline.PEAK_BYTES * 2) == pytest.approx(2.0)
    # the filter's launch at the production shape is bound by its operations
    lanes = 2048 * 16
    ops = roofline.ops(lanes, 20, 2, 1, 160.57)
    assert ops / roofline.PEAK_OPS > roofline.nbytes(lanes, 2048, 3, 2, 1) / roofline.PEAK_BYTES


def test_k4_kernels_name_the_kernel_in_both_cells_and_grow_by_a_file(tmp_path):
    """Both K4 rooflines take K4's time by one pattern: it matches the
    kernel as the profiler names it for every model, not torch's kernels,
    and a K4 under another name is one more file."""
    import re
    import shutil

    from benchmark.trace import KERNELS, k4_kernels

    pattern = re.compile(k4_kernels())
    for functor in ("Sir", "Seir", "SirSubgroups<2>"):
        assert pattern.search(f"void (anonymous namespace)::traj_kernel<(anonymous "
                              f"namespace)::{functor}>(float const*, float const*, float*)")
    assert not pattern.search("void at::native::vectorized_elementwise_kernel<4, "
                              "at::native::CUDAFunctor_add<float> >")
    shutil.copytree(KERNELS, tmp_path / "kernels")
    (tmp_path / "kernels" / "k4.fused_step.txt").write_text("fused_step_kernel\n")
    grown = re.compile(k4_kernels(tmp_path / "kernels"))
    assert grown.search("fused_step_kernel<Sir>") and grown.search("traj_kernel<Sir>")
