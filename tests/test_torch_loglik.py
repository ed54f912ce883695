"""The filter's likelihood update (phase ``pf_loglik``): the plain twin
against the formula it replaced, its order of summation against the kernel's
thread layout, its rows' independence of one another, the wrapper's checks,
the filter's dispatch; on the card, the kernel against the twin."""
import math
import re

import numpy as np
import pytest
import torch

from epitpu_torch import profiling
from epitpu_torch.ops import _build, loglik_cuda
from epitpu_torch.ops.loglik_cuda import loglik_update, loglik_update_reference, row_sum

torch.set_num_threads(1)

SIZES = (1, 2, 15, 16, 17, 33, 1000, 4096)
CARD_SIZES = SIZES + (8192, 32768)


def _inputs(rows, n, seed, device="cpu"):
    """(logw, log_z, lw): log-weights of a binomial weighting's spread with
    some -inf, a running log-likelihood, normalized carried log-weights; and
    rows at the edges: every entry -inf, one finite entry, a NaN, a +inf."""
    g = torch.Generator().manual_seed(seed)
    logw = torch.randn((rows, n), generator=g) * 4.0 - 12.0
    logw[torch.rand((rows, n), generator=g) < 0.05] = -math.inf
    raw = torch.randn((rows, n), generator=g) * 2.0
    lw = raw - torch.logsumexp(raw, -1, keepdim=True)
    log_z = -100.0 * torch.rand(rows, generator=g)
    if rows >= 5:
        logw[0] = -math.inf
        logw[1] = -math.inf
        logw[1, n // 2] = -3.25
        logw[2, n - 1] = math.nan
        logw[3, 0] = math.inf
        lw[4] = -math.inf  # a carried row with nothing left
    return logw.to(device), log_z.to(device), lw.to(device)


def _torch_logsumexp_update(logw, log_z, log_n, lw=None):
    """The update as the filter computed it before the kernel:
    torch.logsumexp and the where chain (smc/filter.py)."""
    neg_inf = torch.tensor(-math.inf)
    if lw is None:
        lse = torch.logsumexp(logw, dim=-1)
        degen = ~torch.isfinite(lse)
        return torch.where(degen, neg_inf, log_z + lse - log_n), None, degen
    s = lw + logw
    lse = torch.logsumexp(s, dim=-1)
    degen = ~torch.isfinite(lse)
    safe = torch.where(degen, torch.zeros_like(lse), lse)
    return (torch.where(degen, neg_inf, log_z + lse),
            torch.where(degen[:, None], torch.full_like(s, -log_n), s - safe[:, None]), degen)


def _same_bits(a, b):
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.bool:
        return bool(torch.equal(a, b))
    nan = torch.isnan(a)
    return bool(a.shape == b.shape and torch.equal(nan, torch.isnan(b))
                and torch.equal(a.view(torch.int32)[~nan], b.view(torch.int32)[~nan]))


def _outputs_equal(got, want):
    return all((g is None and w is None) or _same_bits(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("carry", [False, True], ids=["always resample", "carry"])
@pytest.mark.parametrize("n", SIZES)
def test_twin_equals_torch_logsumexp_to_rounding(n, carry):
    """Within 1e-5 + 1e-6 relative of the torch.logsumexp formula; the
    degenerate rows and every -inf in the same places."""
    logw, log_z, lw = _inputs(64 if n < 4096 else 16, n, seed=n)
    log_n = math.log(n)
    got = loglik_update_reference(logw, log_z, log_n, lw if carry else None)
    want = _torch_logsumexp_update(logw, log_z, log_n, lw if carry else None)
    assert torch.equal(got[2], want[2])
    assert bool(want[2][[0, 2, 3]].all()) and not bool(want[2][1])
    for g, w in zip(got[:2], want[:2]):
        if w is None:
            assert g is None
            continue
        assert torch.equal(torch.isneginf(g), torch.isneginf(w)) and not torch.isnan(g).any()
        fin = torch.isfinite(w)
        torch.testing.assert_close(g[fin], w[fin], rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("carry", [False, True], ids=["always resample", "carry"])
@pytest.mark.parametrize("n", [1, 16, 4096])
def test_twin_edge_rows_equal_the_old_formula_exactly(n, carry):
    """Rows all -inf, with a NaN or a +inf: degenerate, -inf and -log N as
    before; a row with one finite entry: its log-sum-exp is that entry."""
    logw, log_z, lw = _inputs(8, n, seed=1)
    log_n = math.log(n)
    got = loglik_update_reference(logw, log_z, log_n, lw if carry else None)
    want = _torch_logsumexp_update(logw, log_z, log_n, lw if carry else None)
    edge = slice(0, 5 if carry else 4)
    assert _outputs_equal([t[edge] if t is not None else None for t in got],
                          [t[edge] if t is not None else None for t in want])
    if not carry:
        assert float(loglik_update_reference(logw[1:2], torch.zeros(1), 0.0)[0]) == -3.25


def _kernel_layout_sum(e):
    """The kernel's sum of each row of ``e [rows, n]`` (float32), following
    csrc/pf_loglik.cu's threads: P <= 32, lanes and shfl_down by P/2 ... 1;
    past that, thread t of T = min(P, 512) holds elements t + T j of each
    tile of min(P, 8192), adds the tiles in order, folds its registers
    j + K/2 into j, then the block folds thread t + h into t for h = T/2
    ... 32 and the last warp by shuffles."""
    rows, n = e.shape
    p = 1 << (n - 1).bit_length()
    v = np.zeros((rows, p), np.float32)
    v[:, :n] = e

    def shfl_fold(lanes, width):
        h = width // 2
        while h:
            nxt = lanes.copy()
            nxt[:, :width - h] = lanes[:, :width - h] + lanes[:, h:width]
            lanes, h = nxt, h // 2
        return lanes[:, 0]

    if p <= 32:
        return shfl_fold(v, p)
    threads = min(p, 512)
    tile = min(p, 8192)
    k = tile // threads
    regs = v[:, :tile].reshape(rows, k, threads).copy()  # [rows, j, t]: element t + T j
    for q in range(1, p // tile):
        regs = regs + v[:, q * tile:(q + 1) * tile].reshape(rows, k, threads)
    h = k // 2
    while h:
        regs[:, :h] = regs[:, :h] + regs[:, h:2 * h]
        h //= 2
    tree = regs[:, 0].copy()
    h = threads // 2
    while h >= 32:
        tree[:, :h] = tree[:, :h] + tree[:, h:2 * h]
        h //= 2
    return shfl_fold(tree[:, :32], 32)


@pytest.mark.parametrize("n", SIZES + (31, 32, 64, 513, 8191, 8192, 8193, 20000, 32768))
def test_twin_sums_in_the_kernels_thread_order(n):
    rows = 3 if n > 8192 else 8
    g = torch.Generator().manual_seed(n)
    e = torch.exp(torch.randn((rows, n), generator=g) * 3.0)
    e[0, ::3] = 0.0
    assert _same_bits(row_sum(e), torch.from_numpy(_kernel_layout_sum(e.numpy())))


@pytest.mark.parametrize("carry", [False, True], ids=["always resample", "carry"])
@pytest.mark.parametrize("n", [16, 33, 4096])
def test_a_rows_twin_result_does_not_depend_on_the_other_rows(n, carry):
    """One row's outputs are the same bits among 1, 7 or 2,048 rows and at
    any place: a chain shard needs no padding to the unsharded rows."""
    logw, log_z, lw = _inputs(2048, n, seed=7)
    log_n = math.log(n)
    lw = lw if carry else None
    every = loglik_update_reference(logw, log_z, log_n, lw)
    g = torch.Generator().manual_seed(n)
    for size in (1, 7):
        for start in torch.randint(0, logw.shape[0] - size, (6,), generator=g).tolist() + [0]:
            part = slice(start, start + size)
            got = loglik_update_reference(logw[part].contiguous(), log_z[part],
                                          log_n, None if lw is None else lw[part].contiguous())
            want = [None if t is None else t[part] for t in every]
            assert _outputs_equal(got, want), (size, start)


def test_cpu_filter_steps_go_through_the_update_and_launch_nothing(monkeypatch):
    """Each filter step's pf_loglik is one call of loglik_update, in both
    forms; on the CPU that is the twin, with no launch and no counter."""
    from epitpu_torch.models import sir_model
    from epitpu_torch.observe import get_observation_model
    from epitpu_torch.smc import filter as pf
    from epitpu_torch.dist import filter_streams

    calls = []

    def spy(logw, log_z, log_n, lw=None):
        calls.append(lw is not None)
        return loglik_update(logw, log_z, log_n, lw)

    monkeypatch.setattr(pf, "loglik_update", spy)
    y = torch.tensor([[0.0, 2.0, 0.0]] * 6) * torch.arange(6.0)[:, None]
    before = dict(_build.LAUNCHES)
    for every in (1, 4):
        stream, gen = filter_streams(3, "cpu")
        with profiling.recording() as rec:
            res = pf.particle_filter(sir_model(), get_observation_model("binomial"), y,
                                     torch.tensor([[2.0, 1.0]] * 3), 0.1, stream, gen,
                                     n_particles=16, steps_per_unit=2, resample_every=every)
        assert res.log_likelihood.shape == (3,) and rec.counters == {}
    assert calls == [False] * 5 + [True] * 5
    assert _build.LAUNCHES == before


def test_update_raises_off_the_cpu_and_the_card():
    meta = torch.zeros(2, 4, device="meta")
    with pytest.raises(ValueError, match="no likelihood update"):
        loglik_update(meta, torch.zeros(2, device="meta"), 1.0)
    logw, log_z, _ = _inputs(4, 8, seed=0)
    with pytest.raises(ValueError, match="no likelihood-update kernel"):
        loglik_cuda.loglik_update_cuda(logw, log_z, 1.0)


def _bad():
    logw, log_z, lw = _inputs(4, 8, seed=0)
    return {
        "logw float64": ((logw.double(), log_z, None), TypeError),
        "log_z float64": ((logw, log_z.double(), None), TypeError),
        "lw float64": ((logw, log_z, lw.double()), TypeError),
        "lw a list": ((logw, log_z, lw.tolist()), TypeError),
        "logw [N]": ((logw[0], log_z[:1], None), ValueError),
        "logw [rows, 0]": ((logw[:, :0], log_z, None), ValueError),
        "logw [rows, N, 1]": ((logw[..., None], log_z, None), ValueError),
        "log_z of other rows": ((logw, log_z[:3], None), ValueError),
        "log_z [rows, 1]": ((logw, log_z[:, None], None), ValueError),
        "lw of another N": ((logw, log_z, lw[:, :4].contiguous()), ValueError),
        "logw strided": ((logw[:, ::2], log_z, None), ValueError),
        "lw transposed": ((logw[:, :4].contiguous(), log_z, lw[:, :4].t()), ValueError),
        "log_z strided": ((logw[:2], log_z[::2], None), ValueError),
        "lw on another device": ((logw, log_z, torch.zeros(4, 8, device="meta")), ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad()))
def test_kernel_wrapper_refuses_what_it_cannot_take_as_it_is(case):
    args, err = _bad()[case]
    with pytest.raises(err):
        loglik_cuda._check(*args)


def test_kernel_wrapper_takes_the_filters_inputs():
    logw, log_z, lw = _inputs(4, 8, seed=0)
    loglik_cuda._check(logw, log_z, None)
    loglik_cuda._check(logw, log_z, lw)


def test_kernel_is_built_counted_and_declared():
    assert "pf.loglik_launches" in profiling.COUNTERS
    assert "pf_loglik.cu" in _build.SOURCES
    src = (_build.CSRC / "pf_loglik.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kRowThreads"] * consts["kMaxPerThread"] == loglik_cuda.TILE
    assert consts["kWarp"] == 32 and "n > (1 << 30)" in src
    assert loglik_cuda.MAX_PARTICLES == 1 << 30
    assert _build.PROFILED["pf_loglik"] == "pf.loglik_launches"


# ---- on the card ------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("carry", [False, True], ids=["always resample", "carry"])
@pytest.mark.parametrize("n", CARD_SIZES)
def test_kernel_equals_twin_on_card(n, carry):
    _need_card()
    for rows in (1, 32, 2048):
        if rows * n > 2048 * 4096:
            continue
        logw, log_z, lw = _inputs(rows, n, seed=n + rows, device="cuda")
        lw = lw if carry else None
        before = _build.LAUNCHES["pf_loglik"]
        got = loglik_update(logw, log_z, math.log(n), lw)
        assert _build.LAUNCHES["pf_loglik"] == before + 1
        assert _outputs_equal(got, loglik_update_reference(logw, log_z, math.log(n), lw)), rows


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 4096, 32768])
def test_kernel_rows_do_not_depend_on_the_other_rows_on_card(n):
    _need_card()
    rows = 2048 if n == 16 else 64
    logw, log_z, lw = _inputs(rows, n, seed=5, device="cuda")
    every = loglik_update(logw, log_z, math.log(n), lw)
    for size, start in ((1, 0), (1, rows - 1), (7, 3), (7, rows - 7)):
        part = slice(start, start + size)
        got = loglik_update(logw[part].contiguous(), log_z[part], math.log(n),
                            lw[part].contiguous())
        assert _outputs_equal(got, [t[part] for t in every]), (size, start)


@pytest.mark.cuda
def test_kernel_launches_once_a_filter_step_without_a_synchronize():
    _need_card()
    from epitpu_torch.dist import filter_streams
    from epitpu_torch.models import sir_model
    from epitpu_torch.observe import get_observation_model
    from epitpu_torch.smc import particle_filter

    y = (torch.tensor([[0.0, 2.0, 0.0]] * 6) * torch.arange(6.0)[:, None]).cuda()
    for every in (1, 4):
        stream, gen = filter_streams(3, "cuda")
        before = _build.LAUNCHES["pf_loglik"]
        with profiling.recording() as rec:
            particle_filter(sir_model(), get_observation_model("binomial"), y,
                            torch.tensor([[2.0, 1.0]] * 3), 0.1, stream, gen, n_particles=16,
                            steps_per_unit=2, resample_every=every)
        assert _build.LAUNCHES["pf_loglik"] - before == 5 == rec.counters["pf.loglik_launches"]
    logw, log_z, lw = _inputs(32, 4096, seed=2, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loglik_update(logw, log_z, math.log(4096), lw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
