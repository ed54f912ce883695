"""The filter's systematic resampling step (phase ``pf_resample``): the plain
twin against the plain path it replaced, its order of summation against the
kernel's thread layout, degenerate and kept rows, a particle shard's slice,
its rows' independence of one another, the wrapper's checks, the filter's
dispatch; on the card, the kernel against the twin."""
import math
import re

import numpy as np
import pytest
import torch

from epitpu_torch import profiling
from epitpu_torch.ops import _build, resample_cuda
from epitpu_torch.ops.resample_cuda import (cdf_reference, systematic_step,
                                            systematic_step_reference)
from epitpu_torch.smc.resample import systematic_resample

torch.set_num_threads(1)

PLAIN_SIZES = (1, 2, 3, 16, 17, 33, 64, 1000, 4096, 5000)
LAYOUT_SIZES = (1, 2, 3, 15, 16, 17, 31, 32, 33, 64, 513, 1000, 4096, 5000, 8191, 8192, 8193,
                20000)


def _dyadic(rows, n, seed, c=3):
    """(lw, u, x, skip): log-weights whose weights exp(lw - max) are 2^-e,
    e = 0..8, or 0 (-inf), the max 0 at a random particle of each row, so
    every running sum is exact in float32 in any order; uniforms, a cloud of
    distinct states, and a third of the rows marked to keep theirs."""
    g = torch.Generator().manual_seed(seed)
    e = torch.randint(0, 9, (rows, n), generator=g)
    zero = torch.rand((rows, n), generator=g) < 0.1
    top = torch.arange(rows), torch.randint(0, n, (rows,), generator=g)
    e[top], zero[top] = 0, False
    lw = (-e.double() * math.log(2.0)).float()
    lw[zero] = -math.inf
    fin = torch.isfinite(lw)
    assert torch.equal(torch.exp(lw[fin]), torch.exp2(-e[fin].float()))
    u = torch.rand((rows, 1), generator=g)
    x = torch.randn((rows, n, c), generator=g)
    skip = torch.rand(rows, generator=g) < 0.33
    return lw, u, x, skip


def _random(rows, n, seed, c=3):
    """(lw, u, x, skip) as ``_dyadic``, the log-weights of a binomial
    weighting's spread with some -inf."""
    g = torch.Generator().manual_seed(seed)
    lw = torch.randn((rows, n), generator=g) * 4.0 - 12.0
    lw[torch.rand((rows, n), generator=g) < 0.05] = -math.inf
    u = torch.rand((rows, 1), generator=g)
    x = torch.randn((rows, n, c), generator=g)
    return lw, u, x, torch.rand(rows, generator=g) < 0.33


def _plain_step(lw, u, x, skip):
    """The step as the filter computed it before the kernel:
    systematic_resample, the need mask, the gather, the reset
    (smc/filter.py)."""
    n = lw.shape[1]
    anc, _ = systematic_resample(u, lw)
    lw_next = None
    if skip is not None:
        need = ~skip
        anc = torch.where(need[:, None], anc, torch.arange(n).expand_as(anc))
        lw_next = torch.where(need[:, None], torch.full_like(lw, -math.log(n)), lw)
    return anc, torch.gather(x, 1, anc[..., None].expand(*anc.shape, x.shape[-1])), lw_next


def _same_bits(a, b):
    a, b = a.cpu(), b.cpu()
    if a.dtype != torch.float32:
        return bool(a.dtype == b.dtype and torch.equal(a, b))
    nan = torch.isnan(a)
    return bool(a.shape == b.shape and torch.equal(nan, torch.isnan(b))
                and torch.equal(a.view(torch.int32)[~nan], b.view(torch.int32)[~nan]))


def _outputs_equal(got, want):
    return all((g is None and w is None) or (g is not None and w is not None and _same_bits(g, w))
               for g, w in zip(got, want))


@pytest.mark.parametrize("c", [3, 4, 6])
@pytest.mark.parametrize("rows", [1, 7, 64])
@pytest.mark.parametrize("n", PLAIN_SIZES)
def test_twin_equals_the_plain_path(n, rows, c):
    """Equal ancestors, states and carried weights, in both forms, where
    every running sum is exact."""
    lw, u, x, skip = _dyadic(rows, n, seed=n * 100 + rows + c, c=c)
    for form in (None, skip):
        got = systematic_step_reference(lw, u, x, form)
        assert _outputs_equal(got, _plain_step(lw, u, x, form)), "carry" if form is not None else ""
    assert got[0].dtype == torch.int64 and got[1].shape == (rows, n, c)


def _kernel_layout_cdf(e):
    """csrc/pf_resample.cu's CDF of each row of ``e [rows, n]`` (float32),
    following its threads: P <= 32, lanes with shfl_up by 1, 2, ..., P/2,
    the sums then the maxima; past that, thread t of T = min(P, 512) adds
    its K consecutive elements of each tile in order, the block scans the
    threads' last sums (warps by shuffles, their totals in warp 0), adds
    them as (carry + (warps before + lanes before)) + its own sums, and
    keeps the running maximum the same way, tile by tile."""
    rows, n = e.shape
    p = 1 << (n - 1).bit_length()
    v = np.zeros((rows, p), np.float32)
    v[:, :n] = e

    def shfl_up_scan(lanes, op):
        d = 1
        while d < lanes.shape[-1]:
            nxt = lanes.copy()
            nxt[..., d:] = op(lanes[..., :-d], lanes[..., d:])
            lanes, d = nxt, d * 2
        return lanes

    if p <= 32:
        return shfl_up_scan(shfl_up_scan(v, np.add), np.fmax)[:, :n]

    def exclusive(vals, op):  # [rows, T] -> the threads' before, 0 for thread 0
        lanes = shfl_up_scan(vals.reshape(rows, -1, 32), op)
        lane_ex = np.concatenate([np.zeros_like(lanes[..., :1]), lanes[..., :-1]], -1)
        part = np.zeros((rows, 32), np.float32)
        part[:, :lanes.shape[1]] = lanes[..., 31]
        part = shfl_up_scan(part, op)[:, :lanes.shape[1]]
        warp_ex = np.concatenate([np.zeros_like(part[:, :1]), part[:, :-1]], -1)
        return op(warp_ex[..., None], lane_ex).reshape(rows, -1)

    threads, tile = min(p, 512), min(p, 8192)
    k = tile // threads
    out, carry, top = [], np.zeros(rows, np.float32), np.zeros(rows, np.float32)
    for q in range(p // tile):
        regs = v[:, q * tile:(q + 1) * tile].reshape(rows, threads, k)
        own = np.zeros_like(regs)
        acc = np.zeros((rows, threads), np.float32)
        for j in range(k):
            acc = acc + regs[:, :, j]
            own[:, :, j] = acc
        base = carry[:, None] + exclusive(own[:, :, -1], np.add)
        before = np.fmax(top[:, None], exclusive(base + own[:, :, -1], np.fmax))
        vals = base[..., None] + own
        out.append(np.fmax(before[..., None], vals).reshape(rows, tile))
        carry, top = vals[:, -1, -1], out[-1][:, -1]
    return np.concatenate(out, -1)[:, :n]


@pytest.mark.parametrize("n", LAYOUT_SIZES)
def test_twin_cdf_follows_the_kernels_threads(n):
    rows = 3 if n > 4096 else 8
    g = torch.Generator().manual_seed(n)
    w = torch.exp(torch.randn((rows, n), generator=g) * 3.0)
    w[0, ::3] = 0.0
    w[1, ::2] = 1e-30  # tiny weights, where two orders of summation part most
    got = cdf_reference(w)
    assert _same_bits(got, torch.from_numpy(_kernel_layout_cdf(w.numpy())))
    assert bool((got[:, 1:] >= got[:, :-1]).all())


@pytest.mark.parametrize("carry", [False, True], ids=["always resample", "carry"])
@pytest.mark.parametrize("n", [1, 16, 33, 4096, 8193])
def test_degenerate_and_kept_rows_keep_their_particles(n, carry):
    """Rows all -inf, with a NaN or a +inf: identity ancestry, their weights
    reset to -log N (carry form); rows marked to skip: identity and their
    weights kept; the other rows resample."""
    lw, u, x, _ = _random(8, n, seed=3)
    lw[0] = -math.inf
    lw[1, n // 2] = math.nan
    lw[2, 0] = math.inf
    lw[5] = -math.inf
    skip = torch.tensor([False, False, False, False, True, True, False, False])
    anc, x_res, lw_next = systematic_step_reference(lw, u, x, skip if carry else None)
    iota = torch.arange(n)
    kept = [0, 1, 2, 4, 5] if carry else [0, 1, 2, 5]
    for r in range(8):
        alone = systematic_step_reference(lw[r:r + 1], u[r:r + 1], x[r:r + 1])[0][0]
        assert torch.equal(anc[r], iota if r in kept else alone), r
        assert torch.equal(x_res[r], x[r, anc[r]])
    if carry:
        reset = torch.full((n,), -math.log(n))
        for r in range(8):
            assert _same_bits(lw_next[r], lw[r] if r in (4, 5) else reset), r
    else:
        assert lw_next is None
    if n > 1:
        assert not torch.equal(anc[3], iota)


@pytest.mark.parametrize("carry", [False, True], ids=["always resample", "carry"])
@pytest.mark.parametrize("n, p0, n_local", [(16, 0, 4), (16, 12, 4), (33, 11, 11),
                                            (4096, 0, 1024), (4096, 3072, 1024),
                                            (20000, 5000, 5000)])
def test_a_shards_slice_equals_the_unsharded_slice(n, p0, n_local, carry):
    lw, u, x, skip = _random(6, n, seed=n + p0)
    skip = skip if carry else None
    every = systematic_step_reference(lw, u, x, skip)
    got = systematic_step_reference(lw, u, x, skip, p0, n_local)
    part = slice(p0, p0 + n_local)
    assert _outputs_equal(got, (every[0][:, part], every[1][:, part], every[2]))


@pytest.mark.parametrize("n", [16, 33, 4096, 20000])
def test_a_rows_twin_result_does_not_depend_on_the_other_rows(n):
    """One row's outputs are the same bits among 1, 7 or all rows and at any
    place: a chain shard needs no padding to the unsharded rows."""
    rows = 2048 if n == 16 else 24
    lw, u, x, skip = _random(rows, n, seed=7)
    every = systematic_step_reference(lw, u, x, skip)
    g = torch.Generator().manual_seed(n)
    for size in (1, 7):
        for start in torch.randint(0, rows - size, (4,), generator=g).tolist() + [0]:
            part = slice(start, start + size)
            got = systematic_step_reference(lw[part], u[part], x[part], skip[part])
            assert _outputs_equal(got, [t[part] for t in every]), (size, start)


def test_cpu_filter_resamples_through_the_step_and_launches_nothing(monkeypatch):
    """Each systematic resampling step of the filter is one call of
    systematic_step, in both forms (every step; every 4th, 5 steps); on
    the CPU that is the twin, with no launch and no counter; the other
    kinds keep their plain path."""
    from epitpu_torch.dist import filter_streams
    from epitpu_torch.models import sir_model
    from epitpu_torch.observe import get_observation_model
    from epitpu_torch.smc import filter as pf

    calls = []

    def spy(lw, u, x, skip=None, p0=0, n_local=None):
        calls.append(skip is not None)
        return systematic_step(lw, u, x, skip, p0, n_local)

    monkeypatch.setattr(pf, "systematic_step", spy)
    y = torch.tensor([[0.0, 2.0, 0.0]] * 6) * torch.arange(6.0)[:, None]
    before = dict(_build.LAUNCHES)
    for every, kind in ((1, "systematic"), (4, "systematic"), (1, "multinomial"),
                        (4, "systematic_scatter")):
        stream, gen = filter_streams(3, "cpu")
        with profiling.recording() as rec:
            res = pf.particle_filter(sir_model(), get_observation_model("binomial"), y,
                                     torch.tensor([[2.0, 1.0]] * 3), 0.1, stream, gen,
                                     n_particles=16, steps_per_unit=2, resample_every=every,
                                     resampling=kind)
        assert res.log_likelihood.shape == (3,) and rec.counters == {}
    assert calls == [False] * 5 + [True]
    assert _build.LAUNCHES == before


def test_step_raises_off_the_cpu_and_the_card():
    meta = torch.zeros(2, 4, device="meta")
    with pytest.raises(ValueError, match="no resampling step"):
        systematic_step(meta, torch.zeros(2, 1, device="meta"), torch.zeros(2, 4, 3, device="meta"))
    lw, u, x, _ = _random(4, 8, seed=0)
    with pytest.raises(ValueError, match="no resampling kernel"):
        resample_cuda.systematic_step_cuda(lw, u, x)


def _bad():
    lw, u, x, skip = _random(4, 8, seed=0)
    ok = dict(lw=lw, u=u, x=x, skip=skip, p0=0, n_local=8)
    cases = {
        "lw float64": (dict(lw=lw.double()), TypeError),
        "u float64": (dict(u=u.double()), TypeError),
        "x float64": (dict(x=x.double()), TypeError),
        "skip uint8": (dict(skip=skip.to(torch.uint8)), TypeError),
        "x a list": (dict(x=x.tolist()), TypeError),
        "lw [N]": (dict(lw=lw[0], u=u[:1], x=x[:1], skip=skip[:1]), ValueError),
        "lw [rows, 0]": (dict(lw=lw[:, :0], x=x[:, :0], n_local=0), ValueError),
        "u [rows]": (dict(u=u[:, 0]), ValueError),
        "u of other rows": (dict(u=u[:3]), ValueError),
        "x of another N": (dict(x=x[:, :4].contiguous()), ValueError),
        "x [rows, N]": (dict(x=x[..., 0].contiguous()), ValueError),
        "skip [rows, 1]": (dict(skip=skip[:, None]), ValueError),
        "lw strided": (dict(lw=torch.cat([lw, lw], 1)[:, ::2]), ValueError),
        "x strided": (dict(x=torch.cat([x, x], 2)[..., ::2]), ValueError),
        "u on another device": (dict(u=torch.zeros(4, 1, device="meta")), ValueError),
        "slice past N": (dict(p0=4, n_local=5), ValueError),
        "slice before 0": (dict(p0=-1, n_local=2), ValueError),
    }
    return {k: (dict(ok, **v), err) for k, (v, err) in cases.items()}


@pytest.mark.parametrize("case", sorted(_bad()))
def test_kernel_wrapper_refuses_what_it_cannot_take_as_it_is(case):
    args, err = _bad()[case]
    with pytest.raises(err):
        resample_cuda._check(**args)


def test_kernel_wrapper_takes_the_filters_inputs():
    lw, u, x, skip = _random(4, 8, seed=0)
    resample_cuda._check(lw, u, x, None, 0, 8)
    resample_cuda._check(lw, u, x, skip, 4, 4)


def test_kernel_is_built_counted_and_declared():
    assert "pf.resample_launches" in profiling.COUNTERS
    assert "pf_resample.cu" in _build.SOURCES
    assert _build.PROFILED["pf_resample"] == "pf.resample_launches"
    src = (_build.CSRC / "pf_resample.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kRowThreads"] == resample_cuda.ROW_THREADS
    assert consts["kRowThreads"] * consts["kMaxPerThread"] == resample_cuda.TILE
    assert consts["kWarp"] == resample_cuda.WARP == 32
    assert "kMaxN = 1 << 24" in src and resample_cuda.MAX_PARTICLES == 1 << 24


# ---- on the card ------------------------------------------------------------------

# (rows, N, p0, n_local): the PMMH cells' shapes, a four-card shard's slices, the
# edges of N
CARD_CASES = ((2048, 16, 0, 16), (32, 4096, 0, 4096), (32, 4096, 0, 1024),
              (32, 4096, 3072, 1024)) + tuple((7, n, 0, n) for n in (
                  1, 2, 3, 16, 17, 31, 32, 33, 64, 1000, 4096, 5000, 8192, 8193, 65536))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("carry", [False, True], ids=["always resample", "carry"])
@pytest.mark.parametrize("rows, n, p0, n_local", CARD_CASES)
def test_kernel_equals_twin_on_card(rows, n, p0, n_local, carry):
    _need_card()
    lw, u, x, skip = (t.cuda() for t in _random(rows, n, seed=n + rows))
    lw[0] = -math.inf
    if rows > 2:
        lw[1, n // 2] = math.nan
    skip = skip if carry else None
    before = _build.LAUNCHES["pf_resample"]
    got = systematic_step(lw, u, x, skip, p0, n_local)
    assert _build.LAUNCHES["pf_resample"] == before + 1
    assert _outputs_equal(got, systematic_step_reference(lw, u, x, skip, p0, n_local))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 4096, 65536])
def test_kernel_rows_do_not_depend_on_the_other_rows_on_card(n):
    _need_card()
    rows = 2048 if n == 16 else 32
    lw, u, x, skip = (t.cuda() for t in _random(rows, n, seed=5))
    every = systematic_step(lw, u, x, skip)
    for size, start in ((1, 0), (1, rows - 1), (7, 3), (7, rows - 7)):
        part = slice(start, start + size)
        got = systematic_step(lw[part], u[part], x[part], skip[part])
        assert _outputs_equal(got, [t[part] for t in every]), (size, start)


@pytest.mark.cuda
def test_kernel_launches_once_a_resampling_step_without_a_synchronize():
    _need_card()
    from epitpu_torch.dist import filter_streams
    from epitpu_torch.models import sir_model
    from epitpu_torch.observe import get_observation_model
    from epitpu_torch.smc import particle_filter

    y = (torch.tensor([[0.0, 2.0, 0.0]] * 15) * torch.arange(15.0)[:, None]).cuda()
    for every, steps in ((1, 14), (4, 3)):
        stream, gen = filter_streams(3, "cuda")
        before = _build.LAUNCHES["pf_resample"]
        with profiling.recording() as rec:
            particle_filter(sir_model(), get_observation_model("binomial"), y,
                            torch.tensor([[2.0, 1.0]] * 3), 0.1, stream, gen, n_particles=16,
                            steps_per_unit=2, resample_every=every)
        assert _build.LAUNCHES["pf_resample"] - before == steps
        assert rec.counters["pf.resample_launches"] == steps
    lw, u, x, skip = (t.cuda() for t in _random(32, 4096, seed=2))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        systematic_step(lw, u, x, skip)
    finally:
        torch.cuda.set_sync_debug_mode("default")
