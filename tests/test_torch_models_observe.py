"""epitpu_torch models and observation models against epitpu on the same
numpy inputs; the binomial weight's kernel, its wrapper and its dispatch."""
import ctypes
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epitpu.models import sir as jsir
from epitpu.observe import models as jobs
from epitpu_torch import profiling
from epitpu_torch.models import sir_model
from epitpu_torch.observe import models as tobs
from epitpu_torch.ops import _build, obs_cuda

torch.set_num_threads(1)


def test_sir_rates_match_epitpu():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 5000, size=(512, 3)).astype(np.float32)
    x[:, 0] += 1.0  # keep N > 0
    theta = rng.uniform(0.0, 4.0, size=(512, 2)).astype(np.float32)
    ref = np.asarray(jsir._rates(jnp.asarray(x), jnp.asarray(theta)))
    got = sir_model().rate_fn(torch.from_numpy(x), torch.from_numpy(theta)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_sir_init_is_poisson_cloud():
    g = torch.Generator().manual_seed(0)
    x0 = sir_model().init_fn(g, (4, 2000), 4820, 20.0)
    assert x0.shape == (4, 2000, 3)
    assert torch.all(x0.sum(-1) == 4820)
    assert torch.all(x0[..., 2] == 0)
    assert abs(float(x0[..., 1].mean()) - 20.0) < 0.3
    assert abs(float(x0[..., 1].var()) - 20.0) < 1.5


def test_binom_logpmf_matches_epitpu_up_to_1e6():
    rng = np.random.default_rng(1)
    n = np.floor(10 ** rng.uniform(0, 6, size=4000)).astype(np.float32)
    p = rng.uniform(0.001, 0.999, size=4000).astype(np.float32)
    k = np.clip(rng.binomial(n.astype(np.int64), p) + rng.integers(-3, 4, 4000),
                0, n).astype(np.float32)
    ref = np.asarray(jobs.binom_logpmf(jnp.asarray(k), jnp.asarray(n), jnp.asarray(p)))
    got = tobs.binom_logpmf(torch.from_numpy(k), torch.from_numpy(n),
                            torch.from_numpy(p)).numpy()
    assert np.isfinite(ref).all()
    assert np.all(np.abs(got - ref) <= 1e-4 * np.maximum(1.0, np.abs(ref)))


def test_binom_logpmf_edges_equal_exactly():
    k = np.array([0, 7, 7, 0, 3, 0, 5, 5, 0, 5, -1, 8, 2], np.float32)
    n = np.array([7, 7, 7, 0, 0, 5, 5, 5, 5, 5, 5, 5, 5], np.float32)
    p = np.array([.3, .3, .9, .5, .5, 0, 0, 1, 1, .4, .4, .4, .0], np.float32)
    ref = np.asarray(jobs.binom_logpmf(jnp.asarray(k), jnp.asarray(n), jnp.asarray(p)))
    got = tobs.binom_logpmf(torch.from_numpy(k), torch.from_numpy(n),
                            torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert np.isneginf(got[[4, 6, 8, 10, 11, 12]]).all()
    assert (got[[3, 5, 7]] == 0.0).all()


@pytest.mark.parametrize("combine", ["min", "sum"])
@pytest.mark.parametrize("kind", ["binomial", "gaussian"])
def test_observation_models_match_epitpu(kind, combine):
    rng = np.random.default_rng(2)
    x = rng.integers(1, 5000, size=(6, 64, 3)).astype(np.float32)
    y = np.floor(x[0, 0] * 0.1).astype(np.float32)
    param = np.float32(0.1)
    ref = np.asarray(jobs.get_observation_model(kind, combine)(
        jnp.asarray(y), jnp.asarray(x), param))
    got = tobs.get_observation_model(kind, combine)(
        torch.from_numpy(y), torch.from_numpy(x), float(param)).numpy()
    assert got.shape == (6, 64)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


def test_per_chain_obs_param_broadcasts():
    x = torch.full((3, 8, 3), 100.0)
    y = torch.tensor([10.0, 10.0, 10.0])
    p = torch.tensor([0.1, 0.2, 0.3])[:, None, None]
    lw = tobs.make_binomial_obs()(y, x, p)
    for c in range(3):
        ref = tobs.make_binomial_obs()(y, x[c], float(p[c]))
        torch.testing.assert_close(lw[c], ref)


def test_unknown_kinds_raise():
    with pytest.raises(ValueError):
        tobs.get_observation_model("poisson")
    with pytest.raises(ValueError):
        tobs._combine(torch.zeros(2, 3), "max")


# ---- the binomial weight: dispatch, wrapper and kernel (csrc/obs_binomial.cu) --

def _cloud(chains=4, n=32, c=3, seed=3, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = torch.floor(10 ** (torch.rand((chains, n, c), generator=g) * 4))
    return torch.floor(x[0, 0] * 0.1).to(device), x.to(device)


def _edge_cases(c, device="cpu"):
    """(label, y, x, p) at the edges of binom_logpmf: k = 0, k = n, n = 0,
    k > n, k < 0, NaN states; p = 0, 1, clamped near 0 and 1, and one p a
    chain with chains at 0, 1 and NaN."""
    y, x = _cloud(8, 64, c, seed=c)
    y[0] = 0.0
    x[0, :4] = 0.0
    x[1, :8, :] = y
    x[2, :8, :] = y - 1.0
    x[3, 0, 0] = float("nan")
    x[3, 1, :] = float("nan")
    x[4, :8] = torch.floor(y * 0.5)
    x[5:] = y + torch.floor(y * 9 + torch.rand((3, 64, c)) * 100)  # every term finite
    y_neg = y.clone()
    y_neg[-1] = -1.0
    per_chain = torch.tensor([0.1, 0.0, 1.0, 1e-12, 1.0 - 1e-9, 0.5, 0.9, float("nan")])
    cases = [(f"p={v!r}", y, x, torch.tensor(v)) for v in (0.1, 0.0, 1.0, 1e-12, 1.0 - 1e-9)]
    cases += [("p per chain", y, x, per_chain[:, None, None]),
              ("k<0", y_neg, x, torch.tensor(0.1))]
    return [(label, *(t.to(device) for t in ts)) for label, *ts in cases]


def _bits_equal(a, b):
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))
                and torch.equal(a.view(torch.int32)[~nan], b.view(torch.int32)[~nan]))


@pytest.mark.parametrize("combine", ["min", "sum"])
@pytest.mark.parametrize("p_form", ["0-d", "per chain", "float"])
def test_cpu_binomial_weight_is_the_twin_bit_for_bit(combine, p_form):
    """A CPU x_obs runs binom_logpmf and the combine, unchanged: no launch."""
    y, x = _cloud()
    p = {"0-d": torch.tensor(0.1), "float": 0.1,
         "per chain": torch.tensor([0.1, 0.0, 1.0, 0.3])[:, None, None]}[p_form]
    before = dict(_build.LAUNCHES)
    got = tobs.make_binomial_obs(combine)(y, x, p)
    logs = tobs.binom_logpmf(y, x, p)
    want = torch.amin(logs, dim=-1) if combine == "min" else torch.sum(logs, dim=-1)
    assert _bits_equal(got, want)
    assert _bits_equal(tobs.binomial_log_weight_reference(y, x, p, combine), want)
    assert _build.LAUNCHES == before


def test_binomial_weight_raises_off_the_cpu_and_the_card():
    lw = tobs.make_binomial_obs()
    meta = [torch.zeros(3, device="meta"), torch.zeros(2, 4, 3, device="meta"),
            torch.tensor(0.1, device="meta")]
    with pytest.raises(ValueError, match="no binomial observation weight"):
        lw(*meta)
    with pytest.raises(ValueError, match="no binomial observation weight"):
        lw(np.zeros(3, np.float32), np.zeros((2, 4, 3), np.float32), 0.1)
    y, x = _cloud()
    with pytest.raises(ValueError, match="no observation kernel"):
        obs_cuda.binomial_log_weight(y, x, torch.tensor(0.1))


def _bad(y, x, p):
    return {
        "x float64": ((y, x.double(), p), TypeError),
        "y float64": ((y.double(), x, p), TypeError),
        "p float64": ((y, x, p.double()), TypeError),
        "p a float": ((y, x, 0.1), TypeError),
        "x [N, C]": ((y, x[0], p), ValueError),
        "C past the kernel's": ((torch.zeros(128), torch.zeros(4, 2, 128), p), ValueError),
        "y of another C": ((torch.zeros(4), x, p), ValueError),
        "p [chains]": ((y, x, torch.full((4,), 0.1)), ValueError),
        "p [chains, N, 1]": ((y, x, torch.full((4, 32, 1), 0.1)), ValueError),
        "p of other chains": ((y, x, torch.full((5, 1, 1), 0.1)), ValueError),
        "p on another device": ((y, x, torch.tensor(0.1, device="meta")), ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad(*_cloud(), torch.tensor(0.1))))
def test_weight_kernel_wrapper_refuses_what_it_cannot_take_as_it_is(case):
    args, err = _bad(*_cloud(), torch.tensor(0.1))[case]
    with pytest.raises(err):
        obs_cuda._check(*args, "min")


def test_weight_kernel_wrapper_reads_p_at_its_stride_and_takes_strided_states():
    """The plain route's and the exact sampler's final states are strided
    views (``out[:, -1]``): taken, and made contiguous before the launch."""
    y, x = _cloud()
    assert obs_cuda._check(y, x, torch.tensor(0.1), "min") == 0
    assert obs_cuda._check(torch.zeros(6)[::2], torch.zeros(4, 2, 3, 3)[:, :, -1],
                           torch.tensor(0.1), "min") == 0
    assert obs_cuda._check(y, x, torch.full((4,), 0.1)[:, None, None], "sum") == 1
    assert obs_cuda._check(y, x, torch.full((8,), 0.1)[::2, None, None], "min") == 2
    with pytest.raises(ValueError, match="combine"):
        obs_cuda._check(y, x, torch.tensor(0.1), "max")


def test_weight_kernel_is_built_counted_and_declared():
    assert "obs.weight_launches" in profiling.COUNTERS
    assert "obs_binomial.cu" in _build.SOURCES
    src = (_build.CSRC / "obs_binomial.cu").read_text()
    assert int(re.search(r"kMaxC = (\d+);", src).group(1)) == obs_cuda.MAX_COMPARTMENTS
    assert obs_cuda.COMBINES == ("min", "sum") and "use_min = combine_mode == 0" in src
    assert _build.PROFILED["obs_weight"] == "obs.weight_launches"


def test_library_build_compiles_every_cuda_source(monkeypatch, tmp_path):
    seen = []

    def compile_(cmd, tmp, out):
        seen.append(cmd)
        return dict(seconds=0.0, ptxas="", path=str(out))

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "_compile", compile_)
    monkeypatch.setattr(_build, "BUILD_INFO", {})
    _build.build()
    (cmd,) = seen
    units = [a for a in cmd if a.endswith((".cu", ".cuh"))]
    assert units == [str(_build.CSRC / name) for name in
                     ("tauleap.cu", "obs_binomial.cu", "pf_loglik.cu", "pf_resample.cu")]
    assert "--fmad=false" in cmd and "-O3" in cmd and "arch=compute_90a,code=sm_90a" in cmd


# the kernel's device functions compiled for the host (g++, no contraction):
# one row of states through weigh_row<W, kMin>, as the kernel's thread does
HOST_HARNESS = """
template <bool kMin>
void rows(const float* y, const float* x, const float* p, long long p_stride, float* out,
          long long n_rows, long long n_per_chain, int c) {
  int w = 1;
  while (w * 2 <= c && w < 32) w *= 2;
  for (long long i = 0; i < n_rows; ++i) {
    const float pi = p[(i / n_per_chain) * p_stride];
    const float* row = x + i * c;
    switch (w) {
      case 1: out[i] = weigh_row<1, kMin>(y, row, c, pi); break;
      case 2: out[i] = weigh_row<2, kMin>(y, row, c, pi); break;
      case 4: out[i] = weigh_row<4, kMin>(y, row, c, pi); break;
      case 8: out[i] = weigh_row<8, kMin>(y, row, c, pi); break;
      case 16: out[i] = weigh_row<16, kMin>(y, row, c, pi); break;
      default: out[i] = weigh_row<32, kMin>(y, row, c, pi);
    }
  }
}
}  // namespace
extern "C" void weigh(const float* y, const float* x, const float* p, long long p_stride,
                      float* out, long long n_rows, long long n_per_chain, int c, int mode) {
  if (mode == 0) rows<true>(y, x, p, p_stride, out, n_rows, n_per_chain, c);
  else rows<false>(y, x, p, p_stride, out, n_rows, n_per_chain, c);
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on PATH to compile the kernel's device functions for the host")
    src = (_build.CSRC / "obs_binomial.cu").read_text()
    body = src[src.index("namespace {"):src.index("template <int W, bool kMin>\n__global__")]
    d = tmp_path_factory.mktemp("obs_host")
    (d / "obs.cpp").write_text("#include <cmath>\n#define __device__\n#define __forceinline__ "
                               "inline\n" + body + HOST_HARNESS)
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC", "-o",
                    str(d / "obs.so"), str(d / "obs.cpp")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(d / "obs.so"))
    v = ctypes.c_void_p
    lib.weigh.argtypes = [v, v, v, ctypes.c_longlong, v, ctypes.c_longlong, ctypes.c_longlong,
                          ctypes.c_int, ctypes.c_int]

    def weigh(y, x, p, combine):
        y, x, p = (t.contiguous() for t in (y, x, p))
        out = torch.empty(x.shape[:2])
        lib.weigh(y.data_ptr(), x.data_ptr(), p.data_ptr(), 0 if p.dim() == 0 else p.stride(0),
                  out.data_ptr(), out.numel(), x.shape[1], x.shape[2], ("min", "sum").index(combine))
        return out

    return weigh


def _aten_row(values, combine):
    """ATen's CUDA row reduction of one row (Reduce.cuh, C < 64): W lanes,
    lane t folds elements t, t + W, ... into accumulators from the identity,
    then shfl_down by W/2, W/4, ..., 1."""
    f = np.float32
    if combine == "min":
        ident, op = f(np.inf), (lambda a, b: a if (np.isnan(a) or a < b) else b)
    else:
        ident, op = f(0.0), (lambda a, b: f(a + b))
    w = 1
    while w * 2 <= len(values) and w < 32:
        w *= 2
    lanes = []
    for t in range(w):
        acc = [op(ident, values[e]) if e < len(values) else ident
               for e in (t, t + w, t + 2 * w, t + 3 * w)]
        part = acc[0]
        for a in acc[1:]:
            part = op(part, a)
        lanes.append(part)
    off = w // 2
    while off:
        lanes = [op(lanes[t], lanes[t + off]) if t + off < w else lanes[t] for t in range(w)]
        off //= 2
    return lanes[0]


@pytest.mark.parametrize("combine", ["min", "sum"])
@pytest.mark.parametrize("c", [3, 4])
def test_weight_kernel_functions_on_the_host_hold_to_the_twin(host_kernel, c, combine):
    """The kernel's arithmetic, compiled for the host, against the twin on
    the CPU: the same zeros, -inf and NaN; the rest within the CPU's own
    rounding of log (torch's vectorized log is not the C library's)."""
    for label, y, x, p in _edge_cases(c):
        got = host_kernel(y, x, p, combine)
        want = tobs.make_binomial_obs(combine)(y, x, p)
        for special in (torch.isnan, torch.isneginf, lambda t: t == 0):
            assert torch.equal(special(got), special(want)), label
        fin = torch.isfinite(want) & (want != 0)
        torch.testing.assert_close(got[fin], want[fin], rtol=2e-5, atol=2e-4, msg=label)


@pytest.mark.parametrize("combine", ["min", "sum"])
@pytest.mark.parametrize("c", [1, 2, 3, 4, 5, 6, 8, 12, 24, 36, 60])
def test_weight_kernel_reduces_rows_in_atens_order(host_kernel, c, combine):
    """The row's combine in ATen's order, bit for bit, on the kernel's own
    values of each compartment."""
    y, x = _cloud(3, 40, c, seed=c)
    x[0, 0, 0] = float("nan")
    p = torch.tensor([0.05, 0.1, 0.2])[:, None, None]
    got = host_kernel(y, x, p, combine)
    cols = torch.stack([host_kernel(y[j:j + 1], x[..., j:j + 1], p, combine)
                        for j in range(c)], -1).numpy()
    want = torch.tensor([[_aten_row(list(row), combine) for row in chain] for chain in cols])
    assert _bits_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("combine", ["min", "sum"])
@pytest.mark.parametrize("c", [3, 4, 6, 24])
def test_weight_kernel_equals_twin_on_card_at_the_edges(c, combine):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    lw = tobs.make_binomial_obs(combine)
    for label, y, x, p in _edge_cases(c, "cuda"):
        before = _build.LAUNCHES["obs_weight"]
        got = lw(y, x, p)
        assert _build.LAUNCHES["obs_weight"] == before + 1
        assert _bits_equal(got.cpu(), tobs._combine(tobs.binom_logpmf(y, x, p), combine).cpu()), \
            label
        strided = torch.stack([x, x], dim=2)[:, :, -1]  # the plain route's final-state slice
        assert _bits_equal(lw(y, strided, p).cpu(), got.cpu()), label


@pytest.mark.cuda
@pytest.mark.parametrize("chains,n", [(2048, 16), (32, 4096)])
def test_weight_kernel_equals_twin_on_card_on_tauleap_states(chains, n):
    """Both PMMH cells' shapes, every filter step's states from K4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from epitpu_torch.rng import PhiloxStream
    from epitpu_torch.sim.tauleap import advance

    model = sir_model()
    g = torch.Generator(device="cuda").manual_seed(11)
    x = model.init_fn(g, (chains, n), 4820, 20.0).to(torch.float32).contiguous()
    theta = torch.tensor([2.0, 1.0], device="cuda").expand(chains, 2)[:, None, :]
    y = torch.floor(x[0, :14] * 0.1)  # any counts in range
    stream, p = PhiloxStream(12, "cuda"), torch.tensor(0.1, device="cuda")
    for t in range(14):
        for combine in ("min", "sum"):
            got = tobs.make_binomial_obs(combine)(y[t], x, p)
            want = tobs._combine(tobs.binom_logpmf(y[t], x, p), combine)
            assert _bits_equal(got.cpu(), want.cpu()), (t, combine)
        x = advance(model, x, theta, stream, 20, "fast", g)
