"""The one seam to the hand-written kernels (``epitpu_torch.ops._build``): the
ctypes signature of every C entry against its source, and ``launch``'s
stream, return-code check and count with a stand-in entry."""
import ctypes
import re
import types

import pytest
import torch

from epitpu_torch import profiling
from epitpu_torch.models import sir_model
from epitpu_torch.ops import _build, rate_trace

C_TYPES = {"int": ctypes.c_int, "uint32_t": ctypes.c_uint32, "float": ctypes.c_float,
           "long long": ctypes.c_longlong, "double": ctypes.c_double}
PARAMS = {"epi_traj": 24, "epi_traj_generated": 21, "epi_obs_binomial": 10, "epi_pf_loglik": 10,
          "epi_pf_resample": 15}


def _entries(text):
    """{name: [parameter, ...]} of each ``extern "C" int epi_...(`` in ``text``."""
    return {m.group(1): [p.strip() for p in m.group(2).split(",")]
            for m in re.finditer(r'extern "C" int (epi_\w+)\(([^)]*)\)', text)}


def _library_entries():
    return {name: params for unit in _build.SOURCES if unit.endswith(".cu")
            for name, params in _entries((_build.CSRC / unit).read_text()).items()}


def _generated_source():
    return _build.generated_source(rate_trace.functor_source(sir_model()))


def test_every_c_entry_has_a_signature():
    """A new ``.cu`` in SOURCES, or a new entry in one, needs its row in
    ``ENTRIES``: the library would load it without argtypes."""
    generated = _entries(_generated_source())
    assert list(generated) == [_build.GENERATED]
    assert set(_library_entries()) | set(generated) == set(_build.ENTRIES)


@pytest.mark.parametrize("name", sorted(_build.ENTRIES))
def test_entry_argtypes_match_the_source(name):
    """ctypes passes each argument as the type it is told; a parameter added
    to a C entry and not to its row would show only on the card, as garbage
    in every later argument."""
    src = _generated_source() if name == _build.GENERATED else ""
    params = (_entries(src) if src else _library_entries())[name]
    want = [ctypes.c_void_p if "*" in p else C_TYPES[p.rsplit(None, 1)[0]] for p in params]
    assert len(params) == PARAMS[name]
    assert list(_build.ENTRIES[name]) == want
    if src:
        assert '#include "tauleap_kernel.cuh"' in src


@pytest.mark.cuda
def test_load_library_sets_every_entrys_signature_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the library is built by nvcc on the card's machine")
    lib = _build.load_library()
    for name in _library_entries():
        assert getattr(lib, name).argtypes == list(_build.ENTRIES[name]), name
        assert getattr(lib, name).restype is ctypes.c_int


@pytest.fixture
def card(monkeypatch):
    """Card 0 current, its stream 0x5eed, without a card; the cards made
    current are recorded."""
    state = types.SimpleNamespace(current=0, set=[])

    def set_device(index):
        state.set.append(index)
        state.current = index

    monkeypatch.setattr(torch.cuda, "current_device", lambda: state.current)
    monkeypatch.setattr(torch.cuda, "set_device", set_device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda index: types.SimpleNamespace(cuda_stream=0x5eed + index))
    return state


def _stand_in(rc, calls, card):
    def epi_stand_in(*args):
        calls.append((card.current, args))
        return rc

    return epi_stand_in


@pytest.mark.parametrize("key", ["sir", "obs_weight", "pf_loglik", "pf_resample"])
def test_launch_passes_the_stream_and_counts_once(card, key):
    calls = []
    before = dict(_build.LAUNCHES)
    with profiling.recording() as rec:
        _build.launch(_stand_in(0, calls, card), key, torch.device("cuda", 0), 7, None)
        _build.launch(_stand_in(0, calls, card), key, torch.device("cuda", 1), 8, None)
    assert calls == [(0, (7, None, 0x5eed)), (1, (8, None, 0x5eed + 1))]
    assert card.set == [1, 0] and card.current == 0  # card 1 made current, then card 0 again
    assert _build.LAUNCHES == dict(before, **{key: before[key] + 2})
    assert rec.counters == ({_build.PROFILED[key]: 2} if key in _build.PROFILED else {})


def test_launch_raises_naming_the_kernel_and_counts_nothing(card):
    before = dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError, match=r"epi_stand_in launch \(pf_loglik\) failed with "
                                           r"CUDA error 700"):
        _build.launch(_stand_in(700, [], card), "pf_loglik", torch.device("cuda", 2))
    assert _build.LAUNCHES == before and card.current == 0
