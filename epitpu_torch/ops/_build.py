"""Builds the package's CUDA sources into shared libraries at first use.

``nvcc`` compiles ``epitpu_torch/csrc/tauleap.cu`` (the kernel template of
``tauleap_kernel.cuh`` on the hand-written functors), ``obs_binomial.cu``
(the binomial observation weight), ``pf_loglik.cu`` (the filter's
likelihood update) and ``pf_resample.cu`` (its systematic resampling step)
for Hopper (``sm_90a``) into one ``epitpu_torch/_build/libepitpu_kernels-<hash>.so``, a
plain C interface loaded with ``ctypes``; the file name carries a hash of
the sources and the flags, so an edited source builds anew.  No PyTorch
headers are compiled, which keeps the build to seconds.  ``ENTRIES`` holds
the ctypes signature of every C entry, and ``launch`` is the one way the
wrappers (``tauleap_cuda``, ``obs_cuda``, ``loglik_cuda``, ``resample_cuda``) call one: on the
card's current stream, its return code checked, counted in ``LAUNCHES``.

A model without a hand-written functor gets its own library: the functor
text ``epitpu_torch.ops.rate_trace.functor_source`` generates from the
model's rate function, after ``#include "tauleap_kernel.cuh"`` and before
one C entry ``epi_traj_generated``, is written to ``_build/<hash>.cu`` (by
way of a file of the building thread's own) and compiled into
``_build/libepitpu_gen-<hash>.so``, the hash over the header,
that text and the flags.  It takes only the repo's header and the generated
text; an nvcc failure raises with its output.

``--fmad=false`` and no ``--use_fast_math``: the kernels must round like
their plain torch twins, which neither contract multiply-adds nor use the
approximate ``__expf``/``__logf``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from .. import profiling

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("tauleap.cu", "tauleap_kernel.cuh", "obs_binomial.cu", "pf_loglik.cu",
           "pf_resample.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_LIB = None
BUILD_INFO = {}


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def nvcc_command(nvcc, sources, output, include=None):
    inc = [] if include is None else ["-I", str(include)]
    return [nvcc, *NVCC_FLAGS, *inc, "-o", str(output), *map(str, sources)]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libepitpu_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library of this hash exists; records
    the seconds and nvcc's resource report in ``BUILD_INFO``."""
    out = library_path()
    if out.exists():
        BUILD_INFO.setdefault("seconds", 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    units = [CSRC / name for name in SOURCES if name.endswith(".cu")]
    BUILD_INFO.update(_compile(nvcc_command(find_nvcc(), units, tmp), tmp, out))
    return out


def _compile(cmd, tmp, out):
    """Run nvcc; raise with its output on failure; move ``tmp`` to ``out``.
    Returns the seconds, nvcc's resource report and the path."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return dict(seconds=time.perf_counter() - t0, ptxas=proc.stderr.strip(), path=str(out))


# epi_traj's parameters after its family, k and transpose: all of the
# generated entry's (GENERATED_ENTRY)
_TRAJ_LAUNCH = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x0, theta, out
    ctypes.c_int, ctypes.c_int, ctypes.c_int,  # lanes, theta stride, lanes per theta
    ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,  # key0, key1, offset
    ctypes.c_uint32, ctypes.c_uint32,  # lane map: chain offset, local particles per chain
    ctypes.c_uint32, ctypes.c_uint32,  # lane map: total particles per chain, particle offset
    ctypes.c_int, ctypes.c_int, ctypes.c_float,  # t_max, n_sub, dt
    ctypes.c_int,  # final_only
    ctypes.c_int, ctypes.c_int, ctypes.c_int,  # group, threads per block, blocks
    ctypes.c_void_p,  # cudaStream_t
)
# the ctypes signature of every C entry, in its parameter order: each
# ``extern "C"`` entry of SOURCES' ``.cu`` files, and the generated one
ENTRIES = {
    "epi_traj": (ctypes.c_int, ctypes.c_int, ctypes.c_int) + _TRAJ_LAUNCH,  # family, k, transpose
    "epi_obs_binomial": (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # y, x, p
        ctypes.c_longlong, ctypes.c_void_p,  # p's stride between chains, out
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,  # rows, rows a chain, compartments
        ctypes.c_int,  # combine: 0 min, 1 sum
        ctypes.c_void_p,  # cudaStream_t
    ),
    "epi_pf_loglik": (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # logw, lw (or null), log_z
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # log_z', lw' (or null), degen
        ctypes.c_longlong, ctypes.c_int, ctypes.c_double,  # rows, N, log N
        ctypes.c_void_p,  # cudaStream_t
    ),
    "epi_pf_resample": (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # lw, u, skip, x
        ctypes.c_void_p, ctypes.c_void_p,  # anc, x_res
        ctypes.c_void_p, ctypes.c_void_p,  # lw_next (null with skip), scratch (or null)
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int,  # rows, N, C
        ctypes.c_int, ctypes.c_int, ctypes.c_double,  # p0, n_local, log N
        ctypes.c_void_p,  # cudaStream_t
    ),
    "epi_traj_generated": _TRAJ_LAUNCH,
}
GENERATED = "epi_traj_generated"

# the hand-written kernels' launches in this process: K4's by family
# (tauleap_cuda.FAMILIES) and on generated functors, the binomial weighting's
# ("obs_weight"), the likelihood update's ("pf_loglik") and the resampling
# step's ("pf_resample"); "plain" counts the calls of K4's twin on the card
# (tauleap_cuda.route), which launch none
LAUNCHES = dict.fromkeys(("sir", "seir", "sir_subgroups", "generated", "plain", "obs_weight",
                          "pf_loglik", "pf_resample"), 0)
# the epitpu_torch.profiling counter a launch adds to as well
PROFILED = {"obs_weight": "obs.weight_launches", "pf_loglik": "pf.loglik_launches",
            "pf_resample": "pf.resample_launches",
            **dict.fromkeys(("sir", "seir", "sir_subgroups", "generated"), "k4.launches")}


def bind(lib, *names):
    """``lib`` with the ctypes signature of each entry of ``names`` set from ``ENTRIES``."""
    for name in names:
        entry = getattr(lib, name)
        entry.argtypes = list(ENTRIES[name])
        entry.restype = ctypes.c_int
    return lib


def launch(entry, key, device, *args):
    """Launch the C entry ``entry`` (set by ``bind``) with ``args`` and the
    current stream of ``device``'s card, made current for the call if it is
    not; raise naming the entry on a nonzero return (a CUDA error), else
    count the launch in ``LAUNCHES[key]`` and its ``PROFILED`` counter."""
    index, current = device.index, torch.cuda.current_device()
    if index != current:
        torch.cuda.set_device(index)
    try:
        rc = entry(*args, torch.cuda.current_stream(index).cuda_stream)
    finally:
        if index != current:
            torch.cuda.set_device(current)
    if rc != 0:
        raise RuntimeError(f"{entry.__name__} launch ({key}) failed with CUDA error {rc}")
    LAUNCHES[key] += 1
    if key in PROFILED:
        profiling.count(PROFILED[key])


GENERATED_ENTRY = """
extern "C" int epi_traj_generated(const void* x0, const void* theta, void* out, int lanes,
                                  int theta_stride, int lanes_per_theta, uint32_t k0,
                                  uint32_t k1, uint32_t offset, uint32_t lane_c0,
                                  uint32_t lane_n_local, uint32_t lane_n_total,
                                  uint32_t lane_p0, int t_max, int n_sub, float dt,
                                  int final_only, int group, int threads, int blocks,
                                  void* stream) {
  if (lanes <= 0) return 0;
  const Launch l{static_cast<const float*>(x0), static_cast<const float*>(theta),
                 static_cast<float*>(out), lanes, theta_stride, lanes_per_theta, k0, k1,
                 offset, lane_c0, lane_n_local, lane_n_total, lane_p0, t_max, n_sub, dt,
                 final_only, group, threads, blocks, static_cast<cudaStream_t>(stream)};
  return launch<GeneratedModel>(l);
}
"""
GENERATED_INFO = {}  # library path -> BUILD_INFO's fields for its build
_GENERATED = {}  # library path -> loaded ctypes library


def generated_source(functor: str) -> str:
    """The ``.cu`` text for a generated functor (``rate_trace.functor_source``)."""
    return ('// generated by epitpu_torch/ops/_build.py\n#include "tauleap_kernel.cuh"\n\n'
            + functor + GENERATED_ENTRY)


def generated_path(functor: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / SOURCES[1]).read_bytes())
    h.update(generated_source(functor).encode())
    return BUILD_DIR / f"libepitpu_gen-{h.hexdigest()[:16]}.so"


def build_generated(functor: str) -> Path:
    """Compile a generated functor's library unless one of its hash exists;
    records the build in ``GENERATED_INFO``.  Safe to call from several
    threads or processes at once, for the same functor too: each nvcc run
    reads a source and writes a library of its own, moved into place
    (``<hash>.cu`` keeps the text, also after an nvcc failure)."""
    out = generated_path(functor)
    if out.exists():
        GENERATED_INFO.setdefault(str(out), dict(seconds=0.0, ptxas="", path=str(out)))
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = out.name[len("libepitpu_gen-"):-len(".so")]
    own = f"{os.getpid()}.{threading.get_ident()}"
    src, tmp_src = BUILD_DIR / f"{stem}.cu", BUILD_DIR / f"{stem}.{own}.cu"
    tmp_src.write_text(generated_source(functor))
    tmp = out.with_suffix(f".{own}.tmp")
    try:
        GENERATED_INFO[str(out)] = _compile(nvcc_command(find_nvcc(), [tmp_src], tmp, CSRC),
                                            tmp, out)
    finally:
        os.replace(tmp_src, src)
    return out


def load_generated(functor: str):
    """The generated functor's library (built at first use), with
    ``GENERATED``'s ctypes signature set."""
    path = build_generated(functor)
    lib = _GENERATED.get(str(path))
    if lib is None:
        lib = _GENERATED[str(path)] = bind(ctypes.CDLL(str(path)), GENERATED)
    return lib


def load_library():
    """The built library with every entry point's ctypes signature set."""
    global _LIB
    if _LIB is None:
        _LIB = bind(ctypes.CDLL(str(build())), *(n for n in ENTRIES if n != GENERATED))
    return _LIB
