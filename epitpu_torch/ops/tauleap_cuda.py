"""Per-lane tau-leap trajectories: the CUDA kernel and its plain torch twin.

``simulate_lanes`` advances ``B`` independent (theta, x0) lanes through
``t_max * n_sub`` substeps of length ``dt`` (default ``1 / n_sub``) and
records the state at every integer time, ``[B, t_max+1, C]`` -- the layout
of ``epitpu.ops.pallas_simulate`` -- or, with ``final_only``, only the state
at ``t_max``, ``[B, C]``.  Consecutive lanes may share a theta row
(``lanes_per_theta``).  Its callers are the particle filter's propagation
(``t_max=1``, final state only, one theta row per chain, one launch per
filter step, through ``epitpu_torch.sim.tauleap.advance``), the posterior
forecast, ABC rejection (one launch per candidate batch) and the app.  A
shard of a sharded filter step (``epitpu_torch.dist``) passes a
``lane_map`` so that its lanes draw the bits the same particles draw in the
unsharded launch (``epitpu_torch.rng.lane_map_ids``).

On a CPU tensor it runs ``simulate_lanes_reference``, the plain twin on the
same Philox counters.  On a CUDA tensor the model's structure picks one of
three routes before anything is launched (``route``), as epitpu picks its
Pallas kernel or its XLA scan (``epitpu/ops/tauleap_pallas.py:
pallas_simulate_supported``):

* ``"hand"``: a built-in family (``model.kernel``: SIR, SEIR, or K-group SIR
  with K up to ``MAX_GROUPS``, either dynamics) launches
  ``csrc/tauleap.cu``'s hand-written functor;
* ``"generated"``: any other model whose reactions have unique sources
  (K-group SIR past ``MAX_GROUPS`` too) launches the kernel on a functor
  traced from its own ``rate_fn`` (``rate_trace``, built by ``_build``);
* ``"plain"``: a model whose reactions share a source (competing hazards),
  which epitpu never gives its kernel, runs the twin on the card: the
  declared counterpart of epitpu's XLA scan, not a fallback.

A launch that fails raises; nothing retries on another route.
``_build.LAUNCHES`` counts the kernel launches per family (and
``"generated"``) and the plain route's calls (``"plain"``); ``launches()``
sums the kernel launches.  While a recording is open or a profiler runs, a
launch adds to the counters ``k4.launches``, ``k4.thread_slots`` and
``k4.reaction_slots`` (``draw_slots``); the plain route counts none.
"""
from __future__ import annotations

import functools
import math
import weakref

import torch

from .. import profiling
from ..models.base import CompartmentModel
from ..rng import lane_draws, seed_key
from ..sim.samplers import binomial_from_draws
from ..sim.tauleap import n_draw_slots, substep
from . import _build

# model families with a hand-written functor, by their id in csrc/tauleap.cu
FAMILIES = ("sir", "seir", "sir_subgroups")
KERNEL_PATHS = FAMILIES + ("generated",)  # the _build.LAUNCHES keys of K4's launches
MAX_GROUPS = 8  # csrc/tauleap.cu:kMaxGroups
MAX_THREADS = 256  # per block, csrc/tauleap_kernel.cuh:kMaxThreads
WARP = 32  # threads a warp, and at most a lane's; csrc/tauleap_kernel.cuh:kWarp


def launches():
    """Kernel launches so far, every family and generated functor."""
    return sum(_build.LAUNCHES[p] for p in KERNEL_PATHS)


def route(model: CompartmentModel) -> str:
    """The path ``model`` takes on the card, from its structure alone:
    ``"hand"`` for a ``KernelSpec`` family (subgroups up to ``MAX_GROUPS``),
    else ``"generated"`` when no two reactions share a source, else
    ``"plain"``."""
    spec = model.kernel
    if spec is not None:
        if spec.family not in FAMILIES:
            raise ValueError(f"unknown kernel family {spec.family!r}; options {FAMILIES}")
        if spec.family != "sir_subgroups" or 1 <= spec.k <= MAX_GROUPS:
            return "hand"
    return "generated" if model.sources_unique else "plain"


def _warps(lanes: int, group: int) -> int:
    """The warps that hold ``lanes`` lanes of ``group`` threads, ``WARP //
    group`` lanes a warp."""
    return -(-int(lanes) // (WARP // group))


def launch_geometry(reactions: int, lanes: int, sms: int = 132):
    """``(group, threads, blocks)`` of one launch of a model with
    ``reactions`` reactions (``model.num_reactions``): ``group`` threads per
    lane (one a reaction, at most ``WARP``; a thread of a larger model
    draws reactions t, t + 32, ...), ``WARP // group`` lanes a warp and the
    warp's other threads idle, ``threads`` per block (256, or fewer when 256
    would give fewer blocks than the card's ``sms`` multiprocessors, down to
    one warp), and the blocks that cover the warps holding ``lanes`` lanes
    with no empty block.  For a power of two ``group`` that is ``lanes x
    group`` threads."""
    group = min(int(reactions), WARP)
    need = _warps(lanes, group) * WARP
    threads = 32
    for t in (MAX_THREADS, 128, 64):
        if -(-need // t) >= sms:
            threads = t
            break
    return group, threads, max(1, -(-need // threads))


def draw_slots(reactions: int, lanes: int, group: int):
    """``(thread slots, reaction slots)`` of one launch of ``lanes`` lanes
    in groups of ``group`` threads (``launch_geometry``): a thread draws in
    passes of its lane's reactions t, t + group, ..., so each thread of a
    warp that holds lanes has one slot a pass, and ``reactions`` slots of
    each lane draw."""
    passes = -(-reactions // group)
    return _warps(lanes, group) * WARP * passes, lanes * reactions


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def simulate_lanes_reference(model: CompartmentModel, x0, theta, seed: int,
                             offset: int, t_max: int, n_sub: int,
                             final_only: bool = False, lanes_per_theta: int = 1,
                             work=None, lane_map=None, dt=None):
    """Plain torch twin of the kernel, for any model: ``substep`` of length
    ``dt`` (default ``1 / n_sub``) on the (uniform, normal) pairs of counter
    (lane, offset, substep, slot), the lane word through ``lane_map``
    (identity when None).  ``final_only`` slices the last row,
    ``lanes_per_theta`` repeats each theta row.  A ``work`` dict, if given,
    accumulates the draws, the draws of the small regime and their CDF terms
    (``binomial_from_draws``)."""
    if lanes_per_theta != 1:
        theta = theta.repeat_interleave(lanes_per_theta, dim=0)
    b = x0.shape[0]
    u, z = lane_draws(seed, offset, range(t_max * n_sub), b,
                      n_draw_slots(model), device=x0.device, lane_map=lane_map)
    dt = 1.0 / n_sub if dt is None else dt
    x = x0
    out = [x]
    step = 0
    for _ in range(t_max):
        for _ in range(n_sub):
            us, zs = u[step], z[step]

            def draw(n, p, slot, us=us, zs=zs):
                k = n.shape[-1]
                return binomial_from_draws(us[:, slot:slot + k], zs[:, slot:slot + k], n, p,
                                           work)

            x = substep(model, x, theta, dt, draw)
            step += 1
        out.append(x)
    out = torch.stack(out, dim=1)
    return out[:, -1] if final_only else out


def hand_args(model: CompartmentModel):
    """The C entry ``epi_traj``'s ``(family id, k, transpose)`` for a model
    on the ``"hand"`` route."""
    if route(model) != "hand":
        raise ValueError(f"model {model.name!r} has no hand-written functor "
                         f"(route {route(model)!r})")
    spec = model.kernel
    return FAMILIES.index(spec.family), int(spec.k), int(spec.transpose)


_ENTRIES = weakref.WeakKeyDictionary()  # model -> (C entry, its leading arguments, key)


def _entry(model: CompartmentModel, path: str):
    """``model``'s C entry on route ``path``, the arguments that lead its
    own and its ``_build.LAUNCHES`` key; kept for the model's lifetime, a
    generated functor traced and built at first use."""
    hit = _ENTRIES.get(model)
    if hit is None:
        if path == "hand":
            hit = (_build.load_library().epi_traj, hand_args(model), model.kernel.family)
        else:
            from . import rate_trace

            lib = _build.load_generated(rate_trace.functor_source(model))
            hit = (lib.epi_traj_generated, (), "generated")
        _ENTRIES[model] = hit
    return hit


IDENTITY_LANE_MAP = (0, 1, 1, 0)


def _check_lane_map(lane_map, b):
    """``lane_map = (chain_offset, n_local, n_total, particle_offset)`` must
    cover ``b`` lanes with whole chains and keep every lane word in 32 bits
    (the C entry refuses the same maps)."""
    c0, n_local, n_total, p0 = (int(v) for v in lane_map)
    if min(c0, p0) < 0 or n_local < 1 or n_total < n_local or p0 + n_local > n_total:
        raise ValueError(f"lane map {tuple(lane_map)} is not (chain offset >= 0, n_local >= 1, "
                         "n_total >= particle offset + n_local)")
    if b % n_local:
        raise ValueError(f"lane map {tuple(lane_map)}: n_local does not divide B={b}")
    if b and (c0 + b // n_local - 1) * n_total + p0 + n_local - 1 > 0xFFFFFFFF:
        raise ValueError(f"lane map {tuple(lane_map)}: lane words past 32 bits for B={b}")


def _check(model, x0, theta, offset, t_max, n_sub, lanes_per_theta, dt):
    if x0.dtype != torch.float32 or theta.dtype != torch.float32:
        raise TypeError(f"x0 and theta must be float32, got {x0.dtype}, {theta.dtype}")
    if x0.dim() != 2 or x0.shape[1] != model.num_compartments:
        raise ValueError(f"x0 must be [B, {model.num_compartments}], got {tuple(x0.shape)}")
    lpt = int(lanes_per_theta)
    if lpt < 1 or x0.shape[0] % lpt:
        raise ValueError(f"lanes_per_theta={lanes_per_theta} does not divide B={x0.shape[0]}")
    if theta.shape != (x0.shape[0] // lpt, model.theta_dim):
        raise ValueError(
            f"theta must be [{x0.shape[0] // lpt}, {model.theta_dim}] (one row per "
            f"{lpt} lanes), got {tuple(theta.shape)}"
        )
    if theta.device != x0.device:
        raise ValueError(f"x0 on {x0.device} but theta on {theta.device}")
    if not (0 <= int(offset) <= 0xFFFFFFFF) or int(t_max) < 0 or int(n_sub) < 1:
        raise ValueError(f"bad offset/t_max/n_sub: {offset}, {t_max}, {n_sub}")
    if dt is not None and not (math.isfinite(float(dt)) and float(dt) > 0):
        raise ValueError(f"dt must be a positive number, got {dt}")


def simulate_lanes(model: CompartmentModel, x0, theta, seed: int, offset: int,
                   t_max: int, n_sub: int = 20, final_only: bool = False,
                   lanes_per_theta: int = 1, lane_map=None, dt=None):
    """x0 ``[B, C]`` float32, theta ``[B / lanes_per_theta, d]`` float32
    (lane b reads row ``b // lanes_per_theta``), ``seed`` a 64-bit int,
    ``offset`` the Philox call offset -> ``[B, t_max+1, C]``, or ``[B, C]``
    (the state at ``t_max``) with ``final_only``.  Each of the ``n_sub``
    substeps of a unit is ``dt`` long (default ``1 / n_sub``).  ``lane_map``
    (chain offset, local particles per chain, total particles per chain,
    particle offset) sets the counter's lane words; None is the identity.
    On a CUDA tensor the model's ``route`` decides what runs."""
    _check(model, x0, theta, offset, t_max, n_sub, lanes_per_theta, dt)
    dt = 1.0 / int(n_sub) if dt is None else float(dt)
    lane_map = IDENTITY_LANE_MAP if lane_map is None else tuple(int(v) for v in lane_map)
    _check_lane_map(lane_map, x0.shape[0])
    t_max, n_sub, lpt = int(t_max), int(n_sub), int(lanes_per_theta)
    if x0.device.type == "cpu":
        return simulate_lanes_reference(model, x0, theta, seed, offset, t_max, n_sub,
                                        final_only, lpt, lane_map=lane_map, dt=dt)
    if x0.device.type != "cuda":
        raise ValueError(f"no tau-leap kernel for device {x0.device}")
    path = route(model)
    if path == "plain":
        out = simulate_lanes_reference(model, x0, theta, seed, offset, t_max, n_sub,
                                       final_only, lpt, lane_map=lane_map, dt=dt)
        _build.LAUNCHES["plain"] += 1
        return out
    if not (x0.is_contiguous() and theta.is_contiguous()):
        raise ValueError("x0 and theta must be contiguous")
    entry, lead, key = _entry(model, path)
    b, c_dim = x0.shape
    rows = (b, c_dim) if final_only else (b, t_max + 1, c_dim)
    out = torch.empty(rows, dtype=torch.float32, device=x0.device)
    if b == 0:
        return out
    group, threads, blocks = launch_geometry(model.num_reactions, b,
                                             _sm_count(x0.device.index))
    k0, k1 = seed_key(seed)
    _build.launch(entry, key, x0.device, *lead, x0.data_ptr(), theta.data_ptr(), out.data_ptr(),
                  b, theta.shape[1], lpt, k0, k1, int(offset), *lane_map, t_max, n_sub, dt,
                  int(final_only), group, threads, blocks)
    thread_slots, reaction_slots = draw_slots(model.num_reactions, b, group)
    profiling.count("k4.thread_slots", thread_slots)
    profiling.count("k4.reaction_slots", reaction_slots)
    return out
