"""PMMH traffic: chains x particles of the program's chain-batched sampler,
driven in segments as the runner drives it.

A traffic file of this driver names ``chains``, ``particles``,
``store_trajectories``, ``segment_len`` (rows a call), ``warmup_rows`` (the
set-up's first call, the init search and adaptation start among them),
``trace_segments`` (calls under the profiler in a ``--trace 1`` run),
``check_rows`` (window rows recomputed by the reference) and
``k4_ops_per_draw``.  The configuration gives the data, the model, the
observation and the sampler's settings.

Every call after the first continues from the previous call's
``final_state`` with ``segment_len`` rows (epitpu_torch/cli/run.py:
``_run_pmmh_segmented``); the history stays on the device until the window
has closed.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import ess, roofline
from ..trace import k4_kernels
from ..reference import pmmh as ref_pmmh
from . import common

# rows a chain may run: the window ends long before
N_ITERS = 10 ** 7
# bins of the gaps logged beside the number compared
LL_BINS = (0.0, 1e-6, 1e-4, 1e-3, 1e-2, 1e-1, float("inf"))
TRAJ_BINS = (0.0, 1.0, 5.0, 50.0, float("inf"))


def _bins(values, edges):
    """``{"<=edge": count}`` of ``values`` over the ascending ``edges``."""
    out, prev = {}, None
    for e in edges:
        inside = values <= e if prev is None else (values > prev) & (values <= e)
        out[f"<={e:g}"] = int(inside.sum())
        prev = e
    return out


class Driver:
    kind = "pmmh"

    def __init__(self, config, traffic, seed, device):
        import epitpu_torch.models as program_models
        from epitpu_torch.mcmc import particle_mcmc_chains
        from epitpu_torch.observe import get_observation_model

        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.ref_model = common.reference_module("model", config["model"])
        self.y_np = common.observations(config, self.ref_model)
        self.y = torch.as_tensor(self.y_np, device=device)
        s = config["sampler"]
        model = getattr(program_models, config["program_model"])()
        obs = get_observation_model(config["observation"])
        kwargs = dict(
            parameters=list(s["parameters"]), h=s["h"], seed=seed, device=device,
            n_chains=traffic["chains"], adaptive=s["adaptive"], adapt_start=s["adapt_start"],
            n_iters=N_ITERS, obs_param=s["obs_param"], n_particles=traffic["particles"],
            n_population=s["n_population"], mu=s["mu"], steps_per_unit=s["steps_per_unit"],
            resampling=s["resampling"], resample_every=s["resample_every"],
            sampler=s["sampler"], n_init_attempts=s["n_init_attempts"],
            pooled_adaptation=s["pooled_adaptation"],
            store_trajectories=traffic["store_trajectories"],
        )
        self.call = lambda **kw: particle_mcmc_chains(model, obs, self.y, **kwargs, **kw)
        self.history = []
        self.state = None

    def _segment(self, rows):
        res = self.call(init_state=self.state, segment_len=rows)
        self.history.append((res.thetas, res.log_likelihoods, res.sampled_trajs))
        self.state = res.final_state

    def warm_up(self):
        """The init search and the first ``warmup_rows`` rows, at the
        window's shapes."""
        self._segment(self.traffic["warmup_rows"])
        common.synchronize(self.device)

    def window(self, seconds):
        """Segments until ``seconds`` have passed; (rows a chain, seconds),
        the window ended by a synchronize after the last whole segment."""
        seg = self.traffic["segment_len"]
        rows = 0
        self.window_start = sum(h[0].shape[1] for h in self.history)
        t0 = time.perf_counter()
        marks = [t0]
        while True:
            self._segment(seg)
            rows += seg
            marks.append(time.perf_counter())
            if marks[-1] - t0 >= seconds:
                break
        common.synchronize(self.device)
        t1 = time.perf_counter()
        calls = np.diff(marks)
        common.log(f"{len(calls)} segment calls, host seconds each: min {calls.min():.4f} "
                   f"median {np.median(calls):.4f} max {calls.max():.4f}")
        return rows, t1 - t0

    def traced_window(self):
        """``trace_segments`` more segments; the rows a chain they made."""
        rows = self.traffic["trace_segments"] * self.traffic["segment_len"]
        for _ in range(self.traffic["trace_segments"]):
            self._segment(self.traffic["segment_len"])
        return rows

    def collect(self):
        """The program's rows from row 0 on the host, and its device state
        freed."""
        thetas, lls, trajs = (torch.cat(parts, dim=1).cpu() for parts in zip(*self.history))
        self.history, self.state = [], None
        self.rows = {"thetas": thetas, "lls": lls, "trajs": trajs}

    # --- what the window did -------------------------------------------------

    def attempted(self, rows):
        return rows * self.traffic["chains"]

    def failed(self):
        window = slice(self.window_start, None)
        bad = ~torch.isfinite(self.rows["thetas"][:, window]).all(-1)
        bad |= torch.isnan(self.rows["lls"][:, window])
        return int(bad.sum())

    def facts(self, rows):
        """The untraced window's numbers the end-to-end readers take."""
        thetas = self.rows["thetas"][:, self.window_start:self.window_start + rows].numpy()
        return {"chain_rows": rows * self.traffic["chains"],
                "ess_min": ess.min_ess_rank(thetas)}

    def trace_facts(self, trace, rows):
        """The traced window's numbers the per-layer readers take."""
        t = self.traffic
        steps = rows * (self.y_np.shape[0] - 1)
        k4 = self.config["k4"]
        lanes = t["chains"] * t["particles"]
        n_sub = self.config["sampler"]["steps_per_unit"]
        return {
            "pmmh_rows": rows, "traced_chain_rows": rows * t["chains"], "filter_steps": steps,
            "k4_bound_s": steps * roofline.bound_s(
                roofline.ops(lanes, n_sub, k4["reactions"], k4["groups"], t["k4_ops_per_draw"]),
                roofline.nbytes(lanes, t["chains"], k4["compartments"], k4["theta_dim"], 1)),
            "k4_device_s": 1e-6 * trace.kernel_us(k4_kernels()),
        }

    # --- correctness -----------------------------------------------------------

    def check_rows(self):
        """Window rows the reference recomputes, drawn from the seed."""
        first, last = self.window_start, self.rows["thetas"].shape[1]
        rng = np.random.default_rng([self.seed, 1])
        count = min(self.traffic["check_rows"], last - first)
        return sorted(int(r) for r in rng.choice(np.arange(first, last), count, replace=False))

    def spec(self):
        s, t = self.config["sampler"], self.traffic
        return ref_pmmh.PMMHSpec(
            model=self.ref_model,
            obs=common.reference_module("obs", self.config["observation"]),
            chains=t["chains"], particles=t["particles"], parameters=tuple(s["parameters"]),
            h=s["h"], adaptive=s["adaptive"], adapt_start=s["adapt_start"],
            pooled=s["pooled_adaptation"], resample_every=s["resample_every"],
            steps_per_unit=s["steps_per_unit"], obs_param=s["obs_param"],
            n_population=s["n_population"], mu=s["mu"],
            store_trajectories=t["store_trajectories"])

    def reference(self, rows, dtype=torch.float32):
        """The reference's rows ``rows``, each from the program's row before."""
        upto = max(rows)
        on = lambda t: t[:, :upto].to(self.device)
        trajs = on(self.rows["trajs"]) if self.traffic["store_trajectories"] else None
        return ref_pmmh.replay_rows(self.spec(), self.y_np, self.seed, rows,
                                    on(self.rows["thetas"]), on(self.rows["lls"]), trajs,
                                    dtype)

    def program_rows(self, rows):
        """The program's rows ``rows`` in the reference's form."""
        trajs = self.traffic["store_trajectories"]
        return {i: tuple(t[:, i].to(self.device) if t is not None else None
                         for t in (self.rows["thetas"], self.rows["lls"],
                                   self.rows["trajs"] if trajs else None))
                for i in rows}

    def compare(self, reference, program):
        """``row_mismatch_pct``: the share of checked chain-rows where the
        program's theta differs from the reference's by more than 1e-5
        relative, its log-likelihood by more than 1e-3 relative, or, where
        the log-likelihoods are equal, its trajectory by an event."""
        bad = total = 0
        gaps = {"theta": 0, "ll": [], "traj": []}
        for i, (theta, ll, traj) in reference.items():
            p_theta, p_ll, p_traj = program[i]
            miss_theta = (torch.abs(theta - p_theta) > 1e-5 * (1.0 + torch.abs(theta))).any(-1)
            miss_theta |= torch.isnan(p_theta).any(-1)
            rel = torch.where(ll == p_ll, torch.zeros_like(ll),
                              torch.abs(ll - p_ll) / torch.clamp(torch.abs(ll), min=1.0))
            rel = torch.nan_to_num(rel, nan=float("inf"))
            miss = miss_theta | (rel > 1e-3)
            gaps["theta"] += int(miss_theta.sum())
            gaps["ll"].append(rel)
            if traj is not None:
                # a path is one lineage drawn from the filter's weights: where
                # the filter rounded otherwise than the reference (ll not equal
                # bit for bit) it may rightly take another lineage, and the ll
                # judges that row
                t_gap = torch.abs(traj - p_traj).flatten(1).amax(-1)
                gaps["traj"].append(t_gap)
                miss |= (ll == p_ll) & (t_gap > 0.5)
            bad += int(miss.sum())
            total += miss.numel()
        common.log(f"{bad} of {total} chain-rows differ; theta {gaps['theta']}; "
                   f"ll relative gap by bin {_bins(torch.cat(gaps['ll']), LL_BINS)}"
                   + (f"; trajectory gap by bin {_bins(torch.cat(gaps['traj']), TRAJ_BINS)}"
                      if gaps["traj"] else ""))
        return {"row_mismatch_pct": 100.0 * bad / max(total, 1)}

    def readings(self, control_dtype=None):
        """The numbers compared for the program's rows and, with a
        ``control_dtype``, for the reference computed in that precision put
        in the program's place (the control)."""
        rows = self.check_rows()
        reference = self.reference(rows)
        sound = self.compare(reference, self.program_rows(rows))
        if control_dtype is None:
            return sound, None
        low = {i: tuple(None if t is None else t.float() for t in v)
               for i, v in self.reference(rows, control_dtype).items()}
        return sound, self.compare(reference, low)
