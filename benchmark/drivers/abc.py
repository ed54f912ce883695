"""ABC traffic: calls of the program's ABC rejection sampler, one after
another, each asking for ``n_samples`` accepted samples in candidate batches
of ``batch_size``.

A traffic file of this driver names ``batch_size``, ``n_samples``,
``warmup_calls``, ``trace_calls`` (calls under the profiler in a ``--trace
1`` run), ``check_calls`` (calls of the window the reference recomputes,
drawn from the seed) and ``k4_ops_per_draw``.  Call ``k`` of the window
takes the seed ``stream_seed(seed, k)``; the warm-up calls take negative
``k``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import roofline
from ..trace import k4_kernels
from ..reference import abc as ref_abc
from . import common


class Driver:
    kind = "abc"

    def __init__(self, config, traffic, seed, device):
        import epitpu_torch.models as program_models
        from epitpu_torch.abc import abc_rejection

        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.ref_model = common.reference_module("model", config["model"])
        self.observed = torch.as_tensor(common.observations(config, self.ref_model),
                                        device=device)
        a = config["abc"]
        model = getattr(program_models, config["program_model"])()
        self.names = list(model.theta_names)
        self.lo = [a["prior_lo"]] * len(self.names)
        self.hi = [a["prior_hi"]] * len(self.names)
        priors = {n: (a["prior_lo"], a["prior_hi"]) for n in self.names}
        self.call = lambda s: abc_rejection(
            model, s, self.observed, n_samples=traffic["n_samples"], threshold=a["threshold"],
            priors=priors, batch_size=traffic["batch_size"], steps_per_unit=a["steps_per_unit"])
        self.rng = np.random.default_rng([seed, 2])
        self.kept = []  # (call seed, thetas, trajectories, trials) of the calls to check
        self.calls = self.samples = self.trials = 0

    def _call(self, k):
        s = common.stream_seed(self.seed, k)
        res = self.call(s)
        thetas = np.stack([res.posterior[n] for n in self.names], axis=1)
        if k >= 0:
            # a uniform sample of the window's calls, however many there are
            self.calls += 1
            self.samples += thetas.shape[0]
            self.trials += res.trials
            entry = (s, thetas, res.trajectories, res.trials)
            if len(self.kept) < self.traffic["check_calls"]:
                self.kept.append(entry)
            else:
                j = int(self.rng.integers(0, self.calls))
                if j < len(self.kept):
                    self.kept[j] = entry

    def warm_up(self):
        for k in range(1, self.traffic["warmup_calls"] + 1):
            self._call(-k)

    def window(self, seconds):
        """Calls until ``seconds`` have passed; (calls, seconds)."""
        t0 = time.perf_counter()
        while True:
            self._call(self.calls)
            if time.perf_counter() - t0 >= seconds:
                break
        common.synchronize(self.device)
        self.window_samples, self.window_trials = self.samples, self.trials
        return self.calls, time.perf_counter() - t0

    def traced_window(self):
        """``trace_calls`` more calls; the samples and candidates of those
        calls are the traced window's."""
        self.samples = self.trials = 0
        for _ in range(self.traffic["trace_calls"]):
            self._call(self.calls)
        return self.calls

    def collect(self):
        pass

    def attempted(self, calls):
        return self.window_trials

    def failed(self):
        return 0

    def facts(self, calls):
        return {"window_samples": self.window_samples}

    def trace_facts(self, trace, calls):
        k4 = self.config["k4"]
        b = self.traffic["batch_size"]
        t_max = self.observed.shape[0] - 1
        n_sub = self.config["abc"]["steps_per_unit"]
        launches = self.trials // b
        return {
            "traced_samples": self.samples, "traced_trials": self.trials,
            "k4_bound_s": launches * roofline.bound_s(
                roofline.ops(b, t_max * n_sub, k4["reactions"], k4["groups"],
                             self.traffic["k4_ops_per_draw"]),
                roofline.nbytes(b, b, k4["compartments"], k4["theta_dim"], t_max + 1)),
            "k4_device_s": 1e-6 * trace.kernel_us(k4_kernels()),
        }

    # --- correctness -----------------------------------------------------------

    def reference(self, dtype=torch.float32):
        """Each kept call's candidates as the reference computes them."""
        a, b = self.config["abc"], self.traffic["batch_size"]
        return [ref_abc.replay_call(self.ref_model, s, self.observed, trials // b, b, self.lo,
                                    self.hi, a["threshold"], a["steps_per_unit"], dtype)
                for s, _, _, trials in self.kept]

    def _accepted(self, candidates):
        """(thetas, trajectories, trials) that a call returns from its
        candidates: the first ``n_samples`` accepted, in candidate order."""
        thetas, trajs, accepted = candidates
        n, b = self.traffic["n_samples"], self.traffic["batch_size"]
        idx = torch.nonzero(accepted)[:, 0]
        if idx.numel() >= n:
            trials = (int(idx[n - 1]) // b + 1) * b
        else:
            trials = -1  # the call would need more batches than the program ran
        idx = idx[:n]
        return thetas[idx].float().cpu().numpy(), trajs[idx].float().cpu().numpy(), trials

    def compare(self, reference, returned):
        """``sample_mismatch_pct``: samples returned by one side and not the
        other, or returned by both with another trajectory, over the
        reference's samples; ``trials_gap``: candidates the reference needed
        less those the program spent, in absolute value."""
        bad = total = gap = 0
        for candidates, (_, p_theta, p_traj, p_trials) in zip(reference, returned):
            r_theta, r_traj, r_trials = self._accepted(candidates)
            # a sample is known by its theta: both sides draw the same thetas
            where = {tuple(row): j for j, row in enumerate(candidates[0].float().cpu().numpy())}
            r_set = {where[tuple(row)]: j for j, row in enumerate(r_theta)}
            p_set = {}
            for j, row in enumerate(np.asarray(p_theta, dtype=np.float32)):
                c = where.get(tuple(row))
                p_set[c if c is not None else ("unknown", j)] = j
            both = r_set.keys() & p_set.keys()
            t_gaps = [float(np.max(np.abs(r_traj[r_set[c]] - p_traj[p_set[c]]))) for c in both]
            differ = sum(g > 0.5 for g in t_gaps)
            miss = len(r_set.keys() ^ p_set.keys()) + differ
            common.log(f"call: {miss} of {len(r_set)} samples differ ({len(r_set.keys() - p_set.keys())} "
                       f"only the reference's, {len(p_set.keys() - r_set.keys())} only the program's, "
                       f"trajectory gaps of the others {sorted(g for g in t_gaps if g > 0)[-5:]}), "
                       f"trials {p_trials} against {r_trials}")
            bad += miss
            total += len(r_set)
            gap += abs(p_trials - r_trials) if r_trials >= 0 else self.traffic["batch_size"]
        return {"sample_mismatch_pct": 100.0 * bad / max(total, 1), "trials_gap": float(gap)}

    def readings(self, control_dtype=None):
        """The numbers compared for the program's kept calls and, with a
        ``control_dtype``, for the reference computed in that precision put
        in the program's place (the control)."""
        reference = self.reference()
        sound = self.compare(reference, self.kept)
        if control_dtype is None:
            return sound, None
        low = [(None, *self._accepted(c)) for c in self.reference(control_dtype)]
        return sound, self.compare(reference, low)
