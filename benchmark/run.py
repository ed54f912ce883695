"""Run one cell of the benchmark of ``epitpu_torch`` once, and print its
result as the last line of standard output.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is an entry of ``workloads`` in
``BENCHMARK.json``; its configuration is ``benchmark/configs/<config>.json``,
its traffic ``benchmark/workloads/<cell>.json`` (which names its driver,
``benchmark/drivers/<driver>.py``), and each metric a reader
``benchmark/metrics/<metric>.py``: a cell, a configuration or a metric is
added by adding files and entries.

A run builds (first run in a checkout) or loads the program's kernels, makes
the data from the configuration and the seed, warms up at the cell's shapes
(all of it ``setup_s``), then measures for ``--seconds`` with tracing off
(the end-to-end metrics taken on the host's clock); then it runs the traffic
file's traced window under ``torch.profiler``, with ``--trace 1`` for the
per-layer metrics and with ``--trace 0`` where one of the cell's end-to-end
metrics is taken from the device's trace.
Then, the window closed, the peak memory read and the program's state freed,
the plain reference recomputes a sample of the window's outputs drawn from
the seed; ``correct`` is whether every number compared is within its limit.
Without a CUDA device, or fewer than the cell asks for, it exits 2 and
prints no result; so it does with 3 where JAX or the JAX package was loaded,
and with 4 where a metric ``BENCHMARK.json`` lists for the cell read nothing.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# modules that must not be loaded in the process that prints the result
FORBIDDEN = ("jax", "jaxlib", "flax", "epitpu")


class Catalog:
    """``BENCHMARK.json`` and the files it names, found by name."""

    def __init__(self, root=ROOT):
        self.root = Path(root)
        with open(self.root / "BENCHMARK.json") as f:
            self.doc = json.load(f)
        self.cells = {w["name"]: w for w in self.doc["workloads"]}
        self.configs = {c["name"]: c for c in self.doc["configs"]}

    def cell(self, name):
        if name not in self.cells:
            raise SystemExit(f"unknown workload {name!r}; cells: {sorted(self.cells)}")
        return self.cells[name]

    def config(self, cell):
        with open(self.root / self.configs[cell["config"]]["file"]) as f:
            return json.load(f)

    def traffic(self, cell):
        with open(self.root / "benchmark" / "workloads" / f"{cell['name']}.json") as f:
            return json.load(f)

    def metrics(self, cell, trace):
        """The metrics this cell reports: its per-layer ones in a traced run,
        else its end-to-end ones."""
        group = self.doc["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell["name"] in m.get("workloads", [cell["name"]])]

    def reader(self, metric):
        path = self.root / "benchmark" / "metrics" / f"{metric['name']}.py"
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric['name']}",
                                                      path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def driver_class(name):
    return importlib.import_module(f"benchmark.drivers.{name}").Driver


def _merge(base, overrides):
    out = dict(base)
    for k, v in (overrides or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def device_info(device, count):
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(name, seed, seconds, trace, device="cuda", t0=None, catalog=None,
             traffic_overrides=None, driver_hook=None):
    """One run of cell ``name``; returns the result line's dict.
    ``traffic_overrides`` shrink a cell for a test on the CPU;
    ``driver_hook(driver)`` lets a test break the program underneath."""
    import torch

    from .drivers import common
    from .trace import Trace, chrome_events

    t0 = time.perf_counter() if t0 is None else t0
    catalog = catalog or Catalog()
    cell = catalog.cell(name)
    config = catalog.config(cell)
    traffic = _merge(catalog.traffic(cell), traffic_overrides)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(torch.device(device))
    driver = driver_class(traffic["driver"])(config, traffic, seed, device)
    if driver_hook is not None:
        driver_hook(driver)
    driver.warm_up()
    facts = {"setup_s": time.perf_counter() - t0, "kind": driver.kind}
    dev = {}
    # the untraced window: the end-to-end metrics on the host's clock, and in
    # a traced run the per-layer metrics that need a long window
    # (``ess_per_s``, ``iters_per_s.host``)
    done, window_s = driver.window(seconds)
    facts["window_s"] = window_s
    if trace or any(m["source"] == "device_trace" for m in catalog.metrics(cell, False)):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            common.synchronize(device)
            w0 = time.perf_counter()
            traced = driver.traced_window()
            common.synchronize(device)
            traced_s = time.perf_counter() - w0
        tr = Trace(chrome_events(prof))
        facts.update(driver.trace_facts(tr, traced), trace=tr, busy_s=tr.busy_s(),
                     traced_window_s=traced_s)
        if trace:
            dev = {"busy_s": facts["busy_s"], "window_s": traced_s}
    info = {**device_info(device, cell["chips"]), **dev}
    driver.collect()
    if cuda:
        torch.cuda.empty_cache()
    facts.update(driver.facts(done))
    metrics = {}
    for m in catalog.metrics(cell, trace):
        value = catalog.reader(m)(facts)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    r0 = time.perf_counter()
    readings, _ = driver.readings()
    common.log(f"setup {facts['setup_s']:.3f} s, window {window_s:.3f} s, "
               f"reference {time.perf_counter() - r0:.3f} s")
    limits = traffic["limits"]
    checks = {k: {"value": float(v), "limit": float(limits[k])} for k, v in readings.items()}
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": int(driver.attempted(done)),
        "failed": int(driver.failed()),
        "metrics": metrics,
        "device": info,
    }
    if trace:
        result["breakdown"] = {"device_ops": facts["trace"].device_ops(),
                               "idle_gaps": facts["trace"].idle_gaps()}
    result["checks"] = checks
    return result


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    catalog = Catalog()
    cell = catalog.cell(args.workload)
    # one process, few threads: the host's dispatch is what the PMMH cells time
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    # the program's build and kernel caches stay in the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"[benchmark] {args.workload} needs {cell['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0", T0,
                      catalog)
    found = forbidden_modules()
    if found:
        print(f"[benchmark] the run loaded {found}", file=sys.stderr)
        return 3
    # a metric listed for this cell that read nothing (a kernel or scope
    # renamed under it) refuses the run rather than leave the line silent
    missing = [m["name"] for m in catalog.metrics(cell, bool(args.trace))
               if m["name"] not in result["metrics"]]
    if missing:
        print(f"[benchmark] {args.workload} lists {missing}, and their readers found nothing "
              f"to read", file=sys.stderr)
        return 4
    for key, c in result["checks"].items():
        print(f"[benchmark] check {key} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
