#!/usr/bin/env python3
"""Run one cell of the benchmark of dashing_tpu_torch on one NVIDIA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

The cell (an entry of `workloads` in BENCHMARK.json) names a
configuration, portbench/configs/<config>.json, and a traffic mix,
portbench/traffic/<traffic>.json, whose `job` kind (portbench/kinds/
<job>.py, found by name through portbench/jobs.py) builds the inputs
from the seed and runs one unit of work.  The run:

1. set-up: makes the inputs, loads and builds the program (its caches are
   inside the checkout) and runs one warm-up unit: `setup_s`;
2. the window: units back to back, closed loop, until --seconds have
   passed (a unit still running then is finished and counted);
3. with --trace 0 the cell's end-to-end metrics; with --trace 1 the
   window runs under torch.profiler (and the program's phase buckets,
   DASHING_TPU_METRICS=1) and the cell's per-layer metrics are read by
   portbench/metrics/<metric>.py;
4. after the window the peak memory is read, the program's state freed,
   and the plain reference (portbench/reference) checks the last unit's
   outputs against the limits in portbench/limits/<cell>.json.

The last line on standard output is one JSON object: correct, attempted,
failed, metrics, device, (traced) breakdown, and last `checks`, each
compared number with its limit, which also end standard error.  The run
exits non-zero without printing it when no card is there, when the
program cannot be imported, or when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
OUT_DIR = os.path.join(ROOT, "portbench_out")
FORBIDDEN = ("jax", "jaxlib", "flax", "dashing_tpu")

if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _load_json(*parts):
    with open(os.path.join(*parts)) as fp:
        return json.load(fp)


def load_cell(name: str):
    """(bench, cell, config, traffic, limits) of a workload name."""
    bench = _load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = _load_json(HERE, "configs", cell["config"] + ".json")
    traffic = _load_json(HERE, "traffic", cell["traffic"] + ".json")
    limits = _load_json(HERE, "limits", name + ".json")
    return bench, cell, config, traffic, limits


def cell_metrics(bench: dict, name: str, key: str):
    """The metrics of `key` (end_to_end, per_layer) this cell reports."""
    return [m for m in bench[key] if name in m.get("workloads", [name])]


def load_reader(metric: str):
    """portbench/metrics/<metric>.py's `read(ctx)`."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def judge(numbers: dict, limits: dict, failed: int):
    """(checks, correct): each compared number beside its limit, and
    whether no unit failed and every number lies within its limit.  The
    benchmark's runs and the control (control.py) are judged by this."""
    checks = {name: {"value": numbers[name], "limit": limits[name]}
              for name in numbers}
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    return checks, correct


def forbidden_loaded():
    tops = {name.partition(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        res = subprocess.run(["nvidia-smi", "--id=0",
                              "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unknown ({e})"
    return res.stdout.strip() if res.returncode == 0 else "unknown"


class Context:
    """What a per-layer metric reader is given: the traced window's trace
    (portbench/trace.py), the units run in it, the program's phase
    buckets over it, and the job's own work figures."""

    def __init__(self, trace, units, buckets, job):
        self.trace, self.units, self.buckets = trace, units, buckets
        self.job = job
        self.data_dir = os.path.join(HERE, "metrics")


def _spans():
    """Wrap the dist CLI's phases in profiler ranges (traced runs only):
    the sketch, the sizes and the compare, called from cli/main.py
    through the `core` module."""
    from torch.profiler import record_function
    from dashing_tpu_torch.cli import core

    def wrap(name, fn):
        def inner(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return inner

    for attr, name in (("sketch_paths", "pb.sketch"),
                       ("emit_cardinalities", "pb.sizes"),
                       ("compare_condensed", "pb.compare")):
        setattr(core, attr, wrap(name, getattr(core, attr)))


def window(job, seconds: float, trace: bool, max_units: int, log):
    """Run units for `seconds`; (units, failed, work, seconds in units)."""
    units = failed = work = 0
    busy = 0.0
    times = []
    t0 = time.perf_counter()
    while True:
        c0 = job.counters() if trace else None
        t = time.perf_counter()
        try:
            done = job.run()
        except (Exception, SystemExit) as e:        # noqa: BLE001
            failed += 1
            done = 0
            log(f"unit {units} failed: {type(e).__name__}: {e}")
        dt = time.perf_counter() - t
        times.append(dt)
        units += 1
        work += done
        busy += dt
        if trace:
            c1 = job.counters()
            log(f"unit {units - 1}: {dt:.4f} s, work {done}, launches "
                + " ".join(f"{k} {c1[k] - c0[k]}" for k in c1))
        job.after()
        if (time.perf_counter() - t0 >= seconds
                or (max_units and units >= max_units)):
            if len(times) <= 50:
                log("unit seconds: " + " ".join(f"{x:.4f}" for x in times))
            return units, failed, work, busy


def main(argv=None, device=None, overrides=None) -> int:
    """Run a cell.  `device` and `overrides` (keys replaced in the
    configuration) are for the tests, which run on the CPU at a small
    size; the benchmark's own runs give neither."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench, cell, config, traffic, limits = load_cell(args.workload)
    config = {**config, **(overrides or {})}

    def log(msg):
        print(f"[portbench] {msg}", file=sys.stderr, flush=True)

    if args.trace:
        os.environ["DASHING_TPU_METRICS"] = "1"   # read at the port's import
    import torch
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < int(cell["chips"])):
            log(f"needs {cell['chips']} CUDA card(s); "
                f"torch.cuda.is_available() is {torch.cuda.is_available()}")
            return 2
        device = torch.device("cuda", 0)
        kind = torch.cuda.get_device_name(device)
        log(f"card: {card_line()}")
    else:
        device = torch.device(device)
        kind = str(device)
    os.environ["DASHING_TPU_TORCH_DEVICE"] = str(device)
    from dashing_tpu_torch import metrics as buckets
    from portbench import jobs, trace as tr

    job = jobs.make(config, traffic, args.seed, device)
    try:
        job.setup()
        if args.trace and traffic["job"] == "dist":
            _spans()
        job.run()                                   # warm-up
        job.after()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - T_START
        log(f"set-up {setup_s:.3f} s; work a unit {job.work}")

        names = [m["name"] for m in cell_metrics(
            bench, cell["name"], "per_layer" if args.trace else "end_to_end")]
        before = dict(buckets._totals)
        if args.trace:
            from torch.profiler import (ProfilerActivity, profile,
                                        record_function)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with record_function("pb.window"):
                    w0 = time.perf_counter()
                    units, failed, work, busy = window(
                        job, args.seconds, True,
                        int(traffic.get("trace_units", 0)), log)
                    wall = time.perf_counter() - w0
            trace = tr.Trace.from_profile(prof)
        else:
            w0 = time.perf_counter()
            units, failed, work, busy = window(job, args.seconds, False, 0,
                                               log)
            wall = time.perf_counter() - w0
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        log(f"window: {units} units ({failed} failed) in {wall:.4f} s, "
            f"{busy:.4f} s of them in units")

        units_of = {m["name"]: m["unit"]
                    for m in bench["end_to_end"] + bench["per_layer"]}
        dev = {"platform": "gpu" if device.type == "cuda" else device.type,
               "kind": kind, "count": 1, "memory_peak_bytes": int(peak)}
        out = {}
        if args.trace:
            delta = {k: v - before.get(k, 0.0)
                     for k, v in buckets._totals.items()}
            ctx = Context(trace, units, delta, job)
            values = {name: load_reader(name)(ctx) for name in names}
            dev["busy_s"] = trace.busy_s()
            dev["window_s"] = trace.window_s
            out["breakdown"] = {
                "device_ops": tr.top(trace.by_name()),
                "idle_gaps": tr.top(trace.idle_by_host())}
            log("buckets over the window: " + ", ".join(
                f"{k} {v:.4f}" for k, v in sorted(delta.items())))
            _write_profile(args, prof, out["breakdown"], delta)
            del prof, trace
        else:
            values = {"setup_s": setup_s, job.rate_metric: work / busy}
        metrics = {name: {"value": values[name], "unit": units_of[name]}
                   for name in names if values.get(name) is not None}

        job.release()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t = time.perf_counter()
        numbers = job.check()
        log(f"reference check {time.perf_counter() - t:.3f} s")
    finally:
        job.close()

    bad = forbidden_loaded()
    if bad:
        log(f"modules of JAX or the JAX package were loaded: {bad}")
        return 3
    checks, correct = judge(numbers, limits, failed)
    result = {"correct": correct, "attempted": units, "failed": failed,
              "metrics": metrics, "device": dev, **out, "checks": checks}
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


def _write_profile(args, prof, breakdown, delta) -> None:
    """The traced run's table of device operations, breakdown and buckets,
    to portbench_out/<cell>.<seed>.trace.txt (inside the checkout)."""
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, f"{args.workload}.{args.seed}.trace.txt")
    with open(path, "w") as fp:
        fp.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                           row_limit=25,
                                           max_name_column_width=70))
        fp.write("\n" + json.dumps({"breakdown": breakdown,
                                    "buckets": delta}, indent=1) + "\n")


if __name__ == "__main__":
    sys.exit(main())
