#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_profile.py [--reps 3]

Three workloads, each run `--reps` times untraced and then once under
torch.profiler:
  config 2   `dist -k 31 -S 16 -M -b -O ... -o ...` through the CLI entry on
             the 100 synthetic 5 Mbp genomes of chip_smoke.py (same seed),
             with the DASHING_TPU_METRICS buckets of every untraced run;
  n1024      all_pairs_condensed over the 1024-sketch p=14 bank of
             chip_smoke.py's K3 phase (one 1024 x 1024 tile, Mash, MLE):
             K4's X-only form (cum_union), the marginals and K3;
  j1000      the same engine with the joint MLE (-J) over the 1000-sketch
             p=14 bank of chip_smoke.py's K4 phase (one 1000 x 1000 tile,
             Mash): kernels K4 and K5.
For the traced run it prints the profiler's table (top ops by self device
time) and the device busy share of that one run: the union of the device
activity intervals in the trace over the run's wall clock.  The profiler
slows the host, so that share is a lower bound for an untraced run.

Everything printed also goes to chiprun_out/profile.log.  Needs CUDA; exits
non-zero without it.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time

os.environ["DASHING_TPU_METRICS"] = "1"   # read when dashing_tpu_torch.metrics loads

import numpy as np  # noqa: E402

LOG_PATH = os.path.join("chiprun_out", "profile.log")
_log_fp = None


def log(msg: str) -> None:
    print(msg, flush=True)
    if _log_fp is not None:
        _log_fp.write(msg + "\n")
        _log_fp.flush()


def device_busy(prof) -> tuple:
    """(seconds, events): union of the device-side intervals in a trace."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy * 1e-6, len(spans)


def traced(label: str, fn) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log(prof.key_averages().table(sort_by="self_cuda_time_total",
                                  row_limit=15, max_name_column_width=60))
    busy, nev = device_busy(prof)
    log(f"[{label} traced] wall {wall:.4f}s, device busy {busy:.4f}s over "
        f"{nev} device events, busy share {busy / wall:.4f} (one traced run)")


def buckets() -> str:
    from dashing_tpu_torch import metrics
    out = ", ".join(f"{k} {v:.3f}s" for k, v in sorted(metrics._totals.items()))
    metrics._totals.clear()
    metrics._counts.clear()
    return out


def config2(dev, reps: int) -> None:
    import torch
    import chip_smoke
    from dashing_tpu_torch.cli.main import main
    rng = np.random.default_rng(chip_smoke.SEED + 1)
    tmp = tempfile.mkdtemp(prefix="dtt_profile_")
    try:
        genomes = chip_smoke._write_genomes(tmp, 20, 5_000_000, rng)
        paths = [g[0] for g in genomes]
        argv = ["dist", "-k", "31", "-S", "16", "-M", "-b",
                "-O", os.path.join(tmp, "d.bin"),
                "-o", os.path.join(tmp, "sizes.txt"), "--avoid-sorting"] + paths

        def run():
            if main(list(argv)) != 0:
                raise SystemExit("config 2 dist returned nonzero")

        run()                     # warm-up: builds, first-touch
        buckets()
        for r in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            log(f"[config2] rep {r} wall {time.perf_counter() - t0:.4f}s; "
                f"buckets: {buckets()}")
        traced("config2", run)
        buckets()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def n1024(dev, reps: int) -> None:
    import torch
    import chip_smoke
    from dashing_tpu_torch.ops import joint_stats as js
    from dashing_tpu_torch.ops import pairwise as pw
    from dashing_tpu_torch.sketch import estimators as est
    from dashing_tpu_torch.sketch.hll import HLL
    p, n = 14, 1024
    bank, _ = chip_smoke._k3_bank(dev, p, n)
    sketches = [HLL.from_numpy(r, p) for r in bank.cpu().numpy()]

    def run():
        pw.all_pairs_condensed(sketches, pw.MASH_DIST, 21, est.ERTL_MLE,
                               est.ERTL_MLE, dev)

    run()
    for r in range(reps):
        js.cum_union_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        log(f"[n1024] rep {r} compare {dt:.4f}s, "
            f"{n * (n - 1) / 2 / dt:.0f} pairs/s, K4 X-only launches "
            f"{js.cum_union_launches}")
    traced("n1024", run)


def j1000(dev, reps: int) -> None:
    import torch
    import chip_smoke
    from dashing_tpu_torch.ops import pairwise as pw
    from dashing_tpu_torch.sketch import estimators as est
    from dashing_tpu_torch.sketch.hll import HLL
    p, n = 14, 1000
    bank, _ = chip_smoke._k3_bank(dev, p, n)
    sketches = [HLL.from_numpy(r, p, est.ERTL_MLE, est.ERTL_JOINT_MLE)
                for r in bank.cpu().numpy()]

    def run():
        pw.all_pairs_condensed(sketches, pw.MASH_DIST, 31, est.ERTL_MLE,
                               est.ERTL_JOINT_MLE, dev)

    run()
    for r in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        log(f"[j1000] rep {r} compare -J {dt:.4f}s, "
            f"{n * (n - 1) / 2 / dt:.0f} pairs/s")
    traced("j1000", run)


def main() -> int:
    global _log_fp
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", flush=True)
        return 1
    os.makedirs("chiprun_out", exist_ok=True)
    _log_fp = open(LOG_PATH, "w")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    log(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}")
    os.environ["DASHING_TPU_TORCH_DEVICE"] = "cuda"
    from dashing_tpu_torch import device as devmod
    dev = devmod.from_env()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)}")
    config2(dev, args.reps)
    n1024(dev, args.reps)
    j1000(dev, args.reps)
    _log_fp.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
