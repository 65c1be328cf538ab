"""k-mers sketched per second on one card (counterpart of the repo's
bench.py).

    python -m dashing_tpu_torch.bench [--device cuda]

Measures the fused device step of `dashing sketch` on device-resident
ASCII chunks: kernel K2 (ops/encode_hash.ascii_to_registers: canonical
2-bit k-mer -> WangHash -> HLL register max) over ITERS chunks of ROWS x
(CONTENT + K - 1) random bases from numpy's default_rng(0), K = 31, P = 14,
one warm-up run and the best of 3 timed runs, each ending in a
synchronize.  The geometry and the JSON keys are bench.py's; the TPU
workarounds there (the supervised retry child, the XLA compile cache, the
survivor caps) have no counterpart here.

Prints the card's name and power limit (nvidia-smi) on stderr, then ONE
JSON line on stdout:
  {"metric": "kmers_sketched_per_sec_per_chip", "value": N, "unit":
   "kmers/s", "vs_baseline": N, "baseline_pinned": N,
   "host_baseline_measured": N, "device": "..."}
vs_baseline divides by the single-thread numpy rate pinned in
BASELINE.json (read as a data file); host_baseline_measured is the same
numpy pipeline measured now, on this host.  The device comes from
--device or DASHING_TPU_TORCH_DEVICE (default cuda); asking for CUDA
without a card raises, and "device" names what ran.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from . import device as devmod
from .hashes import wang_hash_np
from .ops import encode_hash as eh

K = 31
P = 14
ROWS = 256
CONTENT = 8192             # the pipeline's tile geometry
ITERS = 30
BASELINE_JSON = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "BASELINE.json")


def make_chunks(rows: int = ROWS, content: int = CONTENT,
                iters: int = ITERS) -> np.ndarray:
    """(iters, rows, content + K - 1) uint8 ACGT, bench.py's chunks."""
    rng = np.random.default_rng(0)
    return rng.choice(np.frombuffer(b"ACGT", np.uint8),
                      size=(iters, rows, content + K - 1))


def fold(chunks: torch.Tensor, regs: torch.Tensor) -> torch.Tensor:
    """One run: every chunk through K2 into `regs` (zeroed first)."""
    regs.zero_()
    for i in range(chunks.shape[0]):
        eh.ascii_to_registers(chunks[i], regs, k=K, p=P)
    return regs


def device_rate(dev: torch.device, rows: int = ROWS, content: int = CONTENT,
                iters: int = ITERS, reps: int = 3):
    """(best k-mers/s over `reps` timed runs after one warm-up, the
    registers of the last run)."""
    chunks = torch.from_numpy(make_chunks(rows, content, iters)).to(dev)
    regs = torch.zeros(1 << P, dtype=torch.int32, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fold(chunks, regs)                      # build/load + warm-up
    sync()
    kmers = rows * content * iters
    best = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        fold(chunks, regs)
        sync()
        best = max(best, kmers / (time.perf_counter() - t0))
    return best, regs


def host_baseline_rate(n: int = 1 << 20, reps: int = 3) -> float:
    """Single-thread numpy version of the same pipeline, best of `reps`
    (bench.py's `host_baseline_rate`)."""
    rng = np.random.default_rng(0)
    seq = rng.integers(0, 4, n + K - 1, dtype=np.uint64)
    best = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        fwd = np.zeros(n, np.uint64)
        rc = np.zeros(n, np.uint64)
        for t in range(K):
            fwd = (fwd << np.uint64(2)) | seq[t:t + n]
            rc |= (np.uint64(3) - seq[t:t + n]) << np.uint64(2 * t)
        km = np.minimum(fwd, rc)
        h = wang_hash_np(km)
        idx = (h >> np.uint64(64 - P)).astype(np.int64)
        rest = (h << np.uint64(P)) | np.uint64(1 << (P - 1))
        cnt = np.zeros(n, np.int64)
        y = rest.copy()
        for sh in (32, 16, 8, 4, 2, 1):
            zt = (y >> np.uint64(64 - sh)) == 0
            cnt += np.where(zt, sh, 0)
            y = np.where(zt, y << np.uint64(sh), y)
        regs = np.zeros(1 << P, np.uint8)
        np.maximum.at(regs, idx, (cnt + 1).astype(np.uint8))
        best = max(best, n / (time.perf_counter() - t0))
    return best


def pinned_baseline(path: str = BASELINE_JSON) -> float:
    """The pinned single-thread numpy denominator of BASELINE.json."""
    with open(path) as fp:
        return float(json.load(fp)["pinned_numpy_baseline_kmers_per_sec"])


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    device's name when it is not a card."""
    if dev.type != "cuda":
        return str(dev)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    smi = subprocess.run(["nvidia-smi", f"--id={idx}",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip()


def run(dev: torch.device, rows: int = ROWS, content: int = CONTENT,
        iters: int = ITERS, host_n: int = 1 << 20):
    """The benchmark's JSON record and the registers of its last run."""
    rate, regs = device_rate(dev, rows, content, iters)
    base = pinned_baseline()
    record = {
        "metric": "kmers_sketched_per_sec_per_chip",
        "value": round(rate, 1),
        "unit": "kmers/s",
        "vs_baseline": round(rate / base, 3),
        "baseline_pinned": base,
        "host_baseline_measured": round(host_baseline_rate(host_n), 1),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
    }
    return record, regs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help=f"cuda or cpu (default ${devmod.ENV_VAR} or cuda)")
    a = ap.parse_args(argv)
    dev = devmod.resolve(a.device or os.environ.get(devmod.ENV_VAR, "cuda")
                         or "cuda")
    print(card_line(dev), file=sys.stderr, flush=True)
    record, _ = run(dev)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
