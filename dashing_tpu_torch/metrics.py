"""Lightweight phase metrics (the port's copy of dashing_tpu/metrics.py).

Set DASHING_TPU_METRICS=1 and every CLI run prints per-phase wall time and
throughput to stderr, plus a summary of the accumulated buckets.  Device
traces come from torch.profiler (chip_profile.py), not from here.
"""
from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Dict, Optional

_ENABLED = os.environ.get("DASHING_TPU_METRICS", "") not in ("", "0")

_totals: Dict[str, float] = {}
_counts: Dict[str, float] = {}


def enabled() -> bool:
    return _ENABLED


@contextlib.contextmanager
def phase(name: str, items: float = 0.0, unit: str = "items"):
    """Time a phase; accumulate totals and print on exit when enabled."""
    if not _ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _totals[name] = _totals.get(name, 0.0) + dt
        _counts[name] = _counts.get(name, 0.0) + items
        rate = f", {items / dt:,.0f} {unit}/s" if items and dt > 0 else ""
        print(f"[metrics] {name}: {dt:.3f}s{rate}", file=sys.stderr)


def add_time(name: str, dt: float, items: float = 0.0):
    """Accumulate a measured duration into a bucket (no printing)."""
    if not _ENABLED:
        return
    _totals[name] = _totals.get(name, 0.0) + dt
    if items:
        _counts[name] = _counts.get(name, 0.0) + items


def total(name: str) -> float:
    """Seconds accumulated in a bucket so far (0 when disabled)."""
    return _totals.get(name, 0.0)


@contextlib.contextmanager
def accum(name: str, items: float = 0.0):
    """Accumulate wall time into a named bucket WITHOUT printing per call
    (for inner-loop sites that fire thousands of times per run, e.g.
    per-file parse or per-tile pull); totals appear in summary().
    Thread-unsafe float adds are acceptable here: worst case a lost
    update skews a diagnostic counter, never a result."""
    if not _ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _totals[name] = _totals.get(name, 0.0) + (time.perf_counter() - t0)
        if items:
            _counts[name] = _counts.get(name, 0.0) + items


def summary():
    if not _ENABLED or not _totals:
        return
    print("[metrics] ---- summary ----", file=sys.stderr)
    for name, dt in sorted(_totals.items()):
        items = _counts.get(name, 0.0)
        rate = f"  ({items / dt:,.0f}/s)" if items and dt > 0 else ""
        print(f"[metrics] {name}: {dt:.3f}s{rate}", file=sys.stderr)
