"""Lightweight phase metrics (the port's copy of dashing_tpu/metrics.py).

Set DASHING_TPU_METRICS=1 and every CLI run prints per-phase wall time and
throughput to stderr, plus a summary of the accumulated buckets.  Buckets
are sums over the process, with no timestamps.  A `span` also opens a
torch.profiler range of its bucket's name, so that a profiler running on
the same thread puts the span on one clock with the device trace; the
device trace itself comes from torch.profiler, not from here.
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


@contextlib.contextmanager
def span(name: str, items: float = 0.0):
    """`accum` that also opens `torch.profiler.record_function(name)`.

    Use it only around work that launches nothing on the card and copies
    nothing to or from it: a profiler range that encloses device work has
    a shadow of the same name on the device timeline, which a reader of
    the trace would count as device time.  Regions that enclose device
    work keep `accum`.  A range opened on a thread the profiler does not
    follow is not recorded; the bucket is.  The range opens before the
    bucket's clock starts and closes after it stops, so the bucket holds
    the work and not the range's own cost."""
    if not _ENABLED:
        yield
        return
    from torch.profiler import record_function
    with record_function(name), accum(name, items):
        yield


def summary():
    if not _ENABLED or not _totals:
        return
    print("[metrics] ---- summary ----", file=sys.stderr)
    for name, dt in sorted(_totals.items()):
        items = _counts.get(name, 0.0)
        rate = f"  ({items / dt:,.0f}/s)" if items and dt > 0 else ""
        print(f"[metrics] {name}: {dt:.3f}s{rate}", file=sys.stderr)
