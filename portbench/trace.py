"""Reading a torch.profiler trace of the measured window.

`Trace.from_profile` keeps the device activity (kernels, copies and
sets, each with its name and its interval) and the host events (operator
calls, runtime calls and the benchmark's own `pb.*` ranges).  From them:
the busy time (the union of the device intervals), the device operations
that took most time, and the idle gaps of the device labelled by the
innermost host event that covers each gap's middle.
"""
from __future__ import annotations

import heapq
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

Interval = Tuple[str, float, float]        # (name, start s, end s)
RANGE_PREFIX = "pb."                       # the benchmark's host ranges


@dataclass
class Trace:
    device: List[Interval] = field(default_factory=list)
    host: List[Interval] = field(default_factory=list)
    t0: float = 0.0                        # the window's start (s)
    t1: float = 0.0                        # the window's end (s)

    @classmethod
    def from_profile(cls, prof) -> "Trace":
        from torch.autograd import DeviceType
        dev: List[Interval] = []
        host: List[Interval] = []
        for e in prof.events():
            iv = (e.name, e.time_range.start * 1e-6,
                  e.time_range.end * 1e-6)
            if e.device_type == DeviceType.CUDA:
                # a host range's shadow on the device timeline is no work
                if not e.name.startswith(RANGE_PREFIX):
                    dev.append(iv)
            elif e.device_type == DeviceType.CPU:
                host.append(iv)
        window = [iv for iv in host if iv[0] == RANGE_PREFIX + "window"]
        if window:
            t0, t1 = window[0][1], window[0][2]
        else:
            ends = [iv[1] for iv in dev + host] + [iv[2] for iv in dev + host]
            t0, t1 = (min(ends), max(ends)) if ends else (0.0, 0.0)
        return cls(sorted(dev, key=lambda iv: iv[1]),
                   sorted(host, key=lambda iv: iv[1]), t0, t1)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def merged(self) -> List[Tuple[float, float]]:
        """The device intervals merged where they overlap."""
        out: List[Tuple[float, float]] = []
        for _, s, e in self.device:
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged())

    def by_name(self) -> Dict[str, float]:
        """Device seconds summed by operation name."""
        tot: Dict[str, float] = defaultdict(float)
        for name, s, e in self.device:
            tot[name] += e - s
        return dict(tot)

    def gaps(self) -> List[Tuple[float, float]]:
        """The intervals of the window in which no device work ran."""
        out, cur = [], self.t0
        for s, e in self.merged():
            if s > cur:
                out.append((cur, min(s, self.t1)))
            cur = max(cur, e)
        if cur < self.t1:
            out.append((cur, self.t1))
        return [(s, e) for s, e in out if e > s]

    def idle_by_host(self) -> Dict[str, float]:
        """Idle device seconds summed by the innermost host event (the
        shortest one) covering each gap's middle."""
        tot: Dict[str, float] = defaultdict(float)
        gaps = sorted(self.gaps(), key=lambda g: (g[0] + g[1]) / 2)
        active: List[Tuple[float, float, str]] = []   # heap by end
        i = 0
        for s, e in gaps:
            mid = (s + e) / 2
            while i < len(self.host) and self.host[i][1] <= mid:
                name, hs, he = self.host[i]
                heapq.heappush(active, (he, hs, name))
                i += 1
            while active and active[0][0] < mid:
                heapq.heappop(active)
            label = min(((he - hs, name) for he, hs, name in active),
                        default=(0.0, "no host event"))[1]
            tot[label] += e - s
        return dict(tot)


def top(d: Dict[str, float], n: int = 10) -> List[List]:
    """The n largest entries of a name -> seconds map, as [name, s]."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
