"""Seconds a dist job's device sits idle while the dispatching thread
waits for parse: the length of the device's idle gaps that overlaps the
host ranges named `sketch.parse_wait` (the part of each gap inside a
range, not the gap labelled by its middle), over the jobs.  None where
the trace holds no such range.  For a streamed file the range also waits
on the read-ahead thread's tiling."""

NAME = "sketch.parse_wait"


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def read(ctx):
    waits = _union((s, e) for name, s, e in ctx.trace.host if name == NAME)
    if not waits or ctx.units == 0:
        return None
    gaps = ctx.trace.gaps()
    overlap, i = 0.0, 0
    for s, e in waits:
        while i < len(gaps) and gaps[i][1] <= s:
            i += 1
        j = i
        while j < len(gaps) and gaps[j][0] < e:
            overlap += min(e, gaps[j][1]) - max(s, gaps[j][0])
            j += 1
    return overlap / ctx.units
