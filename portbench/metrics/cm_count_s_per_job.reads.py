"""Host wall seconds of a read-set job's count-min first pass (the
program's `sketch.cm_count` accum: hashing every tile, with the streamed
file's parse waits, and the scatter-adds into the counters, enqueued),
over the jobs of the traced window."""


def read(ctx):
    v = ctx.buckets.get("sketch.cm_count")
    return None if v is None or ctx.units == 0 else v / ctx.units
