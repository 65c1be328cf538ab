"""Host wall seconds of a read-set job's count-min second pass (the
program's `sketch.cm_admit` accum: the second parse's waits, the tiles
hashed again, the gathers and the admission mask, enqueued; the register
fold lies outside it), over the jobs of the traced window."""


def read(ctx):
    v = ctx.buckets.get("sketch.cm_admit")
    return None if v is None or ctx.units == 0 else v / ctx.units
