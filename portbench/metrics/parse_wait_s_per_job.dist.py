"""Host seconds a dist job's dispatching thread waits for the parse of
its next file (the program's `sketch.parse_wait` bucket: the wait on the
parse worker's future, and on the read-ahead queue of a streamed file),
over the jobs of the traced window.  A pure wait on parse only for
whole-file jobs: a streamed file's read-ahead thread also tiles, so the
wait on its queue is a wait on parse and tiling."""


def read(ctx):
    v = ctx.buckets.get("sketch.parse_wait")
    return None if v is None or ctx.units == 0 else v / ctx.units
