"""Host seconds a dist job spends cutting its joined files into tiles
and padding each chunk's width (the program's `host.tile` bucket), over
the jobs of the traced window.  Time on the dispatching thread only for
whole-file jobs: a streamed file is tiled on its read-ahead thread, beside
the dispatching thread, and the bucket adds that in too."""


def read(ctx):
    v = ctx.buckets.get("host.tile")
    return None if v is None or ctx.units == 0 else v / ctx.units
