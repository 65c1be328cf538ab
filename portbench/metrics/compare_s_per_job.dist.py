"""Host wall seconds of a dist job's all-pairs compare phase (the
program's `all-pairs compare` bucket), over the jobs of the window."""


def read(ctx):
    v = ctx.buckets.get("all-pairs compare")
    return None if v is None or ctx.units == 0 else v / ctx.units
