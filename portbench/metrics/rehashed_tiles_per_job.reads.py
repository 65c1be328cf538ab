"""Tiles of a read-set job's count-min second pass that were not kept on
the device between the passes, so parsed and hashed again (the program's
`cm_rehashed_tiles` counter, recorded by the job kind for each unit),
over the jobs of the traced window.  None where the program has no such
counter."""


def read(ctx):
    counts = getattr(ctx.job, "unit_counts", None) or []
    units = counts[-ctx.units:] if ctx.units else []
    if not units or any("cm_rehashed_tiles" not in u for u in units):
        return None
    return sum(u["cm_rehashed_tiles"] for u in units) / len(units)
