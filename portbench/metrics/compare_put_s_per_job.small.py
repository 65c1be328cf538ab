"""Host seconds a dist job spends scattering its compare tiles into the
condensed output (the program's `compare.put` span: each tile's indices
into the upper triangle and the store into the `-b` memory map), over
the jobs of the traced window.  None where the program has no such
span."""


def read(ctx):
    v = ctx.buckets.get("compare.put")
    return None if v is None or ctx.units == 0 else v / ctx.units
