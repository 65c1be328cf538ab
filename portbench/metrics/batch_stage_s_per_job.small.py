"""Host seconds a dist job spends staging its small-file batches (the
program's `sketch.batch_stage` span, before the upload: each batch's
rows joined and its bank vector, and its 2-bit pack where its files'
rows come unpacked), over the jobs of the traced window.  None where the
program has no such span."""


def read(ctx):
    v = ctx.buckets.get("sketch.batch_stage")
    return None if v is None or ctx.units == 0 else v / ctx.units
