"""Small-file batches a dist job folds (the program's `small_batches`
counter, recorded by the job kind for each unit), over the jobs of the
traced window.  None where the program has no such counter."""


def read(ctx):
    counts = getattr(ctx.job, "unit_counts", None) or []
    units = counts[-ctx.units:] if ctx.units else []
    if not units or any("small_batches" not in u for u in units):
        return None
    return sum(u["small_batches"] for u in units) / len(units)
