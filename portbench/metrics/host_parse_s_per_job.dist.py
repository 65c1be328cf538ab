"""Host seconds a dist job spends parsing and joining its FASTA files:
the program's `host.parse` bucket over the traced window, over the jobs.
Parse threads add their time to it side by side, unmarked."""


def read(ctx):
    v = ctx.buckets.get("host.parse")
    return None if v is None or ctx.units == 0 else v / ctx.units
