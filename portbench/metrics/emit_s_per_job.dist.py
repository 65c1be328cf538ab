"""Host seconds a dist job spends writing its matrix (the `-b` flush,
the file's finish and its `.labels`, or the text forms; the program's
`cli.emit` bucket), over the jobs of the traced window."""


def read(ctx):
    v = ctx.buckets.get("cli.emit")
    return None if v is None or ctx.units == 0 else v / ctx.units
