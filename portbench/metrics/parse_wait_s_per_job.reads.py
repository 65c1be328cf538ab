"""Host seconds a read-set job's dispatching thread waits on the
read-ahead queue of its streamed FASTQ (the program's `sketch.parse_wait`
span; the read-ahead thread parses and tiles, for each of the filter's
two passes), over the jobs of the traced window."""


def read(ctx):
    v = ctx.buckets.get("sketch.parse_wait")
    return None if v is None or ctx.units == 0 else v / ctx.units
