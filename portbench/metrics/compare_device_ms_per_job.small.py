"""Device milliseconds of a dist job's compare kernels: the device
operations of the traced window whose names hold one of the parts listed
in compare_device_ms_per_job.small.names.txt beside this file, over the
jobs.  The row-estimate kernel of the `-o` sizes counts here too.  None
where the trace holds none of them."""
import os


def read(ctx):
    path = os.path.join(ctx.data_dir,
                        "compare_device_ms_per_job.small.names.txt")
    with open(path) as fp:
        parts = [w.strip() for w in fp
                 if w.strip() and not w.startswith("#")]
    if ctx.units == 0 or not ctx.trace.device:
        return None
    spent = sum(e - s for name, s, e in ctx.trace.device
                if any(w in name for w in parts))
    return 1e3 * spent / ctx.units if spent else None
