"""Device milliseconds of a dist job's sketch work: every device
operation of the traced window except copies and sets (Memcpy, Memset)
and the kernels of the compare libraries, whose names are listed in
sketch_device_ms_per_job.dist.exclude.txt beside this file, over the
jobs.  The compare phase's own PyTorch operations (histograms, the
measure) are not told apart and count here."""
import os


def read(ctx):
    path = os.path.join(ctx.data_dir, "sketch_device_ms_per_job.dist"
                        ".exclude.txt")
    with open(path) as fp:
        skip = [w.strip() for w in fp
                if w.strip() and not w.startswith("#")]
    if ctx.units == 0 or not ctx.trace.device:
        return None
    spent = sum(e - s for name, s, e in ctx.trace.device
                if not any(w in name for w in skip))
    return 1e3 * spent / ctx.units
