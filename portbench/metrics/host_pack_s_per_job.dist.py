"""Host seconds a dist job spends packing tiles to 2 bits a base for K1:
the program's `host.pack2bit` bucket over the traced window, over the
jobs (absent where the job takes the ASCII route)."""


def read(ctx):
    v = ctx.buckets.get("host.pack2bit")
    return None if not v or ctx.units == 0 else v / ctx.units
