"""`idft_product_ms` (ms, trace): the device time per call of the
operations the program's `nx.idft.product` span launched (the framed
inverse DFT's split of z, its concatenation and its exact-f32 product,
kernels/dft.py:framed_idft). None where the program has no such span."""

from portbench.core.spans import span_device_ms

REDUCE = "max"


def read(ctx):
    return None if ctx.timeline is None else span_device_ms(ctx.timeline, "nx.idft.product")
