"""`fir_ms` (ms, trace): the device time per call of the operations the
program's `nx.fir` span launched (the filtered chain's FIR stage with its
pads and copies, models/pipeline.py:stft_fir_chain). None where the
program has no such span."""

from portbench.core.spans import span_device_ms

REDUCE = "max"


def read(ctx):
    return None if ctx.timeline is None else span_device_ms(ctx.timeline, "nx.fir")
