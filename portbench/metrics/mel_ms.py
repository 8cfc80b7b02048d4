"""`mel_ms` (ms, trace): the device time per call of the operations the
program's `nx.mel` span launched (the mel product, the clamp, the log10,
the floor and the scaling, spectral/mel.py:_log_mel). None where the
program has no such span."""

from portbench.core.spans import span_device_ms

REDUCE = "max"


def read(ctx):
    return None if ctx.timeline is None else span_device_ms(ctx.timeline, "nx.mel")
