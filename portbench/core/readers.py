"""What the metric files (portbench/metrics/) share: the end-to-end
numbers from the window's host clock, and a stage's roofline share from
the trace."""

import math

from portbench.core.peaks import least_seconds
from portbench.core.timeline import CALL_SPAN


def throughput(ctx):
    """Input samples of every call of the window over the whole window, in
    millions a second."""
    w = ctx.window
    return w["samples_per_call"] * w["calls"] / w["window_s"] / 1e6


def percentile_ms(ctx, q: float):
    """The q-th percentile (nearest rank) of every call's latency, ms."""
    lat = sorted(ctx.window["latencies_s"])
    return lat[max(0, math.ceil(q / 100.0 * len(lat)) - 1)] * 1e3


def roofline(ctx, stage: str, span: str = CALL_SPAN):
    """A stage's least time on this card (its work from the configuration,
    portbench/stages/<stage>.py) over the device time of the operations
    that its spans launched, in %; None without a trace, a device time, or
    the card's peaks."""
    if ctx.timeline is None:
        return None
    device_ms = ctx.timeline.device_ms(span)
    least = least_seconds(*ctx.bench.module("stages", stage).work(ctx.cfg), ctx.device_name)
    if least is None or not device_ms:
        return None
    return 100.0 * least[0] * 1e3 / device_ms
