"""`call_p95_ms` (ms, host clock): the 95th percentile (nearest rank) of
every call of the window, each timed from its issue to the host's seeing
its completion event."""

from portbench.core.readers import percentile_ms


def read(ctx):
    return percentile_ms(ctx, 95.0)
