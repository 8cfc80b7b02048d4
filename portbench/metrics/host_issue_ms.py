"""`host_issue_ms` and its variants (ms, trace): the host's time per call
inside the call's span less the time it blocked in device syncs there; on
several cards the largest of the ranks."""

REDUCE = "max"


def read(ctx):
    return None if ctx.timeline is None else ctx.timeline.host_issue_ms()
