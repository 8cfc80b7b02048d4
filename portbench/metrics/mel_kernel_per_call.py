"""`mel_kernel_per_call` (count, trace): the program's `nx.mel.kernel`
spans (kernel M, the log-mel tail in one hand-written kernel) inside the
`call` spans over the calls: 1 where each call's log-mel runs through the
kernel, 0 where it runs as separate torch operations. None where the
program has no spans of its own."""

from portbench.core.spans import instrumented
from portbench.core.timeline import CALL_SPAN

REDUCE = "max"


def read(ctx):
    t = ctx.timeline
    if t is None or not instrumented(t):
        return None
    calls = t.spans[CALL_SPAN]
    kernels = sum(1 for lo, hi in t.spans.get("nx.mel.kernel", [])
                  if any(c_lo <= lo and hi <= c_hi for c_lo, c_hi in calls))
    return kernels / len(calls)
