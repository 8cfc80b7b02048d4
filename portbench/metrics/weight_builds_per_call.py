"""`weight_builds_per_call` and its variants (count, trace): the program's
`nx.weights.*` spans inside the `call` spans (one nested in another counts
once) over the calls: how many times a call rebuilds weights on its path;
0 where they are kept from call to call. On several cards the largest of
the ranks. None where the program has no spans of its own."""

from portbench.core.spans import WEIGHTS, instrumented, outermost
from portbench.core.timeline import CALL_SPAN

REDUCE = "max"


def read(ctx):
    t = ctx.timeline
    if t is None or not instrumented(t):
        return None
    calls = t.spans[CALL_SPAN]
    builds = sum(1 for lo, hi in outermost(t, WEIGHTS)
                 if any(c_lo <= lo and hi <= c_hi for c_lo, c_hi in calls))
    return builds / len(calls)
