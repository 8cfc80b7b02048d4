"""`weights_ms` and its variants (ms, trace): the host's time per call
inside the program's `nx.weights.*` spans (the union of the outermost ones
in each `call` span) less the time it blocked in device syncs there (the
trace's waits); the mean over calls; on several cards the largest of the
ranks. None where the program has no spans of its own."""

from portbench.core.spans import WEIGHTS, instrumented, intersect, outermost
from portbench.core.timeline import CALL_SPAN, clip, length, union

REDUCE = "max"


def read(ctx):
    t = ctx.timeline
    if t is None or not instrumented(t):
        return None
    weights = outermost(t, WEIGHTS)
    waits = union([(e["ts"], e["ts"] + e["dur"]) for e in t.waits])
    calls = t.spans[CALL_SPAN]
    total = 0.0
    for lo, hi in calls:
        inside = union(clip(weights, lo, hi))
        total += length(inside) - length(intersect(inside, waits))
    return total / len(calls) * 1e-3
