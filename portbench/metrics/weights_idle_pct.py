"""`weights_idle_pct` and its variants (%, trace): the share of the traced
window in which the card runs nothing (no kernel, copy or set) while the
host is inside one of the program's `nx.weights.*` spans, by the overlap
of the two sets of intervals; at most `device_idle_pct`. On several cards
the mean of the ranks. None where the program has no spans of its own."""

from portbench.core.spans import WEIGHTS, instrumented, intersect, outermost
from portbench.core.timeline import clip, length, union

REDUCE = "mean"


def read(ctx):
    t = ctx.timeline
    if t is None or not instrumented(t):
        return None
    weights = union(clip(outermost(t, WEIGHTS), t.start, t.end))
    idle = length(weights) - length(intersect(weights, t.busy))
    return 100.0 * idle / (t.end - t.start)
