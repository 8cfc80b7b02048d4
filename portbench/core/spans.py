"""What the program's own spans (`nx.*`, nx_signal_tpu_torch/utils/
profiling.py:span) say in a traced window. They are `user_annotation`
events of the same torch.profiler trace as the benchmark's spans, on the
clock of the card's kernels. A program that has none of them (one older
than its spans) is not instrumented, and its readers return None.

`nx.weights.*` spans are where a call rebuilds weights on its path: kernel
A-tc's layout (`nx.weights.a_tc`), the inverse DFT's numpy weights
(`nx.weights.idft`), the sharded chain's fold (`nx.weights.fold`).
"""

PROGRAM = "nx."
WEIGHTS = "nx.weights."


def instrumented(timeline) -> bool:
    """Whether the program put any span of its own in the trace."""
    return any(name.startswith(PROGRAM) and spans for name, spans in timeline.spans.items())


def outermost(timeline, prefix):
    """The spans whose name starts with `prefix` that no other such span
    holds, sorted: a weights span nested in another counts once."""
    spans = sorted(((lo, hi) for name, found in timeline.spans.items()
                    if name.startswith(prefix) for lo, hi in found),
                   key=lambda s: (s[0], -s[1]))
    kept = []
    for lo, hi in spans:
        if kept and kept[-1][0] <= lo and hi <= kept[-1][1]:
            continue
        kept.append((lo, hi))
    return kept


def intersect(a, b):
    """The intersection of two merged, sorted lists of [start, end)
    intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def span_device_ms(timeline, name):
    """Mean device time of the operations each `name` span launched (the
    union of their intervals), ms: 0 where the spans launched nothing on a
    device (the program's plain CPU versions); None where the program made
    no such span."""
    if not timeline.spans.get(name):
        return None
    ms = timeline.device_ms(name)
    return 0.0 if ms is None else ms
