"""What a torch.profiler trace says about a traced window: the benchmark's
own spans (record_function) on the host, the host's blocking syncs inside
them, the device operations each span launched, the device's busy time and
its idle gaps.

The trace is the profiler's Chrome trace (export_chrome_trace, gzipped),
parsed here, so every number below is read from one file that stays beside
the run (portbench/_traces/, git-ignored).
"""

import gzip
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# host events in which the host waits for the device; besides them, a copy
# from the device to the host (its runtime call waits for the stream)
SYNC_NAMES = ("aten::_local_scalar_dense", "cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaMemcpy")
DTOH = "Memcpy DtoH"
CALL_SPAN = "call"


def union(intervals):
    """Merged [start, end) intervals, sorted."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def length(intervals) -> float:
    return sum(end - start for start, end in intervals)


def clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


class Timeline:
    """The events of one trace, in microseconds on the trace's clock."""

    def __init__(self, path):
        with (gzip.open if str(path).endswith(".gz") else open)(path, "rt") as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        calls = [e for e in events if e.get("cat") == "user_annotation"
                 and e["name"] == CALL_SPAN]
        if not calls:
            raise ValueError(f"no '{CALL_SPAN}' span in the trace {path}")
        self.tid = calls[0]["tid"]
        self.host = [e for e in events if e.get("cat") in HOST_CATS and e["tid"] == self.tid]
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS]
        self.spans = defaultdict(list)
        for e in self.host:
            if e["cat"] == "user_annotation":
                self.spans[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
        for spans in self.spans.values():
            spans.sort()
        launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                     if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
        self.orphans = 0
        self._owner = self._assign(launch_ts)
        to_host = {e["args"].get("correlation") for e in self.device if e["name"].startswith(DTOH)}
        self.waits = [e for e in self.host if e["name"] in SYNC_NAMES or (
            e["cat"] in LAUNCH_CATS and e.get("args", {}).get("correlation") in to_host)]
        # from the first traced call, or from the first device operation the
        # trace holds where the calls before it left none running
        first_call = self.spans[CALL_SPAN][0][0]
        self.start = max(first_call, min((e["ts"] for e in self.device), default=first_call))
        ends = [e["ts"] + e["dur"] for e in self.device]
        self.end = max([self.spans[CALL_SPAN][-1][1], *ends])
        self.busy = union(clip([(e["ts"], e["ts"] + e["dur"]) for e in self.device],
                               self.start, self.end))

    def _assign(self, launch_ts):
        """For each device operation (its index), the host time of its
        launch. An operation whose launch the trace did not record (a
        library that links its own CUDA runtime) takes the launch time of
        the next operation on its stream that has one: one stream runs in
        launch order, so both belong to the same span unless a span ends
        between them."""
        owner = {}
        by_stream = defaultdict(list)
        for i, e in enumerate(self.device):
            by_stream[(e["pid"], e["tid"])].append(i)
        for ops in by_stream.values():
            ops.sort(key=lambda i: self.device[i]["ts"])
            pending = []
            for i in ops:
                corr = self.device[i].get("args", {}).get("correlation")
                if corr in launch_ts:
                    for j in pending:
                        owner[j] = launch_ts[corr]
                    pending = []
                    owner[i] = launch_ts[corr]
                else:
                    pending.append(i)
                    self.orphans += 1
            if pending:
                last = owner.get(ops[-1 - len(pending)]) if len(ops) > len(pending) else None
                for j in pending:
                    if last is not None:
                        owner[j] = last
        return owner

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    @property
    def busy_s(self) -> float:
        return length(self.busy) * 1e-6

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def _syncs(self, lo, hi):
        return union([(e["ts"], e["ts"] + e["dur"]) for e in self.waits
                      if e["ts"] >= lo and e["ts"] + e["dur"] <= hi])

    def host_issue_ms(self, span=CALL_SPAN):
        """Mean host time of a span less the time it blocked in syncs, ms."""
        spans = self.spans.get(span)
        if not spans:
            return None
        return sum((hi - lo) - length(self._syncs(lo, hi)) for lo, hi in spans) / len(spans) * 1e-3

    def syncs_per_call(self, span=CALL_SPAN):
        """Mean count of blocking syncs inside a span: the waits that one
        innermost host op holds (the copy and the stream sync of a `.item()`
        or of a copy to or from pageable memory) count once."""
        spans = self.spans.get(span)
        if not spans:
            return None
        ops = [e for e in self.host if e["cat"] == "cpu_op"]
        count = 0
        for lo, hi in spans:
            inside = [e for e in ops if e["ts"] >= lo and e["ts"] + e["dur"] <= hi]
            held = set()
            for w in self.waits:
                if w["ts"] < lo or w["ts"] + w["dur"] > hi:
                    continue
                around = [e for e in inside if e["ts"] <= w["ts"]
                          and w["ts"] + w["dur"] <= e["ts"] + e["dur"]]
                op = w if w["cat"] == "cpu_op" or not around else min(
                    around, key=lambda e: e["dur"])
                held.add((op["ts"], op["dur"], op["name"]))
            count += len(held)
        return count / len(spans)

    def device_ms(self, span, names=None):
        """Mean device time a span's operations took (the union of their
        intervals), ms; `names` keeps only operations whose name holds one
        of them."""
        spans = self.spans.get(span)
        if not spans:
            return None
        per_span = [[] for _ in spans]
        starts = [lo for lo, _ in spans]
        for i, e in enumerate(self.device):
            if names is not None and not any(n in e["name"] for n in names):
                continue
            at = self._owner.get(i)
            if at is None:
                continue
            k = _find(starts, at)
            if k is not None and at <= spans[k][1]:
                per_span[k].append((e["ts"], e["ts"] + e["dur"]))
        found = [length(union(ops)) for ops in per_span if ops]
        if not found:
            return None
        return sum(length(union(ops)) for ops in per_span) / len(spans) * 1e-3

    def breakdown(self, top=10):
        """The device operations that took most time in the window, and the
        idle gaps summed by the host event the main thread was in at each
        gap's midpoint (its innermost one), in seconds."""
        by_name = defaultdict(float)
        for e in self.device:
            for s, t in clip([(e["ts"], e["ts"] + e["dur"])], self.start, self.end):
                by_name[e["name"]] += (t - s) * 1e-6
        gaps = defaultdict(float)
        edges = [self.start] + [x for iv in self.busy for x in iv] + [self.end]
        host = sorted(self.host, key=lambda e: e["ts"])
        for lo, hi in zip(edges[0::2], edges[1::2]):
            if hi <= lo:
                continue
            mid = 0.5 * (lo + hi)
            inside = [e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]]
            name = min(inside, key=lambda e: e["dur"])["name"] if inside else "host outside any op"
            gaps[name] += (hi - lo) * 1e-6
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(by_name), "idle_gaps": rank(gaps)}


def _find(starts, at):
    """Index of the last span starting at or before `at`, or None."""
    lo, hi = 0, len(starts)
    while lo < hi:
        mid = (lo + hi) // 2
        if starts[mid] <= at:
            lo = mid + 1
        else:
            hi = mid
    return lo - 1 if lo else None
