"""One run of one cell: set-up, warm-up, the measured window, the check of
what the window produced against the reference, the metrics and the last
line.

A cell on one chip runs in this process. A cell on several runs one rank a
card: this process is rank 0 and starts the others (core/ranks.py); every
rank runs `Rank.run` and rank 0 gathers what they measured.

The window. Calls are issued back to back with at most `in_flight` (the
traffic mix's) not yet complete: a stream's double buffer. Each call is
timed on the host clock from its issue to the moment the host sees its
completion event; the window runs from the first issue to the last
completion. On one chip the window issues calls until `--seconds` have
passed. On several, every rank must make the same calls (each exchanges
halos with its neighbours), so they agree at set-up on a count of calls
that lasts `--seconds` at the pace of the warm-up.

With `--trace 1` the window runs a short untraced stretch, then
torch.profiler over the next few seconds; the metric readers read that
trace (core/timeline.py).
"""

import math
import os
import sys
import time
from collections import deque

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench.core.timeline import CALL_SPAN, Timeline

FORBIDDEN = ("jax", "jaxlib", "flax", "nx_signal_tpu")
TRACE_PRE_S = 1.0
TRACE_S = 3.0
WARMUP_TIMED_CALLS = 4


def forbidden_modules():
    """Modules loaded in this process whose top-level name is one of
    FORBIDDEN, compared whole."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class Context:
    """What a metric reader sees: the cell, its configuration and traffic,
    the window's host-clock record and, in a traced run, the timeline."""

    def __init__(self, bench, cell, cfg, traffic, rank, world, device_name, window,
                 timeline=None):
        self.bench, self.cell, self.cfg, self.traffic = bench, cell, cfg, traffic
        self.rank, self.world, self.device_name = rank, world, device_name
        self.window, self.timeline = window, timeline


def _now():
    return time.perf_counter()


class Rank:
    """One rank of a run (the only one on one chip)."""

    def __init__(self, bench, cell_name, *, device_type, rank=0, world=1, address=None):
        self.bench = bench
        self.cell = bench.cell(cell_name)
        self.cfg = bench.config(self.cell["config"])
        self.traffic = bench.traffic(self.cell["traffic"])
        self.rank, self.world = rank, world
        self.cuda = device_type == "cuda"
        self.mesh = None
        if world > 1:
            from nx_signal_tpu_torch.parallel.mesh import make_dsp_mesh
            from nx_signal_tpu_torch.parallel.multihost import initialize

            initialize(address, world, rank, timeout=120.0)
            self.mesh = make_dsp_mesh(1, world, device_type=device_type)
        self.device = torch.device("cuda", torch.cuda.current_device()) if self.cuda \
            else torch.device("cpu")
        self.device_name = torch.cuda.get_device_name(self.device) if self.cuda else "cpu"
        self.entries = bench.module("entries", self.traffic["entry"])

    # ------------------------------------------------------------ helpers
    def _mark(self):
        if not self.cuda:
            return None
        event = torch.cuda.Event()
        event.record()
        return event

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def _gather(self, obj):
        if self.world == 1:
            return [obj]
        import torch.distributed as dist

        every = [None] * self.world
        dist.all_gather_object(every, obj)
        return every

    def barrier(self):
        if self.world > 1:
            import torch.distributed as dist

            dist.all_reduce(torch.zeros(1))   # a host tensor: the gloo side of the group

    def _loop(self, entry, stop, keep, on_issue=None):
        """Issue calls until `stop(i, t)`, at most `in_flight` outstanding;
        returns (calls, latencies in s, first issue, last completion)."""
        in_flight = self.traffic["in_flight"]
        pending, latencies = deque(), []
        i, first, last = 0, None, None
        while True:
            t = _now()
            if len(pending) < in_flight and not stop(i, t):
                if on_issue is not None:
                    on_issue(i)
                first = t if first is None else first
                with record_function(CALL_SPAN):
                    out = entry.call(i)
                pending.append((t, self._mark(), out, i))
                i += 1
                continue
            if not pending:
                return i, latencies, first, last
            t_issue, mark, out, k = pending.popleft()
            if mark is not None:
                mark.synchronize()
            last = _now()
            latencies.append(last - t_issue)
            keep[k % entry.blocks] = out

    # ------------------------------------------------------------ a run
    def run(self, seed, seconds, trace, mode, t_start):
        """Everything of one seed on this rank; returns this rank's report."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        entry = self.entries.Entry(self.cfg, self.traffic, device=self.device, gen=gen,
                                   mode=mode, mesh=self.mesh, bench=self.bench)
        self._sync()
        built = _now() - t_start
        keep = {}
        warm = self.traffic["warmup_calls"]
        self._loop(entry, lambda i, t: i >= warm, keep)
        self._sync()
        t0 = _now()
        self._loop(entry, lambda i, t: i >= WARMUP_TIMED_CALLS, keep)
        self._sync()
        per_call = (_now() - t0) / WARMUP_TIMED_CALLS
        keep.clear()
        # every rank takes the slowest rank's pace, so all make the same calls
        per_call = max(self._gather(per_call))
        self.barrier()
        setup_s = _now() - t_start
        print(f"portbench: rank {self.rank} set-up: inputs and program ready at {built:.3f} s, "
              f"warm at {setup_s:.3f} s", file=sys.stderr, flush=True)

        prof, path = None, None
        if trace:
            pre = min(TRACE_PRE_S, seconds / 4)
            span = min(TRACE_S, seconds - pre)
            count = max(2, math.ceil((pre + span) / per_call))
            start_at = min(max(1, round(pre / per_call)), count - 1)
            prof = profile(activities=[ProfilerActivity.CPU]
                           + ([ProfilerActivity.CUDA] if self.cuda else []))

            def on_issue(i):
                if i == start_at:
                    prof.start()
        else:
            count = max(2, math.ceil(seconds / per_call))
            on_issue = None
        if self.world == 1 and not trace:
            deadline = _now() + seconds
            stop = lambda i, t: t >= deadline
        else:
            stop = lambda i, t: i >= count
        calls, latencies, first, last = self._loop(entry, stop, keep, on_issue)
        self._sync()
        timeline = None
        if prof is not None:
            prof.stop()
            folder = self.bench.root / "portbench" / "_traces"
            folder.mkdir(exist_ok=True)
            path = folder / f"{self.cell['name']}.rank{self.rank}.json.gz"   # ~1 MB, not ~10
            prof.export_chrome_trace(str(path))
            timeline = Timeline(path)
        # the peak since the process started: set-up, warm-up and window
        memory = torch.cuda.max_memory_allocated(self.device) if self.cuda else 0
        window = {"calls": calls, "window_s": last - first, "latencies_s": latencies,
                  "samples_per_call": entry.samples_per_call, "setup_s": setup_s,
                  "per_call_s": per_call, "judged": len(keep)}
        ctx = Context(self.bench, self.cell, self.cfg, self.traffic, self.rank, self.world,
                      self.device_name, window, timeline)
        layer = {}
        if trace:
            for metric in self.bench.per_layer(self.cell["name"]):
                value = self.bench.reader(metric["name"]).read(ctx)
                if value is not None:
                    layer[metric["name"]] = value
        entry.free()     # the program's state; what it produced stays in `keep`
        part = entry.judge(keep)
        keep.clear()
        del entry
        self._sync()
        if self.cuda:
            torch.cuda.empty_cache()
        report = {"rank": self.rank, "window": window, "layer": layer, "part": part,
                  "memory": memory, "forbidden": forbidden_modules(), "trace": None}
        if timeline is not None:
            report["trace"] = {"busy_s": timeline.busy_s, "window_s": timeline.window_s,
                               "breakdown": timeline.breakdown(),
                               "orphans": timeline.orphans, "path": str(path)}
        self.barrier()
        return self._gather(report), ctx


def _reduce(values, how):
    if how == "min":
        return min(values)
    if how == "mean":
        return sum(values) / len(values)
    return max(values)


def result(bench, reports, ctx, trace):
    """The last line's object, from every rank's report (rank 0 calls it)."""
    cell = ctx.cell
    entries = bench.module("entries", ctx.traffic["entry"])
    values = entries.verdict([r["part"] for r in reports])
    limits = ctx.traffic["limits"]
    checks = {name: {"value": values.get(name, float("nan")), "limit": limit}
              for name, limit in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    windows = [r["window"] for r in reports]
    combined = dict(windows[0])
    combined["window_s"] = max(w["window_s"] for w in windows)
    ctx.window = combined
    metrics = {}
    if trace:
        for metric in bench.per_layer(cell["name"]):
            name = metric["name"]
            found = [r["layer"][name] for r in reports if name in r["layer"]]
            if found:
                how = getattr(bench.reader(name), "REDUCE", "max")
                metrics[name] = {"value": _reduce(found, how), "unit": metric["unit"]}
    else:
        for metric in bench.end_to_end(cell["name"]):
            value = bench.reader(metric["name"]).read(ctx)
            if value is not None:
                metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    device = {"platform": "gpu" if ctx.device_name != "cpu" else "cpu",
              "kind": ctx.device_name, "count": ctx.world,
              "memory_peak_bytes": max(r["memory"] for r in reports)}
    line = {"correct": correct, "attempted": combined["calls"],
            "failed": 0 if correct else combined["judged"],
            "metrics": metrics, "device": device}
    traces = [r["trace"] for r in reports if r["trace"] is not None]
    if traces:
        device["busy_s"] = sum(t["busy_s"] for t in traces) / len(traces)
        device["window_s"] = sum(t["window_s"] for t in traces) / len(traces)
        line["breakdown"] = traces[0]["breakdown"]
    line["checks"] = checks
    return line, [r["forbidden"] for r in reports], traces


def os_exit(code):
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
