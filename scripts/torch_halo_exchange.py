#!/usr/bin/env python3
"""Kernel E's exchange on ranks sharing one NVIDIA GPU, for one checkout of
the PyTorch port, so that two versions of kernel E compare in one run.

    python3 scripts/torch_halo_exchange.py [--root DIR] [--tag NAME]

Each of 4 ranks (a subprocess of this script; one gloo group over a
FileStore; all on cuda:0) imports `nx_signal_tpu_torch` from --root (by
default this repository), makes a 768 x 120320 f32 block from a seed (the
bench FIR's block on mesh (1, 4), as `chip_smoke.py` phase 8), calls kernel
E once with hl = hr = 127 and holds it bitwise against the same checkout's
plain halo (send/recv + concat), then times, all ranks together after a
barrier (host clock, median of 5): one call and a sync (`ms`), 16 calls
back to back and one sync, per call (`ms_back_to_back`), and the issue of
one call without a sync (`host_ms`). It uses only the public
`halo_extend_cuda` and `close_halo_buffers`, so any checkout since kernel E
was ported runs. With --breakdown, it also splits the issue of one call
(median of 20, a sync after each) into the host time inside each of the
library's C entry points that kernel E's plan calls (stream waits, stream
writes, the three launches) and the rest, Python (`issue_ms`); that needs
a checkout whose kernel E issues a plan (`halo_plan`).

Prints the card's name and power limit (nvidia-smi), then one JSON line
{"tag", "root", "ms", "ms_back_to_back", "host_ms"[, "issue_ms"]} with the
largest rank's medians (the breakdown of the rank whose issue took
longest). Exits non-zero without a card, or when a rank fails, hangs
(300 s) or disagrees with the plain halo.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

WORLD = 4
CHANNELS, BLOCK, PAD = 768, 120320, 127
TIMEOUT_S = 300


def _import_port(root):
    sys.path.insert(0, os.path.abspath(root))
    import nx_signal_tpu_torch

    return os.path.dirname(nx_signal_tpu_torch.__file__)


# the C entry points that a call of kernel E's plan reaches
_ENTRY_POINTS = ("nx_stream_wait_geq", "nx_stream_write", "nx_halo_put", "nx_halo_interior",
                 "nx_halo_edges")


def _issue_breakdown(call, lib, dev, reps=20):
    """Median ms, per issue of one call, spent inside each of
    _ENTRY_POINTS, the rest ('python') and in all ('total')."""
    import torch
    import torch.distributed as dist

    spent, rows = {}, []
    originals = {name: getattr(lib, name) for name in _ENTRY_POINTS}

    def timed(name, fn):
        def wrapper(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            spent[name] = spent.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return wrapper

    for name, fn in originals.items():
        setattr(lib, name, timed(name, fn))
    try:
        for _ in range(reps):
            spent.clear()
            dist.barrier()
            t0 = time.perf_counter()
            call()
            total = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize(dev)
            rows.append({"total": total, **{n: spent.get(n, 0.0) for n in _ENTRY_POINTS},
                         "python": total - sum(spent.values())})
    finally:
        for name, fn in originals.items():
            setattr(lib, name, fn)
    return {key: sorted(row[key] for row in rows)[reps // 2] for key in rows[0]}


def _rank(rank, root, tmp, breakdown):
    import torch
    import torch.distributed as dist

    _import_port(root)
    from nx_signal_tpu_torch.kernels.cuda_halo import close_halo_buffers, halo_extend_cuda
    from nx_signal_tpu_torch.parallel.halo import _halo_extend_torch
    from nx_signal_tpu_torch.parallel.mesh import make_dsp_mesh

    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), WORLD),
                            rank=rank, world_size=WORLD)
    mesh = make_dsp_mesh(1, WORLD)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(100 + rank)
    x = torch.randn((CHANNELS, BLOCK), generator=gen, device=dev)

    def call():
        return halo_extend_cuda(x, PAD, PAD, mesh=mesh)

    got = call().cpu()
    if not torch.equal(got, _halo_extend_torch(x, PAD, PAD, mesh=mesh).cpu()):
        raise AssertionError(f"rank {rank}: kernel E is not bitwise equal to the plain halo")

    def together(calls=1, wait=True):
        times = []
        for _ in range(5):
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(calls):
                call()
            if wait:
                torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t0) * 1e3 / calls)
            torch.cuda.synchronize(dev)
        return sorted(times)[2]

    report = {"ms": together(), "ms_back_to_back": together(calls=16),
              "host_ms": together(wait=False)}
    if breakdown:
        from nx_signal_tpu_torch.kernels._build import load_library

        report["issue_ms"] = _issue_breakdown(call, load_library(), dev)
    close_halo_buffers()
    reports = [None] * WORLD
    dist.all_gather_object(reports, report)
    if rank == 0:
        with open(os.path.join(tmp, "reports.json"), "w") as f:
            json.dump(reports, f)
    dist.barrier()
    dist.destroy_process_group()


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.join(os.path.dirname(__file__), ".."))
    parser.add_argument("--tag", default="this tree")
    parser.add_argument("--breakdown", action="store_true",
                        help="split the issue of one call by C entry point")
    parser.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--tmp", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.rank is not None:
        _rank(args.rank, args.root, args.tmp, args.breakdown)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("torch_halo_exchange: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    package = _import_port(args.root)
    from nx_signal_tpu_torch.kernels._build import load_library

    load_library()  # one build, before the ranks load it
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, os.path.abspath(__file__), "--root", args.root, "--tmp", tmp,
               *(["--breakdown"] if args.breakdown else [])]
        procs = [subprocess.Popen([*cmd, "--rank", str(r)]) for r in range(WORLD)]
        deadline = time.monotonic() + TIMEOUT_S
        try:
            while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
                if any(p.poll() not in (None, 0) for p in procs):
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        codes = [p.returncode for p in procs]
        if any(codes):
            print(f"torch_halo_exchange: ranks exited with {codes}", file=sys.stderr)
            return 1
        with open(os.path.join(tmp, "reports.json")) as f:
            reports = json.load(f)
    result = {key: max(r[key] for r in reports) for key in ("ms", "ms_back_to_back", "host_ms")}
    if args.breakdown:
        result["issue_ms"] = max((r["issue_ms"] for r in reports), key=lambda b: b["total"])
    print(json.dumps({"tag": args.tag, "root": package, **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
