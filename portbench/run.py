"""Run one cell of BENCHMARK.json once and print one JSON line, the last of
standard output:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It measures nx_signal_tpu_torch on the CUDA
card(s) the cell asks for and exits non-zero, printing no result, where
there are too few, or where a module of JAX or of the JAX package was
loaded. See portbench/README.md.

The options after `--trace` are for the benchmark's own tests and its
calibration (portbench/README.md, "Calibration"), never for a measured
run: `--device
cpu` runs the program's plain CPU versions at a configuration's sizes,
`--mode control` puts the cell's control in the program's place,
`--patch module:function` calls the function first (a fault planted in the
program), `--seeds` runs several seeds after one set-up, and `--rank` and
`--address` are how rank 0 starts the others.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--mode", choices=("program", "control"), default="program")
    p.add_argument("--patch", default=None)
    p.add_argument("--seeds", default=None)
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--address", default=None)
    return p.parse_args(argv)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = _args(argv)
    from portbench.core.spec import Bench

    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    world = cell["chips"]
    if world > 1:
        # one rank a card on one host: each takes the thread budget a launcher
        # (torchrun) gives it, set before numpy and torch start their pools,
        # and the ranks it starts inherit it
        for var in THREAD_VARS:
            os.environ[var] = "1"
    import torch

    print(f"portbench: set-up: torch imported at {time.perf_counter() - T_START:.3f} s",
          file=sys.stderr, flush=True)

    from portbench.core import ranks, runner

    if args.device == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < world):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {world} CUDA device(s), found {found}",
              file=sys.stderr)
        return 3
    if args.patch:
        module, function = args.patch.split(":")
        getattr(importlib.import_module(module), function)()
    seeds = [int(s) for s in args.seeds.split(",")] if args.seeds else [args.seed]

    children = []
    try:
        if world > 1 and args.rank == 0:
            if args.device == "cuda":
                from nx_signal_tpu_torch.kernels._build import build

                build()   # before the ranks start: set-up; it compiles only in a new checkout
            address = f"127.0.0.1:{ranks.free_port()}"
            children = ranks.start([str(Path(__file__).resolve()), *argv], world, address)
            ranks.watch(children)
        else:
            address = args.address
        rank = runner.Rank(bench, args.workload, device_type=args.device, rank=args.rank,
                           world=world, address=address)
        print(f"portbench: rank {args.rank} set-up: its device and group ready at "
              f"{time.perf_counter() - T_START:.3f} s, {torch.get_num_threads()} host "
              "threads", file=sys.stderr, flush=True)
        lines = []
        for seed in seeds:
            reports, ctx = rank.run(seed, args.seconds, bool(args.trace), args.mode, T_START)
            if args.rank == 0:
                lines.append(runner.result(bench, reports, ctx, bool(args.trace)))
        if world > 1:
            if args.device == "cuda":
                from nx_signal_tpu_torch.kernels.cuda_halo import close_halo_buffers

                close_halo_buffers()
            rank.barrier()
            if args.rank != 0:
                runner.os_exit(0)       # the group's teardown is left to process exit
            killed = ranks.stop(children, ranks.LEAVE_TIMEOUT_S)
            if killed:
                print(f"portbench: ranks {killed} did not leave and were killed",
                      file=sys.stderr)
                return 5
    finally:
        ranks.stop(children)            # none is left running, whatever happened
    for line, forbidden, traces in lines:
        found = sorted({m for f in forbidden for m in f} | set(runner.forbidden_modules()))
        if found:
            print(f"portbench: forbidden modules loaded: {found}", file=sys.stderr)
            return 4
        for t in traces:
            print(f"portbench: trace {t['path']} ({t['orphans']} device operations with "
                  "no recorded launch)", file=sys.stderr)
        for name, check in line["checks"].items():
            print(f"check {name} = {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    if code == 0 and "torch" in sys.modules:
        runner = sys.modules.get("portbench.core.runner")
        if runner is not None:
            runner.os_exit(0)   # a process group's teardown at exit is not waited for
    sys.exit(code)
