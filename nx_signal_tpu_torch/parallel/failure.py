"""Failure detection + recovery for long streaming jobs (counterpart of
nx_signal_tpu/parallel/failure.py).

Two pieces: a LIVENESS PROBE - a dead or wedged peer does not raise, it
makes the next collective hang, so detection is a deadline on a tiny
round trip through every device (and an all-reduce across the process
group) - and a RESTART PATH: every op is pure, so the only state is the
streaming carry, which io/checkpoint.py snapshots atomically; recovery is
"reload the last carry and replay from that chunk".

`heartbeat` is the probe; `run_with_recovery` is the supervised loop
gluing probe + checkpoint + replay together. In-process recovery handles
transient failures (a preempted device, a flaky collective); a killed
process restarts and `run_with_recovery` resumes from the checkpoint file
it finds.
"""

import os
import threading
import time

import torch

from nx_signal_tpu_torch.io.checkpoint import load_state, save_state

__all__ = ["FailureDetected", "heartbeat", "run_with_recovery"]


class FailureDetected(RuntimeError):
    """A peer (or the local runtime) failed a liveness probe.

    Examples:

    >>> from nx_signal_tpu_torch.parallel.failure import FailureDetected
    >>> issubclass(FailureDetected, RuntimeError)   # raised by heartbeat()
    True
    """


def _default_probe(device=None):
    """A scalar put on every visible CUDA device and pulled back (or, with
    device='cpu', on the CPU), then, when a torch.distributed group of
    more than one process is up, an all-reduce of ones over it. Any dead
    peer or device makes this hang or raise. With no CUDA device and no
    device='cpu' it raises: the port runs on the card unless asked for the
    CPU."""
    if device is not None and torch.device(device).type == "cpu":
        devices = [torch.device("cpu")]
    elif torch.cuda.is_available():
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        raise RuntimeError("no CUDA device to probe; pass device='cpu' to probe the CPU")
    total = sum(float(torch.ones((), device=d)) for d in devices)
    if total != float(len(devices)):
        raise FailureDetected(f"liveness probe summed {total}, expected {len(devices)}")
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        world = dist.get_world_size()
        on = devices[0] if dist.get_backend() == "nccl" else torch.device("cpu")
        ones = torch.ones((), device=on)
        dist.all_reduce(ones)
        if float(ones) != float(world):
            raise FailureDetected(f"liveness all-reduce summed {float(ones)}, expected {world}")


def heartbeat(*, timeout: float = 30.0, probe=None, device=None) -> float:
    """Run a liveness probe with a hard deadline; returns elapsed seconds.

    Raises FailureDetected if the probe does not complete within `timeout`
    (a hung collective = dead peer) or raises (a torn-down distributed
    runtime; no CUDA device and no device='cpu'). The probe runs in a
    daemon thread so a hang cannot block the caller past the deadline; a
    timed-out probe thread is abandoned (the process is expected to exit
    and be restarted by the job scheduler - recovery is restart from the
    checkpoint, not thread surgery). `device='cpu'` asks the default probe
    for the CPU.

    Examples:

    >>> from nx_signal_tpu_torch.parallel.failure import heartbeat
    >>> heartbeat(timeout=5.0, device='cpu') >= 0.0   # seconds the probe took
    True
    """
    probe = probe or (lambda: _default_probe(device))
    err = []
    done = threading.Event()

    def run():
        try:
            probe()
        except BaseException as e:  # noqa: BLE001 - report, don't die silently
            err.append(e)
        finally:
            done.set()

    t0 = time.perf_counter()
    th = threading.Thread(target=run, daemon=True)
    th.start()
    if not done.wait(timeout):
        raise FailureDetected(
            f"liveness probe did not complete within {timeout}s "
            "(hung collective — a peer is dead or wedged)"
        )
    if err:
        raise FailureDetected(f"liveness probe failed: {err[0]!r}") from err[0]
    return time.perf_counter() - t0


def run_with_recovery(step_fn, init_state, num_steps: int, *,
                      checkpoint_path, checkpoint_every: int = 10,
                      max_restarts: int = 3, heartbeat_every: int = 0,
                      heartbeat_timeout: float = 30.0, heartbeat_device=None,
                      on_restart=None):
    """Supervised streaming loop with checkpoint/replay recovery.

    Runs `state = step_fn(state, step)` for step in [0, num_steps),
    atomically checkpointing the carry every `checkpoint_every` steps
    (io/checkpoint.py). On ANY exception from a step (or a failed
    `heartbeat`, probed every `heartbeat_every` steps when > 0, on
    `heartbeat_device`), reloads the last checkpoint and replays from its
    step - up to `max_restarts` times, then re-raises. If `checkpoint_path`
    already exists at entry, resumes from it (the process-level restart
    path). A restored state is the checkpoint's numpy leaves; the streaming
    processors move it onto the chunk's device.

    step_fn must be effectively idempotent per step (pure compute + an
    idempotent sink, e.g. writing block i to file offset i) - replayed
    steps re-run. Returns the final state. `on_restart(step, exc)` is an
    optional callback for logging/metrics.

    Examples:

    >>> import tempfile, os, torch
    >>> from nx_signal_tpu_torch.parallel.failure import run_with_recovery
    >>> p = os.path.join(tempfile.mkdtemp(), 'ck.npz')
    >>> final = run_with_recovery(lambda s, i: s + 1.0, torch.zeros(()), 5,
    ...                           checkpoint_path=p, checkpoint_every=2)
    >>> float(final)
    5.0
    """
    start = 0
    state = init_state
    if os.path.exists(checkpoint_path):
        state, meta = load_state(checkpoint_path)
        start = int(meta.get("step", 0))
    restarts = 0
    step = start
    while step < num_steps:
        try:
            if heartbeat_every and step % heartbeat_every == 0:
                heartbeat(timeout=heartbeat_timeout, device=heartbeat_device)
            state = step_fn(state, step)
            step += 1
            if step % checkpoint_every == 0 or step == num_steps:
                save_state(checkpoint_path, state, meta={"step": step})
        except Exception as exc:  # noqa: BLE001 - the recovery boundary
            restarts += 1
            if restarts > max_restarts:
                raise
            if on_restart is not None:
                on_restart(step, exc)
            if os.path.exists(checkpoint_path):
                state, meta = load_state(checkpoint_path)
                step = int(meta.get("step", 0))
            else:
                state, step = init_state, 0
    return state
