"""The ranks of a cell on several chips, one process a card: rank 0 is the
process the command started, and it starts ranks 1.. as plain
subprocesses of the same command (multiprocessing's 'spawn' would leave
its resource-tracker process running), with the rendezvous at 127.0.0.1
on a free port (no file, so two runs share nothing). A watchdog thread
ends the run if a rank dies, since the others would wait for it; at the
end rank 0 waits for every rank to leave, kills any that does not, and
reaps each before it prints the last line."""

import socket
import subprocess
import sys
import threading
import time

from portbench.core.runner import os_exit

LEAVE_TIMEOUT_S = 60.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(argv, world: int, address: str):
    """Start ranks 1..world-1 running `argv` (this command) as that rank;
    their standard output goes to standard error, so that the last line of
    standard output is rank 0's."""
    return [subprocess.Popen([sys.executable, *argv, "--rank", str(r), "--address", address],
                             stdout=sys.stderr)
            for r in range(1, world)]


def watch(children):
    """End this process (and kill every rank) as soon as a rank exits with
    an error."""
    def loop():
        while True:
            for rank, child in enumerate(children, start=1):
                code = child.poll()
                if code not in (None, 0):
                    print(f"portbench: rank {rank} exited with {code}; stopping the run",
                          file=sys.stderr)
                    stop(children)
                    os_exit(1)
            if all(child.poll() == 0 for child in children):
                return
            time.sleep(0.2)

    threading.Thread(target=loop, daemon=True).start()


def stop(children, timeout=0.0):
    """Wait up to `timeout` s for every rank to leave, then kill and reap
    each that has not; returns the ranks that had to be killed."""
    deadline = time.monotonic() + timeout
    killed = []
    for rank, child in enumerate(children, start=1):
        try:
            child.wait(max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait()
            killed.append(rank)
    return killed
