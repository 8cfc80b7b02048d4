"""The port's multi-host runtime (nx_signal_tpu_torch/parallel/multihost.py)
on the CPU: four ranks over gloo start through `initialize(address, 4,
rank)`, build their mesh with `make_pod_mesh(2, device_type='cpu')` and
read their `process_block_range`, each held against the JAX package's
function for a process that owns that one device of the mesh. Then the
single-process no-ops, and a launcher environment that is set but cannot
be reached, which raises within its timeout."""

import functools
import os
import socket
import subprocess
import sys
import time
import types

import numpy as np
import pytest

from nx_signal_tpu.parallel import multihost as jax_multihost
from tests import torch_sharded_ranks as ranks


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    return ranks.spawn(functools.partial(ranks.multihost_case, _free_port()), ranks.WORLD,
                       tmp_path_factory.mktemp("multihost"), timeout=180)


def _jax_range(total, n_channel, n_block, rank, monkeypatch):
    """The JAX package's process_block_range in a process that owns the one
    device of rank `rank` on an (n_channel, n_block) mesh, ranks in
    row-major order (a stand-in mesh: its block-axis size and each
    device's process index)."""
    devices = np.array([[types.SimpleNamespace(process_index=c * n_block + b)
                         for b in range(n_block)] for c in range(n_channel)])
    mesh = types.SimpleNamespace(shape={"channel": n_channel, "block": n_block},
                                 devices=devices)
    monkeypatch.setattr(jax_multihost.jax, "process_index", lambda: rank)
    return jax_multihost.process_block_range(total, mesh)


def test_four_ranks_start_through_initialize(reports):
    assert [r["rank"] for r in reports] == [0, 1, 2, 3]
    for r in reports:
        assert r["backend"] == "gloo" and r["world"] == 4 and r["shape"] == (2, 2)
        assert r["coordinate"] == (r["rank"] // 2, r["rank"] % 2)


@pytest.mark.parametrize("index,total", list(enumerate(ranks.MULTIHOST_TOTALS)))
def test_process_block_range(reports, index, total, monkeypatch):
    block = -(-total // 2)
    for r in reports:
        got = r["ranges"][index]
        start = (r["rank"] % 2) * block
        if start >= total:
            assert got == (0, 0)  # past the end (the JAX function gives (start, total))
        else:
            assert got == _jax_range(total, 2, 2, r["rank"], monkeypatch)
    # each channel row's ranges tile [0, total) in block order
    for row in (reports[:2], reports[2:]):
        spans = [r["ranges"][index] for r in row if r["ranges"][index] != (0, 0)]
        assert spans[0][0] == 0 and spans[-1][1] == total
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


def test_single_process_initialize_is_a_no_op(monkeypatch):
    import torch.distributed as dist

    from nx_signal_tpu_torch.parallel import multihost

    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(key, raising=False)
    multihost.initialize()
    multihost.initialize("127.0.0.1:1", num_processes=1, process_id=0)
    assert not dist.is_initialized()


_UNREACHABLE = """
import os, sys, time
from nx_signal_tpu_torch.parallel import multihost
t0 = time.monotonic()
try:
    multihost.initialize(timeout=float(sys.argv[1]))
except Exception as exc:
    print("raised", type(exc).__name__, round(time.monotonic() - t0, 1))
else:
    print("started")
"""


@pytest.mark.parametrize("env", [
    dict(RANK="1", WORLD_SIZE="2", MASTER_ADDR="127.0.0.1"),  # nobody listens at the port
    dict(RANK="0", WORLD_SIZE="2"),                           # no MASTER_ADDR / MASTER_PORT
])
def test_a_set_but_unreachable_environment_raises(env):
    """A launcher's environment that is set but fails raises within the
    timeout (5 s), never starting a one-process run."""
    full = {k: v for k, v in os.environ.items()
            if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_WORLD_SIZE")}
    full.update(env, MASTER_PORT=str(_free_port()) if "MASTER_ADDR" in env else "",
                PYTHONPATH=os.getcwd())
    if not full["MASTER_PORT"]:
        del full["MASTER_PORT"]
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", _UNREACHABLE, "5"], env=full,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.startswith("raised"), out.stdout + out.stderr[-2000:]
    assert float(out.stdout.split()[-1]) < 30.0
    assert time.monotonic() - t0 < 90.0


@pytest.mark.parametrize("cards,ranks_here,want", [
    (0, 4, "gloo"),                  # no card
    (1, 4, "gloo"),                  # four ranks share one card
    (2, 4, "gloo"),
    (4, 4, "cpu:gloo,cuda:nccl"),    # a card each
    (8, 2, "cpu:gloo,cuda:nccl"),
])
def test_backend_takes_nccl_only_with_gloo_beside_it(monkeypatch, cards, ranks_here, want):
    """Where each rank has a card, CUDA tensors go over NCCL and host tensors
    (kernel E's set-up, the liveness probe) over gloo: an NCCL-only group
    would refuse them."""
    import torch
    import torch.distributed as dist

    from nx_signal_tpu_torch.parallel import multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert multihost._backend(ranks_here) == want
    started = []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: started.append((a, kw)))
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    multihost.initialize("127.0.0.1:29500", ranks_here, 1, timeout=7.0)
    (backend,), kw = started[0]
    assert backend == want and kw["init_method"] == "tcp://127.0.0.1:29500"
    assert (kw["world_size"], kw["rank"], kw["timeout"].total_seconds()) == (ranks_here, 1, 7.0)
