"""Multi-host runtime on torch.distributed (counterpart of
nx_signal_tpu/parallel/multihost.py): process-group start-up and the
cross-host mesh layout.

* One process per rank; `initialize()` starts the default process group
  on every rank before any other distributed call.
* Mesh layout as in the JAX package: 'block' (time-block sequence
  parallelism) on the trailing mesh axis, so a channel row's time blocks,
  which exchange halos, are consecutive ranks; launchers number the ranks
  of one host consecutively, so they share a host. 'channel' (no
  communication) spans hosts.
* Halos cross a host boundary only at the two edge blocks of a host.
"""

import os
from datetime import timedelta

import torch
import torch.distributed as dist

from nx_signal_tpu_torch.parallel.mesh import BLOCK_AXIS, make_dsp_mesh, mesh_coordinate

__all__ = ["initialize", "make_pod_mesh", "process_block_range"]

_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def _backend(ranks_here: int) -> str:
    """NCCL for CUDA tensors where each rank of this host has a card of its
    own, with gloo beside it for CPU tensors (kernel E's set-up and the
    liveness probe's host sums); gloo alone where ranks share a card (NCCL
    refuses two ranks on one device) or there is none."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return "cpu:gloo,cuda:nccl" if 0 < ranks_here <= cards else "gloo"


def initialize(coordinator_address=None, num_processes=None, process_id=None, *,
               timeout: float = 300.0):
    """Start the default process group. Call it first on every rank.

    With explicit arguments it starts exactly as told:
    `init_process_group(init_method=f"tcp://{coordinator_address}",
    world_size=num_processes, rank=process_id)` (coordinator_address is
    "host:port", rank 0 listens there), and does nothing when
    num_processes <= 1. With none, it reads a launcher's environment
    (RANK, WORLD_SIZE, MASTER_ADDR, as torchrun sets them): with none of
    them set it does nothing (a plain single process), and an environment
    that is set but fails raises, never falling back to one process (which
    would zero-fill the halos at the blocks of other ranks).

    The backend is gloo where the ranks of a host share a card or have
    none. Where each has a card of its own (the ranks of a host:
    LOCAL_WORLD_SIZE where a launcher sets it, else all of them) it is
    NCCL for CUDA tensors and gloo for CPU ones ('cpu:gloo,cuda:nccl'), so
    a collective on a host tensor still works. Start-up gives up and
    raises after `timeout` seconds.

    Examples:

    >>> import torch.distributed as dist
    >>> from nx_signal_tpu_torch.parallel.multihost import initialize
    >>> initialize(num_processes=1)   # one process: no group to start
    >>> dist.is_initialized()
    False
    """
    wait = timedelta(seconds=timeout)
    if num_processes is not None:
        if num_processes > 1:
            here = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
            dist.init_process_group(_backend(here), init_method=f"tcp://{coordinator_address}",
                                    world_size=num_processes, rank=process_id, timeout=wait)
        return
    if not any(key in os.environ for key in _LAUNCHER_ENV):
        return  # no launcher: a single process
    here = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    dist.init_process_group(_backend(here), init_method="env://", timeout=wait)


def make_pod_mesh(n_channel: int = 1, *, device_type: str = "cuda"):
    """('channel', 'block') mesh over every rank of the job, channel axis
    first so each channel row's time blocks are consecutive ranks:
    `make_dsp_mesh(n_channel, world // n_channel)`.

    Examples:

    >>> import tempfile, torch.distributed as dist
    >>> from nx_signal_tpu_torch.parallel.multihost import make_pod_mesh
    >>> store = dist.FileStore(tempfile.mkdtemp() + "/store", 1)
    >>> dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    >>> tuple(make_pod_mesh(1, device_type="cpu").shape)
    (1, 1)
    >>> dist.destroy_process_group()
    """
    return make_dsp_mesh(n_channel, device_type=device_type)  # n_block = world // n_channel


def process_block_range(total_samples: int, mesh):
    """Half-open [start, end) sample range of this rank's time block (block
    = ceil(total_samples / n_block)); (0, 0) for a block past the end.
    Each rank feeds this range of a stream into the sharded functions.

    Examples:

    >>> import tempfile, torch.distributed as dist
    >>> from nx_signal_tpu_torch.parallel.multihost import make_pod_mesh, process_block_range
    >>> store = dist.FileStore(tempfile.mkdtemp() + "/store", 1)
    >>> dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    >>> process_block_range(48000, make_pod_mesh(1, device_type="cpu"))
    (0, 48000)
    >>> dist.destroy_process_group()
    """
    n_block = mesh.size(mesh.mesh_dim_names.index(BLOCK_AXIS))
    block = -(-total_samples // n_block)
    start = mesh_coordinate(mesh)[1] * block
    if start >= total_samples:
        return (0, 0)
    return (start, min(start + block, total_samples))
