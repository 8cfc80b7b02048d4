"""Device mesh construction for the DSP sharding layer (counterpart of
nx_signal_tpu/parallel/mesh.py) on torch.distributed.

The two axes of the JAX package:

* 'channel' — data parallelism over independent signal channels (the
  leading axis); no communication.
* 'block'   — time-block sequence parallelism: contiguous stream blocks per
  rank, with filter / frame / overlap-add tails exchanged between
  neighbours of the same channel row (parallel/sharded.py).

A rank is one process. `jax.device_count()` becomes the world size of the
initialised default process group, and a rank computes on
`cuda:(local_rank % torch.cuda.device_count())`, so on a machine with one
card every rank shares `cuda:0`. The CPU is used only when asked for, with
`device_type='cpu'`.
"""

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from nx_signal_tpu_torch.utils.devices import card_device

CHANNEL_AXIS = "channel"
BLOCK_AXIS = "block"

__all__ = ["make_dsp_mesh", "channel_block_sharding", "mesh_device", "CHANNEL_AXIS",
           "BLOCK_AXIS"]


def _local_rank() -> int:
    """This process's rank on its host: LOCAL_RANK where a launcher set
    it, else the global rank (one host)."""
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def _rank_device(device_type: str) -> torch.device:
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    card_device()  # raises where there is no card
    return torch.device("cuda", _local_rank() % torch.cuda.device_count())


def make_dsp_mesh(n_channel: int = 1, n_block: int = None, *, device_type: str = "cuda"):
    """Build a ('channel', 'block') `DeviceMesh` over the initialised
    default process group: by default every rank goes on the 'block' axis.
    On 'cuda' (the default) the rank's current device becomes
    `cuda:(local_rank % device_count)` first; with no card that raises,
    and `device_type='cpu'` asks for the CPU.

    The process group is the caller's: for example
    `torch.distributed.init_process_group('gloo', store=FileStore(path,
    world), rank=rank, world_size=world)`. Ranks sharing one card need the
    gloo backend (NCCL refuses two ranks on one device); the sharded ops
    stage what they exchange through host memory on it. Ranks with a card
    each may take NCCL, with gloo beside it for host tensors
    ('cpu:gloo,cuda:nccl', as `parallel.multihost.initialize` starts it).

    Examples:

    >>> import tempfile, torch.distributed as dist
    >>> from nx_signal_tpu_torch.parallel.mesh import make_dsp_mesh
    >>> store = dist.FileStore(tempfile.mkdtemp() + "/store", 1)
    >>> dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    >>> mesh = make_dsp_mesh(1, 1, device_type="cpu")
    >>> mesh.mesh_dim_names, tuple(mesh.shape)
    (('channel', 'block'), (1, 1))
    >>> dist.destroy_process_group()
    """
    if not dist.is_initialized():
        raise RuntimeError("make_dsp_mesh needs an initialised default process group "
                           "(torch.distributed.init_process_group)")
    n_devices = dist.get_world_size()
    if n_block is None:
        n_block = n_devices // n_channel
    if n_channel * n_block != n_devices:
        raise ValueError(
            f"mesh shape ({n_channel}, {n_block}) does not match {n_devices} devices")
    device = _rank_device(device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return init_device_mesh(device_type, (n_channel, n_block),
                            mesh_dim_names=(CHANNEL_AXIS, BLOCK_AXIS))


def channel_block_sharding(mesh, *, ndim: int = 2):
    """The DTensor placements, one per mesh axis, that put the leading
    (channel) axis of an `ndim`-dimensional array on 'channel' and its
    trailing (time) axis on 'block': (Shard(0), Shard(ndim - 1)); a 1-D
    array is replicated over 'channel'.

    Examples:

    >>> from nx_signal_tpu_torch.parallel.mesh import channel_block_sharding
    >>> channel_block_sharding(None, ndim=3)
    (Shard(dim=0), Shard(dim=2))
    """
    return (Shard(0) if ndim >= 2 else Replicate(), Shard(ndim - 1))


def mesh_shape(mesh):
    """(n_channel, n_block) of a ('channel', 'block') mesh."""
    names = mesh.mesh_dim_names
    return mesh.size(names.index(CHANNEL_AXIS)), mesh.size(names.index(BLOCK_AXIS))


def mesh_coordinate(mesh):
    """(channel index, block index) of this rank."""
    coord = mesh.get_coordinate()
    names = mesh.mesh_dim_names
    return coord[names.index(CHANNEL_AXIS)], coord[names.index(BLOCK_AXIS)]


def block_row(mesh):
    """(block group, global ranks of this rank's channel row in block
    order (a tuple), this rank's block index). Kept on the mesh object,
    since DeviceMesh.mesh rebuilds its rank tensor on every access (tens of
    microseconds, on every halo exchange); the cache goes with the mesh, so
    it holds no process group past the mesh's life."""
    hit = getattr(mesh, "_nx_block_row", None)
    if hit is None:
        c, b = mesh_coordinate(mesh)
        ranks = mesh.mesh if mesh.mesh_dim_names[0] == CHANNEL_AXIS else mesh.mesh.T
        hit = (mesh.get_group(BLOCK_AXIS), tuple(int(r) for r in ranks[c]), b)
        mesh._nx_block_row = hit
    return hit


def mesh_device(mesh) -> torch.device:
    """The device this rank computes on: `cuda:(local_rank %
    device_count)` on a 'cuda' mesh, the CPU on a 'cpu' one.

    Examples:

    >>> import tempfile, torch, torch.distributed as dist
    >>> from nx_signal_tpu_torch.parallel.mesh import make_dsp_mesh
    >>> store = dist.FileStore(tempfile.mkdtemp() + "/store", 1)
    >>> dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    >>> mesh = make_dsp_mesh(1, 1, device_type="cpu")
    >>> from nx_signal_tpu_torch.parallel.mesh import mesh_device
    >>> mesh_device(mesh)
    device(type='cpu')
    >>> dist.destroy_process_group()
    """
    return _rank_device(mesh.device_type)
