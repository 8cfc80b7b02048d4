"""Kernel E: the halo exchange between neighbouring time blocks as a
hand-written CUDA peer copy (counterpart of
nx_signal_tpu/kernels/pallas_halo.py:halo_extend_dma; kernel in
kernels/csrc/halo.cu).

`halo_extend_cuda(x_blk, pad_left, pad_right, mesh=mesh)` returns
[left halo | x_blk | right halo]: the left neighbour's last pad_left
samples and the right neighbour's first pad_right, neighbours along the
block axis of this rank's channel row, zeros at the stream edges. Every
rank of the row calls it together.

On a CUDA tensor each rank owns two receive buffers, (C, pad_left) and (C,
pad_right), allocated with cudaMalloc (not torch's caching allocator,
whose IPC handle names a whole segment, not the tensor). Their 64-byte IPC
handles are all-gathered over the block group once, and each rank maps its
neighbours' buffers (cudaIpcOpenMemHandle). Each call then:

1. waits for its own previous assemble, and takes a barrier, so the
   neighbours have read the previous call's buffers;
2. launches one put kernel that stores its tail into the right neighbour's
   left buffer and its head into the left neighbour's right buffer, as the
   TPU kernel's two remote copies do;
3. synchronises its stream and takes a barrier: every put has landed;
4. launches one assemble kernel that writes the result.

The process group carries only the handles and the barriers; the halo data
never passes through it. Ranks may share one card (CUDA IPC between
processes on one device) or sit on several cards of a host, where the same
stores go over NVLink. There is no exchange on a row of one block.
`cudaIpcOpenMemHandle` refuses a handle of its own process, so every rank
must be a process of its own.

The buffers are kept per block group and reused while they are large
enough; `close_halo_buffers()` (collective) releases them, before the
process group is destroyed.

On a CPU tensor the wrapper returns its plain version,
`parallel.halo._halo_extend_torch` (send/recv and a concat). It counts
its launches in `halo_extend_cuda.launches`. Every sharded function of
parallel/sharded.py takes its halos from it.
"""

import ctypes

import torch
import torch.distributed as dist

from nx_signal_tpu_torch.kernels._build import load_library
from nx_signal_tpu_torch.kernels.cuda_dft import _check, _on_card
from nx_signal_tpu_torch.parallel.halo import _halo_extend_torch
from nx_signal_tpu_torch.parallel.mesh import block_row
from nx_signal_tpu_torch.utils.devices import as_signal

__all__ = ["halo_extend_cuda", "close_halo_buffers"]

_HANDLE_BYTES = 64
_WORD = 4


class _PeerBuffers:
    """One rank's receive buffers for one block group, the neighbours'
    buffers mapped into this process, and the event of its last assemble.
    Built collectively by every rank of the group."""

    def __init__(self, lib, group, row, b, left_bytes: int, right_bytes: int, device):
        self.lib, self.group, self.device = lib, group, device
        self.left_bytes, self.right_bytes = left_bytes, right_bytes
        self.last_assemble = None
        # my left halo comes from block b - 1, my right halo from b + 1
        self.recv_left = self._alloc(left_bytes) if b > 0 and left_bytes else None
        self.recv_right = self._alloc(right_bytes) if b + 1 < len(row) and right_bytes else None
        mine = torch.zeros(2 * _HANDLE_BYTES, dtype=torch.uint8)
        for k, ptr in enumerate((self.recv_left, self.recv_right)):
            if ptr is not None:
                handle = ctypes.create_string_buffer(_HANDLE_BYTES)
                _check(lib, lib.nx_ipc_get_handle(ptr, ctypes.addressof(handle)),
                       "cudaIpcGetMemHandle")
                mine[k * _HANDLE_BYTES:(k + 1) * _HANDLE_BYTES] = torch.frombuffer(
                    bytearray(handle.raw), dtype=torch.uint8)
        handles = [torch.empty_like(mine) for _ in row]
        dist.all_gather(handles, mine, group=group)
        by_block = [handles[dist.get_group_rank(group, rank)] for rank in row]
        # my tail goes to the right neighbour's left buffer, my head to the
        # left neighbour's right buffer
        self.put_right = (self._open(by_block[b + 1][:_HANDLE_BYTES])
                          if b + 1 < len(row) and left_bytes else None)
        self.put_left = (self._open(by_block[b - 1][_HANDLE_BYTES:])
                         if b > 0 and right_bytes else None)

    def _alloc(self, nbytes):
        ptr = ctypes.c_void_p()
        _check(self.lib, self.lib.nx_halo_alloc(nbytes, ctypes.addressof(ptr)), "cudaMalloc")
        return ptr.value

    def _open(self, handle):
        raw = ctypes.create_string_buffer(bytes(handle.tolist()), _HANDLE_BYTES)
        ptr = ctypes.c_void_p()
        _check(self.lib, self.lib.nx_ipc_open_handle(ctypes.addressof(raw),
                                                     ctypes.addressof(ptr)),
               "cudaIpcOpenMemHandle")
        return ptr.value

    def fits(self, left_bytes, right_bytes):
        return left_bytes <= self.left_bytes and right_bytes <= self.right_bytes

    def wait_readers(self):
        """Wait until this rank's last assemble has read its buffers."""
        if self.last_assemble is not None:
            self.last_assemble.synchronize()

    def close(self):
        """Unmap the neighbours' buffers, then (after every rank of the
        group has unmapped) free this rank's. Collective."""
        self.wait_readers()
        for ptr in (self.put_right, self.put_left):
            if ptr is not None:
                _check(self.lib, self.lib.nx_ipc_close_handle(ptr), "cudaIpcCloseMemHandle")
        dist.barrier(group=self.group)
        for ptr in (self.recv_left, self.recv_right):
            if ptr is not None:
                _check(self.lib, self.lib.nx_halo_free(ptr), "cudaFree")
        self.put_right = self.put_left = self.recv_left = self.recv_right = None


# block group id -> (group, _PeerBuffers) of this process
_BUFFERS = {}


def _peer_buffers(lib, group, row, b, left_bytes, right_bytes, device):
    """The group's buffers, reallocated (collectively) when too small.
    Called on `device` (the current device)."""
    entry = _BUFFERS.get(id(group))
    if entry is not None and entry[1].fits(left_bytes, right_bytes):
        return entry[1]
    if entry is not None:
        entry[1].close()
    bufs = _PeerBuffers(lib, group, row, b, left_bytes, right_bytes, device)
    _BUFFERS[id(group)] = (group, bufs)
    return bufs


def close_halo_buffers():
    """Release kernel E's buffers and mappings in this process. Collective:
    every rank that called `halo_extend_cuda` calls it, before the process
    group is destroyed."""
    while _BUFFERS:
        _, (_, bufs) = _BUFFERS.popitem()
        with torch.cuda.device(bufs.device):
            bufs.close()


def halo_extend_cuda(x_blk, pad_left: int, pad_right: int, *, mesh):
    """Kernel E: the (C, n) block extended to (C, pad_left + n + pad_right)
    with its block-axis neighbours' halos, zeros at the stream edges;
    `x_blk` itself when both pads are 0. Raises when a pad exceeds n. On a
    CUDA tensor (any element of 4 or 8 bytes) it runs the peer copy of
    kernels/csrc/halo.cu, bitwise equal to the plain version; on a CPU
    tensor it returns the plain version."""
    x_blk = as_signal(x_blk)
    if pad_left == 0 and pad_right == 0:
        return x_blk
    if x_blk.ndim != 2:
        raise ValueError(f"expected a (channels, block) shard, got shape {tuple(x_blk.shape)}")
    c, n = x_blk.shape
    if max(pad_left, pad_right) > n:
        raise ValueError(f"halo ({max(pad_left, pad_right)}) exceeds the per-device "
                         f"block ({n})")
    if pad_left < 0 or pad_right < 0:
        raise ValueError(f"pads must be >= 0, got ({pad_left}, {pad_right})")
    if not _on_card(x_blk):
        return _halo_extend_torch(x_blk, pad_left, pad_right, mesh=mesh)
    size = x_blk.element_size()
    if size % _WORD:
        raise ValueError(f"kernel E copies 4-byte words; {x_blk.dtype} has {size}-byte elements")
    x = x_blk.contiguous()
    group, row, b = block_row(mesh)
    ext = torch.empty((c, pad_left + n + pad_right), dtype=x.dtype, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        bufs = recv_left = recv_right = None
        if len(row) > 1:  # a row of one block has no neighbour: zeros
            bufs = _peer_buffers(lib, group, row, b, c * pad_left * size,
                                 c * pad_right * size, x.device)
            recv_left, recv_right = bufs.recv_left, bufs.recv_right
            bufs.wait_readers()
            dist.barrier(group=group)  # 1. the neighbours have read their buffers
            _put(lib, x, bufs, pad_left, pad_right, stream)
            _check(lib, lib.nx_stream_synchronize(stream), "halo put")
            dist.barrier(group=group)  # 3. every put into this rank's buffers landed
        _assemble(lib, x, ext, recv_left, recv_right, pad_left, pad_right, stream)
        if bufs is not None:
            bufs.last_assemble = torch.cuda.Event()
            bufs.last_assemble.record()
    halo_extend_cuda.launches += 1
    return ext


def _put(lib, x, bufs, pad_left, pad_right, stream):
    """Launch the put kernel: x's tail into the right neighbour's left
    buffer, its head into the left neighbour's right buffer."""
    words = x.element_size() // _WORD
    c, n = x.shape
    _check(lib, lib.nx_halo_put(x.data_ptr(), bufs.put_right, bufs.put_left, c, n * words,
                                pad_left * words, pad_right * words, stream), "halo put kernel")


def _assemble(lib, x, ext, recv_left, recv_right, pad_left, pad_right, stream):
    """Launch the assemble kernel: ext = [recv_left | x | recv_right], zeros
    for a null buffer."""
    words = x.element_size() // _WORD
    c, n = x.shape
    _check(lib, lib.nx_halo_assemble(x.data_ptr(), recv_left, recv_right, ext.data_ptr(), c,
                                     n * words, pad_left * words, pad_right * words, stream),
           "halo assemble kernel")


halo_extend_cuda.launches = 0
