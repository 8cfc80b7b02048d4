"""Kernel E: the halo exchange between neighbouring time blocks as a
hand-written CUDA peer put with its signals in device memory (counterpart
of nx_signal_tpu/kernels/pallas_halo.py:halo_extend_dma; kernels in
kernels/csrc/halo.cu).

`halo_extend_cuda(x_blk, pad_left, pad_right, mesh=mesh)` returns
[left halo | x_blk | right halo]: the left neighbour's last pad_left
samples and the right neighbour's first pad_right, neighbours along the
block axis of this rank's channel row, zeros at the stream edges. Every
rank of the row calls it together.

On a CUDA tensor each rank owns one buffer per block group, allocated with
cudaMalloc (not torch's caching allocator, whose IPC handle names a whole
segment, not the tensor): four 64-bit sequence counters ("arrived from
left", "arrived from right", "freed by left", "freed by right"), zeroed at
creation, then two slots of the left receive buffer, (C, pad_left) each,
and two of the right one, (C, pad_right). The 64-byte IPC handles are
all-gathered over the block group once, and each rank maps its
neighbours' buffers (cudaIpcOpenMemHandle). That set-up, its growth and
`close_halo_buffers` are collective; they synchronise this rank's stream
before their barrier.

Each call after set-up is numbered by a per-group counter, the same on
every rank, and uses slot number mod 2. `halo_plan` lists its operations,
all issued on the caller's current stream: stream waits on this rank's own
counters (`cuStreamWaitValue64`, >=), the put kernel into the neighbours'
slots, stream writes of the call's number into the neighbours' counters
(`cuStreamWriteValue64`, fenced), the interior kernel, and the edges
kernel that copies the received slots into the result. No call makes a
torch.distributed call, a stream or device sync or an Event.synchronize:
the stream's front end does the waiting, as the TPU kernel's receive
semaphores do. A rank that stops calling leaves its neighbours' streams
waiting. A call on another stream than the group's last one first makes
its stream wait (on the device) for an event recorded on the old one.

Ranks may share one card (CUDA IPC between processes on one device) or sit
on several cards of a host, where the same stores go over NVLink and the
waits flush remote writes where the device allows it (unmeasured). There
is no exchange on a row of one block. `cudaIpcOpenMemHandle` refuses a
handle of its own process, so every rank must be a process of its own. A
device without 64-bit stream memory operations raises; there is no other
way through.

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

__all__ = ["halo_extend_cuda", "close_halo_buffers", "halo_plan"]

_HANDLE_BYTES = 64
_WORD = 4
_SLOTS = 2
# the counters of a buffer, 8 bytes each at its start, in this order
_COUNTERS = ("arrived_left", "arrived_right", "freed_left", "freed_right")
_ALIGN = 256  # the counters' block and each slot start on this many bytes


def halo_plan(b: int, blocks: int, call: int, left: bool, right: bool):
    """(slot, operations) of call number `call` (1, 2, ...) of block `b` in
    a row of `blocks`, with a left halo where `left` (pad_left > 0) and a
    right one where `right`, in the order the stream issues them:

    - ('wait', owner, counter, value): the stream waits until that counter
      in block `owner`'s memory (always this block's) is >= value;
    - ('put', ((owner, side, slot), ...)): the put kernel stores into those
      slots of the neighbours' receive buffers ('left' or 'right');
    - ('write', owner, counter, value): a fenced stream write of value into
      a neighbour's counter;
    - ('interior', zero_left, zero_right): the block into the result, and
      zeros in the halo columns of a side that receives nothing;
    - ('edges', ((owner, side, slot), ...)): this block's received slots
      into the result's halo columns.

    Block b writes its tail into the left slot of b + 1 and its head into
    the right slot of b - 1, after the owner freed the slot's previous use
    (call - 2); it signals arrival after the put and frees its own slots
    after the edges. The counters of an existing neighbour are written on
    every call, with or without a halo that way, so a later call with other
    pads waits on up-to-date numbers.

    Examples:

    >>> from nx_signal_tpu_torch.kernels.cuda_halo import halo_plan
    >>> slot, ops = halo_plan(0, 2, 3, True, False)
    >>> slot
    1
    >>> for op in ops:
    ...     print(op)
    ('wait', 0, 'freed_right', 1)
    ('put', ((1, 'left', 1),))
    ('write', 1, 'arrived_left', 3)
    ('interior', True, True)
    ('write', 1, 'freed_left', 3)
    """
    slot = call % _SLOTS
    has_left, has_right = b > 0, b + 1 < blocks
    put_right, put_left = has_right and left, has_left and right
    get_left, get_right = has_left and left, has_right and right
    ops = []
    if call > _SLOTS:
        if put_right:
            ops.append(("wait", b, "freed_right", call - _SLOTS))
        if put_left:
            ops.append(("wait", b, "freed_left", call - _SLOTS))
    targets = ((b + 1, "left", slot),) * put_right + ((b - 1, "right", slot),) * put_left
    if targets:
        ops.append(("put", targets))
    if has_right:
        ops.append(("write", b + 1, "arrived_left", call))
    if has_left:
        ops.append(("write", b - 1, "arrived_right", call))
    ops.append(("interior", not get_left, not get_right))
    if get_left:
        ops.append(("wait", b, "arrived_left", call))
    if get_right:
        ops.append(("wait", b, "arrived_right", call))
    sources = ((b, "left", slot),) * get_left + ((b, "right", slot),) * get_right
    if sources:
        ops.append(("edges", sources))
    if has_left:
        ops.append(("write", b - 1, "freed_right", call))
    if has_right:
        ops.append(("write", b + 1, "freed_left", call))
    return slot, tuple(ops)


def _round_up(nbytes: int) -> int:
    return -(-nbytes // _ALIGN) * _ALIGN


class _PeerBuffers:
    """One rank's buffer for one block group (counters and receive slots),
    its neighbours' buffers mapped into this process, the number of its
    last call and the stream that issued it. Built collectively by every
    rank of the group."""

    def __init__(self, lib, group, row, b, left_bytes: int, right_bytes: int, device):
        self.lib, self.group, self.b, self.device = lib, group, b, device
        flush = ctypes.c_int64()
        err = lib.nx_stream_ops_init(ctypes.addressof(flush))
        if err:
            raise RuntimeError(
                f"kernel E needs the device's 64-bit stream memory operations "
                f"(cuStreamWaitValue64, cuStreamWriteValue64): "
                f"{lib.nx_error_string(err).decode()} ({err})")
        self.left_bytes, self.right_bytes = _round_up(left_bytes), _round_up(right_bytes)
        self.calls, self.stream = 0, None
        ptr = ctypes.c_void_p()
        _check(lib, lib.nx_halo_alloc(_ALIGN + _SLOTS * (self.left_bytes + self.right_bytes),
                                      ctypes.addressof(ptr)), "cudaMalloc")
        self.base = {b: ptr.value}
        handle = ctypes.create_string_buffer(_HANDLE_BYTES)
        _check(lib, lib.nx_ipc_get_handle(self.base[b], ctypes.addressof(handle)),
               "cudaIpcGetMemHandle")
        # as objects: the group's backend may take only CUDA tensors (NCCL)
        mine = (handle.raw, self.left_bytes, self.right_bytes)
        gathered = [None] * len(row)
        dist.all_gather_object(gathered, mine, group=group)
        by_block = [gathered[dist.get_group_rank(group, rank)] for rank in row]
        if any(g[1:] != mine[1:] for g in by_block):
            raise ValueError(f"kernel E: the ranks of a block row asked for receive buffers of "
                             f"different sizes ({[list(g[1:]) for g in by_block]})")
        for j in (b - 1, b + 1):
            if 0 <= j < len(row):
                raw = ctypes.create_string_buffer(by_block[j][0], _HANDLE_BYTES)
                peer = ctypes.c_void_p()
                _check(lib, lib.nx_ipc_open_handle(ctypes.addressof(raw),
                                                   ctypes.addressof(peer)),
                       "cudaIpcOpenMemHandle")
                self.base[j] = peer.value
        # a neighbour's buffer on another card: its stores arrive as remote
        # writes, which a wait flushes where the device allows it
        ordinals = []
        for j, ptr in self.base.items():
            if j != b:
                ordinal = ctypes.c_int64()
                _check(lib, lib.nx_pointer_device(ptr, ctypes.addressof(ordinal)),
                       "cudaPointerGetAttributes")
                ordinals.append(ordinal.value)
        self.flush = int(bool(flush.value) and any(o != device.index for o in ordinals))

    def counter(self, owner: int, name: str) -> int:
        """Address of a counter in block `owner`'s buffer (this block's or a
        neighbour's mapping)."""
        return self.base[owner] + 8 * _COUNTERS.index(name)

    def slot(self, owner: int, side: str, slot: int) -> int:
        """Address of a receive slot in block `owner`'s buffer."""
        start = self.base[owner] + _ALIGN
        if side == "left":
            return start + slot * self.left_bytes
        return start + _SLOTS * self.left_bytes + slot * self.right_bytes

    def fits(self, left_bytes, right_bytes):
        return left_bytes <= self.left_bytes and right_bytes <= self.right_bytes

    def follow(self, stream):
        """Issue on `stream` next: if the last call used another stream, the
        new one first waits, on the device, for everything issued there."""
        if self.stream is not None and self.stream != stream:
            done = torch.cuda.Event()
            done.record(self.stream)
            stream.wait_event(done)
        self.stream = stream

    def close(self):
        """Drain this rank's stream, unmap the neighbours' buffers, then
        (after every rank of the group has done so) free this rank's.
        Collective."""
        if self.stream is not None:
            self.stream.synchronize()  # no wait of ours pends on memory about to go
        for j, ptr in self.base.items():
            if j != self.b:
                _check(self.lib, self.lib.nx_ipc_close_handle(ptr), "cudaIpcCloseMemHandle")
        dist.barrier(group=self.group)
        _check(self.lib, self.lib.nx_halo_free(self.base[self.b]), "cudaFree")
        self.base = {}


# block group id -> (group, _PeerBuffers) of this process
_BUFFERS = {}


def _peer_buffers(lib, group, row, b, left_bytes, right_bytes, device):
    """The group's buffers, reallocated (collectively, counters from zero)
    when too small. Called on `device` (the current device)."""
    entry = _BUFFERS.get(id(group))
    if entry is not None and entry[1].fits(left_bytes, right_bytes):
        return entry[1]
    if entry is not None:
        entry[1].close()
        left_bytes = max(left_bytes, entry[1].left_bytes)
        right_bytes = max(right_bytes, entry[1].right_bytes)
    bufs = _PeerBuffers(lib, group, row, b, left_bytes, right_bytes, device)
    _BUFFERS[id(group)] = (group, bufs)
    return bufs


def close_halo_buffers():
    """Release kernel E's buffers and mappings in this process. Collective:
    every rank that called `halo_extend_cuda` calls it, before the process
    group is destroyed.

    Examples:

    >>> from nx_signal_tpu_torch.kernels.cuda_halo import close_halo_buffers
    >>> close_halo_buffers()   # none open in this process: nothing to release
    """
    while _BUFFERS:
        _, (_, bufs) = _BUFFERS.popitem()
        with torch.cuda.device(bufs.device):
            bufs.close()


def halo_extend_cuda(x_blk, pad_left: int, pad_right: int, *, mesh):
    """Kernel E: the (C, n) block extended to (C, pad_left + n + pad_right)
    with its block-axis neighbours' halos, zeros at the stream edges;
    `x_blk` itself when both pads are 0. Raises when a pad exceeds n. On a
    CUDA tensor (any element of 4 or 8 bytes) it issues the operations of
    `halo_plan` on the current stream, bitwise equal to the plain version;
    on a CPU tensor it returns the plain version.

    Examples:

    >>> import tempfile, torch, torch.distributed as dist
    >>> from nx_signal_tpu_torch.parallel.mesh import make_dsp_mesh
    >>> store = dist.FileStore(tempfile.mkdtemp() + "/store", 1)
    >>> dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    >>> mesh = make_dsp_mesh(1, 1, device_type="cpu")
    >>> from nx_signal_tpu_torch.kernels.cuda_halo import halo_extend_cuda
    >>> halo_extend_cuda(torch.arange(4.0).reshape(1, 4), 2, 1, mesh=mesh)  # no neighbour: zeros
    tensor([[0., 0., 0., 1., 2., 3., 0.]])
    >>> dist.destroy_process_group()
    """
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
        stream = torch.cuda.current_stream()
        if len(row) == 1:  # a row of one block has no neighbour: zeros
            _interior(lib, x, ext, pad_left, pad_right, True, True, stream.cuda_stream)
        else:
            bufs = _peer_buffers(lib, group, row, b, c * pad_left * size,
                                 c * pad_right * size, x.device)
            bufs.follow(stream)
            bufs.calls += 1
            slot, ops = halo_plan(b, len(row), bufs.calls, pad_left > 0, pad_right > 0)
            _issue(lib, bufs, ops, x, ext, pad_left, pad_right, stream.cuda_stream)
    halo_extend_cuda.launches += 1
    return ext


def _issue(lib, bufs, ops, x, ext, pad_left, pad_right, stream):
    """Issue a call's operations (`halo_plan`) on `stream`."""
    for op in ops:
        kind = op[0]
        if kind == "wait":
            _check(lib, lib.nx_stream_wait_geq(stream, bufs.counter(op[1], op[2]), op[3],
                                               bufs.flush), "halo wait (cuStreamWaitValue64)")
        elif kind == "write":
            _check(lib, lib.nx_stream_write(stream, bufs.counter(op[1], op[2]), op[3]),
                   "halo signal (cuStreamWriteValue64)")
        elif kind == "interior":
            _interior(lib, x, ext, pad_left, pad_right, op[1], op[2], stream)
        else:
            slots = {side: bufs.slot(owner, side, slot) for owner, side, slot in op[1]}
            if kind == "put":
                _put(lib, x, slots.get("left"), slots.get("right"), pad_left, pad_right, stream)
            else:
                _edges(lib, x, ext, slots.get("left"), slots.get("right"), pad_left,
                       pad_right, stream)


def _put(lib, x, right_left, left_right, pad_left, pad_right, stream):
    """Launch the put kernel: x's tail into the right neighbour's left slot
    `right_left`, its head into the left neighbour's right slot
    `left_right` (either None)."""
    words = x.element_size() // _WORD
    c, n = x.shape
    _check(lib, lib.nx_halo_put(x.data_ptr(), right_left, left_right, c, n * words,
                                pad_left * words, pad_right * words, stream), "halo put kernel")


def _interior(lib, x, ext, pad_left, pad_right, zero_left, zero_right, stream):
    """Launch the interior kernel: ext[:, pad_left:pad_left + n] = x, and
    zeros in the halo columns of a zeroed side."""
    words = x.element_size() // _WORD
    c, n = x.shape
    _check(lib, lib.nx_halo_interior(x.data_ptr(), ext.data_ptr(), c, n * words,
                                     pad_left * words, pad_right * words, int(zero_left),
                                     int(zero_right), stream), "halo interior kernel")


def _edges(lib, x, ext, recv_left, recv_right, pad_left, pad_right, stream):
    """Launch the edges kernel: the received slots `recv_left` and
    `recv_right` (either None) into ext's halo columns."""
    words = x.element_size() // _WORD
    c, n = x.shape
    _check(lib, lib.nx_halo_edges(recv_left, recv_right, ext.data_ptr(), c, n * words,
                                  pad_left * words, pad_right * words, stream),
           "halo edges kernel")


halo_extend_cuda.launches = 0
