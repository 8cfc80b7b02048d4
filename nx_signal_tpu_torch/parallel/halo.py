"""The plain neighbour exchange of the sharded layer: point-to-point
send/recv along the block axis of a ('channel', 'block') mesh, with zeros
at the stream edges (counterpart of the ppermute shifts of
nx_signal_tpu/parallel/sharded.py).

`_halo_extend_torch` is the plain version of kernel E
(kernels/cuda_halo.py:halo_extend_cuda), which the sharded functions call;
`_shift_from_left` also carries the overlap-add tails of
`parallel.sharded.sharded_istft`. A gloo group takes CPU tensors, so a
CUDA tensor is staged through host memory.
"""

import torch
import torch.distributed as dist

from nx_signal_tpu_torch.parallel.mesh import block_row


def _staged(t, group):
    """(the tensor the group's backend sends, whether it is a host copy):
    gloo takes CPU tensors, so a CUDA tensor goes through host memory."""
    if t.device.type != "cpu" and dist.get_backend(group) == "gloo":
        return t.detach().cpu().contiguous(), True
    return t.contiguous(), False


def _shift(x, mesh, step: int):
    """Each rank receives the `x` of its block neighbour at `-step` along
    the block axis of its channel row (zeros where there is none) and sends
    its own to the neighbour at `+step`: point-to-point ops, no cycle."""
    group, row, b = block_row(mesh)
    send, staged = _staged(x, group)
    recv = torch.zeros_like(send)
    ops = []
    if 0 <= b + step < len(row):
        ops.append(dist.P2POp(dist.isend, send, row[b + step], group, tag=step % 3))
    if 0 <= b - step < len(row):
        ops.append(dist.P2POp(dist.irecv, recv, row[b - step], group, tag=step % 3))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv.to(x.device) if staged else recv


def _shift_from_left(x, mesh):
    """Each rank receives its LEFT neighbour's `x`; block 0 receives zeros."""
    return _shift(x, mesh, 1)


def _shift_from_right(x, mesh):
    """Each rank receives its RIGHT neighbour's `x`; the last block receives
    zeros."""
    return _shift(x, mesh, -1)


def _halo_extend_torch(x_blk, pad_left: int, pad_right: int, *, mesh):
    """Plain version of kernel E: [left neighbour's last pad_left samples |
    x_blk | right neighbour's first pad_right samples] along the last axis,
    zeros at the stream edges, by send/recv and a concat."""
    if pad_left == 0 and pad_right == 0:
        return x_blk
    n = x_blk.shape[-1]
    if max(pad_left, pad_right) > n:
        raise ValueError(f"halo ({max(pad_left, pad_right)}) exceeds the per-device "
                         f"block ({n})")
    parts = []
    if pad_left:
        parts.append(_shift_from_left(x_blk[..., n - pad_left:], mesh))
    parts.append(x_blk)
    if pad_right:
        parts.append(_shift_from_right(x_blk[..., :pad_right], mesh))
    return torch.cat(parts, dim=-1)
