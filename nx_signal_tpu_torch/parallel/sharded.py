"""Sharded DSP ops on torch.distributed: time-block + channel parallelism
with neighbour halos (counterpart of nx_signal_tpu/parallel/sharded.py).

Every entry point is an SPMD program over a ('channel', 'block') mesh
(parallel/mesh.py): every rank of the mesh calls it with the same global
(channels, L) signal, as the JAX functions take a global array. A rank
keeps only its (channel, block) shard of it; the samples of a neighbouring
block reach it only through the halo exchange, never from its own global
copy. Each function returns this rank's shard of the result, the
counterpart of a `shard_map` output that stays on its devices;
`gather_blocks` assembles the global result the JAX function returns.

* channel axis — the leading axis is split into equal row groups;
* block axis — contiguous time blocks; the only communication is the
  neighbour exchange: every halo is kernel E, the CUDA peer copy of
  kernels/cuda_halo.py, on a CUDA tensor, and its plain version (the
  send/recv of parallel/halo.py, zeros at the stream edges, staged through
  host memory on a gloo group) on a CPU one.

Bit-comparability follows the JAX package: a FIR 'same' output sample is
one K-tap dot over [left halo | block | right halo]; a frame belongs to the
block where it starts and is completed by the right halo; the overlap-add
is the left fold of spectral/framing.py, seeded with the left neighbour's
tail so each sample keeps the global association (((tail) + f_m) + ...).

A non-tensor signal goes to the mesh's device (the rank's card on a 'cuda'
mesh); a tensor stays on its own device.
"""

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from nx_signal_tpu_torch.kernels.cuda_dft import fir_framed_dft_power_cuda
from nx_signal_tpu_torch.kernels.cuda_halo import halo_extend_cuda
from nx_signal_tpu_torch.kernels.dft import (
    _check_precision,
    _exact_f32,
    fir_dft_fold_weights,
    good_matmul_fft_length,
)
from nx_signal_tpu_torch.ops.convolution import (
    _direct_convolve,
    _fir_block_size,
    _float_cast,
    convolve,
    fir_convolve_1d,
    oaconvolve,
)
from nx_signal_tpu_torch.ops.iir import sosfilt
from nx_signal_tpu_torch.ops.resample import (
    _pfb_prototype,
    _phase_bank,
    _resample_poly_design,
    _upfirdn_dtype,
    _upfirdn_out_len,
    _upfirdn_phase_outputs,
    pfb_analyze,
)
from nx_signal_tpu_torch.parallel.halo import _shift_from_left, _staged
from nx_signal_tpu_torch.parallel.mesh import block_row, mesh_coordinate, mesh_device, mesh_shape
from nx_signal_tpu_torch.spectral.framing import _ola_fold
from nx_signal_tpu_torch.spectral.stft import (
    _framed_spectrum,
    _resolve_fft_length,
    _stft_result,
    _windowed_frames,
)
from nx_signal_tpu_torch.utils.dtypes import DEFAULT_FLOAT
from nx_signal_tpu_torch.utils.profiling import span

__all__ = ["sharded_convolve_same", "sharded_fir_framed_dft_power", "sharded_oaconvolve_same",
           "sharded_stft", "sharded_istft", "sharded_pfb_analyze", "sharded_sosfilt",
           "sharded_upfirdn", "sharded_resample_poly", "gather_blocks"]

def _block_all_reduce(t, mesh):
    """Sum of `t` over the block axis of this rank's channel row."""
    group, _, _ = block_row(mesh)
    buf, staged = _staged(t, group)
    if not staged:
        buf = buf.clone()  # all_reduce sums in place
    dist.all_reduce(buf, group=group)
    return buf.to(t.device)


def _as_global(x, mesh):
    """(x as a tensor, the device to compute on): a tensor's own device, or
    for anything else the mesh's device. A non-tensor stays on the host
    here, so a rank moves only its own shard to the device."""
    if isinstance(x, torch.Tensor):
        return x, x.device
    return torch.as_tensor(np.asarray(x)), mesh_device(mesh)


def _norm_2d(x, mesh):
    """(x as a 2-D tensor, whether it was 1-D, the device to compute on)."""
    x, device = _as_global(x, mesh)
    if x.ndim == 1:
        return x[None, :], True, device
    if x.ndim == 2:
        return x, False, device
    raise ValueError(f"expected a 1-D or 2-D (channels, time) signal, got rank {x.ndim}")


def _check_divisible(name, value, divisor):
    if value % divisor != 0:
        raise ValueError(f"{name} ({value}) must be divisible by {divisor}")


def _local_shard(x, mesh, block_len: int, axis: int, device):
    """This rank's shard of the global `x`: its channel rows, and block
    `b` of `axis` (samples [b*block_len, (b+1)*block_len), zeros past the
    end), contiguous on `device`."""
    n_channel, _ = mesh_shape(mesh)
    c, b = mesh_coordinate(mesh)
    rows = x.shape[0] // n_channel
    x = x[c * rows:(c + 1) * rows]
    axis = axis % x.ndim
    start = min(b * block_len, x.shape[axis])
    stop = min(start + block_len, x.shape[axis])
    piece = x.narrow(axis, start, stop - start).to(device)
    if stop - start < block_len:
        pad = [0, 0] * (x.ndim - 1 - axis) + [0, block_len - (stop - start)]
        piece = F.pad(piece, pad)
    return piece.contiguous()


def gather_blocks(local, *, mesh, length: int = None, axis: int = -1):
    """The global result from every rank's shard: the shards of a channel
    row concatenated along `axis` in block order (a block's shard may be
    longer, as the last one of `sharded_istft`), the rows along axis 0
    (unless the mesh has one channel row), then `axis` cut to `length`.
    Collective over the whole mesh; every rank gets the result on its
    shard's device. Goes through host memory.

    Examples:

    >>> import tempfile, torch, torch.distributed as dist
    >>> from nx_signal_tpu_torch.parallel.mesh import make_dsp_mesh
    >>> from nx_signal_tpu_torch.parallel.sharded import gather_blocks
    >>> store = dist.FileStore(tempfile.mkdtemp() + "/store", 1)
    >>> dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    >>> mesh = make_dsp_mesh(1, 1, device_type="cpu")
    >>> gather_blocks(torch.arange(6.0).reshape(1, 6), mesh=mesh, length=4)
    tensor([[0., 1., 2., 3.]])
    >>> dist.destroy_process_group()
    """
    shards = [None] * dist.get_world_size()
    dist.all_gather_object(shards, (mesh_coordinate(mesh), local.detach().cpu()))
    n_channel, n_block = mesh_shape(mesh)
    grid = {coord: shard for coord, shard in shards}
    rows = [torch.cat([grid[(c, b)] for b in range(n_block)], dim=axis)
            for c in range(n_channel)]
    out = rows[0] if n_channel == 1 else torch.cat(rows, dim=0)
    if length is not None:
        out = out.narrow(axis, 0, length)
    return out.to(local.device)


def sharded_convolve_same(x, taps, *, mesh, method="direct"):
    """'same'-mode FIR application, sharded over channels and time blocks;
    returns this rank's (channels / n_channel, block) shard.

    Overlap-save: each rank fetches the left halo of (K-1) - (K-1)//2
    samples and the right halo of (K-1)//2 (the single-device 'same'
    split) with kernel E (`halo_extend_cuda`), then runs a local 'valid'
    convolution: method='direct' the Toeplitz contraction `ops.convolution.fir_convolve_1d` with its block
    grid at the global phase (the block is rounded to the FIR block size),
    'conv' a plain conv1d, 'fft' the FFT convolution. No cross-rank sum
    exists: each output is the single-device call's dot, bitwise equal to
    it wherever the local conv sums an output the same way whatever the
    signal's length (cuDNN on the H100 did, for 'direct'; oneDNN on the CPU
    blocks its sums by the length, so there the two differ in the last
    bits). The JAX function's `halo=` has no counterpart: kernel E and its
    plain version give the same bits, and the tensor's device picks one.

    Examples (with a process group initialised, every rank runs):

    >>> import tempfile, torch, torch.distributed as dist
    >>> from nx_signal_tpu_torch.parallel.mesh import make_dsp_mesh
    >>> from nx_signal_tpu_torch.parallel.sharded import gather_blocks, sharded_convolve_same
    >>> store = dist.FileStore(tempfile.mkdtemp() + "/store", 1)
    >>> dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    >>> mesh = make_dsp_mesh(1, 1, device_type="cpu")
    >>> x = torch.arange(8.0).reshape(1, 8)
    >>> y = sharded_convolve_same(x, torch.tensor([1.0, 1.0, 1.0]), mesh=mesh, method="conv")
    >>> gather_blocks(y, mesh=mesh, length=8)
    tensor([[ 1.,  3.,  6.,  9., 12., 15., 18., 13.]])
    >>> dist.destroy_process_group()
    """
    x, squeeze, device = _norm_2d(x, mesh)
    taps = torch.as_tensor(taps, device=device)
    (k,) = taps.shape
    n_channel, n_block = mesh_shape(mesh)
    _check_divisible("channels", x.shape[0], n_channel)
    length = x.shape[1]
    # an even block split, the block rounded to the FIR block size so the
    # Toeplitz block grid has the same global phase on every rank
    grid = _fir_block_size(k) if method == "direct" else 1
    block_len = -(-length // (n_block * grid)) * grid
    pad_right = (k - 1) // 2
    pad_left = (k - 1) - pad_right
    if max(pad_left, pad_right) > block_len:
        raise ValueError(
            f"filter halo ({k - 1}) exceeds the per-device block ({block_len}); "
            "use fewer blocks or a shorter filter")
    x_blk = _local_shard(x, mesh, block_len, -1, device)
    ext = halo_extend_cuda(x_blk, pad_left, pad_right, mesh=mesh)
    if method == "direct":
        # every rank's ext starts pad_left samples before a multiple of the
        # block: the global phase of the single-device call
        out = fir_convolve_1d(_float_cast(ext), _float_cast(taps), "valid", origin=-pad_left)
    elif method == "conv":
        out = _direct_convolve(ext, taps[None, :], "valid", use_matmul=False)
    else:
        out = convolve(ext, taps[None, :], mode="valid", method=method)
    return out[0] if squeeze else out


def _stft_frame_geometry(length, frame_length, stride, n_block):
    """(block_len, frames_per_block, num_frames, halo): the padded per-rank
    block (a multiple of stride) for an even frame split; the padding is
    zeros whose frames are cut from the result."""
    if length < frame_length:
        raise ValueError(f"window length {frame_length} exceeds signal length {length}")
    block_len = -(-length // (n_block * stride)) * stride
    halo = frame_length - stride
    if halo > block_len:
        raise ValueError(
            f"frame halo ({halo}) exceeds the per-device block ({block_len}); "
            "use fewer blocks or a larger hop")
    frames_per_block = block_len // stride
    num_frames = (length - frame_length) // stride + 1
    return block_len, frames_per_block, num_frames, halo


def sharded_stft(x, window, *, mesh, sampling_rate=100, fft_length="power_of_two",
                 overlap_length=None, scaling=None, onesided=False, method="auto",
                 precision="highest"):
    """Block+channel-sharded STFT ('valid' padding): STFTResult(z, times,
    frequencies) with z this rank's (channels / n_channel, block_len /
    stride, bins) shard and the global times and frequencies.

    A rank owns the frames that START in its block; the trailing
    frame_length - stride samples arrive as the right neighbour's halo, so
    every frame is windowed and transformed on one rank, by the
    single-device `stft`'s route (`spectral.stft._framed_spectrum`) and
    result (`_stft_result`). Frame slots past the true frame count (the
    last block's padding) are cut by `gather_blocks(z, mesh=mesh,
    length=len(times), axis=-2)`.

    Examples:

    >>> import tempfile, torch, torch.distributed as dist
    >>> from nx_signal_tpu_torch.parallel.mesh import make_dsp_mesh
    >>> store = dist.FileStore(tempfile.mkdtemp() + "/store", 1)
    >>> dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    >>> mesh = make_dsp_mesh(1, 1, device_type="cpu")
    >>> from nx_signal_tpu_torch.parallel.sharded import sharded_stft
    >>> res = sharded_stft(torch.ones(1, 256), torch.hann_window(64), mesh=mesh,
    ...                    overlap_length=48, onesided=True)
    >>> res.z.shape
    torch.Size([1, 16, 33])
    >>> dist.destroy_process_group()
    """
    x, squeeze, device = _norm_2d(x, mesh)
    window = torch.as_tensor(window, device=device)
    (frame_length,) = window.shape
    if overlap_length is None:
        overlap_length = frame_length // 2
    stride = frame_length - overlap_length
    n_fft = _resolve_fft_length(frame_length, fft_length)
    n_channel, n_block = mesh_shape(mesh)
    _check_divisible("channels", x.shape[0], n_channel)
    block_len, _, num_frames, halo = _stft_frame_geometry(
        x.shape[1], frame_length, stride, n_block)

    x_blk = _local_shard(x, mesh, block_len, -1, device)
    ext = halo_extend_cuda(x_blk, 0, halo, mesh=mesh)
    z = _framed_spectrum(ext, window, stride=stride, n_fft=n_fft, onesided=onesided,
                         method=method, precision=precision)
    return _stft_result(z[0] if squeeze else z, window, n_fft=n_fft, onesided=onesided,
                        scaling=scaling, sampling_rate=sampling_rate, num_frames=num_frames)


def _sharded_fold(frames, stride: int, own: int, overlap: int, mesh):
    """Overlap-add of this block's (..., M, N) frames into its (..., own +
    overlap) samples, bitwise equal to that range of the single-device
    fold: phase 1 folds the frames alone, and its tail past `own` goes to
    the right neighbour; phase 2 folds them again with the left
    neighbour's tail seeding the accumulator (kernel C with `init` on a
    CUDA tensor)."""
    local_len = own + overlap
    partial = _ola_fold(frames, stride, local_len)
    seeded = _shift_from_left(partial[..., own:], mesh)
    return _ola_fold(frames, stride, local_len, init=F.pad(seeded, (0, own)))


def sharded_istft(z, window, *, mesh, fft_length=None, overlap_length=None, scaling=None,
                  sampling_rate=1000, onesided=False, method="auto", precision="highest"):
    """Block+channel-sharded inverse STFT of the global (channels, frames,
    bins) spectrum; returns this rank's shard of the signal: block b's
    (channels / n_channel, own) samples, own = frames_per_block * stride,
    and on the last block also the stream's final `overlap` samples.
    `gather_blocks(y, mesh=mesh, length=frames * stride + overlap)` gives
    the single-device result.

    Frames are sharded over the block axis, padded with zero spectra to an
    even split (their window envelope is masked). Each rank inverts and
    windows its frames by the single-device `istft`'s route
    (`spectral.stft._windowed_frames`), folds them in two phases, the
    second seeded with its left neighbour's tail (`_sharded_fold`), and
    divides by its folded window envelope (1e-10 guard). Needs the overlap
    <= a block's sample range.

    Examples:

    >>> import tempfile, torch, torch.distributed as dist
    >>> from nx_signal_tpu_torch.parallel.mesh import make_dsp_mesh
    >>> store = dist.FileStore(tempfile.mkdtemp() + "/store", 1)
    >>> dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    >>> mesh = make_dsp_mesh(1, 1, device_type="cpu")
    >>> from nx_signal_tpu_torch.parallel.sharded import gather_blocks, sharded_istft, sharded_stft
    >>> x, win = torch.rand(1, 256), torch.hann_window(64)
    >>> z = sharded_stft(x, win, mesh=mesh, overlap_length=48, onesided=True).z
    >>> y = gather_blocks(sharded_istft(z, win, mesh=mesh, overlap_length=48, onesided=True),
    ...                   mesh=mesh, length=256)
    >>> bool(torch.allclose(y[:, 64:-64], x[:, 64:-64], atol=1e-5))
    True
    >>> dist.destroy_process_group()
    """
    z, device = _as_global(z, mesh)
    squeeze = z.ndim == 2
    if squeeze:
        z = z[None]
    if z.ndim != 3:
        raise ValueError(f"expected (..., frames, fft) spectrum of rank 2 or 3, got {z.ndim}")
    window = torch.as_tensor(window, device=device)
    if onesided and fft_length is None:
        n_fft = 2 * (z.shape[-1] - 1)
    else:
        n_fft = _resolve_fft_length(z.shape[-1], fft_length)
    if overlap_length is None:
        overlap_length = window.shape[-1] // 2
    n_channel, n_block = mesh_shape(mesh)
    _check_divisible("channels", z.shape[0], n_channel)
    num_frames = z.shape[1]
    # an even frame split: padded frames are zero spectra (zero terms), and
    # their window-envelope terms are masked below
    frames_per_block = -(-num_frames // n_block)
    if overlap_length >= n_fft:
        raise ValueError(
            f"overlap_length must be a number less than the window size {n_fft}, "
            f"got: {overlap_length}")
    stride = n_fft - overlap_length
    own = frames_per_block * stride  # samples of each block
    if overlap_length > own:
        raise ValueError(
            f"overlap ({overlap_length}) exceeds the per-device sample range ({own})")

    z_blk = _local_shard(z, mesh, frames_per_block, 1, device)
    frames = _windowed_frames(z_blk, window, n_fft=n_fft, onesided=onesided, method=method,
                              scaling=scaling, sampling_rate=sampling_rate, precision=precision)
    _, b = mesh_coordinate(mesh)
    first = b * frames_per_block
    valid = (torch.arange(first, first + frames_per_block, device=device) < num_frames)
    envelope = (window.abs().to(DEFAULT_FLOAT) ** 2).expand(frames_per_block, n_fft)
    envelope = envelope * valid.to(DEFAULT_FLOAT)[:, None]
    num = _sharded_fold(frames, stride, own, overlap_length, mesh)
    env = _sharded_fold(envelope.expand(*frames.shape[:-2], frames_per_block, n_fft),
                        stride, own, overlap_length, mesh)
    env = torch.where(env > 1e-10, env, torch.ones((), dtype=env.dtype, device=env.device))
    out = num / env
    # the counterpart of the JAX psum: every rank of the row takes part and
    # gets the stream's final samples, which only the last block computes;
    # the last block's shard carries them
    is_last = b == n_block - 1
    tail = _block_all_reduce(out[..., own:] if is_last else torch.zeros_like(out[..., own:]),
                             mesh)
    shard = torch.cat([out[..., :own], tail], dim=-1) if is_last else out[..., :own]
    return shard[0] if squeeze else shard


def _sos_state_space(sos):
    """One-sample cascade state space (A, B, C, D) of an (S, 6) sos array,
    host-side f64 numpy: state = [z00, z01, z10, z11, ...] (per-section
    DF2T states in sosfilt order), x -> y with z' = A z + B x,
    y = C z + D x. Used by sharded_sosfilt to chain the blocks."""
    sos = np.asarray(sos, dtype=np.float64)
    n_sections = sos.shape[0]
    n_state = 2 * n_sections
    a_mat = np.zeros((n_state, n_state))
    b_vec = np.zeros(n_state)
    c_cur = np.zeros(n_state)  # current inter-section signal: u = D x + C z
    d_cur = 1.0
    for s in range(n_sections):
        b0, b1, b2, a0, a1, a2 = sos[s]
        b0, b1, b2, a1, a2 = b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0
        i0, i1 = 2 * s, 2 * s + 1
        # DF2T: y = b0 u + z0;  z0' = (b1 - a1 b0) u - a1 z0 + z1;
        #                       z1' = (b2 - a2 b0) u - a2 z0
        bu0, bu1 = b1 - a1 * b0, b2 - a2 * b0
        a_mat[i0] += bu0 * c_cur
        a_mat[i0, i0] += -a1
        a_mat[i0, i1] += 1.0
        a_mat[i1] += bu1 * c_cur
        a_mat[i1, i0] += -a2
        b_vec[i0] = bu0 * d_cur
        b_vec[i1] = bu1 * d_cur
        new_c = b0 * c_cur
        new_c[i0] += 1.0
        c_cur, d_cur = new_c, b0 * d_cur
    return a_mat, b_vec, c_cur, d_cur


def _observability(a_mat, c_vec, length: int):
    """(length, n_state) f64 rows G[n] = C A^n, by doubling: the next rows
    are the ones so far times A^(their count)."""
    rows, power = c_vec[None, :], a_mat
    while rows.shape[0] < length:
        rows = np.vstack([rows, rows @ power])
        power = power @ power
    return rows[:length]


def sharded_sosfilt(sos, x, *, mesh):
    """Causal IIR (cascaded biquads) sharded over channels and time blocks;
    returns this rank's (channels / n_channel, block) shard.

    Superposition breaks the sequential dependency: y(x, z_in) = y(x, 0)
    + ZIR(z_in) and z_out = A^L z_in + z_out(x, 0). Each rank filters its
    block from zero state with `ops.iir.sosfilt` (its zf kept), the
    (rows, 2 S) final states are all-gathered over the block group, each
    rank chains the blocks before it through T = A^L (built on the host in
    f64, the chain in f64), and adds its incoming state's zero-input
    response z_in @ G^T, G[n] = C A^n. One all-gather of 2 S floats a row;
    no halo, so kernel E is not on this path. Within f.p. accuracy of the
    single-device `sosfilt` (the blocks sum in another order). Uneven
    lengths: the last block is padded with zeros past the end.

    Examples (with a process group initialised, every rank runs):

    >>> import tempfile, torch, torch.distributed as dist
    >>> from nx_signal_tpu_torch.ops.iir_design import butter
    >>> from nx_signal_tpu_torch.parallel.mesh import make_dsp_mesh
    >>> from nx_signal_tpu_torch.parallel.sharded import gather_blocks, sharded_sosfilt
    >>> store = dist.FileStore(tempfile.mkdtemp() + "/store", 1)
    >>> dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    >>> mesh = make_dsp_mesh(1, 1, device_type="cpu")
    >>> y = sharded_sosfilt(butter(2, 0.2, output="sos"), torch.ones(2, 100), mesh=mesh)
    >>> tuple(gather_blocks(y, mesh=mesh, length=100).shape)
    (2, 100)
    >>> dist.destroy_process_group()
    """
    sos_np = np.asarray(sos.detach().cpu() if isinstance(sos, torch.Tensor) else sos,
                        dtype=np.float64)
    if sos_np.ndim != 2 or sos_np.shape[1] != 6:
        raise ValueError("sos array must be shape (n_sections, 6)")
    x, squeeze, device = _norm_2d(x, mesh)
    x = _float_cast(x)
    n_channel, n_block = mesh_shape(mesh)
    _check_divisible("channels", x.shape[0], n_channel)
    length = x.shape[1]
    block_len = -(-length // n_block)
    x_blk = _local_shard(x, mesh, block_len, -1, device)
    n_sections = sos_np.shape[0]
    rows = x_blk.shape[0]

    y, zf = sosfilt(sos_np, x_blk, zi=torch.zeros((n_sections, rows, 2), dtype=x_blk.dtype))
    zf0 = zf.permute(1, 0, 2).reshape(rows, 2 * n_sections)  # sosfilt state order

    group, row, b = block_row(mesh)
    buf, _ = _staged(zf0.to(torch.float64), group)
    gathered = [torch.empty_like(buf) for _ in range(n_block)]
    dist.all_gather(gathered, buf, group=group)
    by_block = {row.index(dist.get_global_rank(group, i)): g for i, g in enumerate(gathered)}

    a_mat, _, c_vec, _ = _sos_state_space(sos_np)
    t_blk = torch.as_tensor(np.linalg.matrix_power(a_mat, block_len))
    z_in = torch.zeros_like(buf)
    for k in range(b):  # the blocks before this one, in order
        z_in = z_in @ t_blk.T.to(z_in.device) + by_block[k].to(z_in.device)
    obs_t = torch.as_tensor(_observability(a_mat, c_vec, block_len).T, device=device)
    with _exact_f32():
        out = y + z_in.to(device=device, dtype=y.dtype) @ obs_t.to(y.dtype)
    return out[0] if squeeze else out


def sharded_oaconvolve_same(x, taps, *, mesh):
    """'same'-mode overlap-add FFT convolution, sharded over channels and
    time blocks; returns this rank's (channels / n_channel, block) shard.
    The halos of `sharded_convolve_same` (kernel E), then a local 'valid'
    `ops.convolution.oaconvolve`, whose overlap-add is kernel C on a CUDA
    tensor. Agrees with the single-device `oaconvolve(x, taps, mode='same')`
    to FFT accuracy, not bitwise: the overlap-add block phase differs per
    block.

    Examples:

    >>> import tempfile, torch, torch.distributed as dist
    >>> from nx_signal_tpu_torch.parallel.mesh import make_dsp_mesh
    >>> store = dist.FileStore(tempfile.mkdtemp() + "/store", 1)
    >>> dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    >>> mesh = make_dsp_mesh(1, 1, device_type="cpu")
    >>> from nx_signal_tpu_torch.parallel.sharded import gather_blocks, sharded_oaconvolve_same
    >>> y = sharded_oaconvolve_same(torch.arange(8.0).reshape(1, 8), torch.ones(3), mesh=mesh)
    >>> gather_blocks(y, mesh=mesh, length=8).round()
    tensor([[ 1.,  3.,  6.,  9., 12., 15., 18., 13.]])
    >>> dist.destroy_process_group()
    """
    x, squeeze, device = _norm_2d(x, mesh)
    taps = torch.as_tensor(taps, device=device)
    (k,) = taps.shape
    n_channel, n_block = mesh_shape(mesh)
    _check_divisible("channels", x.shape[0], n_channel)
    block_len = -(-x.shape[1] // n_block)
    pad_right = (k - 1) // 2
    pad_left = (k - 1) - pad_right
    if max(pad_left, pad_right) > block_len:
        raise ValueError(
            f"filter halo ({k - 1}) exceeds the per-device block ({block_len}); "
            "use fewer blocks or a shorter filter")
    ext = halo_extend_cuda(_local_shard(x, mesh, block_len, -1, device), pad_left,
                           pad_right, mesh=mesh)
    out = oaconvolve(ext, taps[None, :], mode="valid")
    return out[0] if squeeze else out


def sharded_fir_framed_dft_power(x, taps, window, *, mesh, stride: int, n_fft: int,
                                 onesided: bool = True, precision="highest"):
    """The fused bench chain, the FIR folded into the framed-DFT power
    spectrogram (kernels/dft.py:fir_framed_dft, output='power'), sharded
    over channels and time blocks; returns this rank's (channels /
    n_channel, block_len / stride, bins) shard of the power, cut to the
    true frame count by `gather_blocks(p, mesh=mesh, length=frames,
    axis=-2)`.

    One halo exchange (kernel E) supplies both the FIR 'same' context and
    the frame tail: pad_left = (K-1) - (K-1)//2 samples from the left
    neighbour (zeros at block 0, the single-device left pad) and frame -
    stride + (K-1)//2 from the right (none where the hop is longer: the
    block's frames then end inside it). Every rank then contracts
    [left halo | block | right halo] against the folded weights with kernel
    A (kernels/cuda_dft.py:fir_framed_dft_power_cuda, pad_left=0, at the
    caller's `precision`: kernel A-tc for 'high' and 'default') on a CUDA
    tensor, its plain version on a CPU one. The filtered signal is never
    built.

    Examples:

    >>> import tempfile, torch, torch.distributed as dist
    >>> from nx_signal_tpu_torch.parallel.mesh import make_dsp_mesh
    >>> store = dist.FileStore(tempfile.mkdtemp() + "/store", 1)
    >>> dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    >>> mesh = make_dsp_mesh(1, 1, device_type="cpu")
    >>> from nx_signal_tpu_torch.parallel.sharded import sharded_fir_framed_dft_power
    >>> p = sharded_fir_framed_dft_power(torch.ones(2, 512), torch.tensor([0.25, 0.5, 0.25]),
    ...                                  torch.hann_window(64), mesh=mesh, stride=16, n_fft=64)
    >>> p.shape   # the shard is padded to whole blocks of frames
    torch.Size([2, 32, 33])
    >>> dist.destroy_process_group()
    """
    _check_precision(precision)
    x, squeeze, device = _norm_2d(x, mesh)
    taps = torch.as_tensor(taps).reshape(-1)
    window = torch.as_tensor(window)
    (frame_length,) = window.shape
    k = taps.shape[0]
    bins = n_fft // 2 + 1 if onesided else n_fft
    if not good_matmul_fft_length(n_fft) or n_fft < frame_length:
        raise ValueError(
            "sharded_fir_framed_dft_power requires a matmul-DFT geometry: "
            f"fft_length <= 1024 and >= frame_length, got {n_fft}")
    n_channel, n_block = mesh_shape(mesh)
    _check_divisible("channels", x.shape[0], n_channel)
    block_len, frames_per_block, _, _ = _stft_frame_geometry(
        x.shape[1], frame_length, stride, n_block)
    pad_left = (k - 1) - (k - 1) // 2
    # none where a hop past the frame leaves the block's last frame inside it
    halo_right = max(0, frame_length - stride + (k - 1) // 2)
    if max(pad_left, halo_right) > block_len:
        raise ValueError(
            f"chain halo (left {pad_left}, right {halo_right}) exceeds the "
            f"per-device block ({block_len}); use fewer blocks, a shorter "
            "filter, or a larger hop")
    with span("nx.weights.fold"):
        weights = fir_dft_fold_weights(taps, window, n_fft, onesided, device=device)
    x_blk = _local_shard(x, mesh, block_len, -1, device).to(DEFAULT_FLOAT)
    ext = halo_extend_cuda(x_blk, pad_left, halo_right, mesh=mesh)
    out = fir_framed_dft_power_cuda(ext, weights, stride=stride, pad_left=0,
                                    num_frames=frames_per_block, bins=bins, precision=precision)
    return out[0] if squeeze else out


def sharded_pfb_analyze(x, n_channels: int, *, mesh, taps_per_channel: int = 8,
                        window=("kaiser", 5.0), taps=None, shift: bool = False):
    """Block+channel-sharded polyphase filterbank channelizer
    (`ops.resample.pfb_analyze`); returns this rank's (channels /
    n_channel, block_len / n_channels, n_channels) shard of frames.

    Geometry of `sharded_stft`: a frame at stride n_channels spans
    n_channels*taps_per_channel samples, so each rank takes the right halo
    of n_channels*(taps_per_channel - 1) samples from its neighbour (kernel
    E on a CUDA tensor) and channelizes its own frames wholly locally; the
    frame slots past the true count (the last block's padding) are cut by
    `gather_blocks(p, mesh=mesh, length=frames, axis=-2)`. Each frame is
    the single-device call's frame, up to the order of the local
    contraction's sums.

    Examples (with a process group initialised, every rank runs):

    >>> import tempfile, torch, torch.distributed as dist
    >>> from nx_signal_tpu_torch.parallel.mesh import make_dsp_mesh
    >>> from nx_signal_tpu_torch.parallel.sharded import gather_blocks, sharded_pfb_analyze
    >>> store = dist.FileStore(tempfile.mkdtemp() + "/store", 1)
    >>> dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    >>> mesh = make_dsp_mesh(1, 1, device_type="cpu")
    >>> p = sharded_pfb_analyze(torch.ones(4, 4096), 16, mesh=mesh, taps_per_channel=4)
    >>> tuple(gather_blocks(p, mesh=mesh, length=253, axis=-2).shape), p.dtype
    ((4, 253, 16), torch.complex64)
    >>> dist.destroy_process_group()
    """
    x, squeeze, device = _norm_2d(x, mesh)
    m = n_channels
    if taps is None:
        taps = _pfb_prototype(m, taps_per_channel,
                              tuple(window) if isinstance(window, list) else window)
    taps = torch.as_tensor(taps).detach().cpu()
    window_length = taps.shape[0]
    if window_length % m != 0:
        raise ValueError(
            f"prototype length ({window_length}) must be a multiple of "
            f"n_channels ({m})")
    n_channel, n_block = mesh_shape(mesh)
    _check_divisible("channels", x.shape[0], n_channel)
    block_len, _, _, halo = _stft_frame_geometry(x.shape[1], window_length, m, n_block)
    ext = halo_extend_cuda(_local_shard(x, mesh, block_len, -1, device), 0, halo, mesh=mesh)
    out = pfb_analyze(ext, m, taps=taps, shift=shift)
    return out[0] if squeeze else out


def _sharded_upfirdn_body(x, bank, t_taps, up, down, *, mesh, n_offset, out_total, device,
                          dtype):
    """Shared per-rank body of sharded_upfirdn / sharded_resample_poly;
    returns this rank's out_block = block_in*up/down outputs.

    Geometry (the JAX package's): the input is cut into n_block equal
    blocks with block_in % down == 0, so block b's outputs start at
    b*out_block with b*out_block*down = b*block_in*up == 0 (mod up): the
    polyphase pattern ((n_offset + l)*down) % up is the same on every rank.
    Output l's window ends at own-block input index q'_l = ((n_offset +
    l)*down)//up, so each rank needs a (T-1)-sample left halo and a right
    halo of max(0, q'_last + 1 - block_in) samples (nonzero only when
    n_offset > 0: resample_poly's group delay). Both come through kernel E
    in one call (its plain send/recv on a CPU tensor), zeros at the stream
    edges: upfirdn's zero padding."""
    n_channel, n_block = mesh_shape(mesh)
    _check_divisible("channels", x.shape[0], n_channel)
    length = x.shape[1]
    # the blocks cover every output: upfirdn's run T-1 filter-tail samples
    # past the input end, so size them by the input extent the last output
    # reads; the zeros past the signal are upfirdn's right padding
    required_in = max(length, -(-(n_offset + out_total) * down // up))
    block_in = -(-required_in // (n_block * down)) * down
    out_block = block_in * up // down
    halo_left = t_taps - 1
    q_last = ((n_offset + out_block - 1) * down) // up
    halo_right = max(0, q_last + 1 - block_in)
    if max(halo_left, halo_right) > block_in:
        raise ValueError(
            f"polyphase halo ({max(halo_left, halo_right)}) exceeds the "
            f"per-device block ({block_in}); use fewer blocks or a shorter "
            "filter")
    x_blk = _local_shard(x, mesh, block_in, -1, device).to(dtype)
    ext = halo_extend_cuda(x_blk, halo_left, halo_right, mesh=mesh)
    return _upfirdn_phase_outputs(ext, bank, up, down, n_offset=n_offset, n_count=out_block)


def sharded_upfirdn(h, x, up: int = 1, down: int = 1, *, mesh):
    """Block+channel-sharded `ops.resample.upfirdn` over a ('channel',
    'block') mesh; returns this rank's (channels / n_channel, out_block)
    shard, cut to the true output count by `gather_blocks(y, mesh=mesh,
    length=n_out)`. Every output is the same T-tap phase dot over the same
    input values as the single-device call (the left halo supplies the
    cross-block context; `_sharded_upfirdn_body`), equal to it up to the
    order of the local contraction's sums.

    A complex64 shard goes through kernel E whole: E copies 4-byte words
    and takes elements of 8 bytes, so the real and imaginary parts travel
    together.

    Examples (with a process group initialised, every rank runs):

    >>> import tempfile, torch, torch.distributed as dist
    >>> from nx_signal_tpu_torch.parallel.mesh import make_dsp_mesh
    >>> from nx_signal_tpu_torch.parallel.sharded import gather_blocks, sharded_upfirdn
    >>> store = dist.FileStore(tempfile.mkdtemp() + "/store", 1)
    >>> dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    >>> mesh = make_dsp_mesh(1, 1, device_type="cpu")
    >>> y = sharded_upfirdn(torch.ones(31), torch.ones(4, 4096), 2, 3, mesh=mesh)
    >>> tuple(gather_blocks(y, mesh=mesh, length=2741).shape)
    (4, 2741)
    >>> dist.destroy_process_group()
    """
    x, squeeze, device = _norm_2d(x, mesh)
    h = torch.as_tensor(h).detach().cpu()
    if h.ndim != 1:
        raise ValueError(f"h must be 1-D, got rank {h.ndim}")
    if up < 1 or down < 1:
        raise ValueError(f"up and down must be >= 1, got: up={up}, down={down}")
    dtype = _upfirdn_dtype(h, x)
    bank, t_taps = _phase_bank(h.to(dtype), up)
    n_out = _upfirdn_out_len(x.shape[1], h.shape[0], up, down)
    out = _sharded_upfirdn_body(x, bank, t_taps, up, down, mesh=mesh, n_offset=0,
                                out_total=n_out, device=device, dtype=dtype)
    return out[0] if squeeze else out


def sharded_resample_poly(x, up: int, down: int, *, mesh, window=("kaiser", 5.0), taps=None):
    """Block+channel-sharded `ops.resample.resample_poly`; returns this
    rank's (channels / n_channel, out_block) shard, cut to the true output
    count by `gather_blocks(y, mesh=mesh, length=ceil(L*up/down))` (up ==
    down: this rank's input block, unchanged). The group-delay slice
    [n_pre_remove, n_pre_remove + n_out) becomes the polyphase output
    offset (n_offset), which keeps the per-rank phase pattern the same on
    every rank and makes the right halo nonzero (`_sharded_upfirdn_body`).

    Examples (with a process group initialised, every rank runs):

    >>> import tempfile, torch, torch.distributed as dist
    >>> from nx_signal_tpu_torch.parallel.mesh import make_dsp_mesh
    >>> from nx_signal_tpu_torch.parallel.sharded import gather_blocks, sharded_resample_poly
    >>> store = dist.FileStore(tempfile.mkdtemp() + "/store", 1)
    >>> dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    >>> mesh = make_dsp_mesh(1, 1, device_type="cpu")
    >>> y = sharded_resample_poly(torch.ones(4, 4096), 1, 2, mesh=mesh)  # decimate by 2
    >>> tuple(gather_blocks(y, mesh=mesh, length=2048).shape)
    (4, 2048)
    >>> dist.destroy_process_group()
    """
    x, squeeze, device = _norm_2d(x, mesh)
    if up < 1 or down < 1:
        raise ValueError(f"up and down must be >= 1, got: up={up}, down={down}")
    n_channel, n_block = mesh_shape(mesh)
    if int(up) == int(down):
        _check_divisible("channels", x.shape[0], n_channel)
        out = _local_shard(x, mesh, -(-x.shape[1] // n_block), -1, device)
        return out[0] if squeeze else out
    up, down, h, n_pre_remove = _resample_poly_design(up, down, window, taps)
    dtype = _upfirdn_dtype(h, x)
    bank, t_taps = _phase_bank(h.to(dtype), up)
    n_out = -(-x.shape[1] * up // down)
    out = _sharded_upfirdn_body(x, bank, t_taps, up, down, mesh=mesh, n_offset=n_pre_remove,
                                out_total=n_out, device=device, dtype=dtype)
    return out[0] if squeeze else out
