"""Sharded spectral estimation: Welch PSD, cross-spectral density and
coherence over a ('channel', 'block') mesh (counterpart of
nx_signal_tpu/parallel/estimation.py), SPMD on torch.distributed like
parallel/sharded.py: every rank passes the same global signal and gets
its channel rows of the result.

Each rank computes the segment spectra of the segments that start in its
time block (`parallel.sharded.sharded_stft`: the right halo of
segment_length - stride samples through kernel E, then kernel B-fft on
the card), subtracts the detrend in the frequency domain with the
per-segment coefficients of its block (one blocked contraction over the
same halo-extended block, whose halo is kernel E again, right pad only),
forms the per-segment cross power, and the segment mean is a local sum
and one sum over the block axis. `average='median'` gathers the segments
of the row through host memory; prefer 'mean' at scale.
"""

import torch

from nx_signal_tpu_torch.kernels.cuda_halo import halo_extend_cuda
from nx_signal_tpu_torch.kernels.dft import blocked_frame_matmul
from nx_signal_tpu_torch.parallel.mesh import mesh_coordinate, mesh_shape
from nx_signal_tpu_torch.parallel.sharded import (
    _block_all_reduce,
    _check_divisible,
    _local_shard,
    _norm_2d,
    _stft_frame_geometry,
    gather_blocks,
    sharded_stft,
)
from nx_signal_tpu_torch.spectral.estimation import (
    _cross_power,
    _detrend_basis_spectra,
    _detrend_columns,
    _finalize,
    _median_average,
    _power_sum,
    _spectral_params,
    _subtract_trend,
    _validate_detrend,
)
from nx_signal_tpu_torch.spectral.framing import as_windowed
from nx_signal_tpu_torch.utils.dtypes import DEFAULT_FLOAT

__all__ = ["sharded_csd", "sharded_welch", "sharded_coherence"]


def _sharded_frame_coefs(x2d, segment_length, stride, mesh, precision, detrend, device):
    """(rows, frames_per_block, k) detrend coefficients (the mean, and the
    slope for 'linear') of the segments that start in this rank's block,
    with sharded_stft's frame geometry and right halo (kernel E, right pad
    only): one blocked contraction, no segment matrix built."""
    _, n_block = mesh_shape(mesh)
    block_len, frames_per_block, _, halo = _stft_frame_geometry(
        x2d.shape[1], segment_length, stride, n_block)
    x_blk = _local_shard(x2d, mesh, block_len, -1, device)
    if not x_blk.is_complex():
        x_blk = x_blk.to(DEFAULT_FLOAT)
    ext = halo_extend_cuda(x_blk, 0, halo, mesh=mesh)
    cols = torch.as_tensor(_detrend_columns(segment_length, detrend), device=device)
    if ext.is_complex():
        frames = as_windowed(ext, window_length=segment_length, stride=stride)
        return frames[..., :frames_per_block, :] @ cols.to(frames.dtype)
    return blocked_frame_matmul(ext, cols.to(DEFAULT_FLOAT), window_length=segment_length,
                                stride=stride, num_frames=frames_per_block,
                                precision=precision)


def _sharded_segment_spectra(x2d, w, *, mesh, stride, n_fft, onesided, detrend, method,
                             precision, device):
    """(rows, frames_per_block, bins) spectra of this block's detrended,
    windowed segments (the slots past the true segment count are padding)."""
    _validate_detrend(detrend, allow_callable=False)
    segment_length = w.shape[-1]
    one_sided_fft = onesided and not x2d.is_complex()
    z, _, _ = sharded_stft(x2d, w, mesh=mesh, sampling_rate=1.0, fft_length=n_fft,
                           overlap_length=segment_length - stride, onesided=one_sided_fft,
                           method=method, precision=precision)
    if detrend in ("constant", "linear"):
        coefs = _sharded_frame_coefs(x2d, segment_length, stride, mesh, precision, detrend,
                                     device)
        wk = torch.as_tensor(_detrend_basis_spectra(w, n_fft, one_sided_fft, detrend),
                             device=z.device)
        z = _subtract_trend(z, coefs, wk)
    return z


def _sharded_average(zx, zy, average, *, mesh, num_frames):
    """The mean (a local sum and one sum over the block axis) or the
    bias-corrected median (the row's segments gathered) over the true
    segments of the cross powers of every block's (rows, frames_per_block,
    bins) spectra; real |X|^2 when zy is zx."""
    c, b = mesh_coordinate(mesh)
    if average == "median" and num_frames > 1:
        rows = zx.shape[0]
        every = gather_blocks(_cross_power(zx, zy), mesh=mesh, length=num_frames, axis=-2)
        return _median_average(every[c * rows:(c + 1) * rows].to(zx.device))
    per_block = zx.shape[-2]
    valid = min(max(num_frames - b * per_block, 0), per_block)
    if zy is zx:
        local = _power_sum(zx[..., :valid, :])
    else:
        local = _cross_power(zx[..., :valid, :], zy[..., :valid, :]).sum(dim=-2)
    return _block_all_reduce(local, mesh) / num_frames


def _sharded_csd(x, y, *, mesh, sampling_rate, window, segment_length, overlap_length,
                 fft_length, detrend, onesided, scaling, average, method, precision):
    """(frequencies, this rank's rows of P_xy): complex, or real |X|^2 when
    y is x."""
    same = y is x
    x2d, squeeze, device = _norm_2d(x, mesh)
    y2d = x2d if same else _norm_2d(y, mesh)[0]
    w, stride, n_fft, scale = _spectral_params(window, segment_length, overlap_length,
                                               fft_length, scaling, average, sampling_rate,
                                               device)
    if onesided and (x2d.is_complex() or y2d.is_complex()):
        raise ValueError("onesided=True requires real input; "
                         "use onesided=False for complex signals")
    n_channel, n_block = mesh_shape(mesh)
    _check_divisible("channels", x2d.shape[0], n_channel)
    _, _, num_frames, _ = _stft_frame_geometry(x2d.shape[1], w.shape[-1], stride, n_block)
    kw = dict(mesh=mesh, stride=stride, n_fft=n_fft, onesided=onesided, detrend=detrend,
              method=method, precision=precision, device=device)
    zx = _sharded_segment_spectra(x2d, w, **kw)
    zy = zx if same else _sharded_segment_spectra(y2d, w, **kw)
    pxy = _sharded_average(zx, zy, average, mesh=mesh, num_frames=num_frames)
    freqs, pxy = _finalize(pxy, scale, n_fft=n_fft, onesided=onesided,
                           sampling_rate=sampling_rate)
    return freqs, pxy[0] if squeeze else pxy


def sharded_csd(x, y, *, mesh, sampling_rate=1.0, window="hann", segment_length=256,
                overlap_length=None, fft_length=None, detrend="constant", onesided=True,
                scaling="density", average="mean", method="auto", precision="highest"):
    """Cross power spectral density by Welch's method, sharded over channels
    and time blocks (scipy.signal.csd semantics; the options of
    `spectral.estimation.csd`). Returns (frequencies, P_xy) with P_xy this
    rank's (channels / n_channel, bins) rows, the same on every block of a
    row; the JAX function's global result is those rows stacked in channel
    order. Agrees with the single-device `csd` to the accuracy of its sums.

    Examples (with a process group initialised, every rank runs):

    >>> import tempfile, torch, torch.distributed as dist
    >>> from nx_signal_tpu_torch.parallel.mesh import make_dsp_mesh
    >>> from nx_signal_tpu_torch.parallel.estimation import sharded_csd
    >>> store = dist.FileStore(tempfile.mkdtemp() + "/store", 1)
    >>> dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    >>> mesh = make_dsp_mesh(1, 1, device_type="cpu")
    >>> x = torch.randn(4, 4096, generator=torch.Generator().manual_seed(0))
    >>> f, C = sharded_csd(x, x, mesh=mesh, sampling_rate=8000.0, segment_length=256)
    >>> tuple(C.shape), C.dtype
    ((4, 129), torch.complex64)
    >>> dist.destroy_process_group()
    """
    freqs, pxy = _sharded_csd(x, y, mesh=mesh, sampling_rate=sampling_rate, window=window,
                              segment_length=segment_length, overlap_length=overlap_length,
                              fft_length=fft_length, detrend=detrend, onesided=onesided,
                              scaling=scaling, average=average, method=method,
                              precision=precision)
    if not pxy.is_complex():
        pxy = pxy.to(torch.complex128 if pxy.dtype == torch.float64 else torch.complex64)
    return freqs, pxy


def sharded_welch(x, *, mesh, sampling_rate=1.0, window="hann", segment_length=256,
                  overlap_length=None, fft_length=None, detrend="constant", onesided=True,
                  scaling="density", average="mean", method="auto", precision="highest"):
    """Welch PSD sharded over channels and time blocks, the distributed
    `spectral.estimation.welch`: (frequencies, this rank's rows of P_xx).

    Examples (with a process group initialised, every rank runs):

    >>> import tempfile, torch, torch.distributed as dist
    >>> from nx_signal_tpu_torch.parallel.mesh import make_dsp_mesh
    >>> from nx_signal_tpu_torch.parallel.estimation import sharded_welch
    >>> store = dist.FileStore(tempfile.mkdtemp() + "/store", 1)
    >>> dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    >>> mesh = make_dsp_mesh(1, 1, device_type="cpu")
    >>> x = torch.randn(4, 4096, generator=torch.Generator().manual_seed(0))
    >>> f, P = sharded_welch(x, mesh=mesh, sampling_rate=8000.0, segment_length=256)
    >>> tuple(f.shape), tuple(P.shape)
    ((129,), (4, 129))
    >>> dist.destroy_process_group()
    """
    return _sharded_csd(x, x, mesh=mesh, sampling_rate=sampling_rate, window=window,
                        segment_length=segment_length, overlap_length=overlap_length,
                        fft_length=fft_length, detrend=detrend, onesided=onesided,
                        scaling=scaling, average=average, method=method, precision=precision)


def sharded_coherence(x, y, *, mesh, sampling_rate=1.0, window="hann", segment_length=256,
                      overlap_length=None, fft_length=None, detrend="constant", method="auto",
                      precision="highest"):
    """Magnitude-squared coherence sharded over channels and time blocks,
    the distributed `spectral.estimation.coherence`: (frequencies, this
    rank's rows of C_xy).

    Examples (with a process group initialised, every rank runs):

    >>> import tempfile, torch, torch.distributed as dist
    >>> from nx_signal_tpu_torch.parallel.mesh import make_dsp_mesh
    >>> from nx_signal_tpu_torch.parallel.estimation import sharded_coherence
    >>> store = dist.FileStore(tempfile.mkdtemp() + "/store", 1)
    >>> dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    >>> mesh = make_dsp_mesh(1, 1, device_type="cpu")
    >>> x = torch.randn(4, 4096, generator=torch.Generator().manual_seed(0))
    >>> f, coh = sharded_coherence(x, torch.roll(x, 1, -1), mesh=mesh, segment_length=256)
    >>> bool(coh.min() >= 0.0) and bool(coh.max() <= 1.000001)
    True
    >>> dist.destroy_process_group()
    """
    common = dict(mesh=mesh, sampling_rate=sampling_rate, window=window,
                  segment_length=segment_length, overlap_length=overlap_length,
                  fft_length=fft_length, detrend=detrend, method=method, precision=precision)
    freqs, pxx = sharded_welch(x, **common)
    _, pyy = sharded_welch(y, **common)
    _, pxy = sharded_csd(x, y, **common)
    return freqs, pxy.abs() ** 2 / (pxx * pyy)
