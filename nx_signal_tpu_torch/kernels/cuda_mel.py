"""Kernel M (kernels/csrc/log_mel.cu) and its band table: Whisper's log-mel
tail, from the complex64 spectrum to the floored log-mel of each clip, in
one pass over z and one in place over the result.

It replaces no TPU kernel: the JAX package leaves the log-mel to a dense
product and XLA's elementwise ops. On the card that tail was about ten
torch passes (a complex abs, the square, an exact-f32 product over a
filterbank that is 98% zeros, then clamp, log10, each clip's max, the
floor, + 4 and / 4); M reads z once.

Its one caller is `models.pipeline.WhisperLogMel`, which builds the band
table once (`mel_bands`) and, on a CUDA spectrum, launches M
(`log_mel_clips_cuda`); on a CPU spectrum it keeps the plain version, the
power and `spectral.mel._log_mel(clips=True)`.
"""

import math

import torch

from nx_signal_tpu_torch.kernels._build import load_library
from nx_signal_tpu_torch.kernels.cuda_dft import _check
from nx_signal_tpu_torch.utils.dtypes import DEFAULT_FLOAT
from nx_signal_tpu_torch.utils.profiling import span

__all__ = ["mel_bands", "log_mel_clips_cuda"]

# log_mel.cu's kMaxBins: a tile of 32 frames' power in 47 KB of shared memory
_MAX_BINS = 376


def mel_bands(filters):
    """The band table of a (mels, bins) float32 filterbank whose every row's
    nonzeros are one run of bins (a Slaney or HTK triangle; a row may have
    none): `bands`, (mels, 3) int32 rows (first nonzero bin, count, offset
    into `weights`), and `weights`, the nonzeros packed row by row in
    increasing bin, both on the filterbank's device. Reads the filterbank
    on the host once (a sync where it lies on the card); raises where a
    row's nonzeros are not one run.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.kernels.cuda_mel import mel_bands
    >>> fb = torch.tensor([[0.0, 0.5, 0.25, 0.0], [0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.75, 1.0]])
    >>> bands, weights = mel_bands(fb)
    >>> bands.tolist(), weights.tolist()
    ([[1, 2, 0], [0, 0, 2], [2, 2, 2]], [0.5, 0.25, 0.75, 1.0])
    """
    if filters.dtype != DEFAULT_FLOAT or filters.ndim != 2:
        raise ValueError(f"expected a (mels, bins) float32 filterbank, got {filters.dtype} "
                         f"{tuple(filters.shape)}")
    f = filters.detach().cpu()
    nonzero = f != 0
    counts = nonzero.sum(-1)
    first = torch.where(counts > 0, nonzero.to(torch.int8).argmax(-1), 0)
    b = torch.arange(f.shape[-1])
    if not torch.equal((b >= first[:, None]) & (b < (first + counts)[:, None]), nonzero):
        raise ValueError("each row of the filterbank must hold its nonzeros in one run of bins")
    bands = torch.stack([first, counts, torch.cumsum(counts, 0) - counts], dim=-1)
    return (bands.to(torch.int32).to(filters.device),
            f[nonzero].contiguous().to(filters.device))


def log_mel_clips_cuda(z, bands, weights):
    """Kernel M: Whisper's log-mel of a batch of clips from their one-sided
    spectrum z, (..., zframes, bins) complex64 on the card, C-contiguous,
    one clip per leading index: the power re^2 + im^2 of every frame but
    the last (never read), each mel's sum over its band of
    `mel_bands(filters)` (a filterbank of z's `bins`), log10 with a 1e-10
    clip, each clip floored at its own max - 8, then (x + 4)/4, as (...,
    mels, zframes - 1) float32. Exact f32 (fmaf, no TF32); deterministic
    (each clip's max is taken with an order-free atomic max); a NaN in a
    frame read makes its clip NaN, as torch's clamp, amax and maximum do,
    and so does a band that does not fit in z's bins or in `weights` (a
    table of another filterbank: the kernel reads nothing outside either).
    No host work, no sync: a fill and one launch inside the span
    `nx.mel.kernel`. Raises on anything else, a CPU spectrum among them:
    its plain version is `models.pipeline.WhisperLogMel`'s CPU route.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.kernels.cuda_mel import log_mel_clips_cuda, mel_bands
    >>> bands, weights = mel_bands(torch.eye(3))
    >>> log_mel_clips_cuda(torch.ones(2, 5, 3, dtype=torch.complex64), bands, weights)
    Traceback (most recent call last):
    ...
    ValueError: kernel M takes a CUDA spectrum, got one on cpu
    """
    if z.dtype != torch.complex64:
        raise ValueError(f"kernel M takes a complex64 spectrum, got {z.dtype}")
    if z.ndim < 2 or not z.is_contiguous():
        raise ValueError(f"kernel M takes a contiguous (..., frames, bins) spectrum, got shape "
                         f"{tuple(z.shape)}, strides {z.stride()}")
    if z.device.type != "cuda":
        raise ValueError(f"kernel M takes a CUDA spectrum, got one on {z.device}")
    *batch, zframes, bins = z.shape
    if not 1 <= bins <= _MAX_BINS or zframes < 2:
        raise ValueError(f"kernel M takes 2 or more frames of 1 to {_MAX_BINS} bins, got "
                         f"{zframes} frames of {bins}")
    if (bands.dtype != torch.int32 or bands.ndim != 2 or bands.shape[1] != 3
            or weights.dtype != DEFAULT_FLOAT or bands.device != z.device
            or weights.device != z.device):
        raise ValueError("kernel M takes the band table of mel_bands on the spectrum's device")
    bands, weights = bands.contiguous(), weights.contiguous()
    mels, frames, clips = bands.shape[0], zframes - 1, math.prod(batch)
    out = torch.empty((*batch, mels, frames), dtype=DEFAULT_FLOAT, device=z.device)
    if clips == 0 or mels == 0:
        return out
    scratch = torch.empty(2 * clips, dtype=torch.int32, device=z.device)  # max, CTAs done
    lib = load_library()
    with span("nx.mel.kernel"), torch.cuda.device(z.device):
        err = lib.nx_log_mel_f32(z.data_ptr(), bands.data_ptr(), weights.data_ptr(),
                                 out.data_ptr(), scratch.data_ptr(), clips, mels, frames,
                                 zframes, bins, weights.numel(),
                                 torch.cuda.current_stream().cuda_stream)
    _check(lib, err, f"log_mel kernel ({clips} clips, {mels} mels, {frames} frames, "
                     f"{bins} bins)")
    log_mel_clips_cuda.launches += 1
    return out


log_mel_clips_cuda.launches = 0
