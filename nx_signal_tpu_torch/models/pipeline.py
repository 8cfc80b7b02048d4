"""The DSP pipelines (counterpart of nx_signal_tpu/models/pipeline.py):
FIR chains, spectrograms and a log-mel front end, composed from the ops
and spectral layers.

* `stft_fir_chain`: a FIR low-pass then a windowed STFT power spectrogram.
  Its power alone (`return_filtered=False`, real input) is fused into one
  frame contraction against weights that fold the filter's 'same' Toeplitz
  matrix into the window-scaled DFT (kernels/dft.py:fir_framed_dft): on a
  CUDA tensor kernel A (kernels/cuda_dft.py:fir_framed_dft_power_cuda) at
  precision 'highest', kernel A-tc on the tensor cores at 'high' (3xTF32)
  and 'default' (one TF32 pass). The filtered path (`return_filtered=True`,
  the default) builds the filtered signal with ops/convolution.py (the
  direct Toeplitz conv1d, the FFT, or overlap-add through kernel C) and
  takes its power by `stft`'s route (spectral/stft.py:_framed_spectrum:
  kernel B-fft or B where it takes the real signal, torch.fft otherwise).
* `StftFirChain`: the fused power chain as an nn.Module (kernel A at
  'highest', A-tc at 'high' and 'default').
* `FIRFilterChain`: firwin design + overlap-add filtering (kernel C).
* `SpectrogramPipeline`, `LogMelFrontend`: stft (kernel B-fft), then dBFS or
  Whisper's log-mel normalization.
* `WhisperLogMel`: Whisper's own log-mel front end at its widths (n_fft 400,
  hop 160, 80 or 128 Slaney mels to 8 kHz), a batch of independent clips
  with a floor per clip, in the (..., mels, frames) layout an encoder takes.
* `WidebandReceiver`: the polyphase channelizer (`ops.resample.pfb_analyze`)
  then a Hann STFT of each complex sub-band stream (torch.fft: the framed
  DFT kernels take real input only) and |z|^2.
* `channelize_power_stream`: a block stream (e.g. `io.raw.
  PrefetchingRawReader` decoding a capture) through `parallel.streaming.
  StreamingPFB`, band power accumulated on the device in float64.
"""

import collections

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from nx_signal_tpu_torch.kernels.cuda_dft import fir_framed_dft_power_cuda
from nx_signal_tpu_torch.kernels.cuda_mel import log_mel_clips_cuda, mel_bands
from nx_signal_tpu_torch.kernels.dft import (
    _check_precision,
    _same_pad_left,
    fir_dft_fold_weights,
    fir_framed_dft,
    # no call here (the filtered power takes spectral.stft's route): a name
    # the benchmark's fault sites patch (portbench/tests/faults.py)
    framed_dft,  # noqa: F401
    good_matmul_fft_length,
)
from nx_signal_tpu_torch.ops.convolution import convolve, oaconvolve
from nx_signal_tpu_torch.ops.filters import firwin
from nx_signal_tpu_torch.ops.resample import pfb_analyze
from nx_signal_tpu_torch.ops.windows import hann
from nx_signal_tpu_torch.spectral.mel import _log_mel, _slaney_max_mel, mel_filters
from nx_signal_tpu_torch.spectral.stft import _framed_spectrum, stft
from nx_signal_tpu_torch.utils.devices import as_signal, target_device
from nx_signal_tpu_torch.utils.dtypes import DEFAULT_FLOAT
from nx_signal_tpu_torch.utils.profiling import span

__all__ = ["StftFirChain", "stft_fir_chain", "FIRFilterChain", "SpectrogramPipeline",
           "LogMelFrontend", "WhisperLogMel", "WidebandReceiver", "channelize_power_stream"]


@dataclass(frozen=True)
class SpectrogramPipeline:
    """Hann-window STFT -> dBFS spectrogram, 20 log10(|S| / max|S|), with
    the spectrum scaling; returns (dB, times, frequencies).

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.models.pipeline import SpectrogramPipeline
    >>> db, times, freqs = SpectrogramPipeline(frame_length=256, fft_length=256)(
    ...     torch.sin(0.2 * torch.arange(4096.0)))
    >>> db.shape, float(db.max())
    (torch.Size([31, 256]), 0.0)
    """

    frame_length: int = 1024
    overlap_length: int = None
    fft_length: int = 1024
    sampling_rate: float = 16000.0

    def __call__(self, x):
        x = as_signal(x)
        z, times, freqs = stft(x, hann(self.frame_length, device=x.device),
                               sampling_rate=self.sampling_rate, fft_length=self.fft_length,
                               overlap_length=self.overlap_length, scaling="spectrum")
        mag = z.abs()
        db = 20.0 * torch.log10(mag / mag.max() + 1e-12)
        return db, times, freqs


@dataclass(frozen=True)
class LogMelFrontend:
    """Whisper-style log-mel front end: STFT (reflect padding) -> |z|^2 ->
    one mel matmul -> log10 with the dynamic-range floor.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.models.pipeline import LogMelFrontend
    >>> LogMelFrontend()(torch.sin(0.2 * torch.arange(16000.0))).shape
    torch.Size([101, 80])
    """

    frame_length: int = 400
    hop_length: int = 160
    fft_length: int = 512
    mel_bins: int = 80
    sampling_rate: float = 16000.0

    def __call__(self, x):
        x = as_signal(x)
        z = stft(x, hann(self.frame_length, device=x.device), sampling_rate=self.sampling_rate,
                 fft_length=self.fft_length,
                 overlap_length=self.frame_length - self.hop_length,
                 window_padding="reflect").z
        filters = mel_filters(self.fft_length, self.mel_bins, self.sampling_rate,
                              device=x.device)
        return _log_mel(z.abs().to(DEFAULT_FLOAT) ** 2, filters, self.fft_length // 2)


class WhisperLogMel(nn.Module):
    """Whisper's log-mel front end (openai/whisper `audio.py:
    log_mel_spectrogram`) as a module, for a batch of independent clips.
    Whisper's constants are its class attributes: 16 kHz, n_fft 400, hop
    160. Its buffers, built once on `device` (None: the card; `.to(device)`
    moves them): the periodic Hann window of 400 and the Slaney filterbank
    of `n_mels` (80, or 128 from large-v3 on) x 201 bins from 0 to 8 kHz,
    built in f64 (librosa's `filters.mel` with its defaults, the top edge at
    exactly half the rate) and kept in f32.

    `forward(x)` maps the real (..., L) 16 kHz signal, one clip a row, to
    its (..., n_mels, L // 160) log-mel spectrogram, contiguous: the
    centred STFT with reflect padding (`stft`, kernel B-fft on a CUDA
    tensor), |z|^2 with the last frame dropped, the exact-f32 mel product,
    log10 with a 1e-10 clip, the floor max - 8 taken over each clip's mels
    and frames, then (x + 4)/4. A 1-D signal is one clip. Whisper pads or
    cuts each clip to 30 s (480 000 samples at 16 kHz) before it. On a
    CUDA tensor everything after the STFT is kernel M
    (`kernels.cuda_mel.log_mel_clips_cuda`, over the band table of the
    filterbank's nonzeros, the buffers `bands` and `band_weights`); on a
    CPU tensor the power and `spectral.mel._log_mel` compute it. `filters`
    is the one source of both: the band table is derived from it, kept out
    of the state dict and rebuilt from the filters `load_state_dict` loads.

    `LogMelFrontend` keeps the JAX package's form instead: NxSignal's mel
    top edge (3016.0), one floor for the whole batch, every frame, and the
    (..., frames, mels) layout.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.models.pipeline import WhisperLogMel
    >>> frontend = WhisperLogMel(n_mels=80, device="cpu")
    >>> x = torch.randn(2, 16000, generator=torch.Generator().manual_seed(0))
    >>> m = frontend(x)
    >>> m.shape, m.is_contiguous()
    (torch.Size([2, 80, 100]), True)
    >>> bool((frontend(x[1]) - m[1]).abs().max() < 1e-5)   # a clip's floor is its own
    True
    """

    sampling_rate = 16000.0
    n_fft = 400
    hop_length = 160

    def __init__(self, n_mels: int = 128, *, device=None):
        super().__init__()
        device = target_device(device)
        with span("nx.weights.mel"):
            filters = mel_filters(self.n_fft, n_mels, self.sampling_rate,
                                  max_mel=_slaney_max_mel(self.sampling_rate / 2.0),
                                  dtype=torch.float64, device=device)
            filters = filters[:, :self.n_fft // 2 + 1].to(DEFAULT_FLOAT).contiguous()
            bands, band_weights = mel_bands(filters)
        self.register_buffer("window", hann(self.n_fft, device=device))
        self.register_buffer("filters", filters)
        self.register_buffer("bands", bands, persistent=False)
        self.register_buffer("band_weights", band_weights, persistent=False)
        self.register_load_state_dict_post_hook(WhisperLogMel._rebuild_bands)

    def _rebuild_bands(self, incompatible_keys):
        """The band table of the filters a state dict has just loaded."""
        with span("nx.weights.mel"):
            self.bands, self.band_weights = mel_bands(self.filters)

    def forward(self, x):
        with span("nx.logmel"):
            x = as_signal(x)
            if x.is_complex():
                raise ValueError("WhisperLogMel needs a real signal")
            z = stft(x, self.window, sampling_rate=self.sampling_rate, fft_length=self.n_fft,
                     overlap_length=self.n_fft - self.hop_length, onesided=True,
                     window_padding="reflect").z
            if z.is_cuda:
                with span("nx.mel"):
                    return log_mel_clips_cuda(z, self.bands, self.band_weights)
            power = z[..., :-1, :].abs() ** 2
            return _log_mel(power, self.filters, self.filters.shape[-1], clips=True)


@dataclass(frozen=True)
class FIRFilterChain:
    """firwin design + overlap-add application ('same' mode; the overlap-add
    is kernel C on a CUDA tensor).

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.models.pipeline import FIRFilterChain
    >>> FIRFilterChain(num_taps=31)(torch.ones(2, 1000)).shape
    torch.Size([2, 1000])
    """

    num_taps: int = 255
    cutoff: tuple = (2000.0,)
    sampling_rate: float = 48000.0
    window: str = "hann"

    def design(self, device=None):
        """The chain's firwin taps, designed on `device` (None: the card)."""
        return firwin(self.num_taps, list(self.cutoff), window=self.window,
                      sampling_rate=self.sampling_rate, device=device)

    @property
    def taps(self):
        return self.design()

    def __call__(self, x):
        x = as_signal(x)
        taps = self.design(x.device)
        if x.ndim > 1:
            taps = taps.reshape((1,) * (x.ndim - 1) + (-1,))
        return oaconvolve(x, taps, mode="same")


def stft_fir_chain(x, taps, window, *, fft_length: int, overlap_length: int,
                   sampling_rate: float = 16000.0, fir_method: str = "direct",
                   onesided: bool = True, return_filtered: bool = True,
                   precision: str = "highest", frame_chunks=1):
    """FIR filter then windowed STFT power spectrogram of the (..., L)
    signal: returns (filtered, power), the 'same'-filtered signal and the
    (..., frames, bins) power of its 'valid' framing at hop frame_length -
    overlap_length, or the power alone with `return_filtered=False`.

    * `return_filtered=False` with real input and frame_length <= fft_length
      <= 1024 runs `kernels.dft.fir_framed_dft(output='power')`, which never
      builds the filtered signal (on a CUDA tensor kernel A at 'highest',
      kernel A-tc at 'high' and 'default'; `frame_chunks` shapes only its
      plain path). This fold costs O(n_fft^2) a frame, so it keeps the JAX
      package's 1024 cut on every device.
    * Otherwise the filtered signal comes from `ops.convolution`:
      `fir_method` 'direct' (the Toeplitz conv1d), 'fft', or 'oa'
      (overlap-add, kernel C). Its power takes `stft`'s route
      (`spectral.stft._framed_spectrum` at method='auto': kernel B-fft, or
      B, where it takes the real signal, and |stft|^2 through torch.fft
      otherwise). `sampling_rate` is accepted for the JAX package's
      signature; the power does not depend on it.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.models.pipeline import stft_fir_chain
    >>> from nx_signal_tpu_torch.ops.filters import firwin
    >>> from nx_signal_tpu_torch.ops.windows import hann
    >>> x = torch.randn(2, 4096, generator=torch.Generator().manual_seed(0))
    >>> taps = firwin(31, [2000.0], sampling_rate=16000.0, device="cpu")
    >>> p = stft_fir_chain(x, taps, hann(256, device="cpu"), fft_length=256, overlap_length=192,
    ...                    return_filtered=False)
    >>> p.shape
    torch.Size([2, 61, 129])
    >>> y, p = stft_fir_chain(x, taps, hann(256, device="cpu"), fft_length=256, overlap_length=192)
    >>> y.shape, p.shape
    (torch.Size([2, 4096]), torch.Size([2, 61, 129]))
    """
    with span("nx.stft_fir_chain"):
        x = as_signal(x)
        taps = torch.as_tensor(taps, device=x.device)
        window = torch.as_tensor(window, device=x.device)
        n_fft = fft_length
        frame_length = window.shape[-1]
        stride = frame_length - overlap_length
        fused_ok = (not x.is_complex() and good_matmul_fft_length(n_fft)
                    and n_fft >= frame_length)
        if not return_filtered and fused_ok:
            return fir_framed_dft(x, taps.reshape(-1), window, stride=stride, n_fft=n_fft,
                                  onesided=onesided, precision=precision, output="power",
                                  frame_chunks=frame_chunks)

        with span("nx.fir"):
            taps_b = taps.reshape((1,) * (x.ndim - 1) + (-1,)) if x.ndim > 1 else taps
            if fir_method == "oa":
                y = oaconvolve(x, taps_b, mode="same")
            else:
                y = convolve(x, taps_b, mode="same", method=fir_method)
        # 'valid' framing, the stft default
        power = _framed_spectrum(y, window, stride=stride, n_fft=n_fft, onesided=onesided,
                                 method="auto", precision=precision, output="power")
        if not return_filtered:
            return power
        return y, power


class StftFirChain(nn.Module):
    """The fused STFT+FIR power chain as a module: the folded (frame + K - 1,
    2*bins) f32 weights, T(taps) @ diag(window) @ DFT built once on the host
    in f64, are its `weights` buffer (so `.to(device)` moves them), and
    `forward(x)` maps the real (..., L) signal to its one-sided
    (..., frames, bins) power spectrogram, equal to
    `stft_fir_chain(x, taps, window, ..., return_filtered=False,
    precision=precision)`. On a CUDA tensor forward runs kernel A at
    'highest', kernel A-tc at 'high' (3xTF32) and 'default' (one TF32 pass);
    on a CPU tensor their plain versions.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.models.pipeline import StftFirChain
    >>> from nx_signal_tpu_torch.ops.filters import firwin
    >>> from nx_signal_tpu_torch.ops.windows import hann
    >>> chain = StftFirChain.from_numpy(firwin(31, [0.2], device="cpu").numpy(),
    ...                                 hann(256, device="cpu").numpy(), stride=64,
    ...                                 n_fft=256, device="cpu")
    >>> chain(torch.zeros(3, 1024)).shape
    torch.Size([3, 13, 129])
    """

    def __init__(self, weights, *, stride: int, num_taps: int, frame_length: int,
                 n_fft: int, precision: str = "highest"):
        super().__init__()
        _check_precision(precision)
        if stride < 1:
            raise ValueError(f"stride must be >= 1, got {stride}")
        if tuple(weights.shape) != (frame_length + num_taps - 1, 2 * (n_fft // 2 + 1)):
            raise ValueError(f"weights of shape {tuple(weights.shape)} do not fold "
                             f"{num_taps} taps into a {frame_length}-frame, {n_fft}-point DFT")
        self.register_buffer("weights", weights)
        self.stride = stride
        self.frame_length = frame_length
        self.pad_left = _same_pad_left(num_taps)
        self.bins = n_fft // 2 + 1
        self.precision = precision

    @classmethod
    def from_numpy(cls, taps, window, *, stride: int, n_fft: int, precision: str = "highest",
                   device=None):
        """Fold the numpy `taps` and `window` (e.g. `np.asarray` of the JAX
        package's firwin / hann) into the module's weights on `device`, by
        default the CUDA device (a RuntimeError where there is none: pass
        device='cpu' for the CPU)."""
        taps = np.asarray(taps, dtype=np.float64).reshape(-1)
        window = np.asarray(window, dtype=np.float64)
        if n_fft < window.shape[-1]:
            raise ValueError(f"n_fft {n_fft} is shorter than the window {window.shape[-1]}")
        weights = fir_dft_fold_weights(taps, window, n_fft, True, device=device)
        return cls(weights, stride=stride, num_taps=taps.shape[0],
                   frame_length=window.shape[-1], n_fft=n_fft, precision=precision)

    def forward(self, x):
        with span("nx.chain"):
            x = as_signal(x)
            if x.is_complex():
                raise ValueError("StftFirChain needs a real signal")
            if x.shape[-1] < self.frame_length:
                raise ValueError(f"window length {self.frame_length} exceeds signal "
                                 f"length {x.shape[-1]}")
            num_frames = (x.shape[-1] - self.frame_length) // self.stride + 1
            return fir_framed_dft_power_cuda(x, self.weights, stride=self.stride,
                                             pad_left=self.pad_left, num_frames=num_frames,
                                             bins=self.bins, precision=self.precision)


@dataclass(frozen=True)
class WidebandReceiver:
    """SDR-style wideband front end: polyphase-channelize the (..., L)
    stream into `n_channels` sub-bands, then Hann-STFT each complex
    sub-band stream over its full spectrum; returns the
    (..., n_channels, frames, frame_length) power |z|^2.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.models.pipeline import WidebandReceiver
    >>> x = torch.randn(1 << 14, generator=torch.Generator().manual_seed(0))
    >>> WidebandReceiver(n_channels=32, frame_length=64, hop=32)(x).shape
    torch.Size([32, 14, 64])
    """

    n_channels: int = 64
    taps_per_channel: int = 8
    frame_length: int = 128
    hop: int = 64
    sampling_rate: float = 100e6

    def __call__(self, x):
        x = as_signal(x)
        channels = pfb_analyze(x, self.n_channels, taps_per_channel=self.taps_per_channel)
        sub_streams = channels.transpose(-1, -2)  # (..., n_channels, frames)
        z = stft(sub_streams, hann(self.frame_length, device=x.device),
                 sampling_rate=self.sampling_rate / self.n_channels,
                 fft_length=self.frame_length,
                 overlap_length=self.frame_length - self.hop).z
        return z.abs() ** 2


class _Stager:
    """Host chunks to the device, each copied there once: on a CUDA device
    through two pinned buffers, each copy asynchronous, and a buffer is
    written again only after its last copy has finished (its event); on the
    CPU a fresh array per chunk."""

    def __init__(self, device, rows: int, length: int, dtype):
        self.device, self.dtype, self.slot = device, dtype, 0
        self.pinned = self.events = None
        if device.type == "cuda":
            dt = torch.from_numpy(np.zeros(0, dtype)).dtype
            self.pinned = [torch.empty(rows * length, dtype=dt, pin_memory=True)
                           for _ in range(2)]
            self.events = [None, None]

    def __call__(self, pieces):
        rows = pieces[0].shape[0]
        n = sum(p.shape[1] for p in pieces)
        if self.pinned is None:
            return torch.from_numpy(np.concatenate(pieces, axis=1).astype(self.dtype, copy=False))
        slot, self.slot = self.slot, 1 - self.slot
        if self.events[slot] is not None:
            self.events[slot].synchronize()
        buf = self.pinned[slot][:rows * n].view(rows, n)
        host, at = buf.numpy(), 0
        for p in pieces:
            host[:, at:at + p.shape[1]] = p
            at += p.shape[1]
        out = buf.to(self.device, non_blocking=True)
        self.events[slot] = torch.cuda.Event()
        self.events[slot].record()
        return out


def channelize_power_stream(blocks, n_channels: int, *, taps_per_channel: int = 8,
                            window=("kaiser", 5.0), taps=None, strategy: str = "auto",
                            precision="highest", drop_tail: bool = False, device=None):
    """Consume an iterator of (channels, block_frames) host blocks - e.g.
    `io.raw.PrefetchingRawReader` decoding a live SDR capture - through a
    `StreamingPFB` channelizer, accumulating per-band power on `device`
    (None: the card) in float64; the complex spectra never leave it.
    Returns (power (channels, n_channels) float32, frames_accumulated int).

    Blocks are queued on the host and cut into chunks of one fixed length
    (the first block's length rounded down to a multiple of n_channels),
    read through a cursor: every sample is copied once, into its chunk, and
    each chunk goes to the device once. A shorter multiple-of-m tail is
    processed too unless `drop_tail=True`. The accumulated power equals
    `pfb_analyze` of the zero-prepended stream summed over frames - the
    `StreamingPFB.lead_frames` warm-up frames are included (their windows
    taper into the zero lead).

    Examples:

    >>> import numpy as np, torch
    >>> from nx_signal_tpu_torch.models.pipeline import channelize_power_stream
    >>> from nx_signal_tpu_torch.ops.resample import pfb_analyze
    >>> x = np.random.default_rng(0).normal(size=(1, 4096)).astype(np.float32)
    >>> blocks = [x[:, :1536], x[:, 1536:3072], x[:, 3072:]]  # ragged tail
    >>> power, frames = channelize_power_stream(blocks, 16, taps_per_channel=4,
    ...                                         device='cpu')
    >>> ref = pfb_analyze(torch.from_numpy(np.pad(x, [(0, 0), (48, 0)])), 16,
    ...                   taps_per_channel=4)
    >>> ref_p = (ref.real ** 2 + ref.imag ** 2).sum(dim=-2)
    >>> tuple(power.shape), frames, bool((power - ref_p).abs().max() < 1e-4 * ref_p.max())
    ((1, 16), 256, True)
    """
    from nx_signal_tpu_torch.parallel.streaming import StreamingPFB

    m = n_channels
    pfb = StreamingPFB(m, taps_per_channel=taps_per_channel, window=window, taps=taps,
                       strategy=strategy, precision=precision)
    it = iter(blocks)
    try:
        first = np.asarray(next(it))
    except StopIteration:
        raise ValueError("empty block stream") from None
    if first.ndim != 2:
        raise ValueError(f"blocks must be (channels, frames), got shape {first.shape}")
    n_streams = first.shape[0]
    chunk_len = (first.shape[1] // m) * m
    if chunk_len == 0:
        raise ValueError(
            f"block length ({first.shape[1]}) is shorter than one "
            f"n_channels ({m}) stride")
    dev = target_device(device)
    kinds = (np.float32, np.float64, np.complex64, np.complex128)
    stage = _Stager(dev, n_streams, chunk_len,
                    first.dtype if first.dtype in kinds else np.float32)
    state = pfb.init_state(batch_shape=(n_streams,), device=dev)
    acc = torch.zeros((n_streams, m), dtype=torch.float64, device=dev)
    frames = 0
    fifo, cursor, buffered = collections.deque([first]), 0, first.shape[1]

    def take(n):
        """The next n queued samples of every stream, as pieces of blocks."""
        nonlocal cursor, buffered
        pieces = []
        while n:
            head = fifo[0]
            k = min(n, head.shape[1] - cursor)
            pieces.append(head[:, cursor:cursor + k])
            cursor, n, buffered = cursor + k, n - k, buffered - k
            if cursor == head.shape[1]:
                fifo.popleft()
                cursor = 0
        return pieces

    def step(pieces):
        nonlocal state, acc, frames
        state, z = pfb.process(state, stage(pieces))
        acc += torch.sum(z.real ** 2 + z.imag ** 2, dim=-2, dtype=torch.float64)
        frames += z.shape[-2]

    while True:
        while buffered >= chunk_len:
            step(take(chunk_len))
        block = next(it, None)
        if block is None:
            break
        block = np.asarray(block)
        if block.shape[1]:
            fifo.append(block)
            buffered += block.shape[1]
    tail_len = (buffered // m) * m
    if tail_len and not drop_tail:
        step(take(tail_len))
    return acc.to(DEFAULT_FLOAT), frames
