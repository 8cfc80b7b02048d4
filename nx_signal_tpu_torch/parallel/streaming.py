"""Stateful block-streaming DSP for unbounded streams (counterpart of
nx_signal_tpu/parallel/streaming.py).

Every processor is a pure pair: `init_state(batch_shape, dtype, device)`
and `process(state, chunk) -> (state, out)`. The state is an explicit
tensor (a numpy array after `io.checkpoint.load_state`; `process` moves it
onto the chunk's device), so a long stream checkpoints at any chunk
boundary and resumes bitwise: a chunk's work depends only on its shape, its
state and its samples. Where the JAX package composes a processor with
`jax.lax.scan`, the port runs a Python loop over the chunks.

Routes, on a CUDA tensor:

* `StreamingFIR`: `ops.convolution.fir_convolve_1d(ext, taps, 'valid')`,
  one exact-f32 conv1d against the taps' Toeplitz band.
* `StreamingIIR`: `ops.iir._lfilter_last_axis` per second-order section
  (the chunked order-2 form).
* `StreamingSTFT`: `spectral.stft._framed_spectrum`, the route of
  `spectral.stft.stft` (kernel B-fft, one launch per chunk, where it takes
  a real chunk and window; torch.fft otherwise).
* `StreamingISTFT`: torch.fft.ifft, the scaling and window, then the
  seeded overlap-add `spectral.framing._ola_fold` (kernel C, once per part
  of the complex frames: two launches per chunk).
* `StreamingPFB`: the channelizer of `ops.resample.pfb_analyze`.
* `StreamingResamplePoly`: `ops.resample._phase_outputs`, the polyphase
  core of `upfirdn`.

A chunk goes through `utils.devices.as_signal` (a numpy chunk goes to the
card). The constants a processor applies to every chunk (taps, window,
envelope, PFB weights, the resampler's banded weight) are copied to a
device on its first chunk there and kept on the processor (`_kept`); the
chunked IIR's matrices are kept per denominator and device by
`ops.iir._chunk_constants_on`. So a chunk makes no host-to-device copy.
`init_state` makes its zeros on `device`, by default the card
(`utils.devices.target_device`).
"""

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from nx_signal_tpu_torch.kernels.dft import _check_precision
from nx_signal_tpu_torch.ops.convolution import _float_cast, fir_convolve_1d
from nx_signal_tpu_torch.ops.filters import firwin
from nx_signal_tpu_torch.ops.iir import _lfilter_last_axis, _sos_host, _work_dtype
from nx_signal_tpu_torch.ops.resample import (
    _pfb_channels,
    _pfb_route,
    _pfb_weights,
    _phase_bank,
    _phase_outputs,
    _phase_plan,
    _resample_poly_design,
    _upfirdn_dtype,
)
from nx_signal_tpu_torch.spectral.framing import _ola_fold
from nx_signal_tpu_torch.spectral.stft import _apply_scaling, _framed_spectrum
from nx_signal_tpu_torch.utils.devices import as_signal, target_device
from nx_signal_tpu_torch.utils.dtypes import DEFAULT_COMPLEX, DEFAULT_FLOAT

__all__ = ["StreamingFIR", "StreamingSTFT", "StreamingISTFT", "StreamingIIR",
           "StreamingPFB", "StreamingResamplePoly"]


def _host(a) -> torch.Tensor:
    """A constant as a host tensor of its own dtype."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    return torch.as_tensor(np.asarray(a))


def _kept(proc, key, make):
    """The constant `key` of the processor `proc`, made by `make()` on first
    use and kept on it: a processor's device copies live as long as it
    does, one per device (and dtype or chunk length where they vary)."""
    copies = proc.__dict__.setdefault("_copies", {})
    if key not in copies:
        copies[key] = make()
    return copies[key]


def _zeros(shape, dtype, device) -> torch.Tensor:
    """init_state's zeros: `dtype` a torch or numpy dtype, `device` None
    for the card."""
    if not isinstance(dtype, torch.dtype):
        dtype = torch.from_numpy(np.zeros(0, dtype)).dtype
    return torch.zeros(shape, dtype=dtype, device=target_device(device))


def _state_on(state, device) -> torch.Tensor:
    """The carried state as a tensor on the chunk's device (a numpy state,
    e.g. from `io.checkpoint.load_state`, is copied there)."""
    return torch.as_tensor(state).to(device)


@dataclass(frozen=True)
class StreamingFIR:
    """Causal overlap-save FIR: chunk outputs equal
    convolve(stream, taps, mode='full')[:len(stream)] - the filter's group
    delay is NOT compensated (that needs future samples). The carry is the
    last K-1 input samples.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.parallel.streaming import StreamingFIR
    >>> fir = StreamingFIR(torch.tensor([0.5, 0.5]))
    >>> state = fir.init_state(device='cpu')
    >>> state, y1 = fir.process(state, torch.tensor([1.0, 2.0, 3.0, 4.0]))
    >>> state, y2 = fir.process(state, torch.tensor([5.0, 6.0, 7.0, 8.0]))
    >>> torch.cat([y1, y2])   # == full conv of the stream
    tensor([0.5000, 1.5000, 2.5000, 3.5000, 4.5000, 5.5000, 6.5000, 7.5000])
    """

    taps: object

    def __post_init__(self):
        object.__setattr__(self, "_taps", _float_cast(_host(self.taps)).reshape(-1))

    def init_state(self, batch_shape=(), dtype=DEFAULT_FLOAT, device=None):
        return _zeros((*batch_shape, self._taps.shape[-1] - 1), dtype, device)

    def process(self, state, chunk):
        chunk = _float_cast(as_signal(chunk))
        state = _state_on(state, chunk.device)
        k = self._taps.shape[-1]
        ext = torch.cat([state.to(chunk.dtype), chunk], dim=-1)
        taps = _kept(self, chunk.device, lambda: self._taps.to(chunk.device))
        out = fir_convolve_1d(ext, taps, "valid")
        new_state = ext[..., -(k - 1):] if k > 1 else state
        return new_state, out


@dataclass(frozen=True)
class StreamingSTFT:
    """Streaming frame extraction + windowed FFT. The carry holds the
    samples not yet consumed by a full frame (the frame_length - hop
    overlap context), initialized to zeros - so the stream behaves like the
    batch signal PREPENDED with frame_length - hop zeros: streaming frame i
    starts at stream sample i*hop - (frame_length - hop), and concatenating
    the per-chunk spectra equals
    stft(concat([zeros(frame_length - hop), stream]), padding='valid').

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.windows import hann
    >>> from nx_signal_tpu_torch.parallel.streaming import StreamingSTFT
    >>> sstft = StreamingSTFT(hann(8, device="cpu"), hop=4, onesided=True)
    >>> state = sstft.init_state(device='cpu')
    >>> state, z1 = sstft.process(state, torch.ones(8))
    >>> state, z2 = sstft.process(state, torch.ones(8))
    >>> tuple(z1.shape), tuple(z2.shape)   # 2 frames per 8-sample chunk at hop 4
    ((2, 5), (2, 5))
    """

    window: object
    hop: int
    fft_length: int = None
    onesided: bool = False

    def __post_init__(self):
        object.__setattr__(self, "_window", _host(self.window))

    @property
    def frame_length(self):
        return self._window.shape[-1]

    def init_state(self, batch_shape=(), dtype=DEFAULT_FLOAT, device=None):
        return _zeros((*batch_shape, self.frame_length - self.hop), dtype, device)

    def process(self, state, chunk):
        chunk = as_signal(chunk)
        frame_length = self.frame_length
        if chunk.shape[-1] % self.hop != 0:
            raise ValueError(
                f"chunk length ({chunk.shape[-1]}) must be a multiple of the "
                f"hop ({self.hop}) so frame counts stay static"
            )
        state = _state_on(state, chunk.device)
        ext = torch.cat([state.to(chunk.dtype), chunk], dim=-1)
        window = _kept(self, ext.device, lambda: self._window.to(ext.device))
        z = _framed_spectrum(ext, window, stride=self.hop, n_fft=self.fft_length or frame_length,
                             onesided=self.onesided,
                             method="fft" if window.is_complex() else "auto",
                             precision="highest")
        consumed = z.shape[-2] * self.hop
        return ext[..., consumed:], z


@dataclass(frozen=True)
class StreamingISTFT:
    """Streaming inverse STFT via the deterministic overlap-add fold. The
    carry is the overlap tail (the last frame_length - hop output samples,
    still accumulating). Emitted samples are normalized by the periodic NOLA
    window envelope, so the concatenated output equals the batch `istft`
    everywhere except the first and last half-window of the whole stream
    (which the batch version also reconstructs imperfectly).

    Examples:

    >>> import numpy as np, torch
    >>> from nx_signal_tpu_torch.ops.windows import hann
    >>> from nx_signal_tpu_torch.parallel.streaming import StreamingISTFT
    >>> sistft = StreamingISTFT(hann(8, device="cpu"), hop=4)
    >>> state = sistft.init_state(device='cpu')
    >>> z = torch.from_numpy(np.fft.fft(np.ones((2, 8))).astype(np.complex64))
    >>> state, y = sistft.process(state, z)
    >>> tuple(y.shape)   # hop * frames emitted, overlap tail carried
    (8,)
    """

    window: object
    hop: int
    scaling: str = None
    sampling_rate: float = 1000.0

    def __post_init__(self):
        window = _host(self.window)
        object.__setattr__(self, "_window", window)
        object.__setattr__(self, "_env", self._envelope(window.shape[-1]))

    def init_state(self, batch_shape=(), dtype=DEFAULT_COMPLEX, device=None):
        return _zeros((*batch_shape, self._window.shape[-1] - self.hop), dtype, device)

    def _envelope(self, frame_length):
        """Periodic interior NOLA envelope: env[s] = sum_j w^2[s + j*hop],
        one hop period, in f32 (host numpy)."""
        w2 = np.abs(self._window.numpy()).astype(np.float32) ** 2
        w2 = np.pad(w2, (0, (-frame_length) % self.hop))
        env = w2.reshape(-1, self.hop).sum(axis=0)
        return np.where(env > 1e-10, env, np.float32(1.0))

    def process(self, state, z_chunk):
        z_chunk = as_signal(z_chunk)
        frame_length = self._window.shape[-1]
        overlap = frame_length - self.hop
        if z_chunk.shape[-1] != frame_length:
            raise ValueError(
                f"StreamingISTFT requires fft_length == window length "
                f"({frame_length}); got spectra with {z_chunk.shape[-1]} bins "
                "— decimating or cropping bins would silently corrupt the "
                "reconstruction"
            )
        device = z_chunk.device
        window, env = _kept(self, device, lambda: (self._window.to(device),
                                                   torch.from_numpy(self._env).to(device)))
        frames = torch.fft.ifft(z_chunk, n=frame_length, dim=-1)
        frames = _apply_scaling(frames, window, self.scaling, self.sampling_rate,
                                inverse=True)
        frames = frames * window
        m = frames.shape[-2]
        local_len = m * self.hop + overlap
        init = F.pad(_state_on(state, device).to(frames.dtype), (0, local_len - overlap))
        acc = _ola_fold(frames, self.hop, local_len, init=init)
        emitted = acc[..., :m * self.hop].reshape(*acc.shape[:-1], m, self.hop)
        emitted = (emitted / env).flatten(-2)
        return acc[..., m * self.hop:], emitted


@dataclass(frozen=True)
class StreamingPFB:
    """Streaming critically-sampled polyphase channelizer - `pfb_analyze`
    on an unbounded stream. The carry is the last
    (taps_per_channel-1)*n_channels input samples, zero-initialized, so the
    stream behaves like the batch signal PREPENDED with that many zeros:
    concatenating per-chunk outputs equals
    `pfb_analyze(concat([zeros((tpc-1)*m), stream]))`, and dropping the
    first `lead_frames` (= taps_per_channel-1) output frames gives
    `pfb_analyze(stream)` to f32 accuracy. Chunk lengths must be multiples
    of n_channels. The prototype is designed once, here.

    Examples:

    >>> import numpy as np, torch
    >>> from nx_signal_tpu_torch.ops.resample import pfb_analyze
    >>> from nx_signal_tpu_torch.parallel.streaming import StreamingPFB
    >>> x = torch.from_numpy(np.random.default_rng(0).normal(size=512).astype(np.float32))
    >>> pfb = StreamingPFB(8, taps_per_channel=4)
    >>> state = pfb.init_state(device='cpu')
    >>> state, z1 = pfb.process(state, x[:256])
    >>> state, z2 = pfb.process(state, x[256:])
    >>> z = torch.cat([z1, z2], dim=-2)[pfb.lead_frames:]
    >>> ref = pfb_analyze(x, 8, taps_per_channel=4)
    >>> tuple(z.shape), bool((z - ref).abs().max() < 1e-5)
    ((61, 8), True)
    """

    n_channels: int
    taps_per_channel: int = 8
    window: tuple = ("kaiser", 5.0)
    taps: object = None
    shift: bool = False
    strategy: str = "auto"
    precision: str = "highest"

    def __post_init__(self):
        m = self.n_channels
        if self.taps is None:
            # a host prototype: process lays out its weights from it per device
            proto = firwin(m * self.taps_per_channel, [1.0 / m], window=self.window,
                           device="cpu")
        else:
            proto = _host(self.taps)
            if proto.shape[0] % m != 0:
                raise ValueError(
                    f"prototype length ({proto.shape[0]}) must be a "
                    f"multiple of n_channels ({m})")
            object.__setattr__(self, "taps_per_channel", proto.shape[0] // m)
        object.__setattr__(self, "taps", proto)

    @property
    def lead_frames(self) -> int:
        """Zero-lead-in output frames to drop for batch alignment."""
        return self.taps_per_channel - 1

    def init_state(self, batch_shape=(), dtype=DEFAULT_FLOAT, device=None):
        return _zeros((*batch_shape, (self.taps_per_channel - 1) * self.n_channels), dtype,
                      device)

    def process(self, state, chunk):
        m = self.n_channels
        chunk = _float_cast(as_signal(chunk))
        if chunk.shape[-1] % m != 0 or chunk.shape[-1] < m:
            raise ValueError(
                f"chunk length ({chunk.shape[-1]}) must be a non-zero "
                f"multiple of n_channels ({m}) so frame counts stay static"
            )
        _check_precision(self.precision)
        dtype, strategy = _pfb_route(chunk.dtype, self.taps.dtype, m, self.strategy)
        dev = chunk.device
        weights = _kept(self, (dev, dtype, strategy),
                        lambda: _pfb_weights(self.taps, m, strategy, dtype, dev))
        state = _state_on(state, dev)
        ext = torch.cat([state.to(chunk.dtype), chunk], dim=-1)
        out = _pfb_channels(ext.to(dtype), weights, m, strategy, self.precision, self.shift)
        carry = (self.taps_per_channel - 1) * m
        new_state = ext[..., -carry:] if carry else state
        return new_state, out


@dataclass(frozen=True)
class StreamingResamplePoly:
    """Streaming rational-rate polyphase resampler - `resample_poly`
    (scipy semantics, gcd-reduced up/down, group-delay-aligned output
    grid) on an unbounded stream. Per chunk of C input samples (C a
    multiple of the reduced `down`) it emits exactly C*up/down output
    samples; the carry holds the last `taps-1 + Z` input samples, where
    the Z-sample zero lead (a multiple of `down`, covering the centered
    filter's group-delay lookahead) makes every chunk's outputs depend
    only on already-received input. Alignment: concatenating the per-call
    outputs and dropping the first `lead_out` (= Z*up/down) samples gives
    `resample_poly(stream)` sample-for-sample to f32 accuracy; to drain the
    filter tail at end-of-stream, feed zero chunks until
    `lead_out + ceil(n_in*up/down)` total outputs have been collected.

    The per-call phase pattern ((n_offset + l)*down) % up is chunk-invariant
    because C*up = (C*up/down)*down = 0 (mod up), the argument of
    parallel/sharded.py:sharded_upfirdn with the chunk index in place of
    the rank.

    Examples:

    >>> import numpy as np, torch
    >>> from nx_signal_tpu_torch.ops.resample import resample_poly
    >>> from nx_signal_tpu_torch.parallel.streaming import StreamingResamplePoly
    >>> x = torch.from_numpy(np.random.default_rng(0).normal(size=600).astype(np.float32))
    >>> sr = StreamingResamplePoly(2, 3)
    >>> state = sr.init_state(device='cpu')
    >>> outs = []
    >>> for k in range(4):   # 2 data chunks + 2 zero flush chunks
    ...     chunk = x[300 * k:300 * (k + 1)] if k < 2 else torch.zeros(300)
    ...     state, y = sr.process(state, chunk)
    ...     outs.append(y)
    >>> y = torch.cat(outs)[sr.lead_out:]
    >>> ref = resample_poly(x, 2, 3)
    >>> bool((y[:ref.shape[0]] - ref).abs().max() < 1e-5)
    True
    """

    up: int
    down: int
    window: tuple = ("kaiser", 5.0)
    taps: object = None

    def __post_init__(self):
        if self.up < 1 or self.down < 1:
            raise ValueError(
                f"up and down must be >= 1, got: up={self.up}, "
                f"down={self.down}")
        if int(self.up) == int(self.down):
            object.__setattr__(self, "_identity", True)
            object.__setattr__(self, "_z", 0)
            object.__setattr__(self, "_n_z", 0)
            return
        up, down, h, npr = _resample_poly_design(self.up, self.down, self.window, self.taps)
        bank, t_taps = _phase_bank(h, up)
        # Zero lead Z: a multiple of `down` covering the group-delay
        # lookahead (the last output of a chunk reads up to ~npr*down/up
        # samples past the chunk end) with a one-period safety margin for
        # the floor jitter.
        z0 = (npr * down) // up + down + up
        z = -(-z0 // down) * down
        for name, value in (("_identity", False), ("_up", up), ("_down", down),
                            ("_bank", torch.from_numpy(bank)), ("_t_taps", t_taps),
                            ("_npr", npr), ("_z", z), ("_n_z", z * up // down)):
            object.__setattr__(self, name, value)

    @property
    def lead_out(self) -> int:
        """Warm-up output samples to drop for batch alignment."""
        return self._n_z

    def init_state(self, batch_shape=(), dtype=DEFAULT_FLOAT, device=None):
        carry = 0 if self._identity else self._t_taps - 1 + self._z
        return _zeros((*batch_shape, carry), dtype, device)

    def process(self, state, chunk):
        chunk = _float_cast(as_signal(chunk))
        if self._identity:
            return state, chunk
        up, down = self._up, self._down
        if chunk.shape[-1] % down != 0 or chunk.shape[-1] < down:
            raise ValueError(
                f"chunk length ({chunk.shape[-1]}) must be a non-zero "
                f"multiple of the reduced down factor ({down}) so output "
                "counts stay static"
            )
        n_c = chunk.shape[-1] * up // down
        dtype = _upfirdn_dtype(self._bank, chunk)
        state = _state_on(state, chunk.device)
        ext = torch.cat([state.to(dtype), chunk.to(dtype)], dim=-1)

        def plan():
            w, geometry = _phase_plan(self._bank.to(dtype).numpy(), up, down,
                                      n_offset=self._npr, n_count=n_c)
            return torch.as_tensor(w, device=ext.device), geometry

        w, geometry = _kept(self, (ext.device, dtype, n_c), plan)
        out = _phase_outputs(ext, w, geometry, n_c)
        new_state = ext[..., -(self._t_taps - 1 + self._z):]
        return new_state, out


@dataclass(frozen=True)
class StreamingIIR:
    """Causal IIR filtering of an unbounded stream as cascaded second-order
    sections: chunk outputs equal sosfilt over the concatenated stream (the
    DF2T state is an exact stream summary; the chunked form associates
    sums differently, so equality is to f.p. accuracy rather than
    bitwise). The carry is the (n_sections, ..., 2) sosfilt state. The
    result dtype is the chunk's promoted with a tensor `sos`'s, as
    `ops.iir.sosfilt` does.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.parallel.streaming import StreamingIIR
    >>> siir = StreamingIIR(torch.tensor([[0.2, 0.2, 0.0, 1.0, -0.6, 0.0]]))
    >>> state = siir.init_state(device='cpu')
    >>> state, o1 = siir.process(state, torch.ones(4))
    >>> o1   # == sosfilt over the whole stream
    tensor([0.2000, 0.5200, 0.7120, 0.8272])
    """

    sos: object

    def __post_init__(self):
        object.__setattr__(self, "_sos", _sos_host(self.sos))

    def init_state(self, batch_shape=(), dtype=DEFAULT_FLOAT, device=None):
        return _zeros((self._sos.shape[0], *batch_shape, 2), dtype, device)

    def process(self, state, chunk):
        chunk = _float_cast(as_signal(chunk))
        state = _state_on(state, chunk.device)
        out = chunk.to(_work_dtype(chunk, self.sos))
        new_states = []
        for s in range(self._sos.shape[0]):
            out, zf = _lfilter_last_axis(self._sos[s, :3], self._sos[s, 3:], out,
                                         state[s].to(chunk.dtype))
            new_states.append(zf)
        return torch.stack(new_states, dim=0), out
