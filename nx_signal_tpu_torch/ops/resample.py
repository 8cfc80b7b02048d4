"""Polyphase resampling and filterbanks (counterpart of
nx_signal_tpu/ops/resample.py): scipy.signal.upfirdn / resample_poly /
resample / decimate semantics, and the polyphase analysis filterbank (DFT
channelizer).

No zero-stuffing is ever done. `upfirdn` is one polyphase correlation:
output n reads phase filter (n*down) mod up over the input ending at
(n*down) div up, evaluated as one `kernels.dft.blocked_frame_matmul`
against a banded weight, over a tile of R consecutive outputs per frame
row. The filterbank is a
framed DFT with the phase wrapped mod n_channels: one banded contraction
('matmul'), or the polyphase sum then one DFT matmul ('factored').

Every product is exact f32 on the card (TF32 off, `kernels/dft.py:
_exact_f32`), complex matmuls included. A signal goes through
`utils.devices.as_signal`; filter taps are host constants.
"""

import functools
import math
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from nx_signal_tpu_torch.kernels.dft import (
    _check_precision,
    _dft_weights,
    _exact_f32,
    blocked_frame_matmul,
)
from nx_signal_tpu_torch.ops.filters import firwin
from nx_signal_tpu_torch.spectral.framing import as_windowed
from nx_signal_tpu_torch.utils.devices import as_signal
from nx_signal_tpu_torch.utils.dtypes import DEFAULT_FLOAT

__all__ = ["upfirdn", "resample_poly", "pfb_analyze",
           "pfb_footprint_bytes", "resample", "decimate"]

# The polyphase geometry, the JAX package's: a tile of about _TILE_OUTPUTS
# outputs per frame row (a multiple of `up`), down to R = up when the
# banded weight would pass _TILE_MAX_WEIGHTS elements. The strategy is the
# H100's: 'materialize' (frames, one GEMM) up to _MATERIALIZE_MAX_BLOCKS
# hop blocks per frame, where it beat the banded 'conv'; 'conv' past it,
# as fast there without C copies of the signal
# (scripts/torch_resample_variants.py; PERF.md section 6).
_TILE_OUTPUTS = 128
_TILE_MAX_WEIGHTS = 1 << 22
_MATERIALIZE_MAX_BLOCKS = 8


def _upfirdn_out_len(n_in: int, k: int, up: int, down: int) -> int:
    return -(-((n_in - 1) * up + k) // down)


def _phase_bank(h, up: int):
    """Phase filter bank H[p, t] = h[p + t*up], reversed in t so a plain
    frame-window dot computes the correlation sum, as a host numpy array of
    h's dtype. Returns (bank (up, T), T)."""
    h = h.detach().cpu().numpy()
    k = h.shape[0]
    num_phases = -(-k // up)  # taps per phase (T)
    h_pad = np.pad(h, (0, num_phases * up - k))
    return np.ascontiguousarray(h_pad.reshape(num_phases, up).T[:, ::-1]), num_phases


def _upfirdn_dtype(h, x):
    """The promoted dtype of taps and signal; integers become float32."""
    dtype = torch.promote_types(h.dtype, x.dtype)
    if not (dtype.is_floating_point or dtype.is_complex):
        dtype = DEFAULT_FLOAT
    return dtype


def _upfirdn_phase_outputs(ext, bank, up: int, down: int, *, n_offset: int, n_count: int):
    """Outputs n = n_offset .. n_offset+n_count-1 of the upfirdn correlation
    out[n] = sum_t H[p_n, t] * x[q_n - t], p_n = (n*down) % up,
    q_n = (n*down)//up, from an already-extended signal `ext` whose index
    convention is ext[q + T - 1] = x[q] (the caller prepends the T-1
    samples of left context: zeros at the stream edge, halo samples in a
    sharded block). `bank` is the host (up, T) phase bank of `_phase_bank`.

    This core serves the single-device `upfirdn` (n_offset=0) and the
    per-rank body of parallel.sharded.sharded_upfirdn /
    sharded_resample_poly (n_offset = the global output offset, the same on
    every rank because out_block*down == block_in*up keeps the phase
    pattern rank-periodic).

    Evaluation: one `blocked_frame_matmul` for a tile of R consecutive
    outputs per frame row (R a multiple of `up` near _TILE_OUTPUTS, not
    the minimal R = up). Column r of the banded weight matrix holds phase
    filter p_r at row offset o_r - o_min (o_r = the output's window start),
    and the frame stride is (R//up)*down. R falls back to `up` where the
    banded weight would pass _TILE_MAX_WEIGHTS elements (a very large
    `down`). A frame of at most _MATERIALIZE_MAX_BLOCKS hop blocks, and
    any complex signal or taps, takes 'materialize' (the frames, then one
    GEMM); a longer one the banded 'conv', which builds no frames."""
    w, geometry = _phase_plan(bank, up, down, n_offset=n_offset, n_count=n_count)
    return _phase_outputs(ext, torch.as_tensor(w, device=ext.device), geometry, n_count)


def _phase_plan(bank, up: int, down: int, *, n_offset: int, n_count: int):
    """The host banded weight (window_length, R) of `_upfirdn_phase_outputs`
    and its frame geometry (o_min, window_length, stride, num_frames): a
    stream whose chunks all have n_count outputs plans once."""
    t_taps = bank.shape[1]
    r_tile = -(-_TILE_OUTPUTS // up) * up
    est_window = t_taps + (r_tile // up) * down
    if r_tile > up and est_window * r_tile > _TILE_MAX_WEIGHTS:
        r_tile = up
    n_classes = min(r_tile, n_count)
    offsets = [((n_offset + r) * down) // up for r in range(n_classes)]
    phases = [((n_offset + r) * down) % up for r in range(n_classes)]
    o_min = min(offsets)
    window_length = t_taps + max(offsets) - o_min
    num_frames = (n_count - 1) // n_classes + 1
    if n_classes % up == 0:
        stride = (n_classes // up) * down
    else:
        # partial tile (n_classes == n_count, not a multiple of up):
        # num_frames == 1, so the stride only sizes the single frame
        stride = down
    w = np.zeros((window_length, n_classes), dtype=bank.dtype)
    for r in range(n_classes):
        s = offsets[r] - o_min
        w[s:s + t_taps, r] = bank[phases[r]]
    return w, (o_min, window_length, stride, num_frames)


def _phase_outputs(ext, w, geometry, n_count: int):
    """`_upfirdn_phase_outputs` with the plan of `_phase_plan`, its weight
    `w` already on ext's device."""
    o_min, window_length, stride, num_frames = geometry
    batch, n_classes = ext.shape[:-1], w.shape[1]
    c_blocks = -(-window_length // stride)
    strategy = ("materialize" if c_blocks <= _MATERIALIZE_MAX_BLOCKS or ext.is_complex()
                or w.is_complex() else "conv")
    out = blocked_frame_matmul(ext[..., o_min:], w, window_length=window_length,
                               stride=stride, num_frames=num_frames, strategy=strategy)
    # (..., J, n_classes): cell (j, r) is output j*n_classes + r
    if n_classes == 1:
        return out[..., :n_count, 0]
    return out.reshape(*batch, num_frames * n_classes)[..., :n_count]


def upfirdn(h, x, up: int = 1, down: int = 1):
    """Upsample by `up` (conceptually zero-stuffing), FIR filter with `h`,
    downsample by `down`: scipy.signal.upfirdn semantics over the last axis
    of `x` (leading axes are batch).

    Polyphase evaluation: out[n] = sum_t H[p_n, t] * x[q_n - t] with
    p_n = (n*down) % up, q_n = (n*down) // up, H[p, t] = h[p + t*up]
    (`_upfirdn_phase_outputs`); no stuffed zeros are ever built or
    multiplied. The result has the promoted dtype of h and x (integers
    become float32).

    Examples:

    2x zero-stuffed upsampling through a length-3 boxcar:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.resample import upfirdn
    >>> upfirdn(torch.tensor([1.0, 1.0, 1.0]), torch.tensor([1.0, 2.0, 3.0]), up=2, down=1)
    tensor([1., 1., 3., 2., 5., 3., 3.])
    """
    x = as_signal(x)
    h = torch.as_tensor(h)
    if h.ndim != 1:
        raise ValueError(f"h must be 1-D, got rank {h.ndim}")
    if up < 1 or down < 1:
        raise ValueError(f"up and down must be >= 1, got: up={up}, down={down}")
    k = h.shape[0]
    n_in = x.shape[-1]
    n_out = _upfirdn_out_len(n_in, k, up, down)

    dtype = _upfirdn_dtype(h, x)
    bank, t_taps = _phase_bank(h.to(dtype), up)
    x = x.to(dtype)

    # Left-pad T-1 zeros (ext[q + T - 1] = x[q]) plus whatever right zeros
    # the final windows read past the signal end.
    q_max = ((n_out - 1) * down) // up
    pad_right = max(0, q_max + 1 - n_in)
    ext = F.pad(x, (t_taps - 1, pad_right))
    return _upfirdn_phase_outputs(ext, bank, up, down, n_offset=0, n_count=n_out)


def _resample_poly_design(up: int, down: int, window, taps):
    """Shared resample_poly setup: gcd-reduce the ratio, design (or accept)
    the odd-length anti-alias prototype, apply scipy's group-delay
    pre-padding. Returns (up, down, h_padded, n_pre_remove); h_padded is a
    host tensor."""
    if up < 1 or down < 1:
        raise ValueError(f"up and down must be >= 1, got: up={up}, down={down}")
    g = math.gcd(int(up), int(down))
    up, down = int(up) // g, int(down) // g
    if taps is None:
        max_rate = max(up, down)
        half_len = 10 * max_rate
        h = firwin(2 * half_len + 1, [1.0 / max_rate], window=window, device="cpu")
    else:
        h = torch.as_tensor(taps).detach().cpu()
        if h.shape[0] % 2 != 1:
            raise ValueError("resample_poly prototype filter must have odd length")
        half_len = (h.shape[0] - 1) // 2
    h = h * up
    # Zero-pad the filter front so its group delay lands on an output-grid
    # sample, then drop the delay (scipy's alignment).
    n_pre_pad = (down - half_len % down) % down
    h = torch.cat([torch.zeros(n_pre_pad, dtype=h.dtype), h])
    n_pre_remove = (half_len + n_pre_pad) // down
    return up, down, h, n_pre_remove


def resample_poly(x, up: int, down: int, *, window=("kaiser", 5.0), taps=None):
    """Rational-rate polyphase resampling, scipy.signal.resample_poly
    semantics over the last axis: gcd-reduce up/down, design an anti-alias
    FIR (Kaiser 5.0 by default, 10*max(up, down) half-length) scaled by
    `up`, apply it through `upfirdn`, and slice the centred n_in*up/down
    samples. Pass `taps` to use a custom (odd-length) prototype instead.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.resample import resample_poly
    >>> resample_poly(torch.tensor([0.0, 1.0, 2.0, 3.0]), 2, 1).numpy().round(4)
    array([0.    , 0.5614, 1.0005, 1.2946, 2.001 , 2.9651, 3.0016, 1.6071],
          dtype=float32)
    """
    x = as_signal(x)
    if up < 1 or down < 1:
        raise ValueError(f"up and down must be >= 1, got: up={up}, down={down}")
    if int(up) == int(down):
        return x
    up, down, h, n_pre_remove = _resample_poly_design(up, down, window, taps)
    n_in = x.shape[-1]
    n_out = -(-n_in * up // down)

    y = upfirdn(h, x, up, down)
    return y[..., n_pre_remove:n_pre_remove + n_out]


def pfb_analyze(x, n_channels: int, *, taps_per_channel: int = 8, window=("kaiser", 5.0),
                taps=None, shift: bool = False, strategy: str = "auto",
                precision="highest"):
    """Critically-sampled polyphase analysis filterbank (DFT channelizer),
    the wideband-SDR front end.

    Splits the last axis of `x` into `n_channels` equal sub-bands, each
    decimated by n_channels: frames of n_channels*taps_per_channel samples
    at stride n_channels, weighted by the polyphase decomposition of the
    prototype low-pass, summed over taps, then a DFT across the channel
    axis. Returns (..., frames, channels) complex.

    The prototype defaults to firwin(n_channels*taps_per_channel,
    1/n_channels, kaiser 5.0); pass `taps` to override. `shift=True` applies
    fftshift over the channel axis (centre-DC ordering).

    Strategies (the same function; the PFB is a framed DFT with the phase
    e^(-2i*pi*k*n/m) wrapped mod m):

    * 'matmul' (real input): one `blocked_frame_matmul` ('conv') against
      W[n, k] = proto[n] * e^(-2i*pi*k*n/m), shape (m*tpc, 2*m) [Re | Im].
    * 'factored' (real input): the tpc-tap polyphase sum over the
      (blocks, m) view as one depthwise conv1d, then one (rows, m) @
      (m, 2m) DFT matmul over the flattened leading axes: tpc-fold fewer
      operations than 'matmul'.
    * 'einsum': frames, a weighted sum and `torch.fft.fft`; complex input
      and the oracle.
    * 'auto': 'einsum' for complex or float64 input, 'factored' for real
      input with m >= 64, else 'matmul'.

    'matmul' and 'factored' compute in float32; asked for explicitly on
    float64 input they downcast and warn. `precision` is validated and
    every product is exact f32 whatever it says.

    Examples:

    An 8-band filterbank on one 4096-sample stream yields (1, frames, 8):

    >>> import numpy as np, torch
    >>> from nx_signal_tpu_torch.ops.resample import pfb_analyze
    >>> x = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 4096)).astype(np.float32))
    >>> pfb_analyze(x, 8, taps_per_channel=4).shape
    torch.Size([1, 509, 8])
    """
    x = as_signal(x)
    _check_precision(precision)
    m = n_channels
    proto = _pfb_proto(m, taps_per_channel, window, taps)
    taps_per_channel = proto.shape[0] // m
    dtype, strategy = _pfb_route(x.dtype, proto.dtype, m, strategy)
    x = x.to(dtype)
    window_length = m * taps_per_channel
    if x.shape[-1] < window_length:
        raise ValueError(
            f"signal length {x.shape[-1]} is shorter than the prototype "
            f"({window_length} taps)")
    weights = _pfb_weights(proto, m, strategy, dtype, x.device)
    return _pfb_channels(x, weights, m, strategy, precision, shift)


def _pfb_proto(m: int, taps_per_channel: int, window, taps):
    """The host prototype of `pfb_analyze`: the designed default or the
    given `taps`, whose length must be a multiple of m."""
    if taps is None:
        return _pfb_prototype(m, taps_per_channel,
                              tuple(window) if isinstance(window, list) else window)
    proto = torch.as_tensor(taps).detach().cpu()
    if proto.shape[0] % m != 0:
        raise ValueError(
            f"prototype length ({proto.shape[0]}) must be a multiple of "
            f"n_channels ({m})")
    return proto


def _pfb_route(x_dtype, proto_dtype, m: int, strategy: str):
    """The compute dtype and the strategy 'auto' resolves to, checked (and
    a warning where f32 weights meet float64 input)."""
    dtype = torch.promote_types(x_dtype, proto_dtype)
    if not (dtype.is_floating_point or dtype.is_complex):
        dtype = DEFAULT_FLOAT
    complex_in = dtype.is_complex

    if strategy not in ("auto", "matmul", "factored", "einsum"):
        raise ValueError("strategy must be 'auto', 'matmul', 'factored' or "
                         f"'einsum', got {strategy!r}")
    if strategy == "auto":
        if complex_in or dtype == torch.float64:
            strategy = "einsum"  # keeps the promoted dtype
        elif m >= 64:
            strategy = "factored"
        else:
            strategy = "matmul"
    if strategy in ("matmul", "factored") and complex_in:
        raise ValueError(
            f"strategy={strategy!r} requires real input (the stacked-real "
            "weight layout); use 'einsum' for complex signals")
    if strategy in ("matmul", "factored") and dtype == torch.float64:
        warnings.warn(
            f"pfb_analyze strategy={strategy!r} computes in float32 "
            "(stacked-real weights); float64 input is downcast. Use "
            "strategy='einsum' (or 'auto') to keep f64 accuracy.",
            UserWarning, stacklevel=3)
    return dtype, strategy


def _pfb_weights(proto, m: int, strategy: str, dtype, device):
    """The weights of `strategy` on `device`, from the host prototype:
    'matmul' the (m*tpc, 2m) f32 [Re | Im] band of `_pfb_matmul`, else the
    (tpc, m) polyphase prototype (f32 for 'factored', `dtype` for
    'einsum'). A stream applies the same weights to every chunk."""
    if strategy == "matmul":
        proto_np = proto.numpy().astype(np.float64)
        return torch.as_tensor(
            _dft_weights(proto_np, proto.shape[0], m, False, np.float64).astype(np.float32),
            device=device)
    w = proto.reshape(-1, m)
    return w.to(dtype=DEFAULT_FLOAT if strategy == "factored" else dtype, device=device)


def _pfb_channels(x, weights, m: int, strategy: str, precision, shift: bool):
    """`pfb_analyze` of `x` (already of the compute dtype) with the device
    weights of `_pfb_weights`."""
    if strategy == "matmul":
        channels = _pfb_matmul(x, weights, m, weights.shape[0], precision)
    elif strategy == "factored":
        channels = _pfb_factored(x, weights, m, weights.shape[0])
    else:
        taps_per_channel = weights.shape[0]
        frames = as_windowed(x, window_length=m * taps_per_channel, stride=m)
        blocks = frames.reshape(*frames.shape[:-1], taps_per_channel, m)
        # y[t, c] = sum_j w[j, c] * x[t*m + j*m + c]  (filter-and-decimate)
        with _exact_f32():
            summed = torch.einsum("...jc,jc->...c", blocks, weights)
        channels = torch.fft.fft(summed, dim=-1)
    if shift:
        channels = torch.fft.fftshift(channels, dim=-1)
    return channels


@functools.cache
def _pfb_prototype(m: int, taps_per_channel: int, window):
    """The default prototype firwin(m*tpc, 1/m, window), a host float32
    tensor designed once per band count, taps and window rather than on
    every call (8192 taps at 1024 bands)."""
    return firwin(m * taps_per_channel, [1.0 / m], window=window, device="cpu")


def pfb_footprint_bytes(strategy: str, batch_elems: int, length: int,
                        n_channels: int, taps_per_channel: int) -> int:
    """Modelled peak device bytes of one `pfb_analyze` call (f32/c64
    buffers), in units of the input size S = 4 * batch * length bytes:

    'einsum'   (2 + tpc + 1 + 2 + 2) S - input, a padded copy, the
               (frames, m*tpc) expansion, the sum and the complex output;
    'matmul'   (2 + 2 + 2) S - input, a padded copy, the (frames, 2m)
               stacked Re|Im accumulator and the complex output;
    'factored' (2 + 1 + 2 + 2) S - input, the polyphase sum, the
               accumulator and the complex output.

    The same integers as the JAX package's model; `chip_smoke.py` phase 11
    prints it beside the peak the card measures.

    Examples:

    >>> from nx_signal_tpu_torch.ops.resample import pfb_footprint_bytes
    >>> s = 4 * 8 * 4_194_304
    >>> pfb_footprint_bytes('factored', 8, 4_194_304, 1024, 8) // s
    7
    """
    s = 4 * batch_elems * length
    mults = {"einsum": 2 + taps_per_channel + 5, "matmul": 6, "factored": 7}
    if strategy not in mults:
        raise ValueError("strategy must be 'matmul', 'factored' or "
                         f"'einsum', got {strategy!r}")
    return mults[strategy] * s


def _pfb_matmul(x, weights, m, window_length, precision):
    """PFB as one banded framed-DFT contraction: Y[t, k] = frame_t @ W with
    W[n, k] = proto[n] e^(-2i*pi*k*n/m), the f32 weights of `_pfb_weights`
    (built in f64 on the host: the DFT phase wraps mod m exactly as
    `_dft_weights` computes it for n_fft < frame)."""
    num_frames = (x.shape[-1] - window_length) // m + 1
    acc = blocked_frame_matmul(x.to(DEFAULT_FLOAT), weights, window_length=window_length,
                               stride=m, num_frames=num_frames, precision=precision)
    return torch.complex(acc[..., :m], acc[..., m:])


@functools.cache
def _pfb_dft_matrix(m: int, device):
    """The (m, 2m) [Re | Im] DFT matrix of the factored PFB, built in f64
    on the host, cast to f32, once per band count and device."""
    return torch.as_tensor(_dft_weights(np.ones(m), m, m, False, np.float64)
                           .astype(np.float32), device=device)


def _pfb_factored(x, proto, m, taps_per_channel):
    """PFB with the polyphase sum factored out: the taps_per_channel-tap
    weighted sliding sum over the (blocks, m) view (`_polyphase_sum`),
    then one (rows, m) @ (m, 2m) DFT matmul over the flattened leading
    axes (exact f32)."""
    x = x.to(DEFAULT_FLOAT)
    batch = x.shape[:-1]
    nb = x.shape[-1] // m
    u = x[..., :nb * m].reshape(*batch, nb, m)
    w = proto.to(dtype=DEFAULT_FLOAT, device=x.device).reshape(taps_per_channel, m)
    s = _polyphase_sum(u, w)
    lead = s.shape[:-1]
    with _exact_f32():
        acc = torch.matmul(s.reshape(-1, m), _pfb_dft_matrix(m, x.device))
    acc = acc.reshape(*lead, 2 * m)
    return torch.complex(acc[..., :m], acc[..., m:])


def _polyphase_sum(u, w):
    """s[..., t, c] = sum_j w[j, c] * u[..., t + j, c] over the (..., nb, m)
    hop blocks `u` and the (tpc, m) weights `w`: (..., nb - tpc + 1, m), as
    one depthwise conv1d (groups=m; a cross-correlation, as the sum is),
    exact f32. On the H100 it beat tpc shifted multiply-adds at 16 to 1024
    bands (scripts/torch_resample_variants.py; PERF.md section 6)."""
    tpc, m = w.shape
    batch, nb = u.shape[:-2], u.shape[-2]
    u2 = u.reshape(-1, nb, m).transpose(1, 2)                       # (N, m, nb)
    with _exact_f32():
        s = F.conv1d(u2, w.T.contiguous()[:, None, :], groups=m)   # (N, m, F)
    return s.transpose(1, 2).reshape(*batch, nb - tpc + 1, m)


def resample(x, num: int, *, axis: int = -1, window=None):
    """Fourier-method resampling to exactly `num` samples along `axis`,
    scipy.signal.resample semantics: FFT, spectrum truncation or
    zero-padding with the even-length Nyquist bin folded (down) or split
    (up), inverse FFT scaled by num/N. Assumes the signal is periodic (use
    `resample_poly` for streams).

    `window` weights the spectrum before resampling, in one of three
    forms: a spec accepted by `ops.windows.get_window` (its periodic
    window, ifftshifted into fftfreq order), a callable evaluated on
    numpy's fftfreq(N), or a length-N array already in fftfreq order. Real
    input returns real output (through the complex FFT).

    Examples:

    A 4-point sine period resampled to 8 points reproduces the sine:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.resample import resample
    >>> resample(torch.tensor([0.0, 1.0, 0.0, -1.0]), 8).numpy().round(4)
    array([ 0.    ,  0.7071,  1.    ,  0.7071,  0.    , -0.7071, -1.    ,
           -0.7071], dtype=float32)
    """
    from nx_signal_tpu_torch.ops.windows import get_window

    x = as_signal(x)
    axis = axis % x.ndim
    n_in = x.shape[axis]
    if num <= 0:
        raise ValueError(f"num must be positive, got {num}")
    real_input = not x.is_complex()
    xm = torch.movedim(x, axis, -1)
    spec = torch.fft.fft(xm, dim=-1)
    if window is not None:
        part = spec.real.dtype
        if callable(window):
            w = torch.as_tensor(np.asarray(window(np.fft.fftfreq(n_in))), device=x.device)
        elif isinstance(window, (str, tuple, list)):
            w = torch.fft.ifftshift(get_window(window, n_in, periodic=True, dtype=part,
                                               device=x.device))
        else:
            w = torch.as_tensor(window, device=x.device)
        if tuple(w.shape) != (n_in,):
            raise ValueError(f"window must have length {n_in}, got shape {tuple(w.shape)}")
        spec = spec * w
    n = min(num, n_in)
    nyq = n // 2 + 1
    y_spec = torch.zeros(xm.shape[:-1] + (num,), dtype=spec.dtype, device=spec.device)
    y_spec[..., :nyq] = spec[..., :nyq]
    if n > 2:
        y_spec[..., nyq - n:] = spec[..., nyq - n:]
    if n % 2 == 0:
        if num < n_in:
            # downsampling: fold the symmetric -N/2 component into the new
            # Nyquist bin
            y_spec[..., n // 2] += spec[..., n_in - n // 2]
        elif num > n_in:
            # upsampling: split the old Nyquist bin across +/- N/2
            y_spec[..., n // 2] *= 0.5
            y_spec[..., num - n // 2] = y_spec[..., n // 2]
    y = torch.fft.ifft(y_spec, dim=-1) * (num / n_in)
    if real_input:
        y = y.real
    return torch.movedim(y, -1, axis)


def decimate(x, q: int, *, n: int = None, ftype: str = "iir", axis: int = -1,
             zero_phase: bool = True):
    """Downsample by the integer factor `q` after anti-alias filtering,
    scipy.signal.decimate semantics: ftype='iir' is an order-8 Chebyshev-I
    filter (0.05 dB ripple, cutoff 0.8/q) as 'ba', zero-phase through
    `filtfilt` by default, else `lfilter`; 'sos' the same filter as
    biquads through `sosfiltfilt` / `sosfilt` (an extension of the JAX
    package); 'fir' a 20*q+1-tap Hamming `firwin` at 1/q, centred through
    `resample_poly` (zero_phase) or causal through `upfirdn`.

    The 'iir' form runs orders above 2 one f64 step per sample
    (`ops/iir.py`): at long signals prefer 'sos' or 'fir'.

    Examples:

    A ramp decimated 2x (FIR path) stays a ramp away from the edges:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.resample import decimate
    >>> decimate(torch.arange(16.0), 2, ftype="fir").numpy().round(2)
    array([ 0.13,  2.03,  3.93,  6.14,  7.8 , 10.35, 11.46, 15.1 ],
          dtype=float32)
    """
    from nx_signal_tpu_torch.ops.iir import filtfilt, lfilter, sosfilt, sosfiltfilt
    from nx_signal_tpu_torch.ops.iir_design import cheby1

    if q <= 0:
        raise ValueError(f"q must be a positive integer, got {q}")
    x = as_signal(x)
    axis = axis % x.ndim
    if ftype == "iir":
        order = 8 if n is None else int(n)
        b, a = cheby1(order, 0.05, 0.8 / q)
        y = filtfilt(b, a, x, axis=axis) if zero_phase else lfilter(b, a, x, axis=axis)
    elif ftype == "sos":
        order = 8 if n is None else int(n)
        sos = cheby1(order, 0.05, 0.8 / q, output="sos")
        y = sosfiltfilt(sos, x, axis=axis) if zero_phase else sosfilt(sos, x, axis=axis)
    elif ftype == "fir":
        numtaps = (20 * q if n is None else int(n)) + 1
        # host taps: resample_poly and upfirdn lay out their weights on the host
        b = firwin(numtaps, [1.0 / q], window="hamming", device="cpu")
        xm = torch.movedim(x, axis, -1)
        n_out = xm.shape[-1] // q + bool(xm.shape[-1] % q)
        if zero_phase:
            # polyphase with group-delay centring (scipy uses
            # resample_poly(x, 1, q, window=b) here)
            y = resample_poly(xm, 1, q, taps=b)[..., :n_out]
        else:
            y = upfirdn(b, xm, up=1, down=q)[..., :n_out]
        return torch.movedim(y, -1, axis)
    else:
        raise ValueError(f"ftype must be 'iir', 'fir', or 'sos', got {ftype!r}")
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(None, None, q)
    return y[tuple(sl)]
