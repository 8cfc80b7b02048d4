"""Plain reference of Whisper's log-mel front end, in float64 PyTorch:
openai/whisper `audio.py:log_mel_spectrogram` for a batch of clips, with
the floor taken per clip as Hugging Face's `WhisperFeatureExtractor` takes
it for a batch. It imports nothing of the program and takes only the
inputs that the benchmark made.

Per clip: `torch.stft(x, n_fft, hop, window=torch.hann_window(n_fft),
center=True, pad_mode='reflect')`, |z|^2 with the last frame dropped, the
Slaney filterbank (librosa's `filters.mel(sr, n_fft, n_mels)` with its
defaults: fmin 0, fmax sr / 2, Slaney scale and norm, written out below)
times the power, log10 of it clipped at 1e-10, the floor max - 8 over the
clip's mels and frames, then (x + 4)/4. Departures from Whisper's code:
the filterbank is computed in f64 and kept in f64 rather than read from
its f32 `mel_filters.npz`, and the whole computation is f64.

Its control (`control_log_mel`) is the same computation in float32 with
the mel product in TF32 (the power and the filterbank rounded to TF32's
10-bit mantissa, products and sums in float32), emulated so that it reads
the same on a CPU as on a card: the program's product is an exact float32
one with TF32 off, and this is the step below it.

`errors` compares a log-mel spectrogram with this one. A log-mel value is
as well conditioned as its mel energy is large: an FFT's rounding is
relative to the whole frame, so a band whose energy is a small part of its
clip's loudest reads a relative error, and a log error, as much larger as
its energy is smaller (in white noise the smallest of a few million
one-bin bands lies ~7 decades below the mean, and float32 then reads
~1e-4 in the log, as much as TF32 does in a loud band). So each element's
error is weighed by its conditioning: 1 where the reference's mel energy
is within CONDITIONED_DECADES of its clip's largest, or FLOOR_MARGIN
decades or more below the floor (there both sides read the floor, set by
the clip's largest alone), and the energy over 10^-CONDITIONED_DECADES of
the clip's largest in between.
"""

import contextlib
import math

import torch

ROWS = 32                      # clips a block: 32 x 3001 x 201 complex128 take ~0.3 GB
CLAMP = 1e-10
DYNAMIC_RANGE = 8.0            # decades kept below each clip's largest
CONDITIONED_DECADES = 3.0
FLOOR_MARGIN = 0.3


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def tf32(t):
    """float32 `t` rounded to TF32's 10-bit mantissa (to nearest, ties away)."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def hz_to_mel(hz: float) -> float:
    """librosa.hz_to_mel(hz, htk=False): linear below 1 kHz, logarithmic above."""
    f_sp, min_log_hz = 200.0 / 3.0, 1000.0
    if hz < min_log_hz:
        return hz / f_sp
    return min_log_hz / f_sp + math.log(hz / min_log_hz) / (math.log(6.4) / 27.0)


def mel_to_hz(mels):
    """librosa.mel_to_hz(mels, htk=False) of an f64 tensor."""
    f_sp, min_log_hz = 200.0 / 3.0, 1000.0
    min_log_mel = min_log_hz / f_sp
    return torch.where(mels >= min_log_mel,
                       min_log_hz * torch.exp(math.log(6.4) / 27.0 * (mels - min_log_mel)),
                       f_sp * mels)


def filterbank(n_mels: int, sampling_rate: float, n_fft: int, device=None):
    """librosa.filters.mel(sr=sampling_rate, n_fft=n_fft, n_mels=n_mels), f64
    (n_mels, n_fft // 2 + 1): triangles between n_mels + 2 points evenly
    spaced in Slaney mels from 0 to sampling_rate / 2, each scaled by 2 /
    its width in Hz."""
    freqs = torch.linspace(0.0, sampling_rate / 2.0, n_fft // 2 + 1, dtype=torch.float64,
                           device=device)
    mel_f = mel_to_hz(torch.linspace(0.0, hz_to_mel(sampling_rate / 2.0), n_mels + 2,
                                     dtype=torch.float64, device=device))
    fdiff = mel_f[1:] - mel_f[:-1]
    ramps = mel_f[:, None] - freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = torch.clamp(torch.minimum(lower, upper), min=0.0)
    return weights * (2.0 / (mel_f[2:] - mel_f[:-2]))[:, None]


def _mel_energy(x, filters, n_fft: int, hop: int, dtype):
    """(clips, mels, frames - 1) mel energy of the (clips, L) signal, in `dtype`."""
    z = torch.stft(x.to(dtype), n_fft, hop, window=torch.hann_window(n_fft, dtype=dtype,
                                                                     device=x.device),
                   center=True, pad_mode="reflect", return_complex=True)
    return filters.to(dtype) @ (z[..., :-1].abs() ** 2)


def _normalise(mel):
    log_spec = torch.clamp(mel, min=CLAMP).log10()
    top = log_spec.amax(dim=(-2, -1), keepdim=True)
    return (torch.maximum(log_spec, top - DYNAMIC_RANGE) + 4.0) / 4.0, log_spec, top


def log_mel(x, n_mels: int, sampling_rate: float, n_fft: int, hop: int):
    """(clips, n_mels, L // hop) f64 log-mel of the (clips, L) signal, ROWS
    clips at a time."""
    filters = filterbank(n_mels, sampling_rate, n_fft, device=x.device)
    with no_tf32():
        return torch.cat([_normalise(_mel_energy(x[r:r + ROWS], filters, n_fft, hop,
                                                 torch.float64))[0]
                          for r in range(0, x.shape[0], ROWS)])


def weighted_errors(m, m_ref, log_ref, top):
    """Each element's |m - m_ref| weighed by its conditioning (the module's
    docstring): `log_ref` is the reference's clipped log10 mel energy and
    `top` its clip's largest."""
    below = log_ref - top                          # <= 0, decades below the clip's largest
    weight = torch.where(below >= -CONDITIONED_DECADES, 1.0,
                         torch.pow(10.0, below + CONDITIONED_DECADES))
    weight = torch.where(below <= -(DYNAMIC_RANGE + FLOOR_MARGIN), 1.0, weight)
    return (m.double() - m_ref).abs() * weight


def errors(m, x, n_mels: int, sampling_rate: float, n_fft: int, hop: int) -> float:
    """The largest weighed error of the log-mel `m` of the (clips, L) float32
    signal `x` against the reference's: inf for a wrong shape, NaN where
    `m` holds a NaN."""
    want = (x.shape[0], n_mels, x.shape[-1] // hop)
    if tuple(m.shape) != want:
        return math.inf
    filters = filterbank(n_mels, sampling_rate, n_fft, device=x.device)
    worst = 0.0
    with no_tf32():
        for r in range(0, x.shape[0], ROWS):
            m_ref, log_ref, top = _normalise(_mel_energy(x[r:r + ROWS], filters, n_fft, hop,
                                                         torch.float64))
            err = weighted_errors(m[r:r + ROWS], m_ref, log_ref, top)
            if bool(torch.isnan(err).any()):
                return math.nan
            worst = max(worst, float(err.max()))
    return worst


def control_log_mel(x, n_mels: int, sampling_rate: float, n_fft: int, hop: int):
    """(clips, n_mels, L // hop) log-mel in float32 with the mel product in
    TF32, ROWS clips at a time."""
    filters = tf32(filterbank(n_mels, sampling_rate, n_fft, device=x.device))
    with no_tf32():
        out = []
        for r in range(0, x.shape[0], ROWS):
            z = torch.stft(x[r:r + ROWS], n_fft, hop,
                           window=torch.hann_window(n_fft, device=x.device), center=True,
                           pad_mode="reflect", return_complex=True)
            out.append(_normalise(filters @ tf32(z[..., :-1].abs() ** 2))[0])
    return torch.cat(out)
