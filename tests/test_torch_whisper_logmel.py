"""WhisperLogMel (models/pipeline.py), Whisper's log-mel front end, against
the float64 reference of the benchmark (portbench/references/logmel.py:
openai/whisper's `log_mel_spectrogram` with librosa's Slaney filterbank
written out, the floor per clip), on the CPU at 3 clips x 2 s at 16 kHz: a
loud clip, one 40 dB below it, and one whose second half is zeros (the
zero padding to a chunk), at 80 and 128 mels.

Tolerance: 1e-5 on the normalised log-mel values, each error weighed by
how well its reference value is conditioned (`references/logmel.py:errors`):
float32 reads 6.8e-7 here, the power rounded to TF32 5.2-5.3e-5, 3016.0
for the top mel edge 6.7e-3 (80 mels) and 8.9e-2 (128), a floor taken over
the batch 0.23.
"""

import numpy as np
import pytest
import torch

import nx_signal_tpu_torch.models.pipeline as pipeline
from nx_signal_tpu_torch.models.pipeline import WhisperLogMel
from nx_signal_tpu_torch.spectral.mel import _log_mel, _slaney_max_mel, mel_filters
from portbench.references import logmel as ref

RATE, N_FFT, HOP, SAMPLES = 16000.0, 400, 160, 32000
TOL = 1e-5
MELS = [80, 128]


def _clips():
    rng = np.random.default_rng(20240)
    x = rng.normal(size=(3, SAMPLES))
    x[1] *= 0.01                    # 40 dB below the first
    x[2] *= 0.3
    x[2, SAMPLES // 2:] = 0.0       # zero-padded to the chunk
    return torch.from_numpy(x.astype(np.float32))


X = _clips()


def _err(m, x, n_mels):
    return ref.errors(m, x, n_mels, RATE, N_FFT, HOP)


@pytest.fixture(scope="module", params=MELS)
def frontend(request):
    return WhisperLogMel(request.param, device="cpu")


def test_matches_whispers_log_mel(frontend):
    n_mels = frontend.filters.shape[0]
    assert _err(frontend(X), X, n_mels) <= TOL


def test_shape_is_clips_mels_frames_less_the_last(frontend):
    n_mels = frontend.filters.shape[0]
    m = frontend(X)
    assert m.shape == (3, n_mels, SAMPLES // HOP) and m.is_contiguous()
    assert m.dtype == torch.float32
    one = frontend(X[0])
    assert one.shape == (n_mels, SAMPLES // HOP) and one.is_contiguous()
    # a (2, 3, L) batch keeps its leading axes
    assert frontend(torch.stack([X, X])).shape == (2, 3, n_mels, SAMPLES // HOP)


def test_each_clip_alone_equals_its_row_in_the_batch(frontend):
    # to the tolerance: a batch of one is summed in another order, and the
    # quietest bands magnify that (1.1e-6 at 3 decades below the peak)
    batch = frontend(X)
    for c in range(X.shape[0]):
        torch.testing.assert_close(frontend(X[c]), batch[c], rtol=0, atol=TOL)


def test_a_batch_wide_floor_breaks_the_batch_invariance(frontend, monkeypatch):
    # the same module with the floor taken over the whole batch, as
    # LogMelFrontend takes it: the quieter clips' floors rise
    monkeypatch.setattr(pipeline, "_log_mel", lambda power, filters, freq_size, **_: _log_mel(
        power, filters, freq_size).transpose(-1, -2).contiguous())
    batch = frontend(X)
    assert float((frontend(X[2]) - batch[2]).abs().max()) > 0.1
    assert _err(batch, X, frontend.filters.shape[0]) > 100 * TOL


@pytest.mark.parametrize("n_mels", MELS)
def test_the_filterbank_is_librosas_to_half_the_rate(n_mels):
    want = ref.filterbank(n_mels, RATE, N_FFT)
    got = WhisperLogMel(n_mels, device="cpu").filters
    assert got.dtype == torch.float32 and got.shape == (n_mels, N_FFT // 2 + 1)
    scale = float(want.abs().max())
    assert float((got.double() - want).abs().max()) <= 1e-7 * scale
    # NxSignal's rounded top edge, 3016.0, is off by far more
    edge = mel_filters(N_FFT, n_mels, RATE, max_mel=3016.0, dtype=torch.float64,
                       device="cpu")[:, :N_FFT // 2 + 1]
    assert float((edge - want).abs().max()) > 1e-3 * scale
    assert _slaney_max_mel(RATE / 2) == pytest.approx(ref.hz_to_mel(RATE / 2) * 200.0 / 3.0,
                                                      rel=1e-15)


@pytest.mark.parametrize("n_mels", MELS)
def test_the_3016_edge_fails_the_tolerance(n_mels, monkeypatch):
    monkeypatch.setattr(pipeline, "mel_filters",
                        lambda *a, **k: mel_filters(*a, **{**k, "max_mel": 3016.0}))
    assert _err(WhisperLogMel(n_mels, device="cpu")(X), X, n_mels) > 100 * TOL


def test_the_power_rounded_to_tf32_fails_the_tolerance(frontend):
    n_mels = frontend.filters.shape[0]
    z = torch.stft(X, N_FFT, HOP, window=frontend.window, center=True, pad_mode="reflect",
                   return_complex=True).transpose(-1, -2)
    power = z[..., :-1, :].abs() ** 2
    exact = _log_mel(power, frontend.filters, N_FFT // 2 + 1, clips=True)
    rounded = _log_mel(ref.tf32(power), frontend.filters, N_FFT // 2 + 1, clips=True)
    assert _err(exact, X, n_mels) <= TOL < _err(rounded, X, n_mels)


def test_a_wrong_shape_or_a_nan_is_not_correct(frontend):
    n_mels = frontend.filters.shape[0]
    m = frontend(X)
    assert _err(m[..., :-1], X, n_mels) == float("inf")
    m[1, 3, 7] = float("nan")
    assert np.isnan(_err(m, X, n_mels))


def test_the_floor_is_eight_decades_below_each_clips_peak(frontend):
    m = frontend(X)
    top, low = m.amax(dim=(-2, -1)), m.amin(dim=(-2, -1))
    assert bool((low >= top - 2.0 - 1e-6).all())                # (8 / 4) below
    assert float(low[2]) == pytest.approx(float(top[2]) - 2.0, abs=1e-6)   # the zero tail
    # the quiet clip's peak sits 4 decades (1.0 normalised) below the loud one's
    assert float(top[0] - top[1]) == pytest.approx(1.0, abs=0.05)


def test_the_weights_are_built_once_in_their_span():
    with torch.profiler.profile() as prof:
        frontend = WhisperLogMel(80, device="cpu")
        frontend(X[:1])
    names = [e.name for e in prof.events()]
    assert names.count("nx.weights.mel") == 1
    assert names.count("nx.logmel") == 1 and names.count("nx.mel") == 1
    assert names.count("nx.stft") == 1
