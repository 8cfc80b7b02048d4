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

On a CUDA spectrum the front end's tail is kernel M (kernels/cuda_mel.py,
csrc/log_mel.cu). Its CPU cases here: the band table rebuilds the
filterbank bit for bit, a CPU spectrum keeps today's route bit for bit, and
the wrapper raises on what it does not take. Its cases marked `cuda` skip
without a card; they import no JAX, and run on an H100 from the repository
root with

    python -m pytest --noconftest -q -m cuda tests/test_torch_whisper_logmel.py
"""

import numpy as np
import pytest
import torch

import nx_signal_tpu_torch.models.pipeline as pipeline
from nx_signal_tpu_torch.kernels import cuda_mel
from nx_signal_tpu_torch.models.pipeline import WhisperLogMel
from nx_signal_tpu_torch.spectral.mel import _log_mel, _slaney_max_mel, mel_filters
from nx_signal_tpu_torch.spectral.stft import stft
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


# kernel M (kernels/cuda_mel.py, csrc/log_mel.cu)


@pytest.mark.parametrize("n_mels", MELS)
def test_the_band_table_rebuilds_the_filterbank_exactly(n_mels):
    frontend = WhisperLogMel(n_mels, device="cpu")
    filters, bands, weights = frontend.filters, frontend.bands, frontend.band_weights
    assert bands.dtype == torch.int32 and bands.shape == (n_mels, 3)
    first, count, offset = bands.long().unbind(-1)
    assert int(count.sum()) == weights.numel() == int((filters != 0).sum())
    assert torch.equal(offset, torch.cumsum(count, 0) - count)
    dense = torch.zeros_like(filters)
    for m in range(n_mels):
        lo, n, off = int(first[m]), int(count[m]), int(offset[m])
        dense[m, lo:lo + n] = weights[off:off + n]
    assert torch.equal(dense, filters)       # every nonzero, bit for bit
    assert torch.equal(count == 0, (filters == 0).all(-1))   # and every zero row
    assert bool((weights != 0).all())


def test_the_band_table_refuses_a_row_of_two_runs():
    with pytest.raises(ValueError, match="one run"):
        cuda_mel.mel_bands(torch.tensor([[1.0, 0.0, 1.0]]))


def _spectrum(frontend, x):
    return stft(x, frontend.window, sampling_rate=frontend.sampling_rate,
                fft_length=frontend.n_fft, overlap_length=frontend.n_fft - frontend.hop_length,
                onesided=True, window_padding="reflect").z


def _todays_route(frontend, x):
    """WhisperLogMel.forward as it was before kernel M, written out."""
    z = _spectrum(frontend, x)
    return _log_mel(z[..., :-1, :].abs() ** 2, frontend.filters, frontend.filters.shape[-1],
                    clips=True)


def test_a_cpu_spectrum_keeps_the_plain_route_bit_for_bit(frontend, monkeypatch):
    def no_kernel(*a, **k):
        raise AssertionError("kernel M launched on a CPU spectrum")

    monkeypatch.setattr(pipeline, "log_mel_clips_cuda", no_kernel)
    assert torch.equal(frontend(X), _todays_route(frontend, X))
    assert torch.equal(frontend(X[1]), _todays_route(frontend, X[1]))


@pytest.mark.parametrize("case, match", [
    ("cpu", "CUDA spectrum"), ("complex128", "complex64"), ("non-contiguous", "contiguous")])
def test_kernel_m_raises_on_what_it_does_not_take(case, match):
    bands, weights = cuda_mel.mel_bands(torch.eye(4))
    z = torch.ones(2, 6, 4, dtype=torch.complex64)
    z = {"cpu": z, "complex128": z.to(torch.complex128),
         "non-contiguous": z.transpose(0, 1)}[case]
    before = cuda_mel.log_mel_clips_cuda.launches
    with pytest.raises(ValueError, match=match):
        cuda_mel.log_mel_clips_cuda(z, bands, weights)
    assert cuda_mel.log_mel_clips_cuda.launches == before


@pytest.mark.parametrize("n_mels", MELS)
def test_loading_a_state_dict_rebuilds_the_band_table(n_mels):
    """`filters` is the one source: the band table (kept out of the state
    dict) follows the filters a state dict loads, so the card route reads
    the same filterbank as the CPU route."""
    frontend = WhisperLogMel(n_mels, device="cpu")
    assert set(frontend.state_dict()) == {"window", "filters"}
    state = frontend.state_dict()
    moved = torch.zeros_like(state["filters"])     # one bin up, doubled: still one run a row
    moved[:, 1:] = 2.0 * state["filters"][:, :-1]
    state["filters"] = moved
    frontend.load_state_dict(state)
    assert torch.equal(frontend.filters, state["filters"])
    bands, weights = cuda_mel.mel_bands(state["filters"])
    assert torch.equal(frontend.bands, bands) and torch.equal(frontend.band_weights, weights)
    first, count, offset = frontend.bands.long().unbind(-1)
    dense = torch.zeros_like(frontend.filters)
    for m in range(n_mels):
        lo, n, off = int(first[m]), int(count[m]), int(offset[m])
        dense[m, lo:lo + n] = frontend.band_weights[off:off + n]
    assert torch.equal(dense, state["filters"])


# on the card: M against the plain version (the power and _log_mel, the
# same torch operations as the CPU route, run on the card). Tolerance 2e-6
# on the normalised values: the two differ in the power (re^2 + im^2 by fmaf
# against |z| squared), the order of the band's sum (all its terms positive,
# so each relative error is a few f32 ulp) and log10's implementation (at
# most 2 ulp of log10 values up to 10, ~1.9e-6, a quarter of that after the
# scaling).
CARD_TOL = 2e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _gained_clips(clips, samples, device, seed):
    """`clips` rows of unit white noise at gains uniform in -40..0 dB."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(clips, samples, generator=gen)
    gain_db = -40.0 * torch.rand(clips, generator=gen)
    return (x * torch.pow(10.0, gain_db / 20.0)[:, None]).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n_mels", MELS)
@pytest.mark.parametrize("clips", [1, 3, 512])
def test_kernel_m_matches_the_plain_version_on_cuda(card, n_mels, clips):
    """M on the module's card route against the plain version on the same
    card, at CARD_TOL, on 30 s clips; 3 clips put the odd clip's z rows on
    8-byte boundaries; 512 is the benchmark's call."""
    frontend = WhisperLogMel(n_mels, device=card)
    x = _gained_clips(clips, 480000, card, seed=clips + n_mels)
    before = cuda_mel.log_mel_clips_cuda.launches
    got = frontend(x)
    assert cuda_mel.log_mel_clips_cuda.launches == before + 1
    want = _todays_route(frontend, x)
    assert got.shape == want.shape == (clips, n_mels, 480000 // HOP)
    assert got.is_contiguous() and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= CARD_TOL
    if clips == 3:   # and against the float64 reference, at the module's tolerance
        assert _err(got.cpu(), x.cpu(), n_mels) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n_mels", MELS)
def test_kernel_m_takes_a_1d_signal_and_a_silent_clip_on_cuda(card, n_mels):
    frontend = WhisperLogMel(n_mels, device=card)
    x = X.to(card)
    one = frontend(x[0])
    assert one.shape == (n_mels, SAMPLES // HOP)
    assert float((one - _todays_route(frontend, x[0])).abs().max()) <= CARD_TOL
    # a silent clip: every mel energy at the clamp, log10 -10, the floor
    # below it, so every value is one, (-10 + 4) / 4
    silent = torch.zeros_like(x)
    silent[1] = x[1]
    got = frontend(silent)
    for c in (0, 2):
        assert bool((got[c] == got[c, 0, 0]).all())
        assert float(got[c, 0, 0]) == pytest.approx(-1.5, abs=CARD_TOL)
    assert float((got - _todays_route(frontend, silent)).abs().max()) <= CARD_TOL


@pytest.mark.cuda
def test_kernel_m_never_reads_the_last_frame_and_a_nan_fills_its_clip_on_cuda(card):
    frontend = WhisperLogMel(128, device=card)
    z = _spectrum(frontend, X.to(card))
    run = lambda z: cuda_mel.log_mel_clips_cuda(z, frontend.bands, frontend.band_weights)
    clean = run(z)
    z[..., -1, :] = float("nan")
    assert torch.equal(run(z), clean)
    z[1, 7, 50] = float("nan")     # a frame read: that clip is NaN, as torch's ops make it
    got = run(z)
    assert bool(torch.isnan(got[1]).all())
    assert torch.equal(got[0], clean[0]) and torch.equal(got[2], clean[2])


@pytest.mark.cuda
def test_kernel_m_is_deterministic_and_counts_its_launches_on_cuda(card):
    frontend = WhisperLogMel(128, device=card)
    x = _gained_clips(64, 480000, card, seed=7)
    before = cuda_mel.log_mel_clips_cuda.launches
    first, second = frontend(x), frontend(x)
    assert cuda_mel.log_mel_clips_cuda.launches == before + 2
    assert torch.equal(first, second)   # the clips' maxima do not depend on the CTAs' order


@pytest.mark.cuda
def test_kernel_m_runs_in_its_span_inside_the_mel_span_on_cuda(card):
    frontend = WhisperLogMel(80, device=card)
    x = X.to(card)
    frontend(x)
    torch.cuda.synchronize()
    with torch.profiler.profile() as prof:
        frontend(x)
        torch.cuda.synchronize()
    spans = {e.name: e for e in prof.events() if e.name.startswith("nx.")}
    assert {"nx.logmel", "nx.stft", "nx.mel", "nx.mel.kernel"} <= set(spans)
    outer, inner = spans["nx.mel"].time_range, spans["nx.mel.kernel"].time_range
    assert outer.start <= inner.start and inner.end <= outer.end
    assert not any(e.name.startswith("nx.weights.") for e in prof.events())


@pytest.mark.cuda
def test_kernel_m_reads_nothing_outside_a_band_table_of_another_width_on_cuda(card):
    """A table of a wider filterbank (n_fft 800: bands past z's 201 bins)
    makes the clips NaN rather than reading past a frame's row; a table
    whose offsets pass the end of its weights does the same."""
    frontend = WhisperLogMel(128, device=card)
    z = _spectrum(frontend, X.to(card))
    wide = mel_filters(800, 128, RATE, max_mel=_slaney_max_mel(RATE / 2.0),
                       dtype=torch.float64, device="cpu")[:, :401].float()
    bands, weights = cuda_mel.mel_bands(wide.to(card))
    assert int((bands[:, 0] + bands[:, 1]).max()) > z.shape[-1]
    assert bool(torch.isnan(cuda_mel.log_mel_clips_cuda(z, bands, weights)).all())
    short = frontend.band_weights[:-1]
    assert bool(torch.isnan(cuda_mel.log_mel_clips_cuda(z, frontend.bands, short)).all())
