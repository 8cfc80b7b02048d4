"""The PyTorch port's STFT+FIR chain as a whole, its design-time inputs
(windows, sinc, firwin) and its independence from JAX.

Tolerances:
* windows, sinc, firwin: 1e-6 absolute — the same f32 formulas; the two
  libraries' cos/sin and dot products may differ in the last ulp.
* stft_fir_chain / StftFirChain: 1e-4 x max|power| against the JAX
  stft_fir_chain, the JAX package's gate for f32 contractions summed in
  different orders; the filtered signal of return_filtered=True and
  FIRFilterChain at 1e-5 x max|y| (f32 convolutions in other orders).
* SpectrogramPipeline: the dB values as amplitudes relative to the peak,
  10^(dB/20), at 1e-5 absolute (f32 DFT sums; in dB a weak bin's rounding
  is magnified, 3e-3 dB at -70 dB).
* the folded weights held by StftFirChain: bitwise (the same numpy f64 fold).
* WidebandReceiver: 1e-4 x each band's max power against the JAX receiver
  (f32 PFB and FFT sums in other orders).
* channelize_power_stream: 1e-4 of the max (the JAX test's gate) against
  the JAX function and against pfb_analyze of the zero-prepended stream;
  2e-6 of each band's power where an f32 accumulator stalls (the f64
  accumulator reads ~1e-7 there, the JAX package's f32 one 8e-6 to 2e-5).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nx_signal_tpu.kernels.dft import fir_dft_fold_weights as jax_fold
from nx_signal_tpu.models.pipeline import FIRFilterChain as JaxFIRChain
from nx_signal_tpu.models.pipeline import SpectrogramPipeline as JaxSpectrogram
from nx_signal_tpu.models.pipeline import stft_fir_chain as jax_chain
from nx_signal_tpu.ops import filters as jfilt
from nx_signal_tpu.ops import waveforms as jwave
from nx_signal_tpu.ops import windows as jw
from nx_signal_tpu.models.pipeline import WidebandReceiver as JaxWidebandReceiver
from nx_signal_tpu.models.pipeline import channelize_power_stream as jax_channelize
from nx_signal_tpu_torch.models import pipeline as tpipe
from nx_signal_tpu_torch.models.pipeline import (
    FIRFilterChain,
    SpectrogramPipeline,
    StftFirChain,
    WidebandReceiver,
    channelize_power_stream,
    stft_fir_chain,
)
from nx_signal_tpu_torch.ops.resample import pfb_analyze
from nx_signal_tpu_torch.ops import filters as tfilt
from nx_signal_tpu_torch.ops import waveforms as twave
from nx_signal_tpu_torch.ops import windows as tw

REPO = Path(__file__).resolve().parents[1]


def assert_close_to_max(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("name", ["hann", "hamming", "blackman"])
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("n", [1, 2, 8, 255, 512])
def test_cosine_windows(name, periodic, n):
    want = np.asarray(getattr(jw, name)(n, periodic=periodic))
    got = getattr(tw, name)(n, periodic=periodic, device="cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("window", ["hann", "hamming", "blackman",
                                    ("general_cosine", [0.6, 0.4])])
@pytest.mark.parametrize("periodic", [True, False])
def test_get_window(window, periodic):
    want = np.asarray(jw.get_window(window, 33, periodic=periodic))
    got = tw.get_window(window, 33, periodic=periodic, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_general_cosine_and_unknown_window():
    np.testing.assert_allclose(
        tw.general_cosine(10, [0.5, 0.3, 0.2], device="cpu").numpy(),
        np.asarray(jw.general_cosine(10, [0.5, 0.3, 0.2])), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="unknown window 'kaiser'"):
        tw.get_window("kaiser", 8)


def test_sinc(rng):
    t = np.concatenate([[0.0, 0.5, 1.0, -2.0], rng.normal(size=50) * 10]).astype(np.float32)
    np.testing.assert_allclose(twave.sinc(torch.from_numpy(t)).numpy(),
                               np.asarray(jwave.sinc(jnp.asarray(t))), rtol=0, atol=1e-6)
    assert twave.sinc(torch.arange(3)).dtype == torch.float32


@pytest.mark.parametrize("num_taps,cutoff,rate,pass_zero,window", [
    (255, [2000.0], 48000.0, True, "hamming"),
    (255, [2000.0], 48000.0, True, "hann"),
    (100, [3000.0], 48000.0, True, "hamming"),
    (5, [0.5], 2.0, True, "hamming"),
    (31, [0.2, 0.5], 2.0, False, "blackman"),   # bandpass
    (31, [0.3], 2.0, False, "hamming"),         # highpass, odd taps
    (65, [0.25, 0.6], 2.0, True, "hann"),       # bandstop
])
def test_firwin(num_taps, cutoff, rate, pass_zero, window):
    want = np.asarray(jfilt.firwin(num_taps, cutoff, window=window, pass_zero=pass_zero,
                                   sampling_rate=rate))
    got = tfilt.firwin(num_taps, cutoff, window=window, pass_zero=pass_zero,
                       sampling_rate=rate, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_firwin_errors():
    with pytest.raises(ValueError, match="strictly between"):
        tfilt.firwin(11, [1.5])
    with pytest.raises(ValueError, match="odd number of taps"):
        tfilt.firwin(10, [0.3], pass_zero=False)
    with pytest.raises(ValueError, match="non-empty"):
        tfilt.firwin(11, [])


CHAIN_GEOMETRIES = [  # channels, length, taps, frame, overlap, n_fft, frame_chunks
    (2, 8192, 255, 512, 384, 512, 1),   # the bench chain, cut to size
    (3, 5000, 100, 400, 240, 512, 1),   # even taps, hop 160 does not divide the frame
    (1, 4096, 64, 256, 192, 256, 2),
]


@pytest.mark.parametrize("geometry", CHAIN_GEOMETRIES)
def test_stft_fir_chain_matches_jax(geometry, rng):
    channels, length, k, frame, overlap, n_fft, chunks = geometry
    x = rng.normal(size=(channels, length)).astype(np.float32)
    taps = np.array(jfilt.firwin(k, [2000.0], sampling_rate=48000.0))
    window = np.array(jw.hann(frame))
    kw = dict(fft_length=n_fft, overlap_length=overlap, sampling_rate=48000.0,
              return_filtered=False, precision="high", frame_chunks=chunks)
    want = np.asarray(jax_chain(jnp.asarray(x), taps, window, **kw))
    got = stft_fir_chain(torch.from_numpy(x), torch.from_numpy(taps),
                         torch.from_numpy(window), **kw)
    assert got.dtype == torch.float32
    assert_close_to_max(got, want.astype(np.float32))


@pytest.mark.parametrize("k,frame,hop,n_fft", [(255, 512, 128, 512), (100, 400, 150, 512)])
def test_stft_fir_chain_module(k, frame, hop, n_fft, rng):
    x = rng.normal(size=(2, 6000)).astype(np.float32)
    taps = np.array(jfilt.firwin(k, [3000.0], sampling_rate=48000.0))
    window = np.array(jw.hann(frame))
    chain = StftFirChain.from_numpy(taps, window, stride=hop, n_fft=n_fft, device="cpu")
    assert dict(chain.named_buffers())["weights"] is chain.weights
    np.testing.assert_array_equal(chain.weights.numpy(),
                                  np.asarray(jax_fold(taps, window, n_fft, True)))
    want = np.asarray(jax_chain(jnp.asarray(x), taps, window, fft_length=n_fft,
                                overlap_length=frame - hop, return_filtered=False))
    assert_close_to_max(chain.to("cpu")(torch.from_numpy(x)), want.astype(np.float32))


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("k,frame,hop,n_fft", [(255, 512, 128, 512), (100, 400, 150, 512)])
def test_stft_fir_chain_module_precision(precision, k, frame, hop, n_fft, rng):
    """StftFirChain(precision=p) is stft_fir_chain(..., precision=p,
    return_filtered=False) bit for bit (the same folded weights through the
    same wrapper: on a CPU tensor A's or A-tc's plain version), and within
    the existing chain tests' gate of the JAX stft_fir_chain at that
    precision: 1e-4 x max at 'highest' and 'high', 1e-2 x max at 'default'
    (one TF32 pass against the JAX package's f32 on the CPU,
    tests/test_torch_precision.py)."""
    x = rng.normal(size=(2, 6000)).astype(np.float32)
    taps = np.array(jfilt.firwin(k, [3000.0], sampling_rate=48000.0))
    window = np.array(jw.hann(frame))
    chain = StftFirChain.from_numpy(taps, window, stride=hop, n_fft=n_fft, precision=precision,
                                    device="cpu")
    assert chain.precision == precision
    got = chain(torch.from_numpy(x))
    kw = dict(fft_length=n_fft, overlap_length=frame - hop, return_filtered=False,
              precision=precision)
    want = stft_fir_chain(torch.from_numpy(x), torch.from_numpy(taps),
                          torch.from_numpy(window), **kw)
    assert got.shape == want.shape and torch.equal(got, want)
    jax_want = np.asarray(jax_chain(jnp.asarray(x), taps, window, **kw))
    assert_close_to_max(got, jax_want.astype(np.float32),
                        rel=1e-2 if precision == "default" else 1e-4)


def test_stft_fir_chain_module_checks_its_precision():
    taps, window = np.ones(5) / 5, np.hanning(256)
    with pytest.raises(ValueError) as want:
        stft_fir_chain(torch.zeros(2, 4096), taps, window, fft_length=256, overlap_length=128,
                       return_filtered=False, precision="fast")
    with pytest.raises(ValueError) as got:
        StftFirChain.from_numpy(taps, window, stride=128, n_fft=256, precision="fast",
                                device="cpu")
    assert str(got.value) == str(want.value)


def test_stft_fir_chain_unported_paths():
    """Every path of stft_fir_chain is ported; what still raises is what the
    JAX package rejects too."""
    x, taps, window = torch.zeros(2, 4096), np.ones(5) / 5, tw.hann(256, device="cpu")
    kw = dict(fft_length=256, overlap_length=128, fir_method="winograd")
    with pytest.raises(ValueError, match="method"):
        stft_fir_chain(x, taps, window, **kw)
    with pytest.raises(ValueError, match="method"):
        jax_chain(jnp.zeros((2, 4096)), taps, np.asarray(window), **kw)
    with pytest.raises(ValueError, match="shorter than the window"):
        StftFirChain.from_numpy(taps, window.numpy(), stride=64, n_fft=128, device="cpu")


FILTERED_GEOMETRIES = [  # channels, length, taps, frame, overlap, n_fft
    (2, 8192, 255, 512, 384, 512),   # the bench chain, cut to size
    (3, 5000, 100, 400, 240, 512),   # even taps
]


@pytest.mark.parametrize("geometry", FILTERED_GEOMETRIES)
@pytest.mark.parametrize("fir_method", ["direct", "fft", "oa"])
def test_stft_fir_chain_filtered_matches_jax(geometry, fir_method, rng):
    channels, length, k, frame, overlap, n_fft = geometry
    x = rng.normal(size=(channels, length)).astype(np.float32)
    taps = np.array(jfilt.firwin(k, [2000.0], sampling_rate=48000.0))
    window = np.array(jw.hann(frame))
    kw = dict(fft_length=n_fft, overlap_length=overlap, sampling_rate=48000.0,
              fir_method=fir_method)
    want_y, want_p = jax_chain(jnp.asarray(x), taps, window, **kw)
    got_y, got_p = stft_fir_chain(torch.from_numpy(x), taps, torch.from_numpy(window), **kw)
    assert got_y.dtype == torch.float32 and got_p.dtype == torch.float32
    assert_close_to_max(got_y, np.asarray(want_y), rel=1e-5)
    assert_close_to_max(got_p, np.asarray(want_p).astype(np.float32))
    # the power alone through the same branch agrees with the fused path
    fused = stft_fir_chain(torch.from_numpy(x), taps, window, return_filtered=False, **kw)
    assert_close_to_max(got_p, fused.numpy())


@pytest.mark.parametrize("case", ["complex_input", "long_fft"])
@pytest.mark.parametrize("return_filtered", [True, False])
def test_stft_fir_chain_stft_branch_matches_jax(case, return_filtered, rng):
    """Complex input or n_fft > 1024 takes the stft (torch.fft) branch."""
    if case == "complex_input":
        x = (rng.normal(size=(2, 6000)) + 1j * rng.normal(size=(2, 6000))).astype(np.complex64)
        frame, overlap, n_fft = 256, 128, 256
    else:
        x = rng.normal(size=(2, 12000)).astype(np.float32)
        frame, overlap, n_fft = 2048, 1024, 2048
    taps = np.array(jfilt.firwin(63, [3000.0], sampling_rate=48000.0))
    window = np.array(jw.hann(frame))
    kw = dict(fft_length=n_fft, overlap_length=overlap, sampling_rate=48000.0,
              return_filtered=return_filtered, onesided=case != "complex_input")
    want = jax_chain(jnp.asarray(x), taps, window, **kw)
    got = stft_fir_chain(torch.from_numpy(x), taps, window, **kw)
    if return_filtered:
        assert_close_to_max(got[0], np.asarray(want[0]), rel=1e-5)
        got, want = got[1], want[1]
    assert_close_to_max(got, np.asarray(want).astype(np.float32))


@pytest.mark.parametrize("case", ["complex_input", "long_fft"])
def test_filtered_power_is_the_stft_power_bit_for_bit_on_the_fft_route(case, rng):
    """On the torch.fft route (complex input, or an n_fft of 2048 on the
    CPU) the filtered chain's power is |stft(y).z|^2 of its own filtered
    signal bit for bit: the chain and stft share one route,
    `spectral.stft._framed_spectrum`."""
    import importlib

    stft = importlib.import_module("nx_signal_tpu_torch.spectral.stft").stft
    if case == "complex_input":
        x = (rng.normal(size=(2, 6000)) + 1j * rng.normal(size=(2, 6000))).astype(np.complex64)
        frame, overlap, n_fft = 256, 128, 256
    else:
        x = rng.normal(size=(2, 12000)).astype(np.float32)
        frame, overlap, n_fft = 2048, 1024, 2048
    taps = tfilt.firwin(63, [3000.0], sampling_rate=48000.0, device="cpu")
    window = tw.hann(frame, device="cpu")
    kw = dict(fft_length=n_fft, overlap_length=overlap, sampling_rate=48000.0,
              onesided=case != "complex_input")
    y, power = stft_fir_chain(torch.from_numpy(x), taps, window, **kw)
    want = stft(y, window, **kw).z.abs() ** 2
    assert power.dtype == want.dtype and power.shape == want.shape
    assert torch.equal(power, want)


@pytest.mark.parametrize("params", [dict(), dict(num_taps=65, cutoff=(1000.0, 4000.0),
                                                 sampling_rate=16000.0, window="hamming")])
@pytest.mark.parametrize("shape", [(3000,), (2, 4000)])
def test_fir_filter_chain_matches_jax(params, shape, rng):
    x = rng.normal(size=shape).astype(np.float32)
    want = np.asarray(JaxFIRChain(**params)(jnp.asarray(x)))
    chain = FIRFilterChain(**params)
    np.testing.assert_allclose(chain.design(device="cpu").numpy(),
                               np.asarray(JaxFIRChain(**params).taps),
                               rtol=0, atol=1e-6)
    assert_close_to_max(chain(torch.from_numpy(x)), want, rel=1e-5)


@pytest.mark.parametrize("params", [dict(frame_length=256, fft_length=256),
                                    dict(frame_length=400, overlap_length=300,
                                         fft_length=512, sampling_rate=8000.0)])
def test_spectrogram_pipeline_matches_jax(params, rng):
    t = np.arange(16000) / 16000.0
    x = (np.sin(2 * np.pi * 440.0 * t) + 0.1 * rng.normal(size=t.size)).astype(np.float32)
    want_db, want_t, want_f = JaxSpectrogram(**params)(jnp.asarray(x))
    got_db, got_t, got_f = SpectrogramPipeline(**params)(torch.from_numpy(x))
    want_db = np.asarray(want_db)
    assert got_db.shape == want_db.shape and float(got_db.max()) == 0.0
    np.testing.assert_allclose(10.0 ** (got_db.numpy() / 20.0), 10.0 ** (want_db / 20.0),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=1e-6)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=1e-6)


@pytest.mark.parametrize("params,n", [
    (dict(n_channels=32, frame_length=64, hop=32, sampling_rate=3.2e6), 1 << 16),
    (dict(n_channels=64, taps_per_channel=4, frame_length=32, hop=8), 1 << 15),
])
def test_wideband_receiver_matches_jax(params, n, rng):
    x = rng.normal(size=(2, n)).astype(np.float32)
    got = WidebandReceiver(**params)(torch.from_numpy(x)).numpy()
    want = np.asarray(JaxWidebandReceiver(**params)(jnp.asarray(x)))
    assert got.shape == want.shape and got.shape[1] == params["n_channels"]
    assert np.isfinite(got).all()
    scale = np.abs(want).max(axis=(-2, -1), keepdims=True)
    assert (np.abs(got - want) <= 1e-4 * scale).all()


def _offline_power(x, m, tpc):
    """pfb_analyze of the zero-prepended stream, power summed over frames
    in f64 (the einsum route in f64)."""
    lead = (tpc - 1) * m
    full = torch.from_numpy(np.pad(x.astype(np.float64), [(0, 0), (lead, 0)]))
    ref = pfb_analyze(full, m, taps_per_channel=tpc, strategy="einsum")
    return (ref.real ** 2 + ref.imag ** 2).sum(dim=-2).numpy()


class TestChannelizePowerStream:
    def test_matches_jax_and_offline_power(self, rng):
        m, tpc = 32, 4
        x = rng.normal(size=(2, 8192)).astype(np.float32)
        blocks = [x[:, :3000], x[:, 3000:5050], x[:, 5050:]]  # ragged
        power, frames = channelize_power_stream(blocks, m, taps_per_channel=tpc, device="cpu")
        assert frames == 8192 // m and power.dtype == torch.float32
        want, want_frames = jax_channelize(blocks, m, taps_per_channel=tpc)
        assert frames == want_frames
        assert_close_to_max(power, np.asarray(want))
        assert_close_to_max(power, _offline_power(x, m, tpc))

    def test_from_prefetching_raw_reader(self, rng, tmp_path):
        from nx_signal_tpu_torch.io.raw import PrefetchingRawReader, write_raw

        m, tpc = 64, 8
        x = rng.uniform(-0.9, 0.9, size=(1, 50000)).astype(np.float32)
        p = str(tmp_path / "cap.i16")
        write_raw(p, x, dtype="i16")
        with PrefetchingRawReader(p, dtype="i16", channels=1, block_frames=8192) as pf:
            power, frames = channelize_power_stream(pf, m, taps_per_channel=tpc,
                                                    device="cpu")
        assert frames == 50000 // m
        decoded = (np.round(np.clip(x * 32768, -32768, 32767)) / 32768).astype(np.float32)
        assert_close_to_max(power, _offline_power(decoded[:, :(50000 // m) * m], m, tpc))

    def test_drop_tail_and_validation(self, rng):
        x = rng.normal(size=(1, 1000)).astype(np.float32)
        power, frames = channelize_power_stream([x[:, :640], x[:, 640:]], 16,
                                                taps_per_channel=4, drop_tail=True,
                                                device="cpu")
        assert frames == 40   # one 640-sample chunk; the 352-sample tail dropped
        _, kept = channelize_power_stream([x[:, :640], x[:, 640:]], 16, taps_per_channel=4,
                                          device="cpu")
        assert kept == 62
        with pytest.raises(ValueError, match="empty block stream"):
            channelize_power_stream([], 16, device="cpu")
        with pytest.raises(ValueError, match="shorter than one"):
            channelize_power_stream([np.zeros((1, 8), np.float32)], 16, device="cpu")
        with pytest.raises(ValueError, match="channels, frames"):
            channelize_power_stream([np.zeros(64, np.float32)], 16, device="cpu")

    def test_read_cursor_small_first_block_then_large_blocks(self, rng, monkeypatch):
        """A 64-sample first block fixes the chunk at 64; the 8192-sample
        blocks that follow are read through the cursor: every chunk is
        staged once, from views of the queued blocks, and every sample
        once (no re-concatenation of the queue per chunk)."""
        m, tpc = 16, 4
        x = rng.normal(size=(2, 64 + 3 * 8192 + 40)).astype(np.float32)
        blocks = [x[:, :64]] + [x[:, 64 + i * 8192:64 + (i + 1) * 8192] for i in range(3)]
        blocks.append(x[:, 64 + 3 * 8192:])
        staged = []
        stage = tpipe._Stager.__call__

        def counting(self, pieces):
            staged.append(sum(p.shape[1] for p in pieces))
            assert all(any(np.shares_memory(p, b) for b in blocks) for p in pieces)
            return stage(self, pieces)

        monkeypatch.setattr(tpipe._Stager, "__call__", counting)
        power, frames = channelize_power_stream(blocks, m, taps_per_channel=tpc, device="cpu")
        assert staged == [64] * ((x.shape[1] - 40) // 64) + [32]
        assert sum(staged) == frames * m == x.shape[1] - 8
        want, want_frames = jax_channelize(blocks, m, taps_per_channel=tpc)
        assert frames == want_frames
        assert_close_to_max(power, np.asarray(want))

    def test_float64_accumulator_holds_where_float32_stalls(self):
        """A loud first chunk (amplitude 2^13) then 1024 quiet ones: each
        quiet chunk adds less than half an f32 ulp of the running sum, so an
        f32 accumulator (the JAX package's) drops them, 8e-6 to 2e-5 of the
        band power; the f64 one keeps them."""
        m, tpc = 16, 4
        rng = np.random.default_rng(5)
        x = np.concatenate([rng.normal(size=(1, 64)) * 2.0 ** 13,
                            rng.normal(size=(1, 64 * 1024))], axis=1).astype(np.float32)
        blocks = [x[:, i:i + 64] for i in range(0, x.shape[1], 64)]
        power, _ = channelize_power_stream(blocks, m, taps_per_channel=tpc, device="cpu")
        want = _offline_power(x, m, tpc)
        rel = np.abs(power.numpy() - want) / want
        assert rel.max() < 2e-6
        jax_power, _ = jax_channelize(blocks, m, taps_per_channel=tpc)
        assert (np.abs(np.asarray(jax_power) - want) / want).max() > 5e-6


def test_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch, rng):
    """A signal that is not a tensor goes to the CUDA device, and
    from_numpy builds there by default: with no card both raise (never a
    quiet run on the CPU). A CPU tensor or device='cpu' asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = rng.normal(size=(2, 4096)).astype(np.float32)
    taps = tfilt.firwin(31, [0.2], device="cpu").numpy()
    window = tw.hann(256, device="cpu").numpy()
    kw = dict(fft_length=256, overlap_length=192)
    for call in (lambda: stft_fir_chain(x, taps, window, return_filtered=False, **kw),
                 lambda: stft_fir_chain(x.tolist(), taps, window, **kw),
                 lambda: SpectrogramPipeline(frame_length=256, fft_length=256)(x[0]),
                 lambda: FIRFilterChain(num_taps=31)(x),
                 lambda: StftFirChain.from_numpy(taps, window, stride=64, n_fft=256),
                 lambda: WidebandReceiver(n_channels=16, frame_length=32, hop=16)(x[0]),
                 lambda: channelize_power_stream([x], 16)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    got = stft_fir_chain(torch.from_numpy(x), taps, window, return_filtered=False, **kw)
    chain = StftFirChain.from_numpy(taps, window, stride=64, n_fft=256, device="cpu")
    assert got.device.type == "cpu" and chain.weights.device.type == "cpu"
    assert_close_to_max(chain(torch.from_numpy(x)), got)


def _run(args, cwd, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_port_imports_and_runs_without_jax():
    # the port must run where JAX is absent: every `import jax` now raises
    code = (
        "import sys\n"
        "for name in [m for m in sys.modules if m == 'jax' or m.startswith('jax.')]:\n"
        "    sys.modules[name] = None\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np, torch\n"
        "import nx_signal_tpu_torch as nt\n"
        "x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 4096)).astype('f4'))\n"
        "taps, w = nt.firwin(63, [0.2], device='cpu'), nt.hann(256, device='cpu')\n"
        "p = nt.stft_fir_chain(x, taps, w, fft_length=256,\n"
        "                      overlap_length=192, return_filtered=False)\n"
        "yf, pf = nt.stft_fir_chain(x, taps, w, fft_length=256,\n"
        "                           overlap_length=192, fir_method='oa')\n"
        "ps = nt.fir_framed_dft(x, taps, w, stride=64,\n"
        "                       n_fft=256, onesided=True, output='power',\n"
        "                       kernel='cuda_shared')\n"
        "assert pf.shape == ps.shape == p.shape and yf.shape == x.shape\n"
        "y = nt.istft(nt.stft(x, w, overlap_length=192, onesided=True).z,\n"
        "             w, overlap_length=192, onesided=True)\n"
        "assert p.shape == (2, 61, 129) and bool(torch.isfinite(p).all()), p.shape\n"
        "assert y.shape == (2, 4096)\n"
        "print('NO_JAX_OK')\n"
    )
    proc = _run(["-c", code], cwd=REPO, env_extra={"PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr
    assert "NO_JAX_OK" in proc.stdout


def test_port_sources_never_import_jax():
    files = sorted((REPO / "nx_signal_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for line in path.read_text().splitlines():
            words = line.strip().split()
            assert not (words[:1] == ["import"] and words[1].startswith("jax")), path
            assert not (words[:1] == ["from"] and words[1].startswith("jax")), path


def test_chip_smoke_fails_without_a_gpu_or_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py is expected to pass")
    proc = _run([str(REPO / "chip_smoke.py")], cwd=REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    proc = _run([str(lone)], cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
