"""Parity of the port's streaming processors (nx_signal_tpu_torch/parallel/
streaming.py) with the JAX package's, case by case after
tests/test_streaming.py: the same numpy chunks, made from a seed, go
through the JAX processor and its counterpart; where the JAX tests compose
a processor with jax.lax.scan, the port runs a Python loop over the chunks.

Tolerances, stated per test, as the JAX tests' `assert_all_close` states
them (the absolute tolerance given, and 1e-4 relative):
* FIR 1e-5, PFB and resampler 2e-5, per chunk against the JAX processor
  and against the batch call (f32 contractions summed in other orders).
* STFT 1e-4 (|z| reaches ~40 with hann 256); ISTFT 1e-5 x max|y| per chunk
  against the JAX processor, 1e-3 against the delayed signal in the
  interior (the JAX test's gate).
* IIR 1e-4 of scipy's f64 sosfilt (the JAX test's f32 gate), 1e-9 / 1e-7
  relative in f64; 2e-6 per chunk against the JAX processor in f32.
* Resume from a checkpoint: bitwise against the uninterrupted run.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from nx_signal_tpu.ops import windows as jw
from nx_signal_tpu.ops.convolution import convolve as jax_convolve
from nx_signal_tpu.ops.resample import pfb_analyze as jax_pfb
from nx_signal_tpu.ops.resample import resample_poly as jax_resample_poly
from nx_signal_tpu.parallel import streaming as js
from nx_signal_tpu.spectral.stft import stft as jax_stft
from nx_signal_tpu_torch.io.checkpoint import load_state, save_state
from nx_signal_tpu_torch.ops.resample import pfb_analyze, resample_poly
from nx_signal_tpu_torch.ops.windows import hann
from nx_signal_tpu_torch.parallel import streaming as ts

T = torch.from_numpy


def _close(got, want, atol, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def _run_jax(proc, state, chunks):
    outs = []
    for c in chunks:
        state, y = proc.process(state, jnp.asarray(c))
        outs.append(np.asarray(y))
    return state, outs


def _run_port(proc, state, chunks):
    outs = []
    for c in chunks:
        state, y = proc.process(state, T(np.ascontiguousarray(c)))
        outs.append(y.numpy())
    return state, outs


def _split(x, size):
    return [x[..., i:i + size] for i in range(0, x.shape[-1], size)]


class TestStreamingFIR:
    @pytest.mark.parametrize("k,chunk", [(31, 100), (255, 512), (17, 64)])
    def test_matches_batch_full(self, k, chunk, rng):
        x = rng.normal(size=1024).astype(np.float32)
        taps = rng.normal(size=k).astype(np.float32)
        jproc, tproc = js.StreamingFIR(jnp.asarray(taps)), ts.StreamingFIR(T(taps))
        _, want = _run_jax(jproc, jproc.init_state(), _split(x, chunk))
        _, got = _run_port(tproc, tproc.init_state(device="cpu"), _split(x, chunk))
        for g, w in zip(got, want):
            _close(g, w, 1e-5)
        expected = np.asarray(jax_convolve(x, taps, mode="full"))[:1024]
        _close(np.concatenate(got), expected, 1e-5, 1e-4)

    def test_loop_in_place_of_scan(self, rng):
        x = rng.normal(size=(8, 128)).astype(np.float32)  # 8 chunks of 128
        taps = rng.normal(size=33).astype(np.float32)
        jproc, tproc = js.StreamingFIR(jnp.asarray(taps)), ts.StreamingFIR(taps)
        _, ys = jax.lax.scan(jproc.process, jproc.init_state(), jnp.asarray(x))
        _, got = _run_port(tproc, tproc.init_state(device="cpu"), list(x))
        _close(np.concatenate(got), np.asarray(ys).reshape(-1), 1e-5)
        expected = np.asarray(jax_convolve(x.reshape(-1), taps, mode="full"))[:1024]
        _close(np.concatenate(got), expected, 1e-5, 1e-4)

    def test_batched_channels(self, rng):
        x = rng.normal(size=(3, 256)).astype(np.float32)
        taps = rng.normal(size=21).astype(np.float32)
        jproc, tproc = js.StreamingFIR(jnp.asarray(taps)), ts.StreamingFIR(taps)
        _, want = _run_jax(jproc, jproc.init_state(batch_shape=(3,)), _split(x, 128))
        state = tproc.init_state(batch_shape=(3,), device="cpu")
        assert tuple(state.shape) == (3, 20)
        _, got = _run_port(tproc, state, _split(x, 128))
        for g, w in zip(got, want):
            _close(g, w, 1e-5)
        expected = np.asarray(jax_convolve(x, taps[None], mode="full"))[:, :256]
        _close(np.concatenate(got, axis=-1), expected, 1e-5, 1e-4)


class TestStreamingSTFT:
    @pytest.mark.parametrize("fft_length,onesided", [(None, False), (None, True),
                                                     (512, True), (2048, False)])
    def test_matches_batch(self, fft_length, onesided, rng):
        """fft_length 2048 (past 1024) takes torch.fft; the others the framed
        DFT (kernel B-fft's plain version here)."""
        x = rng.normal(size=2048).astype(np.float32)
        w, hop = np.array(jw.hann(256)), 128
        jproc = js.StreamingSTFT(jnp.asarray(w), hop=hop, fft_length=fft_length,
                                 onesided=onesided)
        tproc = ts.StreamingSTFT(T(w), hop=hop, fft_length=fft_length, onesided=onesided)
        assert tproc.frame_length == jproc.frame_length == 256
        _, want = _run_jax(jproc, jproc.init_state(), _split(x, 512))
        _, got = _run_port(tproc, tproc.init_state(device="cpu"), _split(x, 512))
        for g, w_ in zip(got, want):
            assert g.shape == w_.shape and g.dtype == np.complex64
            _close(g, w_, 1e-4)
        n_fft = fft_length or 256
        expected, _, _ = jax_stft(
            np.concatenate([np.zeros(256 - hop, np.float32), x]), w, fft_length=n_fft,
            overlap_length=256 - hop, sampling_rate=100, onesided=onesided)
        z = np.concatenate(got, axis=0)
        _close(z, np.asarray(expected)[:z.shape[0]], 1e-4)

    def test_complex_window_takes_torch_fft(self, monkeypatch, rng):
        """A complex window keeps the stream on torch.fft (the framed-DFT
        kernels take a real window only), and the per-chunk spectra are the
        batch stft's torch.fft route on the zero-prefixed stream."""
        stft_module = importlib.import_module("nx_signal_tpu_torch.spectral.stft")
        calls, real = [], stft_module.framed_dft
        monkeypatch.setattr(stft_module, "framed_dft",
                            lambda *a, **k: calls.append(k["n_fft"]) or real(*a, **k))
        x = rng.normal(size=(2, 2048)).astype(np.float32)
        w, hop = (np.hanning(256) * np.exp(0.3j * np.arange(256))).astype(np.complex64), 128
        proc = ts.StreamingSTFT(T(w), hop=hop)
        _, got = _run_port(proc, proc.init_state((2,), device="cpu"), _split(x, 512))
        assert calls == []
        stream = np.concatenate([np.zeros((2, 256 - hop), np.float32), x], axis=-1)
        want = stft_module.stft(T(stream), T(w), fft_length=256, overlap_length=256 - hop,
                                method="fft").z.numpy()
        z = np.concatenate(got, axis=-2)
        assert z.dtype == np.complex64
        _close(z, want[..., :z.shape[-2], :], 1e-5)

    def test_chunk_not_multiple_of_hop(self):
        proc = ts.StreamingSTFT(hann(64, device="cpu"), hop=32)
        with pytest.raises(ValueError, match="multiple of the"):
            proc.process(proc.init_state(device="cpu"), torch.zeros(100))


class TestStreamingISTFT:
    @pytest.mark.parametrize("scaling", [None, "spectrum", "psd"])
    def test_roundtrip_interior(self, scaling, rng):
        x = rng.normal(size=4096).astype(np.float32)
        w, hop = np.array(jw.hann(256)), 64
        kw = dict(scaling=scaling, sampling_rate=8000.0)
        # the spectra the scaled decoders expect: the encoder's, scaled
        factor = {None: 1.0, "spectrum": w.sum(),
                  "psd": np.sqrt(8000.0 * (w.astype(np.float64) ** 2).sum())}[scaling]
        jenc, jdec = js.StreamingSTFT(jnp.asarray(w), hop=hop), js.StreamingISTFT(
            jnp.asarray(w), hop=hop, **kw)
        tenc, tdec = ts.StreamingSTFT(T(w), hop=hop), ts.StreamingISTFT(T(w), hop=hop, **kw)
        es, ds = jenc.init_state(), jdec.init_state()
        tes, tds = tenc.init_state(device="cpu"), tdec.init_state(device="cpu")
        got, want = [], []
        for c in _split(x, 512):
            es, z = jenc.process(es, jnp.asarray(c))
            z = (z / factor).astype(jnp.complex64)
            ds, y = jdec.process(ds, z)
            want.append(np.asarray(y))
            # the same spectrum into both decoders
            tds, ty = tdec.process(tds, T(np.array(z)))
            got.append(ty.numpy())
            tes, _ = tenc.process(tes, T(c))
        for g, w_ in zip(got, want):
            assert g.dtype == np.complex64
            _close(g, w_, 1e-5 * np.abs(w_).max())
        y = np.real(np.concatenate(got))
        delay = 256 - hop
        expected = np.concatenate([np.zeros(delay, np.float32), x])
        m = min(len(y), len(expected))
        _close(y[256:m], expected[256:m], 1e-3)

    def test_port_encoder_then_decoder(self, rng):
        """The port's own encoder (the framed DFT) into its decoder (the
        complex fold through kernel C's wrapper)."""
        x = rng.normal(size=(2, 4096)).astype(np.float32)
        w, hop = hann(256, device="cpu"), 64
        enc, dec = ts.StreamingSTFT(w, hop=hop), ts.StreamingISTFT(w, hop=hop)
        es, ds = enc.init_state(batch_shape=(2,), device="cpu"), dec.init_state(
            batch_shape=(2,), device="cpu")
        outs = []
        for c in _split(x, 512):
            es, z = enc.process(es, T(np.ascontiguousarray(c)))
            ds, y = dec.process(ds, z)
            outs.append(y.numpy())
        y = np.real(np.concatenate(outs, axis=-1))
        expected = np.concatenate([np.zeros((2, 256 - hop), np.float32), x], axis=-1)
        _close(y[:, 256:4096], expected[:, 256:4096], 1e-5, 0.0)

    def test_rejects_bin_mismatch(self):
        dec = ts.StreamingISTFT(hann(256, device="cpu"), hop=64)
        with pytest.raises(ValueError, match="fft_length == window length"):
            dec.process(dec.init_state(device="cpu"), torch.zeros((4, 512), dtype=torch.complex64))


class TestStreamingPFB:
    @pytest.mark.parametrize("m,tpc,chunks", [
        (8, 4, (256, 128, 384)),
        (64, 8, (1024, 1024)),
        (16, 6, (160, 320, 160, 320)),
    ])
    def test_matches_offline(self, m, tpc, chunks, rng):
        x = rng.normal(size=sum(chunks)).astype(np.float32)
        pieces = np.split(x, np.cumsum(chunks)[:-1])
        jproc, tproc = js.StreamingPFB(m, taps_per_channel=tpc), ts.StreamingPFB(
            m, taps_per_channel=tpc)
        assert tproc.lead_frames == jproc.lead_frames == tpc - 1
        _, want = _run_jax(jproc, jproc.init_state(), pieces)
        _, got = _run_port(tproc, tproc.init_state(device="cpu"), pieces)
        for g, w, c in zip(got, want, chunks):
            assert g.shape == (c // m, m)
            _close(g, w, 2e-5)
        z = np.concatenate(got, axis=0)[tproc.lead_frames:]
        ref = np.asarray(jax_pfb(jnp.asarray(x), m, taps_per_channel=tpc))
        assert z.shape == ref.shape
        _close(z, ref, 2e-5)

    def test_batched_and_strategies(self, rng):
        x = rng.normal(size=(3, 768)).astype(np.float32)
        for strategy in ("matmul", "factored", "einsum"):
            jproc = js.StreamingPFB(64, taps_per_channel=4, strategy=strategy)
            tproc = ts.StreamingPFB(64, taps_per_channel=4, strategy=strategy)
            _, want = _run_jax(jproc, jproc.init_state(batch_shape=(3,)), _split(x, 384))
            _, got = _run_port(tproc, tproc.init_state(batch_shape=(3,), device="cpu"),
                               _split(x, 384))
            for g, w in zip(got, want):
                _close(g, w, 2e-5)
            z = np.concatenate(got, axis=-2)[:, tproc.lead_frames:]
            ref = pfb_analyze(T(x), 64, taps_per_channel=4, strategy=strategy).numpy()
            _close(z, ref, 2e-5)

    def test_custom_prototype(self, rng):
        proto = rng.normal(size=96).astype(np.float32)
        jproc = js.StreamingPFB(16, taps=jnp.asarray(proto))
        tproc = ts.StreamingPFB(16, taps=proto)
        assert tproc.taps_per_channel == jproc.taps_per_channel == 6
        x = rng.normal(size=640).astype(np.float32)
        _, want = _run_jax(jproc, jproc.init_state(), _split(x, 320))
        _, got = _run_port(tproc, tproc.init_state(device="cpu"), _split(x, 320))
        for g, w in zip(got, want):
            _close(g, w, 2e-5)
        with pytest.raises(ValueError, match="multiple of n_channels"):
            ts.StreamingPFB(16, taps=proto[:90])

    def test_checkpoint_resume_bitwise(self, rng, tmp_path):
        """Serialize mid-stream state, restore into a fresh object, and
        continue: outputs must be BIT-identical to the uninterrupted run."""
        x = rng.normal(size=1024).astype(np.float32)
        pfb = ts.StreamingPFB(16, taps_per_channel=8)
        _, ref = _run_port(pfb, pfb.init_state(device="cpu"), _split(x, 256))
        state, got = _run_port(pfb, pfb.init_state(device="cpu"), _split(x[:512], 256))
        path = tmp_path / "pfb_state"
        save_state(str(path), {"carry": state})
        restored = load_state(str(path))[0]["carry"]
        assert isinstance(restored, np.ndarray)
        _, tail = _run_port(ts.StreamingPFB(16, taps_per_channel=8), restored,
                            _split(x[512:], 256))
        for a, b in zip(got + tail, ref):
            np.testing.assert_array_equal(a, b)

    def test_chunk_validation(self):
        pfb = ts.StreamingPFB(16, taps_per_channel=4)
        with pytest.raises(ValueError, match="multiple of n_channels"):
            pfb.process(pfb.init_state(device="cpu"), torch.zeros(100))


class TestStreamingResamplePoly:
    @pytest.mark.parametrize("up,down", [(1, 3), (2, 3), (3, 1), (7, 5), (160, 441)])
    def test_matches_offline(self, up, down, rng):
        jproc, tproc = js.StreamingResamplePoly(up, down), ts.StreamingResamplePoly(up, down)
        assert tproc.lead_out == jproc.lead_out
        n = 4000 - (4000 % down)
        x = rng.normal(size=n).astype(np.float32)
        chunk = 10 * down
        ref = np.asarray(jax_resample_poly(jnp.asarray(x), up, down))
        need = tproc.lead_out + ref.shape[0]
        pieces = _split(x, chunk)
        while sum(p.shape[-1] for p in pieces) * up // down < need:
            pieces.append(np.zeros(chunk, np.float32))   # flush the filter tail
        _, want = _run_jax(jproc, jproc.init_state(), pieces)
        _, got = _run_port(tproc, tproc.init_state(device="cpu"), pieces)
        for g, w in zip(got, want):
            _close(g, w, 2e-5)
        _close(np.concatenate(got)[tproc.lead_out:need], ref, 2e-5)

    def test_matches_scipy(self, rng):
        x = rng.normal(size=1998).astype(np.float32)
        sr = ts.StreamingResamplePoly(2, 3)
        ref = sps.resample_poly(x.astype(np.float64), 2, 3, window=("kaiser", 5.0))
        need = sr.lead_out + ref.shape[0]
        pieces = _split(x, 333)
        while len(pieces) * 222 < need:
            pieces.append(np.zeros(333, np.float32))
        _, got = _run_port(sr, sr.init_state(device="cpu"), pieces)
        _close(np.concatenate(got)[sr.lead_out:need], ref, 1e-4, 1e-4)

    def test_batched_identity_and_validation(self, rng):
        sr = ts.StreamingResamplePoly(4, 4)
        state = sr.init_state(device="cpu")
        assert tuple(state.shape) == (0,) and sr.lead_out == 0
        x = rng.normal(size=32).astype(np.float32)
        state, y = sr.process(state, T(x))
        np.testing.assert_array_equal(y.numpy(), x)
        sr = ts.StreamingResamplePoly(1, 2)
        xb = rng.normal(size=(3, 200)).astype(np.float32)
        state = sr.init_state(batch_shape=(3,), device="cpu")
        state, y = sr.process(state, T(xb))
        assert tuple(y.shape) == (3, 100)
        jsr = js.StreamingResamplePoly(1, 2)
        _, jy = jsr.process(jsr.init_state(batch_shape=(3,)), jnp.asarray(xb))
        _close(y.numpy(), jy, 2e-5)
        with pytest.raises(ValueError, match="multiple of the reduced"):
            sr.process(state, torch.zeros((3, 33)))
        with pytest.raises(ValueError, match="up and down"):
            ts.StreamingResamplePoly(0, 3)

    def test_checkpoint_resume_bitwise(self, rng, tmp_path):
        x = rng.normal(size=1200).astype(np.float32)
        sr = ts.StreamingResamplePoly(2, 3)
        _, ref = _run_port(sr, sr.init_state(device="cpu"), _split(x, 300))
        state, got = _run_port(sr, sr.init_state(device="cpu"), _split(x[:600], 300))
        path = tmp_path / "srp_state"
        save_state(str(path), {"carry": state})
        restored = load_state(str(path))[0]["carry"]
        _, tail = _run_port(ts.StreamingResamplePoly(2, 3), restored, _split(x[600:], 300))
        for a, b in zip(got + tail, ref):
            np.testing.assert_array_equal(a, b)

    def test_loop_in_place_of_scan(self, rng):
        jproc, tproc = js.StreamingResamplePoly(1, 4), ts.StreamingResamplePoly(1, 4)
        x = rng.normal(size=2048).astype(np.float32)
        _, ys = jax.lax.scan(jproc.process, jproc.init_state(), jnp.asarray(x.reshape(8, 256)))
        _, got = _run_port(tproc, tproc.init_state(device="cpu"), list(x.reshape(8, 256)))
        got = np.concatenate(got)
        _close(got, np.asarray(ys).reshape(-1), 2e-5)
        ref = resample_poly(T(x), 1, 4).numpy()
        n = min(got.shape[0] - tproc.lead_out, ref.shape[0])
        _close(got[tproc.lead_out:][:n], ref[:n], 2e-5)


class TestStreamingIIR:
    def test_chunks_equal_whole(self, rng):
        sos = sps.butter(6, 0.25, output="sos")
        x = rng.normal(size=(3, 256)).astype(np.float32)
        jproc = js.StreamingIIR(jnp.asarray(sos, dtype=jnp.float32))
        tproc = ts.StreamingIIR(T(sos.astype(np.float32)))
        jstate = jproc.init_state(batch_shape=(3,), dtype=jnp.float32)
        tstate = tproc.init_state(batch_shape=(3,), dtype=np.float32, device="cpu")
        assert tuple(tstate.shape) == (3, 3, 2)
        jstate, want = _run_jax(jproc, jstate, _split(x, 64))
        tstate, got = _run_port(tproc, tstate, _split(x, 64))
        for g, w in zip(got, want):
            assert g.dtype == np.float32
            _close(g, w, 2e-6, 0.0)
        _close(tstate.numpy(), np.asarray(jstate), 2e-6, 0.0)
        _close(np.concatenate(got, axis=-1), sps.sosfilt(sos, x.astype(np.float64)),
               1e-4, 1e-4)

    def test_loop_in_place_of_scan(self, rng):
        """f64 chunks and an f64 sos: the JAX scan against the port's loop."""
        sos = sps.butter(4, 0.3, output="sos")
        x = rng.normal(size=512)
        jproc, tproc = js.StreamingIIR(jnp.asarray(sos)), ts.StreamingIIR(T(sos))
        chunks = x.reshape(8, 64)
        _, ys = jax.lax.scan(jproc.process, jproc.init_state(dtype=jnp.float64),
                             jnp.asarray(chunks))
        _, got = _run_port(tproc, tproc.init_state(dtype=torch.float64, device="cpu"),
                           list(chunks))
        got = np.concatenate(got)
        assert got.dtype == np.float64
        _close(got, np.asarray(ys).reshape(-1), 1e-9, 1e-7)
        _close(got, sps.sosfilt(sos, x), 1e-9, 1e-7)

    def test_checkpoint_resume_bitwise(self, rng, tmp_path):
        sos = sps.butter(8, 0.1, output="sos").astype(np.float32)
        proc = ts.StreamingIIR(T(sos))
        x = rng.normal(size=(2, 1024)).astype(np.float32)
        _, ref = _run_port(proc, proc.init_state(batch_shape=(2,), device="cpu"),
                           _split(x, 128))
        state, got = _run_port(proc, proc.init_state(batch_shape=(2,), device="cpu"),
                               _split(x[:, :512], 128))
        save_state(str(tmp_path / "iir.npz"), state)
        restored, _ = load_state(str(tmp_path / "iir.npz"))
        _, tail = _run_port(proc, restored, _split(x[:, 512:], 128))
        for a, b in zip(got + tail, ref):
            np.testing.assert_array_equal(a, b)
