"""The port's seeded random-geometry sweeps against scipy: every sweep of
tests/test_fuzz_parity.py (which holds the JAX package to the same oracle)
with its seeds and gates, run on the port's counterparts on the CPU
(CPU tensors in, so no card is asked for). No JAX here: the JAX file
already runs its package on these seeds, and leaving it out keeps the
tier's time down.

Gates, as in the JAX file: upfirdn 1e-6 x max(1, max|want|); resample_poly,
convolve and ShortTimeFFT 1e-4 x that scale; the stft -> istft round trip
1e-4 absolute on the interior; the IIR designs 1e-8 absolute and their
sosfilt 1e-5 x scale; the PFB against its einsum strategy 2e-6 x
max|ref|; find_peaks scipy's indices exactly, prominences at 1e-6; the
streaming processors 2e-5 x scale of the offline ops. The sharded sweep
runs sharded_convolve_same on one gloo group of 8 CPU ranks
(`torch_sharded_ranks.fuzz_sharded_cases`, the JAX file's 8-device meshes)
against the single-device direct convolve at 1e-5 x max, not bitwise as
the JAX file holds lax.conv: on the CPU oneDNN blocks a conv1d's sums by
the input length, so a block's outputs differ from the whole signal's in
the last bits (the port's gate for this comparison,
tests/test_torch_sharded.py::test_sharded_convolve_same_matches_jax).
"""

import numpy as np
import pytest
import scipy.signal as sps
import torch

from nx_signal_tpu_torch.ops.convolution import convolve
from nx_signal_tpu_torch.ops.find_peaks import find_peaks
from nx_signal_tpu_torch.ops.iir import sosfilt
from nx_signal_tpu_torch.ops.iir_design import butter, cheby1
from nx_signal_tpu_torch.ops.resample import pfb_analyze, resample_poly, upfirdn
from nx_signal_tpu_torch.ops.windows import get_window
from nx_signal_tpu_torch.parallel.streaming import StreamingPFB, StreamingResamplePoly
from nx_signal_tpu_torch.spectral.short_time_fft import ShortTimeFFT
from nx_signal_tpu_torch.spectral.stft import istft, stft
from tests import torch_sharded_ranks as ranks

T = torch.from_numpy


@pytest.mark.parametrize("seed", range(12))
def test_upfirdn_random_geometry(seed):
    rng = np.random.default_rng(100 + seed)
    up = int(rng.integers(1, 12))
    down = int(rng.integers(1, 12))
    n = int(rng.integers(3, 4000))
    k = int(rng.integers(1, 80))
    x = rng.normal(size=n)
    h = rng.normal(size=k)
    got = upfirdn(h, T(x), up, down).numpy()
    want = sps.upfirdn(h, x, up, down)
    assert got.shape == want.shape, (up, down, n, k)
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=1e-6 * scale,
                               err_msg=f"up={up} down={down} n={n} k={k}")


@pytest.mark.parametrize("seed", range(8))
def test_resample_poly_random_ratio(seed):
    rng = np.random.default_rng(200 + seed)
    up = int(rng.integers(1, 10))
    down = int(rng.integers(1, 10))
    n = int(rng.integers(64, 3000))
    x = rng.normal(size=n)
    got = resample_poly(T(x), up, down).numpy()
    want = sps.resample_poly(x, up, down)
    assert got.shape == want.shape, (up, down, n)
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=1e-4 * scale,
                               err_msg=f"up={up} down={down} n={n}")


@pytest.mark.parametrize("seed", range(8))
def test_stft_istft_random_geometry_roundtrip(seed):
    rng = np.random.default_rng(300 + seed)
    frame = int(rng.choice([64, 128, 256, 512]))
    hop = int(rng.choice([f for f in (16, 32, 64, 128, 256)
                          if f < frame and frame % f == 0]))
    n = int(rng.integers(4, 12)) * frame
    wname = str(rng.choice(["hann", "hamming", "blackman"]))
    w = get_window(wname, frame, periodic=True, device="cpu")
    x = rng.normal(size=n).astype(np.float32)
    z, _, _ = stft(T(x), w, overlap_length=frame - hop, fft_length=frame,
                   sampling_rate=1000.0, onesided=True)
    y = istft(z, w, overlap_length=frame - hop, fft_length=frame, onesided=True).numpy()
    lo, hi = frame, min(y.shape[-1], n) - frame
    if hi > lo:
        err = np.abs(y[lo:hi] - x[lo:hi]).max()
        assert err < 1e-4, (frame, hop, wname, err)


@pytest.mark.parametrize("seed", range(6))
def test_iir_design_apply_random(seed):
    rng = np.random.default_rng(400 + seed)
    order = int(rng.integers(2, 8))
    wn = float(rng.uniform(0.05, 0.45))
    kind = str(rng.choice(["butter", "cheby1"]))
    if kind == "butter":
        sos = np.asarray(butter(order, wn, output="sos"))
        sos_ref = sps.butter(order, wn, output="sos")
    else:
        sos = np.asarray(cheby1(order, 1.0, wn, output="sos"))
        sos_ref = sps.cheby1(order, 1.0, wn, output="sos")
    np.testing.assert_allclose(sos, sos_ref, atol=1e-8, err_msg=f"{kind} n={order} wn={wn}")
    x = rng.normal(size=2000)
    got = sosfilt(sos, T(x)).numpy()
    want = sps.sosfilt(sos_ref, x)
    np.testing.assert_allclose(got, want, atol=1e-5 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("seed", range(5))
def test_pfb_random_vs_einsum(seed):
    rng = np.random.default_rng(500 + seed)
    m = int(rng.choice([8, 16, 32, 64, 128]))
    tpc = int(rng.integers(2, 12))
    n = int(rng.integers(2, 6)) * m * tpc + int(rng.integers(0, m))
    x = rng.normal(size=n).astype(np.float32)
    ref = pfb_analyze(T(x), m, taps_per_channel=tpc, strategy="einsum").numpy()
    got = pfb_analyze(T(x), m, taps_per_channel=tpc).numpy()
    assert got.shape == ref.shape, (m, tpc, n)
    scale = max(1e-30, np.abs(ref).max())
    np.testing.assert_allclose(got, ref, atol=2e-6 * scale, err_msg=f"m={m} tpc={tpc} n={n}")


@pytest.mark.parametrize("seed", range(10))
def test_convolution_random_modes(seed):
    rng = np.random.default_rng(600 + seed)
    n = int(rng.integers(8, 2000))
    k = int(rng.integers(1, min(n, 200)))
    mode = str(rng.choice(["full", "same", "valid"]))
    method = str(rng.choice(["direct", "fft"]))
    cplx = bool(rng.integers(0, 2))
    x = rng.normal(size=n)
    h = rng.normal(size=k)
    if cplx:
        x = x + 1j * rng.normal(size=n)
        h = h + 1j * rng.normal(size=k)
    got = convolve(T(x), T(h), mode=mode, method=method).numpy()
    want = sps.convolve(x, h, mode=mode)
    assert got.shape == want.shape, (n, k, mode, method, cplx)
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=1e-4 * scale,
                               err_msg=f"n={n} k={k} {mode}/{method}")


@pytest.mark.parametrize("seed", range(8))
def test_short_time_fft_random_geometry(seed):
    rng = np.random.default_rng(700 + seed)
    wl = int(rng.choice([32, 48, 64, 100, 128]))
    hop = int(rng.integers(1, wl))
    mfft = wl + int(rng.integers(0, wl))
    fft_mode = str(rng.choice(["onesided", "twosided", "centered"]))
    n = int(rng.integers(wl + 1, 2000))
    w = rng.normal(size=wl) ** 2 + 0.1
    x = rng.normal(size=n)
    ours = ShortTimeFFT(w, hop=hop, fs=100.0, mfft=mfft, fft_mode=fft_mode)
    ref = sps.ShortTimeFFT(w, hop=hop, fs=100.0, mfft=mfft, fft_mode=fft_mode)
    za = ours.stft(T(x)).numpy()
    zb = ref.stft(x)
    assert za.shape == zb.shape, (wl, hop, mfft, fft_mode, n)
    scale = max(1.0, np.abs(zb).max())
    np.testing.assert_allclose(za, zb, atol=1e-4 * scale,
                               err_msg=f"wl={wl} hop={hop} mfft={mfft} {fft_mode} n={n}")


@pytest.mark.parametrize("seed", range(10))
def test_find_peaks_random_conditions(seed):
    rng = np.random.default_rng(800 + seed)
    n = int(rng.integers(32, 1500))
    x = np.cumsum(rng.normal(size=n))  # random walk: plateaus unlikely, rich peak structure
    kwargs = {}
    if rng.integers(0, 2):
        kwargs["height"] = float(rng.uniform(np.min(x), np.max(x)))
    if rng.integers(0, 2):
        kwargs["distance"] = int(rng.integers(1, 50))
    if rng.integers(0, 2):
        kwargs["prominence"] = float(rng.uniform(0.1, 3.0))
    if rng.integers(0, 2):
        kwargs["width"] = float(rng.uniform(1.0, 10.0))
    got = find_peaks(T(x), **kwargs)
    idx = got.indices.numpy()[: int(got.valid_count)]
    want, props = sps.find_peaks(x, **kwargs)
    np.testing.assert_array_equal(idx, want, err_msg=f"n={n} kwargs={kwargs}")
    if "prominence" in kwargs and len(want):
        np.testing.assert_allclose(got.properties["prominences"].numpy()[: len(want)],
                                   props["prominences"], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("seed", range(4))
def test_sharded_geometry_random(seed, sharded_fuzz):
    """Random mesh shape x signal length on 8 gloo ranks: the sharded FIR
    conv path against the single-device direct convolve."""
    mesh_shape, x, taps = ranks.fuzz_sharded_case(seed)
    got, want = sharded_fuzz[seed]
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max(),
                               err_msg=f"mesh={mesh_shape} n={x.shape[-1]} k={taps.shape[0]}")


@pytest.fixture(scope="module")
def sharded_fuzz(tmp_path_factory):
    return ranks.spawn(ranks.fuzz_sharded_cases, ranks.FUZZ_WORLD,
                       tmp_path_factory.mktemp("fuzz_sharded"))


@pytest.mark.parametrize("seed", range(6))
def test_streaming_random_chunking(seed):
    """Random chunk partitions through StreamingPFB / StreamingResamplePoly
    reproduce the offline ops wherever the block boundaries fall."""
    rng = np.random.default_rng(1000 + seed)
    if rng.integers(0, 2):
        m = int(rng.choice([8, 16, 32, 64]))
        tpc = int(rng.integers(2, 8))
        n_chunks = int(rng.integers(2, 6))
        chunks = [int(rng.integers(1, 6)) * m for _ in range(n_chunks)]
        while sum(chunks) < m * tpc:   # the offline oracle needs one window
            chunks.append(int(rng.integers(1, 6)) * m)
        x = rng.normal(size=sum(chunks)).astype(np.float32)
        pfb = StreamingPFB(m, taps_per_channel=tpc)
        state = pfb.init_state(device="cpu")
        outs, i = [], 0
        for c in chunks:
            state, z = pfb.process(state, T(x[i:i + c]))
            outs.append(z.numpy())
            i += c
        got = np.concatenate(outs, axis=0)[pfb.lead_frames:]
        ref = pfb_analyze(T(x), m, taps_per_channel=tpc).numpy()
        assert got.shape == ref.shape, (m, tpc, chunks)
        scale = max(1e-30, np.abs(ref).max())
        np.testing.assert_allclose(got, ref, atol=2e-5 * scale,
                                   err_msg=f"m={m} tpc={tpc} {chunks}")
    else:
        up = int(rng.integers(1, 8))
        down = int(rng.integers(1, 8))
        if up == down:
            up += 1
        sr = StreamingResamplePoly(up, down)
        d = sr._down if not sr._identity else down
        chunk = int(rng.integers(1, 20)) * d
        n = int(rng.integers(4, 12)) * chunk
        x = rng.normal(size=n).astype(np.float32)
        state = sr.init_state(device="cpu")
        outs = []
        for i in range(0, n, chunk):
            state, y = sr.process(state, T(x[i:i + chunk]))
            outs.append(y.numpy())
        ref = resample_poly(T(x), up, down).numpy()
        need = sr.lead_out + ref.shape[0]
        while sum(o.shape[-1] for o in outs) < need:
            state, y = sr.process(state, torch.zeros(chunk))
            outs.append(y.numpy())
        got = np.concatenate(outs)[sr.lead_out:need]
        scale = max(1.0, np.abs(ref).max())
        np.testing.assert_allclose(got, ref, atol=2e-5 * scale,
                                   err_msg=f"up={up} down={down} chunk={chunk} n={n}")
