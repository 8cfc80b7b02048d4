"""The PyTorch port's STFT+FIR chain as a whole, its design-time inputs
(windows, sinc, firwin) and its independence from JAX.

Tolerances:
* windows, sinc, firwin: 1e-6 absolute — the same f32 formulas; the two
  libraries' cos/sin and dot products may differ in the last ulp.
* stft_fir_chain / StftFirChain: 1e-4 x max|power| against the JAX
  stft_fir_chain(return_filtered=False), the JAX package's gate for f32
  contractions summed in different orders.
* the folded weights held by StftFirChain: bitwise (the same numpy f64 fold).
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
from nx_signal_tpu.models.pipeline import stft_fir_chain as jax_chain
from nx_signal_tpu.ops import filters as jfilt
from nx_signal_tpu.ops import waveforms as jwave
from nx_signal_tpu.ops import windows as jw
from nx_signal_tpu_torch.models.pipeline import StftFirChain, stft_fir_chain
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
    got = getattr(tw, name)(n, periodic=periodic)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("window", ["hann", "hamming", "blackman",
                                    ("general_cosine", [0.6, 0.4])])
@pytest.mark.parametrize("periodic", [True, False])
def test_get_window(window, periodic):
    want = np.asarray(jw.get_window(window, 33, periodic=periodic))
    got = tw.get_window(window, 33, periodic=periodic)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_general_cosine_and_unknown_window():
    np.testing.assert_allclose(
        tw.general_cosine(10, [0.5, 0.3, 0.2]).numpy(),
        np.asarray(jw.general_cosine(10, [0.5, 0.3, 0.2])), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="not yet ported"):
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
                       sampling_rate=rate)
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
    chain = StftFirChain.from_numpy(taps, window, stride=hop, n_fft=n_fft)
    assert dict(chain.named_buffers())["weights"] is chain.weights
    np.testing.assert_array_equal(chain.weights.numpy(),
                                  np.asarray(jax_fold(taps, window, n_fft, True)))
    want = np.asarray(jax_chain(jnp.asarray(x), taps, window, fft_length=n_fft,
                                overlap_length=frame - hop, return_filtered=False))
    assert_close_to_max(chain.to("cpu")(torch.from_numpy(x)), want.astype(np.float32))


@pytest.mark.cuda
def test_stft_fir_chain_frame_chunks_runs_kernel_on_cuda(rng):
    """frame_chunks only shapes the plain path: on the card the chain still
    launches kernel A, once, and agrees with the chunked plain path at
    1e-4 x max."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from nx_signal_tpu_torch.kernels import cuda_dft
    from nx_signal_tpu_torch.kernels.dft import fir_framed_dft

    x = torch.from_numpy(rng.normal(size=(2, 8192)).astype(np.float32)).cuda()
    taps, window = tfilt.firwin(255, [2000.0], sampling_rate=48000.0), tw.hann(512)
    before = cuda_dft.fir_framed_dft_power_cuda.launches
    got = stft_fir_chain(x, taps, window, fft_length=512, overlap_length=384,
                         return_filtered=False, frame_chunks=4)
    assert cuda_dft.fir_framed_dft_power_cuda.launches == before + 1
    want = fir_framed_dft(x, taps, window, stride=128, n_fft=512, onesided=True,
                          output="power", frame_chunks=4, kernel="torch")
    assert_close_to_max(got.cpu(), want.cpu())


def test_stft_fir_chain_unported_paths():
    x, taps, window = torch.zeros(2, 4096), np.ones(5) / 5, tw.hann(256)
    with pytest.raises(NotImplementedError, match="convolution"):
        stft_fir_chain(x, taps, window, fft_length=256, overlap_length=128)
    with pytest.raises(NotImplementedError, match="convolution"):
        stft_fir_chain(x, taps, tw.hann(2048), fft_length=2048, overlap_length=1024,
                       return_filtered=False)
    with pytest.raises(ValueError, match="shorter than the window"):
        StftFirChain.from_numpy(taps, window.numpy(), stride=64, n_fft=128)


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
        "p = nt.stft_fir_chain(x, nt.firwin(63, [0.2]), nt.hann(256), fft_length=256,\n"
        "                      overlap_length=192, return_filtered=False)\n"
        "y = nt.istft(nt.stft(x, nt.hann(256), overlap_length=192, onesided=True).z,\n"
        "             nt.hann(256), overlap_length=192, onesided=True)\n"
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
