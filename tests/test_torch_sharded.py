"""Parity of the sharded port (nx_signal_tpu_torch/parallel/) with the JAX
package's sharded layer.

One gloo group of 4 CPU ranks, spawned once per test process and shared
with tests/test_torch_sharded_estimation.py (tests/torch_sharded_ranks.py,
which imports no JAX), runs every case and returns the gathered results; the tests here hold them against the JAX
functions on a 4-device slice of the CPU mesh of tests/conftest.py.

Tolerances, those of the port's single-device parity tests for the same
local op (oneDNN and XLA sum in other orders): 1e-5 of the max for the
convolutions and the chain (tests/test_torch_convolution.py,
tests/test_torch_pipeline.py), 1e-4 for stft / istft
(tests/test_torch_stft.py). Bitwise where the port holds itself: the plain
halo against the concat of the signal's slices, kernel E's plain version
against it, and the seeded sharded fold against the single-device fold.
(The sharded 'conv' is held at 1e-5 against the port's single-device
conv1d: oneDNN blocks its sums by the input length, so the bits differ.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nx_signal_tpu.ops import filters as jfilt
from nx_signal_tpu.ops import windows as jw
from nx_signal_tpu.parallel import sharded as js
from nx_signal_tpu.parallel.mesh import make_dsp_mesh as jax_mesh
from nx_signal_tpu_torch.parallel.mesh import channel_block_sharding, make_dsp_mesh

from tests import torch_sharded_ranks as ranks


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return ranks.cpu_results(tmp_path_factory)


def mesh4(shape):
    return jax_mesh(*shape, devices=jax.devices()[:4])


def assert_close_to_max(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("case", ranks.CONV_CASES, ids=str)
def test_sharded_convolve_same_matches_jax(case, results):
    mesh_shape, length, k, method = case
    x, taps = ranks.signal(1, (8, length)), ranks.signal(2, k)
    want = np.asarray(js.sharded_convolve_same(x, taps, mesh=mesh4(mesh_shape), method=method))
    got = results["conv", mesh_shape, length, k, method]
    assert got.dtype == np.float32
    assert_close_to_max(got, want, 1e-5)
    if method == "conv":  # oneDNN blocks its sums by the input length: not bitwise
        assert_close_to_max(got, results["conv_single", length, k], 1e-5)


def test_sharded_convolve_same_1d_input(results):
    x, taps = ranks.signal(3, 2048), ranks.signal(4, 33)
    want = np.asarray(js.sharded_convolve_same(x, taps, mesh=mesh4((1, 4))))
    assert results["conv_1d"].shape == (2048,)
    assert_close_to_max(results["conv_1d"], want, 1e-5)


def test_halo_matches_the_pallas_dma_halo(results):
    """The JAX DMA halo kernel in interpret mode, against the port's
    kernel E (its plain version on the CPU)."""
    x, taps = ranks.signal(1, (8, 4096)), ranks.signal(2, 255)
    want = np.asarray(js.sharded_convolve_same(x, taps, mesh=mesh4((1, 4)), method="conv",
                                               halo="pallas_dma"))
    assert_close_to_max(results["conv", (1, 4), 4096, 255, "conv"], want, 1e-5)


@pytest.mark.parametrize("rank", range(ranks.WORLD))
def test_plain_halo_is_the_concat(rank, results):
    """On every rank and pad pair (zero, one-sided, a whole block), the
    send/recv halo and kernel E's wrapper on a CPU tensor are bitwise the
    concat of the global signal's slices, and launch nothing."""
    assert results["halo_ok", rank] == [True] * len(ranks.HALO_PADS)


@pytest.mark.parametrize("case", ranks.CHAIN_CASES, ids=str)
def test_sharded_fir_framed_dft_power_matches_jax(case, results):
    mesh_shape, (channels, length, k, frame, hop, n_fft) = case
    x = ranks.signal(6, (channels, length))
    taps = np.asarray(jfilt.firwin(k, [2000.0], sampling_rate=48000.0))
    want = np.asarray(js.sharded_fir_framed_dft_power(
        x, taps, np.asarray(jw.hann(frame)), mesh=mesh4(mesh_shape), stride=hop, n_fft=n_fft))
    assert_close_to_max(results["chain", mesh_shape, length], want.astype(np.float32), 1e-5)
    # on a CPU tensor kernel A's wrapper runs its plain version
    assert all(results["chain_launches", mesh_shape, length, r] == 0 for r in range(4))


@pytest.mark.parametrize("case", ranks.STFT_CASES, ids=str)
def test_sharded_stft_and_istft_match_jax(case, results):
    mesh_shape, channels, length, frame, overlap, onesided = case
    x = ranks.signal(7, (channels, length))
    kw = dict(fft_length=frame, overlap_length=overlap, sampling_rate=8000.0,
              onesided=onesided)
    jmesh = mesh4(mesh_shape)
    z, times, freqs = js.sharded_stft(x, jw.hann(frame), mesh=jmesh, **kw)
    key = mesh_shape, length, onesided
    got_z, got_t, got_f = results["stft", key]
    assert got_z.dtype == np.complex64
    assert_close_to_max(got_z, np.asarray(z), 1e-4)
    np.testing.assert_allclose(got_t, np.asarray(times), rtol=1e-6)
    np.testing.assert_allclose(got_f, np.asarray(freqs), rtol=1e-6)
    # istft of the same spectrum: the port's stft output, given to both
    y = js.sharded_istft(jnp.asarray(got_z), jw.hann(frame), mesh=jmesh, **kw)
    assert_close_to_max(results["istft", key], np.asarray(y), 1e-4)


@pytest.mark.parametrize("case", ranks.STFT_CASES, ids=str)
def test_sharded_fold_is_the_single_device_fold(case, results):
    """The two-phase fold seeded with the left neighbour's tail, bitwise
    equal to the single-device fold of the same frames (padded frames
    included)."""
    mesh_shape, _, length, _, _, onesided = case
    sharded, single = results["fold", (mesh_shape, length, onesided)]
    assert sharded.shape == single.shape
    assert sharded.tobytes() == single.tobytes()


@pytest.mark.parametrize("case", ranks.OA_CASES, ids=str)
def test_sharded_oaconvolve_same_matches_jax(case, results):
    mesh_shape, length, k = case
    x, taps = ranks.signal(8, (4, length)), ranks.signal(9, k)
    want = np.asarray(js.sharded_oaconvolve_same(x, taps, mesh=mesh4(mesh_shape)))
    assert_close_to_max(results["oa", mesh_shape, length, k], want, 1e-5)


@pytest.mark.parametrize("case", ranks.SOS_CASES, ids=str)
def test_sharded_sosfilt_matches_jax(case, results):
    """At the JAX package's gate (tests/test_sharded.py:276-277), 1e-5 of
    the max, against the port's single-device sosfilt in every case, and
    against the JAX sharded_sosfilt on the 4-device mesh for the 2-section
    cases, the uneven 1-D one included (each call of the JAX function
    compiles its scans anew: 50-60 s a case on a CPU for 2 sections, about
    110 s for ellip8's 4); every case also 1e-4 of the max against scipy
    f64 (tests/test_sharded.py:286, :296)."""
    import scipy.signal as sps

    mesh_shape, design, channels, length = case
    sos, x = ranks.sos_design(design), ranks.sos_signal(channels, length)
    got = results["sos", mesh_shape, design, length]
    assert_close_to_max(got, results["sos_single", mesh_shape, design, length], 1e-5)
    assert_close_to_max(got, sps.sosfilt(sos, x.astype(np.float64)), 1e-4)
    if sos.shape[0] == 2:
        want = np.asarray(js.sharded_sosfilt(sos, x, mesh=mesh4(mesh_shape)))
        assert_close_to_max(got, want, 1e-5)


def test_sos_state_space_impulse_response():
    """The host (A, B, C, D) reproduces the sos impulse response
    (tests/test_sharded.py:298-312), and equals the JAX package's."""
    import scipy.signal as sps

    from nx_signal_tpu_torch.parallel import sharded as ts

    sos = sps.cheby1(6, 1.0, 0.25, output="sos")
    a_mat, b_vec, c_vec, d = ts._sos_state_space(sos)
    for got, want in zip((a_mat, b_vec, c_vec, d), js._sos_state_space(sos)):
        np.testing.assert_array_equal(got, want)
    imp = np.zeros(64)
    imp[0] = 1.0
    z, out = np.zeros(a_mat.shape[0]), np.empty(64)
    for i in range(64):
        out[i] = c_vec @ z + d * imp[i]
        z = a_mat @ z + b_vec * imp[i]
    np.testing.assert_allclose(out, sps.sosfilt(sos, imp), atol=1e-12, rtol=1e-10)
    obs = ts._observability(a_mat, c_vec, 100)
    row = c_vec
    for i in range(100):
        np.testing.assert_allclose(obs[i], row, atol=1e-14, rtol=1e-12)
        row = row @ a_mat


@pytest.mark.parametrize("case", ranks.UPFIRDN_CASES + [ranks.UPFIRDN_COMPLEX], ids=str)
def test_sharded_upfirdn_matches_jax(case, results):
    """Against the JAX sharded_upfirdn on the 4-device mesh at the f32
    parity gate (1e-5 of the max), and against the port's single-device
    upfirdn at the JAX package's sharded gate (rtol 2e-5, atol 2e-5 of the
    max; tests/test_sharded_resample.py:43-44); 1-D input stays 1-D, and a
    complex64 signal stays complex64 through the halo."""
    mesh_shape, channels, length, (up, down, k) = case
    complex_input = case == ranks.UPFIRDN_COMPLEX
    x = ranks.polyphase_signal(channels, length, complex_input)
    h = ranks.upfirdn_taps(k)
    key = mesh_shape, length, up, down, complex_input
    got, single = results["upfirdn", key], results["upfirdn_single", key]
    want = np.asarray(js.sharded_upfirdn(h, x, up, down, mesh=mesh4(mesh_shape)))
    assert got.dtype == (np.complex64 if complex_input else np.float32)
    assert_close_to_max(got, want, 1e-5)
    assert got.shape == single.shape
    np.testing.assert_allclose(got, single, rtol=2e-5, atol=2e-5 * np.abs(single).max())


@pytest.mark.parametrize("case", ranks.RESAMPLE_CASES, ids=str)
def test_sharded_resample_poly_matches_jax(case, results):
    """halo_right > 0 (the group delay in n_offset), an uneven length and
    the 160/441 ratio: against the JAX sharded_resample_poly at 1e-5 of
    the max, and against the port's single-device resample_poly at the JAX
    package's gate (rtol = atol = 1e-5; tests/test_sharded_resample.py:72-73)."""
    mesh_shape, channels, length, (up, down) = case
    x = ranks.polyphase_signal(channels, length)
    got = results["resample_poly", mesh_shape, length, up, down]
    single = results["resample_poly_single", mesh_shape, length, up, down]
    want = np.asarray(js.sharded_resample_poly(x, up, down, mesh=mesh4(mesh_shape)))
    assert_close_to_max(got, want, 1e-5)
    assert got.shape == single.shape
    np.testing.assert_allclose(got, single, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ranks.PFB_SHARDED_CASES, ids=str)
def test_sharded_pfb_analyze_matches_jax(case, results):
    """Against the JAX sharded_pfb_analyze at 1e-5 of the max, and against
    the port's single-device pfb_analyze at the JAX package's gate
    (rel_close, 1e-6; tests/test_sharded.py:221-242)."""
    mesh_shape, channels, length, (m, tpc) = case
    x = ranks.polyphase_signal(channels, length).astype(np.float32)
    got = results["pfb", mesh_shape, length, m]
    single = results["pfb_single", mesh_shape, length, m]
    want = np.asarray(js.sharded_pfb_analyze(x, m, mesh=mesh4(mesh_shape),
                                             taps_per_channel=tpc))
    assert got.dtype == np.complex64
    assert_close_to_max(got, want, 1e-5)
    assert got.shape == single.shape
    scale = np.abs(single).max()
    np.testing.assert_allclose(got, single, rtol=1e-6, atol=1e-6 * scale)


@pytest.mark.parametrize("name,pattern", [
    ("polyphase_halo", r"polyphase halo \(599\) exceeds the per-device block \(278\); use "
                       r"fewer blocks or a shorter filter"),
    ("pfb_halo", r"frame halo \(448\) exceeds the per-device block \(256\)"),
    ("pfb_taps", r"prototype length \(100\) must be a multiple of n_channels \(16\)"),
    ("sos_shape", r"sos array must be shape \(n_sections, 6\)"),
    ("sos_channels", r"channels \(3\) must be divisible by 2"),
    ("halo", r"filter halo \(32\) exceeds the per-device block \(8\)"),
    ("chain_halo", r"chain halo \(left 150, right 534\) exceeds the per-device block \(512\)"),
    ("channels", r"channels \(3\) must be divisible by 2"),
    ("kernel_halo", r"halo \(17\) exceeds the per-device block \(16\)"),
    ("frame_halo", r"frame halo \(448\) exceeds the per-device block \(256\)"),
    ("mesh", r"mesh shape \(3, 1\) does not match 4 devices"),
])
def test_error_paths(name, pattern, results):
    import re

    assert results["errors"][name] is not None and re.search(pattern, results["errors"][name])


def test_jax_raises_the_same_errors():
    """The JAX package's messages for the errors the ranks hit."""
    with pytest.raises(ValueError, match=r"filter halo \(32\) exceeds"):
        js.sharded_convolve_same(np.zeros((1, 32), np.float32), np.zeros(33, np.float32),
                                 mesh=mesh4((1, 4)), method="conv")
    with pytest.raises(ValueError, match=r"channels \(3\) must be divisible by 2"):
        js.sharded_convolve_same(np.zeros((3, 4096), np.float32), np.zeros(5, np.float32),
                                 mesh=mesh4((2, 2)))


def test_jax_raises_the_same_polyphase_errors():
    """The JAX package's messages for the polyphase errors the ranks hit."""
    mesh = mesh4((1, 4))
    with pytest.raises(ValueError, match=r"polyphase halo \(599\) exceeds the per-device "
                                         r"block \(278\); use fewer blocks or a shorter filter"):
        js.sharded_upfirdn(np.ones(600, np.float32), np.zeros((1, 512), np.float32), 1, 1,
                           mesh=mesh)
    with pytest.raises(ValueError, match=r"frame halo \(448\) exceeds the per-device block"):
        js.sharded_pfb_analyze(np.zeros((1, 1024), np.float32), 64, mesh=mesh,
                               taps_per_channel=8)
    with pytest.raises(ValueError, match=r"prototype length \(100\) must be a multiple"):
        js.sharded_pfb_analyze(np.zeros((1, 4096), np.float32), 16, mesh=mesh,
                               taps=np.ones(100))


def test_mesh_needs_a_group_and_the_card_unless_asked(monkeypatch):
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_dsp_mesh(1, 4, device_type="cpu")
    from nx_signal_tpu_torch.parallel import mesh as tm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm._rank_device("cuda")
    assert tm._rank_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("ndim,want", [(1, ("Replicate()", "Shard(dim=0)")),
                                       (2, ("Shard(dim=0)", "Shard(dim=1)")),
                                       (3, ("Shard(dim=0)", "Shard(dim=2)"))])
def test_channel_block_sharding(ndim, want):
    assert tuple(map(repr, channel_block_sharding(None, ndim=ndim))) == want


def test_chip_smoke_phase8_on_cpu_ranks():
    """chip_smoke.py's phase-8 rank program on 4 CPU ranks at a small size,
    with the plain versions (the card's launch gates and timings are
    skipped): the paths, shapes and checks the card runs, rehearsed."""
    import chip_smoke

    before = {pid for pid, _ in chip_smoke._live_children()}
    reports = chip_smoke._phase8(4, "cpu", dict(channels=8, length=16384, small_channels=4,
                                                block=4096))
    assert [r["rank"] for r in reports] == [0, 1, 2, 3]
    assert all(set(r["launches"].values()) == {0} for r in reports)
    # the ranks are reaped and no helper process outlives the phase
    assert [c for c in chip_smoke._live_children() if c[0] not in before] == []
