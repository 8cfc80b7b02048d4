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


@pytest.mark.parametrize("name,pattern", [
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
