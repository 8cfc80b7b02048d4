"""The hand-written kernels on the card, against their plain versions.

Every test here is marked `cuda` and skips where there is no CUDA device.
The file imports neither JAX nor the JAX package, so on a machine with an
NVIDIA GPU (and nvcc, but no JAX) it runs on its own, from the repository
root:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances: the contraction kernels (A, A-tc, B, D) and the FFT kernel
(B-fft) against their plain versions per bin at 1e-4 of the bin's max, or
at 1e-4 x max where the plain version sums in f32 too (the gate of
chip_smoke.py); the overlap-add (C, with and without a seed) and the halo
exchange (E) bitwise.
"""

import functools

import numpy as np
import pytest
import torch

from nx_signal_tpu_torch.kernels import cuda_dft
from nx_signal_tpu_torch.kernels.cuda_dft import _ola_fold_torch
from nx_signal_tpu_torch.kernels import dft as td
from nx_signal_tpu_torch.models.pipeline import FIRFilterChain, stft_fir_chain
from nx_signal_tpu_torch.ops import filters as tfilt
from nx_signal_tpu_torch.ops import windows as tw


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")


def assert_close_to_max(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def hann_np(n):
    return tw.hann(n, dtype=torch.float64, device="cpu").numpy()


def assert_close_per_bin(got, want, rel=1e-4):
    got, want = got.cpu(), want.cpu()
    assert got.shape == want.shape
    err = (got - want).abs().reshape(-1, want.shape[-1]).amax(0)
    scale = want.abs().reshape(-1, want.shape[-1]).amax(0)
    assert float((err / scale).max()) <= rel


@pytest.mark.cuda
@pytest.mark.parametrize("power", [True, False])
def test_framed_dft_kernel_matches_plain_on_cuda(power, rng):
    """Kernels A and B against their plain versions at 1e-4 x max
    (chip_smoke.py is the check that runs them at the main path's
    shapes); framed_dft takes B-fft at n_fft 1031, 2048, 4093, 4096, 8191,
    8192, 12289, 16382, 16384, 16400 and 65536 and at a frame longer than
    n_fft (400 at n_fft 256), and the dense B only outside B-fft's range (4
    and 65537)."""
    need_cuda()
    x = torch.from_numpy(rng.normal(size=(3, 20000)).astype(np.float32)).cuda()
    taps, window = rng.normal(size=100), hann_np(400)
    kw = dict(stride=150, n_fft=512, onesided=True, output="power")
    before = cuda_dft.fir_framed_dft_power_cuda.launches
    got = td.fir_framed_dft(x, taps, window, **kw)
    assert cuda_dft.fir_framed_dft_power_cuda.launches == before + 1
    assert_close_to_max(got.cpu(), td.fir_framed_dft(x, taps, window, kernel="torch",
                                                     **kw).cpu())
    output = "power" if power else "complex"
    kw = dict(stride=150, n_fft=512, onesided=True, output=output)
    before = cuda_dft.framed_fft_cuda.launches
    got = td.framed_dft(x, window, **kw)
    assert cuda_dft.framed_fft_cuda.launches == before + 1
    assert_close_to_max(got.cpu(), td.framed_dft(x.cpu(), window, **kw))
    for n_fft in (1031, 2048, 4093, 4096, 8191, 8192, 12289, 16382, 16384, 16400, 65536, 256):
        kw = dict(stride=150, n_fft=n_fft, onesided=True, output=output)
        before = (cuda_dft.framed_fft_cuda.launches, cuda_dft.framed_dft_cuda.launches)
        got = td.framed_dft(x, window, **kw)
        assert (cuda_dft.framed_fft_cuda.launches,
                cuda_dft.framed_dft_cuda.launches) == (before[0] + 1, before[1])
        assert_close_to_max(got.cpu(), td.framed_dft(x.cpu(), window, **kw))
    for n_fft in (4, 65537):   # outside B-fft's range
        kw = dict(stride=150, n_fft=n_fft, onesided=True, output=output)
        before = (cuda_dft.framed_fft_cuda.launches, cuda_dft.framed_dft_cuda.launches)
        got = td.framed_dft(x, window, **kw)
        assert (cuda_dft.framed_fft_cuda.launches,
                cuda_dft.framed_dft_cuda.launches) == (before[0], before[1] + 1)
        assert_close_to_max(got.cpu(), td.framed_dft(x.cpu(), window, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [  # channels, length, frame, hop, n_fft, onesided
    (4, 48000, 512, 128, 512, True),
    (2, 30000, 512, 128, 512, False),   # the full spectrum
    (3, 20001, 400, 150, 512, True),    # frame < n_fft, a hop that does not divide it
    (2, 20000, 12, 5, 16, True),
    (2, 20001, 5, 3, 8, False),
    (2, 30001, 1024, 1000, 1024, True),
    (3, 20001, 400, 160, 400, True),    # the mixed-radix kernel: Whisper's n_fft
    (3, 20001, 441, 147, 441, False),   # odd n_fft, two frames per FFT
    (2, 20001, 512, 128, 600, True),    # frame < n_fft
    (2, 30001, 1000, 250, 1000, False),
    (3, 20001, 512, 128, 572, True),    # 2^2 * 11 * 13: radices 2, 13, 11
    (2, 20001, 512, 128, 1021, True),   # a prime: Bluestein, M = 2048, two frames per FFT
    (2, 20001, 1018, 128, 1018, False),  # 2 * 509: Bluestein, M = 1024
    (3, 20001, 900, 333, 997, True),    # a prime, M = 2048
    (2, 20001, 1031, 256, 1031, True),  # a prime, M = 2079 (13-smooth, P / S = 1.97)
    (2, 30001, 2048, 512, 2048, True),  # radix 8 on the persistent loop kernel
    (1, 30001, 4093, 1024, 4093, True),  # a prime, M = 8192
    (2, 30001, 4094, 1024, 4094, False),  # 2 * 23 * 89: Bluestein, M = 4096
    (1, 40001, 4096, 1024, 4096, True),  # radix 8 on the loop kernel, M = 2048
    (2, 20001, 1024, 128, 512, True),   # a frame of 2 x n_fft, folded
    (1, 40001, 8192, 1024, 4096, False),  # the same past 4096
    (1, 40001, 8186, 1024, 4093, True),  # and on Bluestein's M = 8192 (the mixed kernel)
    (1, 70001, 8191, 2048, 8191, True),  # a prime: M = 16384 over a cluster of 2 CTAs
    (1, 70001, 8192, 2048, 8192, False),  # radix 8 on 1024 threads
    (1, 70001, 12000, 3000, 12000, True),  # 13-smooth past 4096: the frames from global memory
    (1, 100001, 12289, 3072, 12289, True),  # a prime: M = 24640 over a cluster of 2 CTAs
    (1, 100001, 16381, 4095, 16381, True),  # 3 * 43 * 127: M = 32768 over a cluster of 4 CTAs
    (1, 100001, 15625, 3906, 15625, False),  # 5^6, L = 15625 over a cluster of 2 CTAs
    (1, 100001, 16382, 4096, 16382, True),  # 2 * 8191: M = 16384 over a cluster
    (1, 100001, 16384, 4096, 16384, False),  # radix 8 on 1024 threads
    (1, 80001, 16384, 2048, 8192, True),  # a frame of 2 x 8192, folded
    # past 16384, a frame of 512 zero-padded (the plain weights of a full
    # frame pass 17 GB at 65536: test_framed_fft_long_frames_on_cuda holds
    # those against an f64 FFT)
    (1, 100001, 512, 5000, 20000, True),    # 13-smooth, L = 10000 on one CTA
    (1, 200001, 512, 10000, 40000, False),  # 13-smooth, L = 20000 over a cluster of 2
    (1, 100001, 512, 4921, 19683, True),    # 3^9: radix 9, odd L over a cluster of 2
    (2, 300001, 512, 14762, 59049, False),  # 3^10, odd L = 59049 over a cluster of 8
    (1, 200001, 512, 8192, 32768, True),    # radix 8 on the mixed kernel, a cluster of 2
    (1, 300001, 512, 16384, 65536, False),  # B-fft's largest: L = 32768, a cluster of 4
    (1, 150001, 512, 8187, 32749, True),    # a prime: M = 65536 over a cluster of 8
    (1, 300001, 512, 16383, 65534, True),   # 2 * 7 * 31 * 151: M = 65536, even n_fft
    (2, 300001, 512, 16383, 65535, False),  # 3 * 5 * 17 * 257: M = 131072, a cluster of 16
])
@pytest.mark.parametrize("output", ["complex", "power"])
def test_framed_fft_kernel_matches_plain_on_cuda(geometry, output, rng):
    """Kernel B-fft (an FFT per frame: radix 8 for a power of two, the
    mixed-radix plan for a 13-smooth n_fft, Bluestein's otherwise; a frame
    longer than n_fft folded modulo n_fft) against its plain version (the
    dense contraction), per bin at 1e-4 of the bin's max."""
    need_cuda()
    ch, n, frame, hop, n_fft, onesided = geometry
    x = torch.from_numpy(rng.normal(size=(ch, n)).astype(np.float32)).cuda()
    window = hann_np(frame)
    kw = dict(stride=hop, n_fft=n_fft, onesided=onesided, output=output)
    before = cuda_dft.framed_fft_cuda.launches
    got = cuda_dft.framed_fft_cuda(x, window, **kw)
    assert cuda_dft.framed_fft_cuda.launches == before + 1
    assert got.dtype == (torch.float32 if output == "power" else torch.complex64)
    assert_close_per_bin(got, cuda_dft.framed_fft_cuda(x.cpu(), window, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft", [20000, 19683, 32749, 32768, 59049, 65534, 65535, 65536])
def test_framed_fft_long_frames_on_cuda(n_fft, rng):
    """Kernel B-fft past 16384 at a hann frame of n_fft and hop n_fft / 4
    (the frames read from global memory, a cluster of CTAs) against the f64
    torch.fft of the same f32 frames, per bin at 1e-4 of the bin's max."""
    need_cuda()
    hop = n_fft // 4
    x = torch.from_numpy(rng.normal(size=(2, 6 * n_fft)).astype(np.float32)).cuda()
    window = hann_np(n_fft)
    before = cuda_dft.framed_fft_cuda.launches
    got = td.framed_dft(x, window, stride=hop, n_fft=n_fft, onesided=True)
    assert cuda_dft.framed_fft_cuda.launches == before + 1
    frames = x.double().unfold(-1, n_fft, hop) * torch.from_numpy(window).cuda()
    assert_close_per_bin(got, torch.fft.rfft(frames, n=n_fft))


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [  # channels, length, taps, frame, hop, n_fft
    (2, 70001, 255, 4096, 4096, 4096),   # A's window of 16 frames: 311 568 B, over the 232 448
    (2, 60001, 255, 3072, 3072, 3072),   # 241 936 B
    (3, 60001, 100, 1024, 3001, 1024),   # a hop past the frame, no multiple of 4
])
def test_a_kernel_streams_x_at_any_hop_on_cuda(geometry, rng):
    """Kernel A where the staged window of x does not fit in shared memory
    (it streams x through its weight ring) against its plain version per
    bin at 1e-4, and bitwise equal to every other frame at half the hop,
    where the window is staged: one fmaf chain per frame in increasing k
    either way."""
    need_cuda()
    ch, n, k, frame, hop, n_fft = geometry
    x = torch.from_numpy(rng.normal(size=(ch, n)).astype(np.float32)).cuda()
    w = td.fir_dft_fold_weights(rng.normal(size=k), hann_np(frame), n_fft, True, device="cuda")
    bins = n_fft // 2 + 1
    args = dict(pad_left=td._same_pad_left(k), bins=bins)
    frames = (n - frame) // hop + 1
    got = cuda_dft.fir_framed_dft_power_cuda(x, w, stride=hop, num_frames=frames, **args)
    assert_close_per_bin(got, td._framed_matmul_torch(x.cpu(), w.cpu(), power=True, stride=hop,
                                                      num_frames=frames, **args))
    if hop % 2 == 0:
        half = cuda_dft.fir_framed_dft_power_cuda(x, w, stride=hop // 2,
                                                  num_frames=2 * frames - 1, **args)
        assert torch.equal(got, half[:, ::2])
    # kernel B's wrapper on the same weights: the [Re | Im] output, no pad
    kw = dict(stride=hop, num_frames=frames, bins=bins)
    acc = td._framed_matmul_torch(x.cpu(), w.cpu(), pad_left=0, power=False, **kw)
    assert_close_per_bin(cuda_dft.framed_dft_cuda(x, w, **kw),
                         torch.complex(acc[..., :bins], acc[..., bins:]))


@pytest.mark.cuda
def test_stft_fir_chain_at_a_long_hop_on_cuda(rng):
    """StftFirChain at n_fft 4096, hop 4096 (kernel A streaming x), once,
    against its plain version per bin at 1e-4."""
    need_cuda()
    from nx_signal_tpu_torch.models.pipeline import StftFirChain

    x = torch.from_numpy(rng.normal(size=(2, 100000)).astype(np.float32))
    taps = tfilt.firwin(255, [2000.0], sampling_rate=48000.0, device="cpu").numpy()
    chain = StftFirChain.from_numpy(taps, hann_np(4096), stride=4096, n_fft=4096)
    before = cuda_dft.fir_framed_dft_power_cuda.launches
    got = chain(x.cuda())
    assert cuda_dft.fir_framed_dft_power_cuda.launches == before + 1
    assert_close_per_bin(got, chain.to("cpu")(x))


@pytest.mark.cuda
def test_sharded_chain_at_a_long_hop_bitwise_on_cuda(tmp_path):
    """Two ranks on cuda:0: sharded_fir_framed_dft_power at hop 4096 (kernel
    A streaming x; no right halo where the hop passes the frame) bitwise
    equal to the single-device chain on every rank."""
    need_cuda()
    from tests import torch_sharded_ranks as ranks

    assert ranks.spawn(ranks.cuda_long_hop_chain_case, 2, tmp_path) == [True, True]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("geometry", [  # channels, length, taps, frame, hop, n_fft
    (3, 20000, 255, 512, 128, 512),
    (2, 12001, 100, 400, 150, 512),     # even taps, a hop that does not divide the frame
])
def test_tc_kernel_matches_plain_on_cuda(precision, geometry, rng):
    """Kernel A-tc against its plain version (the same TF32 products summed
    in f64), per bin at 1e-4; fir_framed_dft launches it for 'high' and
    'default' and kernel A for 'highest'."""
    need_cuda()
    ch, n, k, frame, hop, n_fft = geometry
    x = torch.from_numpy(rng.normal(size=(ch, n)).astype(np.float32)).cuda()
    taps, window = rng.normal(size=k), hann_np(frame)
    kw = dict(stride=hop, n_fft=n_fft, onesided=True, output="power")
    before = (cuda_dft.fir_framed_dft_power_cuda.launches,
              cuda_dft.fir_framed_dft_power_tc_cuda.launches)
    got = td.fir_framed_dft(x, taps, window, precision=precision, **kw)
    td.fir_framed_dft(x, taps, window, precision="highest", **kw)
    assert (cuda_dft.fir_framed_dft_power_cuda.launches,
            cuda_dft.fir_framed_dft_power_tc_cuda.launches) == (before[0] + 1, before[1] + 1)
    assert_close_per_bin(got, td.fir_framed_dft(x.cpu(), taps, window, precision=precision,
                                                **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("geometry", [  # channels, length, taps, frame, hop, n_fft, weights
    (3, 20000, 255, 512, 128, 512, "fold"),     # the bench chain's shape: packed weights
    (2, 12001, 31, 441, 147, 441, "fold"),      # odd n_fft: not packed
    (2, 12001, 63, 384, 128, 512, "random"),    # arbitrary weights: not packed
    (2, 40001, 64, 1024, 256, 1024, "fold"),    # 128 frames per CTA
])
def test_tc_kernel_layouts_match_plain_on_cuda(precision, geometry, rng):
    """Kernel A-tc with packed (256 slots for 257 bins) and unpacked weights
    against its plain version per bin at 1e-4 of the bin's max."""
    need_cuda()
    ch, n, k, frame, hop, n_fft, kind = geometry
    x = torch.from_numpy(rng.normal(size=(ch, n)).astype(np.float32)).cuda()
    bins = n_fft // 2 + 1
    if kind == "fold":
        w = td.fir_dft_fold_weights(rng.normal(size=k), hann_np(frame), n_fft, True, device="cuda")
    else:
        w = torch.from_numpy(rng.normal(size=(frame + k - 1, 2 * bins)).astype(np.float32)).cuda()
    assert cuda_dft._a_packs(w, bins) == (kind == "fold" and n_fft % 2 == 0)
    assert cuda_dft._tc_takes(hop, w.shape[0])
    args = dict(stride=hop, pad_left=td._same_pad_left(k),
                num_frames=(n - frame) // hop + 1, bins=bins, precision=precision)
    before = cuda_dft.fir_framed_dft_power_tc_cuda.launches
    got = cuda_dft.fir_framed_dft_power_tc_cuda(x, w, **args)
    assert cuda_dft.fir_framed_dft_power_tc_cuda.launches == before + 1
    assert_close_per_bin(got, cuda_dft.fir_framed_dft_power_tc_cuda(x.cpu(), w.cpu(), **args))


@pytest.mark.cuda
def test_packed_kernels_nan_bins_match_plain_on_cuda(rng):
    """One inf sample: kernels A and A-tc (packed weights) give NaN at the
    same bins as their plain versions (the DC bin of the frames holding it,
    where x @ W meets the zero Im column; every bin at 'high', whose x_lo =
    inf - inf is NaN) and agree elsewhere."""
    need_cuda()
    x = rng.normal(size=(2, 6000)).astype(np.float32)
    x[0, 500] = np.inf
    x = torch.from_numpy(x)
    w = td.fir_dft_fold_weights(rng.normal(size=31), hann_np(64), 64, True, device="cpu")
    args = dict(stride=16, pad_left=td._same_pad_left(31), num_frames=(6000 - 64) // 16 + 1,
                bins=33)
    assert cuda_dft._a_packs(w, 33)
    for fn, kw in ((cuda_dft.fir_framed_dft_power_cuda, {}),
                   (cuda_dft.fir_framed_dft_power_tc_cuda, dict(precision="high")),
                   (cuda_dft.fir_framed_dft_power_tc_cuda, dict(precision="default"))):
        got = fn(x.cuda(), w.cuda(), **args, **kw).cpu()
        want = fn(x, w, **args, **kw)
        assert torch.isnan(want).any()
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(torch.isinf(got), torch.isinf(want))
        finite = torch.isfinite(want)
        assert_close_per_bin(torch.where(finite, got, 0.0), torch.where(finite, want, 0.0))


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [  # channels, length, taps, frame, hop, n_fft, weights
    (3, 20000, 255, 512, 128, 512, "fold"),     # the bench chain's shape: packed weights
    (2, 12001, 100, 400, 150, 600, "fold"),     # a hop that is no multiple of 4: scalar x loads
    (2, 40001, 64, 1024, 1000, 1024, "fold"),   # the 16-frame tile
    (2, 12001, 31, 441, 147, 441, "fold"),      # odd n_fft: not packed
    (2, 12001, 63, 384, 128, 512, "random"),    # arbitrary weights: not packed
])
def test_a_kernel_matches_plain_on_cuda(geometry, rng):
    """Kernel A (the register-tiled exact-f32 contraction) against its
    plain version per bin at 1e-4 of the bin's max, power and, through
    kernel B's wrapper, the [Re | Im] output of the same weights."""
    need_cuda()
    ch, n, k, frame, hop, n_fft, kind = geometry
    x = torch.from_numpy(rng.normal(size=(ch, n)).astype(np.float32)).cuda()
    bins = n_fft // 2 + 1
    if kind == "fold":
        w = td.fir_dft_fold_weights(rng.normal(size=k), hann_np(frame), n_fft, True, device="cuda")
    else:
        w = torch.from_numpy(rng.normal(size=(frame + k - 1, 2 * bins)).astype(np.float32)).cuda()
    args = dict(stride=hop, pad_left=td._same_pad_left(k),
                num_frames=(n - frame) // hop + 1, bins=bins)
    before = cuda_dft.fir_framed_dft_power_cuda.launches
    got = cuda_dft.fir_framed_dft_power_cuda(x, w, **args)
    assert cuda_dft.fir_framed_dft_power_cuda.launches == before + 1
    assert_close_per_bin(got, td._framed_matmul_torch(x.cpu(), w.cpu(), power=True, **args))
    kw = dict(stride=hop, num_frames=args["num_frames"] - 1, bins=bins)
    acc = td._framed_matmul_torch(x.cpu(), w.cpu(), pad_left=0, power=False, **kw)
    assert_close_per_bin(cuda_dft.framed_dft_cuda(x, w, **kw),
                         torch.complex(acc[..., :bins], acc[..., bins:]))


@pytest.mark.cuda
def test_overlap_add_kernel_bitwise_on_cuda(rng):
    need_cuda()
    frames = torch.from_numpy(rng.normal(size=(2, 40, 400)).astype(np.float32)).cuda()
    got = cuda_dft.overlap_add_cuda(frames, stride=150, out_length=40 * 150 + 250)
    want = _ola_fold_torch(frames, 150, 40 * 150 + 250).cpu()
    assert got.cpu().numpy().tobytes() == want.numpy().tobytes()


@pytest.mark.cuda
def test_halo_kernel_and_seeded_overlap_add_bitwise_on_cuda(tmp_path):
    """Two ranks sharing cuda:0 (a gloo group; CUDA IPC between the
    processes): kernel E against the send/recv halo, bitwise, for f32 with
    hl = 128, hr = 127, for hl = 1, hr = 0, for f64, and for complex64 (8-byte
    elements, the two parts moved together); kernel C with a
    seed (some of it -0.0) against the plain seeded fold, bitwise."""
    need_cuda()
    from tests import torch_sharded_ranks as ranks

    assert ranks.spawn(ranks.cuda_halo_case, 2, tmp_path) == [True] * 5


@pytest.mark.cuda
def test_halo_kernel_back_to_back_on_four_ranks_on_cuda(tmp_path):
    """Four ranks sharing cuda:0, meshes (1, 4) and (2, 2): kernel E's
    steady-state calls, back to back with fresh blocks and a delayed rank,
    take no collective and no sync (those raise during them); f32 and f64,
    pads (1, 0) and (0, 4), a call on a side stream and a call that grows
    the buffers; every result bitwise equal to the send/recv halo."""
    need_cuda()
    from tests import torch_sharded_ranks as ranks

    verdicts = ranks.spawn(ranks.cuda_halo_stream_case, ranks.WORLD, tmp_path)
    calls = 1 + len(ranks.HALO_CALLS) + 3
    assert len(verdicts) == 2 * calls * ranks.WORLD
    assert [k for k, ok in verdicts.items() if not ok] == []


@pytest.mark.cuda
def test_four_ranks_started_through_multihost_on_cuda(tmp_path):
    """Four ranks started through `multihost.initialize(address, 4, rank)`
    and `make_pod_mesh(1)`: gloo where they share one card, NCCL for CUDA
    tensors with gloo for host ones where each has its own. Kernel E
    bitwise against the send/recv halo (f32, f64), sharded_welch through B-fft
    and E within 1e-5 x max of welch, and an all-reduce of a host tensor,
    on every rank."""
    need_cuda()
    import socket

    from tests import torch_sharded_ranks as ranks

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    reports = ranks.spawn(functools.partial(ranks.cuda_multihost_case, port), ranks.WORLD,
                          tmp_path)
    own = torch.cuda.device_count() >= ranks.WORLD
    assert [r["rank"] for r in reports] == list(range(ranks.WORLD))
    assert [r["device"] for r in reports] == (list(range(ranks.WORLD)) if own
                                              else [0] * ranks.WORLD)
    assert {r["backend"] for r in reports} == {"cpu:gloo,cuda:nccl" if own else "gloo"}
    assert [(r["rank"], k) for r in reports for k, ok in r["verdicts"].items() if not ok] == []
    assert all(len(r["verdicts"]) == 4 for r in reports)


@pytest.mark.cuda
def test_stft_fir_chain_frame_chunks_runs_kernel_on_cuda(rng):
    """frame_chunks only shapes the plain path: on the card the chain still
    launches kernel A, once, and agrees with the chunked plain path at
    1e-4 x max."""
    need_cuda()
    x = torch.from_numpy(rng.normal(size=(2, 8192)).astype(np.float32)).cuda()
    taps = tfilt.firwin(255, [2000.0], sampling_rate=48000.0, device="cpu")
    window = tw.hann(512, device="cpu")
    before = cuda_dft.fir_framed_dft_power_cuda.launches
    got = stft_fir_chain(x, taps, window, fft_length=512, overlap_length=384,
                         return_filtered=False, frame_chunks=4)
    assert cuda_dft.fir_framed_dft_power_cuda.launches == before + 1
    want = td.fir_framed_dft(x, taps, window, stride=128, n_fft=512, onesided=True,
                             output="power", frame_chunks=4, kernel="torch")
    assert_close_to_max(got.cpu(), want.cpu())


@pytest.mark.cuda
def test_filtered_chain_runs_kernels_b_and_c_on_cuda(rng):
    """On the card the filtered chain frames with kernel B-fft and FIRFilterChain
    overlap-adds with kernel C; both agree with the CPU at 1e-4 x max."""
    need_cuda()
    x = rng.normal(size=(2, 8192)).astype(np.float32)
    taps = tfilt.firwin(255, [2000.0], sampling_rate=48000.0, device="cpu")
    window = tw.hann(512, device="cpu")
    before_b, before_c = cuda_dft.framed_fft_cuda.launches, cuda_dft.overlap_add_cuda.launches
    y, p = stft_fir_chain(torch.from_numpy(x).cuda(), taps, window, fft_length=512,
                          overlap_length=384)
    filtered = FIRFilterChain()(torch.from_numpy(x).cuda())
    assert cuda_dft.framed_fft_cuda.launches == before_b + 1
    assert cuda_dft.overlap_add_cuda.launches == before_c + 1
    want_y, want_p = stft_fir_chain(torch.from_numpy(x), taps, window, fft_length=512,
                                    overlap_length=384)
    assert_close_to_max(y.cpu(), want_y)
    assert_close_to_max(p.cpu(), want_p)
    assert_close_to_max(filtered.cpu(), FIRFilterChain()(torch.from_numpy(x)))


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [  # batch, length, taps, stride, n_fft, window
    ((2,), 5000, 255, 128, 512, "hann"),
    ((3, 2), 9000, 63, 128, 512, "blackman"),
    ((1,), 4000, 1, 256, 512, "hamming"),
    ((2,), 20000, 129, 128, 1024, "hann"),
    ((1,), 50001, 64, 1000, 2000, "hann"),   # the 16-block tile
    ((1,), 30001, 32, 50, 400, "blackman"),  # a hop that is not a multiple of 4
    ((1,), 20000, 17, 34, 374, "hann"),      # 188 bins: the last tile ends on its edge
    ((2,), 20000, 129, 128, 1024, "blackman"),  # 2 neighbour bins, J = 8
])
def test_shared_kernel_matches_plain_on_cuda(geometry, rng):
    """Kernel D against its plain version, per bin at 1e-4 of the bin's
    max, on the geometries of the JAX package's shared-kernel tests, a hop
    of 1000 (the 16-block tile), a hop of 50 (x read as scalars), bins that
    end on a tile's edge and Blackman at n_fft 1024; and edge='conv' /
    edge='pad' both run kernel A, with equal results."""
    need_cuda()
    batch, length, k, stride, n_fft, wname = geometry
    x = rng.normal(size=(*batch, length)).astype(np.float32)
    taps = rng.normal(size=k).astype(np.float32)
    window = getattr(tw, wname)(n_fft, dtype=torch.float64, device="cpu").numpy()
    coeffs = td.recognize_cosine_window(window, n_fft)
    xc = torch.from_numpy(x).cuda()
    before = cuda_dft.fir_framed_dft_power_shared_cuda.launches
    got = td.fir_framed_dft_shared(xc, taps, stride=stride, n_fft=n_fft, window_coeffs=coeffs,
                                   onesided=True, output="power").cpu()
    assert cuda_dft.fir_framed_dft_power_shared_cuda.launches == before + 1
    want = td.fir_framed_dft_shared(torch.from_numpy(x), taps, stride=stride, n_fft=n_fft,
                                    window_coeffs=coeffs, onesided=True, output="power")
    per_bin = ((got - want).abs().reshape(-1, want.shape[-1]).amax(0)
               / want.abs().reshape(-1, want.shape[-1]).amax(0))
    assert float(per_bin.max()) <= 1e-4
    kw = dict(stride=stride, n_fft=n_fft, onesided=True, output="power")
    before = cuda_dft.fir_framed_dft_power_cuda.launches
    conv = td.fir_framed_dft(xc, taps, window, edge="conv", **kw)
    assert torch.equal(conv, td.fir_framed_dft(xc, taps, window, edge="pad", **kw))
    assert cuda_dft.fir_framed_dft_power_cuda.launches == before + 2


@pytest.mark.cuda
def test_shared_kernel_nan_bins_match_plain_on_cuda(rng):
    """Kernel D on a signal holding an inf, a NaN and a sample whose power
    overflows f32 (the bench chain's 255 taps, hann 512, hop 128): the same
    frames and bins come out NaN and inf as in the plain version, whose
    sums meet them in the same products, and the finite bins agree per bin
    at 1e-4 of the bin's max."""
    need_cuda()
    x = rng.normal(size=(2, 8000)).astype(np.float32)
    x[0, 1000], x[0, 5000], x[1, 3000] = np.inf, 1e25, np.nan
    taps = tfilt.firwin(255, [2000.0], sampling_rate=48000.0, device="cpu").numpy()
    kw = dict(taps=taps, stride=128, n_fft=512, window_coeffs=(0.5, -0.5), onesided=True,
              output="power")
    before = cuda_dft.fir_framed_dft_power_shared_cuda.launches
    got = td.fir_framed_dft_shared(torch.from_numpy(x).cuda(), **kw).cpu()
    assert cuda_dft.fir_framed_dft_power_shared_cuda.launches == before + 1
    want = td.fir_framed_dft_shared(torch.from_numpy(x), **kw)
    assert want.isnan().any() and want.isinf().any()
    assert torch.equal(got.isnan(), want.isnan()) and torch.equal(got.isinf(), want.isinf())
    finite = torch.isfinite(want)
    assert_close_per_bin(torch.where(finite, got, 0.0), torch.where(finite, want, 0.0))


@pytest.mark.cuda
def test_public_functions_run_on_cuda(rng):
    """Every ported public function of ops/convolution.py, spectral/mel.py
    and models/pipeline.py takes CUDA tensors, keeps them on the card and
    agrees with its CPU result at 1e-4 x max (f32 sums in other orders)."""
    need_cuda()
    from nx_signal_tpu_torch.models.pipeline import LogMelFrontend, SpectrogramPipeline
    from nx_signal_tpu_torch.ops import convolution as tc
    from nx_signal_tpu_torch.spectral import mel as tm
    from nx_signal_tpu_torch.spectral.stft import stft

    def arr(*shape, complex_=False):
        a = rng.normal(size=shape)
        if complex_:
            a = a + 1j * rng.normal(size=shape)
        return torch.from_numpy(a.astype(np.complex64 if complex_ else np.float32))

    sig, ker = arr(3, 700), arr(1, 31)
    csig, cker = arr(500, complex_=True), arr(12, complex_=True)
    img, kimg = arr(20, 24), arr(5, 4)
    cases = [
        (tc.convolve, (sig, ker), dict(mode="same")),
        (tc.convolve, (sig, ker), dict(mode="valid", method="fft")),
        (tc.convolve, (csig, cker), dict(mode="full")),
        (tc.convolve, (img, kimg), dict(mode="same")),
        (tc.correlate, (csig, cker), dict(mode="same")),
        (tc.fftconvolve, (img, kimg), dict(mode="full")),
        (tc.oaconvolve, (sig, ker), dict(mode="same")),
        (tc.oaconvolve, (csig, cker), dict(mode="full")),
        (tc.fir_convolve_1d, (sig, ker[0]), dict(mode="full", origin=37)),
        (tc.convolve2d, (img, kimg), dict(mode="same", boundary="symm")),
        (tc.convolve2d, (img, kimg), dict(mode="full", boundary="wrap")),
        (tc.correlate2d, (img, kimg), dict(mode="valid", boundary="fill", fillvalue=0.5)),
        (lambda a, b: tc.deconvolve(a, b)[0], (torch.tensor([1.0, 3.0, 3.0, 1.0]),
                                              torch.tensor([1.0, 1.0])), {}),
        (lambda z: tm.stft_to_mel(z, 8000.0, fft_length=256, mel_bins=40),
         (stft(arr(2, 4000), tw.hann(256, device="cpu"), fft_length=256, overlap_length=128,
               onesided=True).z,), {}),
        (lambda x: SpectrogramPipeline(frame_length=256, fft_length=256)(x)[0],
         (arr(4096),), {}),
        (LogMelFrontend(), (arr(2, 16000),), {}),
    ]
    for fn, args, kw in cases:
        want = fn(*args, **kw)
        got = fn(*(a.cuda() for a in args), **kw)
        assert got.device.type == "cuda" and got.dtype == want.dtype, fn
        assert_close_to_max(got.cpu(), want)
    fb = tm.mel_filters(512, 80, 16000.0, device="cuda")
    assert fb.device.type == "cuda"
    assert_close_to_max(fb.cpu(), tm.mel_filters(512, 80, 16000.0, device="cpu"), rel=1e-5)


def _launches_of(fn, *kernels):
    """(fn's result, how many times each kernel launched in it)."""
    before = [k.launches for k in kernels]
    out = fn()
    torch.cuda.synchronize()
    return out, [k.launches - b for k, b in zip(kernels, before)]


@pytest.mark.cuda
@pytest.mark.parametrize("average", ["mean", "median"])
@pytest.mark.parametrize("detrend", ["constant", "linear"])
def test_welch_runs_kernel_b_fft_on_cuda(average, detrend, rng):
    """welch on the card launches B-fft once (not the dense B) and agrees
    with its CPU run (the plain versions) at 1e-4 x max."""
    need_cuda()
    from nx_signal_tpu_torch.spectral.estimation import welch

    x = torch.from_numpy(rng.normal(size=(3, 30000)).astype(np.float32))
    kw = dict(sampling_rate=48000.0, segment_length=512, overlap_length=256, detrend=detrend,
              average=average)
    (_, got), counts = _launches_of(lambda: welch(x.cuda(), **kw), cuda_dft.framed_fft_cuda,
                                    cuda_dft.framed_dft_cuda)
    assert counts == [1, 0] and got.device.type == "cuda"
    assert_close_to_max(got.cpu(), welch(x, **kw)[1])


@pytest.mark.cuda
def test_csd_coherence_and_spectrogram_run_kernel_b_fft_on_cuda(rng):
    """csd (two spectra), coherence (two welch and one csd) and spectrogram
    launch B-fft on the card and agree with their CPU runs at 1e-4 x max."""
    need_cuda()
    from nx_signal_tpu_torch.spectral.estimation import coherence, csd
    from nx_signal_tpu_torch.spectral.spectrogram import spectrogram

    x = torch.from_numpy(rng.normal(size=(2, 20000)).astype(np.float32))
    y = torch.roll(x, 5, dims=-1) + 0.3 * torch.from_numpy(
        rng.normal(size=(2, 20000)).astype(np.float32))
    kw = dict(segment_length=400, overlap_length=240, fft_length=512)
    for fn, n_fft_calls in ((lambda a, b: csd(a, b, **kw)[1], 2),
                            (lambda a, b: coherence(a, b, **kw)[1], 4),
                            (lambda a, b: spectrogram(a, 8000.0, window_length=400)[2], 1)):
        got, counts = _launches_of(lambda: fn(x.cuda(), y.cuda()), cuda_dft.framed_fft_cuda)
        assert counts == [n_fft_calls]
        assert_close_to_max(got.cpu(), fn(x, y))


@pytest.mark.cuda
@pytest.mark.parametrize("fft_mode,mfft", [("onesided", 512), ("onesided2X", 600),
                                           ("twosided", 512)])
def test_short_time_fft_runs_kernels_b_fft_and_c_on_cuda(fft_mode, mfft, rng):
    """ShortTimeFFT.stft on the card runs B-fft in the one-sided modes
    (torch.fft in the others), istft folds with kernel C (real frames, or
    the real and imaginary parts apart); both agree with their CPU runs at
    1e-4 x max and the round trip returns the signal."""
    need_cuda()
    from nx_signal_tpu_torch.spectral.short_time_fft import ShortTimeFFT

    x = torch.from_numpy(rng.normal(size=(2, 20000)).astype(np.float32))
    sft = ShortTimeFFT(hann_np(512), 128, 48000.0, fft_mode=fft_mode, mfft=mfft,
                       scale_to="psd" if fft_mode == "onesided2X" else None)
    z, counts = _launches_of(lambda: sft.stft(x.cuda()), cuda_dft.framed_fft_cuda)
    assert counts == [1 if fft_mode != "twosided" else 0]
    z_cpu = sft.stft(x)
    assert_close_to_max(z.cpu(), z_cpu)
    y, counts = _launches_of(lambda: sft.istft(z, k1=20000), cuda_dft.overlap_add_cuda)
    assert counts == [1 if fft_mode != "twosided" else 2]
    assert_close_to_max(y.cpu(), sft.istft(z_cpu, k1=20000))
    assert_close_to_max(y.real.cpu(), x)


# kernel B-ifft's cases: n_fft, window length, z's shape (..., bins); the
# tile of a CTA is 64 frames at n_fft <= 512 and 32 at 1024
IFFT_CASES = [
    (8, 8, (2, 70, 5)),
    (16, 16, (3, 1031, 9)),
    (64, 64, (3, 33, 33)),
    (64, 63, (2, 37, 33)),           # an odd window: the last sample alone
    (512, 512, (2, 2, 45, 257)),     # batched
    (512, 400, (129, 257)),          # a window shorter than n_fft
    (512, 512, (257,)),              # 1-D: one frame
    (512, 512, (2, 50, 250)),        # fewer bins than n_fft/2 + 1 (zeros past them)
    (512, 512, (2, 50, 300)),        # more (cut)
    (1024, 1024, (2, 1000, 513)),    # 2000 frames: not a multiple of the tile
]


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,frame,shape", IFFT_CASES)
def test_framed_ifft_kernel_matches_plain_on_cuda(n_fft, frame, shape, rng):
    """Kernel B-ifft against its plain version (the dense weights product)
    at 1e-5 of the frames' max, DC and Nyquist imaginary parts included in
    z (both ignore them); and each frame's bits do not depend on the batch:
    the frames of a slice of z are bitwise the slice of the frames."""
    need_cuda()
    z = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)
    window = hann_np(frame).astype(np.float32)
    zt, wt = torch.from_numpy(z), torch.from_numpy(window)
    before = cuda_dft.framed_ifft_cuda.launches
    got = cuda_dft.framed_ifft_cuda(zt.cuda(), wt.cuda(), n_fft=n_fft)
    torch.cuda.synchronize()
    assert cuda_dft.framed_ifft_cuda.launches == before + 1
    assert got.shape == (*shape[:-1], frame) and got.dtype == torch.float32
    want = td._framed_idft_torch(zt, window, n_fft=n_fft, onesided=True)
    assert_close_to_max(got.cpu(), want, rel=1e-5)
    if len(shape) > 1:
        part = cuda_dft.framed_ifft_cuda(zt[..., 1:, :].cuda(), wt.cuda(), n_fft=n_fft)
        assert torch.equal(part, got[..., 1:, :])


@pytest.mark.cuda
@pytest.mark.parametrize("scaling", [None, "spectrum", "psd"])
def test_istft_runs_kernel_b_ifft_on_cuda(scaling, rng):
    """istft of a one-sided spectrum on the card (hann 512, hop 128)
    launches B-ifft once and kernel C twice (the frames and the envelope)
    and agrees with its CPU run (the dense product) at 1e-5 x max, with
    each scaling, past the first and last n_fft samples (there the division
    by the small window envelope magnifies any rounding of the frames)."""
    need_cuda()
    from nx_signal_tpu_torch.spectral.stft import istft, stft

    x = torch.from_numpy(rng.normal(size=(3, 20000)).astype(np.float32))
    window = tw.hann(512, device="cpu")
    kw = dict(fft_length=512, overlap_length=384, onesided=True, scaling=scaling,
              sampling_rate=48000.0)
    z = stft(x, window, **kw).z
    got, counts = _launches_of(lambda: istft(z.cuda(), window.cuda(), **kw),
                               cuda_dft.framed_ifft_cuda, cuda_dft.overlap_add_cuda)
    assert counts == [1, 2]
    want = istft(z, window, **kw)
    assert got.shape == want.shape
    assert_close_to_max(got.cpu()[..., 512:-512], want[..., 512:-512], rel=1e-5)


@pytest.mark.cuda
def test_card_istft_builds_no_weights_and_copies_nothing_to_or_from_the_host(rng):
    """Each istft call on the card at n_fft 512: one B-ifft launch inside
    the `nx.idft.product` span, no `nx.weights.idft` span (no dense
    weights), and no copy between host and card."""
    need_cuda()
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    from nx_signal_tpu_torch.spectral.stft import istft, stft

    window = tw.hann(512, device="cuda")
    x = torch.from_numpy(rng.normal(size=(4, 30000)).astype(np.float32)).cuda()
    kw = dict(fft_length=512, overlap_length=384, onesided=True)
    z = stft(x, window, **kw).z
    istft(z, window, **kw)
    torch.cuda.synchronize()
    before = cuda_dft.framed_ifft_cuda.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            istft(z, window, **kw)
        torch.cuda.synchronize()
    assert cuda_dft.framed_ifft_cuda.launches == before + 2
    names = Counter(e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CPU)
    assert names["nx.istft"] == 2 and names["nx.idft.product"] == 2
    assert names["nx.weights.idft"] == 0
    device = Counter(e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
    assert sum(n for name, n in device.items() if "framed_ifft_kernel" in name) == 2
    assert not [name for name in device if "HtoD" in name or "DtoH" in name]


@pytest.mark.cuda
def test_sharded_istft_runs_kernel_b_ifft_bitwise_on_cuda(tmp_path):
    """Two ranks sharing cuda:0: sharded_istft of a one-sided spectrum
    launches B-ifft once on each rank, and each rank's shard is bitwise the
    whole-signal istft's samples on the same card."""
    need_cuda()
    from tests import torch_sharded_ranks as ranks

    assert ranks.spawn(ranks.cuda_istft_case, 2, tmp_path) == [True, True]


@pytest.mark.cuda
def test_sharded_welch_runs_kernels_b_fft_and_e_on_cuda(tmp_path):
    """Two ranks sharing cuda:0: sharded_welch launches B-fft once and
    kernel E twice (the frame halo and the coefficients' halo) on each rank,
    and each rank's PSD is within 1e-5 x max of the single-device welch."""
    need_cuda()
    from tests import torch_sharded_ranks as ranks

    assert ranks.spawn(ranks.cuda_welch_case, 2, tmp_path) == [True, True]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", ["none", "complex", "real"])
def test_overlap_add_kernel_on_complex_frames_bitwise_on_cuda(seed, rng):
    """complex64 frames fold through kernel C once per part (seeded by the
    seed's parts), bitwise equal to the plain per-part fold, signed zeros
    included."""
    need_cuda()
    from nx_signal_tpu_torch.spectral.framing import _ola_fold

    frames = (rng.normal(size=(3, 40, 400)) + 1j * rng.normal(size=(3, 40, 400))).astype(
        np.complex64)
    frames.real[:, :, :8] = -0.0
    out_length = 40 * 150 + 250
    init = {"none": None,
            "complex": (rng.normal(size=(3, out_length))
                        + 1j * rng.normal(size=(3, out_length))).astype(np.complex64),
            "real": rng.normal(size=(3, out_length)).astype(np.float32)}[seed]
    t_init = None if init is None else torch.from_numpy(init)
    got, counts = _launches_of(
        lambda: _ola_fold(torch.from_numpy(frames).cuda(), 150, out_length,
                          init=None if t_init is None else t_init.cuda()),
        cuda_dft.overlap_add_cuda)
    assert counts == [2]
    want = _ola_fold_torch(torch.from_numpy(frames), 150, out_length, init=t_init)
    assert got.cpu().numpy().tobytes() == want.numpy().tobytes()


@pytest.mark.cuda
def test_streaming_stft_istft_launch_counts_and_resume_on_cuda(rng, tmp_path):
    """On the card StreamingSTFT launches B-fft once per chunk and
    StreamingISTFT kernel C twice per chunk (the real and imaginary parts);
    the chunks agree with their CPU runs at 1e-4 x max, and a resume of
    StreamingISTFT from a checkpoint is bitwise equal to the uninterrupted
    run."""
    need_cuda()
    from nx_signal_tpu_torch.io.checkpoint import load_state, save_state
    from nx_signal_tpu_torch.parallel.streaming import StreamingISTFT, StreamingSTFT

    w, hop = tw.hann(512, device="cpu"), 128
    enc, dec = StreamingSTFT(w, hop=hop), StreamingISTFT(w, hop=hop)
    x = torch.from_numpy(rng.normal(size=(4, 8 * 4096)).astype(np.float32))
    chunks = list(x.split(4096, dim=-1))
    es, ds = enc.init_state((4,)), dec.init_state((4,))
    zs, ys = [], []
    for i, c in enumerate(chunks):
        (es, z), counts = _launches_of(lambda: enc.process(es, c.numpy()),
                                       cuda_dft.framed_fft_cuda)
        assert counts == [1] and z.device.type == "cuda"
        (ds, y), counts = _launches_of(lambda: dec.process(ds, z), cuda_dft.overlap_add_cuda)
        assert counts == [2]
        zs.append(z)
        ys.append(y)
        if i == 3:
            save_state(str(tmp_path / "istft.npz"), ds)
    es_cpu, ds_cpu = enc.init_state((4,), device="cpu"), dec.init_state((4,), device="cpu")
    for c, z, y in zip(chunks, zs, ys):
        es_cpu, z_cpu = enc.process(es_cpu, c)
        ds_cpu, y_cpu = dec.process(ds_cpu, z.cpu())
        assert_close_to_max(z.cpu(), z_cpu)
        assert_close_to_max(y.cpu(), y_cpu)
    state, _ = load_state(str(tmp_path / "istft.npz"))
    for z, y in zip(zs[4:], ys[4:]):
        state, y2 = dec.process(state, z)
        assert y2.cpu().numpy().tobytes() == y.cpu().numpy().tobytes()


@pytest.mark.cuda
def test_streaming_chunks_make_no_host_to_device_copy_on_cuda(rng):
    """After a first chunk (which copies each processor's constants to the
    card once), a chunk of every streaming processor on a device tensor
    issues no host-to-device copy (each would wait for the stream): the
    profiler's memcpy events of the second chunk are all device to device
    or device to host."""
    need_cuda()
    from torch.profiler import ProfilerActivity, profile

    from nx_signal_tpu_torch.ops.iir_design import butter
    from nx_signal_tpu_torch.parallel import streaming as ts

    procs = [
        (ts.StreamingFIR(tfilt.firwin(255, [0.1], device="cpu")), 4800),
        (ts.StreamingIIR(butter(8, 0.1, output="sos")), 4800),
        (ts.StreamingSTFT(tw.hann(512, device="cpu"), hop=128), 4864),
        (ts.StreamingPFB(1024, taps_per_channel=8), 8192),
        (ts.StreamingResamplePoly(1, 3), 4800),
    ]
    for proc, n in procs:
        state = proc.init_state((4,))
        for i in range(2):
            chunk = torch.from_numpy(rng.normal(size=(4, n)).astype(np.float32)).cuda()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                state, y = proc.process(state, chunk)
                torch.cuda.synchronize()
        names = [e.name for e in prof.events()]
        assert not [m for m in names if "HtoD" in m], (type(proc).__name__, names)
    istft = ts.StreamingISTFT(tw.hann(512, device="cpu"), hop=128)
    state = istft.init_state((4,))
    for i in range(2):
        z = torch.randn((4, 38, 512), dtype=torch.complex64, device="cuda")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            state, y = istft.process(state, z)
            torch.cuda.synchronize()
    assert not [e.name for e in prof.events() if "HtoD" in e.name]


@pytest.mark.cuda
def test_lsim_returns_every_array_on_the_signal_device():
    """A signal on the card and a host time vector: tout, yout and xout all
    come back on the card."""
    need_cuda()
    from nx_signal_tpu_torch.ops.ltisys import lsim

    t = torch.linspace(0.0, 1.0, 101, dtype=torch.float64)
    u = torch.ones(101, dtype=torch.float64, device="cuda")
    tout, y, x = lsim(([1.0], [1.0, 1.0]), u, t)
    assert {tout.device.type, y.device.type, x.device.type} == {"cuda"}
    assert torch.equal(tout.cpu(), t)
