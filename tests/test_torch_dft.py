"""Parity of the PyTorch port's kernels/dft.py with the JAX package, on the
CPU, where every kernel wrapper runs its plain PyTorch version.

Tolerances:
* host weight functions (toeplitz_band, _dft_weights, _idft_weights,
  fir_dft_fold_weights): bitwise — the same numpy f64 operations, cast to
  f32 the same way.
* contractions (blocked_frame_matmul, framed_dft, framed_idft,
  fir_framed_dft): 1e-4 x max|reference|, the JAX package's own gate
  (pallas_dft.py:385) — both sides are f32 sums of up to ~800 products in
  different orders (conv1d vs XLA's conv or the Pallas dot).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nx_signal_tpu.kernels import dft as jd
from nx_signal_tpu.kernels.pallas_dft import fir_framed_dft_power_pallas, framed_dft_pallas
from nx_signal_tpu.ops import windows as jw
from nx_signal_tpu_torch.kernels import cuda_dft
from nx_signal_tpu_torch.kernels import dft as td


def assert_bitwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.ascontiguousarray(got).tobytes() == np.ascontiguousarray(want).tobytes()


def assert_close_to_max(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def hann_np(n):
    return np.array(jw.hann(n))


@pytest.mark.parametrize("num_taps", [1, 3, 100, 255])
@pytest.mark.parametrize("out_cols", [4, 64])
def test_toeplitz_band_bitwise(num_taps, out_cols, rng):
    taps = rng.normal(size=num_taps)
    assert_bitwise(td.toeplitz_band(taps, out_cols), jd.toeplitz_band(taps, out_cols, np))


@pytest.mark.parametrize("frame,n_fft,onesided", [
    (512, 512, True), (400, 512, True), (256, 256, False), (7, 8, True), (9, 9, False)])
def test_dft_and_idft_weights_bitwise(frame, n_fft, onesided):
    window = np.asarray(jw.hann(frame), np.float64)
    assert_bitwise(td._dft_weights(window, frame, n_fft, onesided, np.float32),
                   jd._dft_weights(window, frame, n_fft, onesided, np.float32))
    assert_bitwise(td._idft_weights(window, frame, n_fft, onesided, np.float32),
                   jd._idft_weights(window, frame, n_fft, onesided, np.float32))


@pytest.mark.parametrize("num_taps,frame,n_fft,onesided", [
    (255, 512, 512, True), (100, 400, 512, True), (4, 256, 256, False), (1, 64, 64, True)])
def test_fir_dft_fold_weights_bitwise(num_taps, frame, n_fft, onesided, rng):
    taps = rng.normal(size=num_taps).astype(np.float32)
    window = hann_np(frame)
    want = jd.fir_dft_fold_weights(taps, window, n_fft, onesided)
    got = td.fir_dft_fold_weights(taps, torch.from_numpy(window), n_fft, onesided, device="cpu")
    assert got.dtype == torch.float32
    assert_bitwise(got, want)


@pytest.mark.parametrize("strategy", ["conv", "materialize", "blocked"])
@pytest.mark.parametrize("window,stride,length", [(300, 128, 3000), (256, 100, 2000),
                                                  (128, 128, 1000)])
@pytest.mark.parametrize("cols", [10, 2])  # 'conv': a conv1d, or few columns: one matmul
def test_blocked_frame_matmul(strategy, window, stride, length, cols, rng):
    x = rng.normal(size=(2, length)).astype(np.float32)
    w = rng.normal(size=(window, cols)).astype(np.float32)
    m = (length - window) // stride + 1
    want = jd.blocked_frame_matmul(jnp.asarray(x), jnp.asarray(w), window_length=window,
                                   stride=stride, num_frames=m)
    got = td.blocked_frame_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                  window_length=window, stride=stride, num_frames=m,
                                  strategy=strategy)
    assert_close_to_max(got, want)



@pytest.mark.parametrize("window,stride,length", [(300, 128, 3000), (256, 100, 2000),
                                                  (128, 128, 1000)])
@pytest.mark.parametrize("cols", [10, 2])
def test_blocked_strategy_adds_its_partial_products(window, stride, length, cols, rng):
    """strategy='blocked' (C partial matmuls added in increasing r) against
    the JAX package's 'blocked' and the port's 'materialize'."""
    x = rng.normal(size=(2, length)).astype(np.float32)
    w = rng.normal(size=(window, cols)).astype(np.float32)
    m = (length - window) // stride + 1
    kw = dict(window_length=window, stride=stride, num_frames=m)
    got = td.blocked_frame_matmul(torch.from_numpy(x), torch.from_numpy(w), strategy="blocked",
                                  **kw)
    assert_close_to_max(got, jd.blocked_frame_matmul(jnp.asarray(x), jnp.asarray(w),
                                                     strategy="blocked", **kw))
    assert_close_to_max(got, td.blocked_frame_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                                     strategy="materialize", **kw))
    with pytest.raises(ValueError, match="'conv', 'materialize' or 'blocked'"):
        td.blocked_frame_matmul(torch.from_numpy(x), torch.from_numpy(w), strategy="frames",
                                **kw)


FRAMED_GEOMETRIES = [  # channels, length, frame, hop, n_fft
    (2, 4096, 512, 128, 512),
    (1, 3000, 400, 150, 512),   # hop does not divide the frame, n_fft > frame
    (3, 2048, 256, 256, 256),   # no overlap
    (2, 3000, 512, 128, 600),   # 7-smooth n_fft: the mixed-radix B-fft
    (2, 3000, 400, 160, 400),   # Whisper's frame, hop and n_fft
    (3, 3000, 441, 147, 441),   # odd n_fft: two frames per complex FFT
    (2, 3000, 500, 128, 1000),  # n_fft 2^3 * 5^3
    (2, 3000, 512, 128, 572),   # 2^2 * 11 * 13: the mixed-radix B-fft, radices 2, 13, 11
    (2, 1000, 12, 5, 16),       # the FFT kernel's small sizes
    (1, 500, 5, 3, 8),
    (1, 5000, 1000, 300, 1024),
    (2, 3000, 700, 128, 512),   # a frame longer than n_fft: folded modulo n_fft
    (1, 4000, 1500, 300, 1031),  # the same, odd n_fft on Bluestein's transform
    (1, 6000, 2048, 512, 2048),  # librosa's default n_fft
    (1, 9000, 1024, 1024, 4093),  # a prime past 4096 / 2: Bluestein (M = 8192), frame zero-padded
]


@pytest.mark.parametrize("geometry", FRAMED_GEOMETRIES)
@pytest.mark.parametrize("onesided", [True, False])
@pytest.mark.parametrize("output", ["complex", "power"])
def test_framed_dft(geometry, onesided, output, rng):
    channels, length, frame, hop, n_fft = geometry
    x = rng.normal(size=(channels, length)).astype(np.float32)
    window = hann_np(frame)
    want = jd.framed_dft(jnp.asarray(x), window, stride=hop, n_fft=n_fft,
                         onesided=onesided, output=output)
    got = td.framed_dft(torch.from_numpy(x), torch.from_numpy(window), stride=hop,
                        n_fft=n_fft, onesided=onesided, output=output)
    assert got.dtype == (torch.complex64 if output == "complex" else torch.float32)
    assert_close_to_max(got, np.asarray(want).astype(got.numpy().dtype))


@pytest.mark.parametrize("n_fft,kernel", [(8, "fft"), (16, "fft"), (512, "fft"), (1024, "fft"),
                                          (400, "fft"), (441, "fft"), (600, "fft"),
                                          (1000, "fft"), (4, "dense"), (572, "fft"),
                                          (1021, "fft"), (2048, "fft"), (4097, "fft"),
                                          (8191, "fft"), (8192, "fft"), (16382, "fft"),
                                          (16384, "fft"), (8193, "fft"), (12289, "fft"),
                                          (16385, "fft"), (20000, "fft"), (32749, "fft"),
                                          (32768, "fft"), (65536, "fft"), (65537, "dense")])
def test_framed_dft_kernel_split(n_fft, kernel, rng):
    """framed_dft takes kernel B-fft for every n_fft from 8 to 65536 (572,
    1021, 2048, 4097, 8191, 8193, 12289, 16382, 16384, 16385, 20000, the
    prime 32749, 32768 and 65536 included) and the dense kernel B for an
    n_fft below 8 or above 65536; on a CPU tensor both wrappers are the
    same plain version, so their results are equal bitwise."""
    assert cuda_dft.fft_kernel_takes(n_fft) == (kernel == "fft")
    # past 16384 a shorter frame and fewer frames: the weights grow as n_fft
    frame, hop = (min(n_fft, 400), 3) if n_fft <= 16384 else (128, 31)
    x = torch.from_numpy(rng.normal(size=(2, 3 * frame + 7)).astype(np.float32))
    window = hann_np(frame)
    m = (x.shape[-1] - frame) // hop + 1
    bins = n_fft // 2 + 1
    dense = cuda_dft.framed_dft_cuda(
        x, torch.as_tensor(td._dft_weights(window, frame, n_fft, True, np.float32)), stride=hop,
        num_frames=m, bins=bins)
    assert torch.equal(cuda_dft.framed_fft_cuda(x, window, stride=hop, n_fft=n_fft,
                                                onesided=True), dense)
    assert torch.equal(td.framed_dft(x, window, stride=hop, n_fft=n_fft, onesided=True), dense)


# every n_fft to 1024, and past it a fixed list up to B-fft's largest: past
# 16384 the 13-smooth 19683 = 3^9 (radix 9), 20000, 40000 and 59049 = 3^10,
# the powers of two 32768 and 65536, and Bluestein's 16385, 32749 and 65534
# (M = 65536), 40009 (an odd prime: the 13-smooth M 80080) and 65535 (M =
# 131072)
PAST_1024 = [1025, 1031, 1100, 1536, 2000, 2047, 2048, 2049, 2187, 3000, 4093, 4094, 4095,
             4096, 4097, 6000, 8191, 8192, 12000, 12289, 15625, 16382, 16384, 16385, 19683,
             20000, 32749, 32768, 40000, 40009, 59049, 65534, 65535, 65536]
THIRTEEN_SMOOTH = [n for n in [*range(8, 1025), *PAST_1024] if cuda_dft._thirteen_smooth(n)]
BLUESTEIN = [n for n in [*range(8, 1025), *PAST_1024] if not cuda_dft._thirteen_smooth(n)]


def assert_buffers_fit(plan):
    """Past `_FULL_PAD_POINTS` no pass's padding adds more than 1/8 to its
    buffer, so that framed_fft.cu's two M-point buffers fit in shared
    memory."""
    if plan.points > td._FULL_PAD_POINTS:
        groups = np.cumprod(plan.radices)
        assert all(8 * c <= g for c, g in zip(plan.pads, groups))


def replay_passes(plan, first, table, off):
    """The Stockham passes of `plan` over M points, the first pass's points
    given by first(t) for an index array t (with any leading batch axes),
    through two padded buffers with the plan's twiddles from table[off:],
    in the dtype of the points; returns the unpadded output and the table
    offset after the passes."""
    size = plan.points
    src, in_group, in_pad, ns = None, 1, 0, 1
    for p, (r, c) in enumerate(zip(plan.radices, plan.pads)):
        span, group = size // r, ns * r
        j = np.arange(span)
        t = j[None, :] + np.arange(r)[:, None] * span
        v = first(t) if p == 0 else src[..., t + t // in_group * in_pad]
        jm, g = j % ns, j // ns
        if p > 0:
            v = v * table[off + np.arange(r)[:, None] * ns + jm]
            off += group
        dst = np.full(v.shape[:-2] + (size + size // group * c,), np.nan + 0j, dtype=v.dtype)
        dst[..., g * (group + c) + jm + np.arange(r)[:, None] * ns] = np.fft.fft(v, axis=-2)
        src, in_group, in_pad, ns = dst, group, c, group
    assert src.shape[-1] == size   # the last pass is unpadded
    return src, off


def replay_fft_plan(n_fft, frames, bluestein=False, dtype=np.complex128, points=None):
    """Kernel B-fft's planned transform in numpy, in the kernel's order and
    layout (framed_fft.cu: framed_fft_mixed_kernel, and
    framed_fft_loop_kernel for a power-of-two M, whose one exchange buffer
    holds what the two padded buffers here hold), in `dtype`: the Stockham
    passes of the plan through two padded buffers with the plan's twiddle
    table (`bluestein`: the chirp-z transform of
    `kernels.dft._bluestein_plan` with M = `points` or the rule's, the chirp
    on the first pass's points, the filter spectrum and conj on the second
    FFT's, w_k conj(.) on its output), then the split (even n_fft, one frame
    per FFT) or the separation (odd, two frames); returns the onesided
    spectra of the (even count of) frames, (frames, bins)."""
    plan = td._bluestein_plan(n_fft, points) if bluestein else td._fft_plan(n_fft)
    size = plan.length
    table = (plan.table[:, 0] + 1j * plan.table[:, 1]).astype(dtype)
    frames = frames.astype(np.dtype(dtype).type(0).real.dtype)
    post = 0 if n_fft % 2 else size // 2 + 1
    if n_fft % 2:
        z = frames[0::2] + 1j * frames[1::2]
    else:
        z = frames[:, 0::2] + 1j * frames[:, 1::2]
    z = z.astype(dtype)
    if bluestein:
        chirp, filt = table[post:post + size], table[post + size:post + size + plan.points]
        off = post + size + plan.points
        inside = np.minimum(np.arange(plan.points), size - 1)
        chirped = np.where(np.arange(plan.points) < size, z[..., inside] * chirp[inside], 0)
        a, end = replay_passes(plan, lambda t: chirped[..., t], table, off)
        b, end2 = replay_passes(plan, lambda t: np.conj(a[..., t] * filt[t]), table, off)
        assert end == end2
        src = chirp * np.conj(b[..., :size])
    else:
        src, end = replay_passes(plan, lambda t: z[..., t], table, post)
    assert end == table.shape[0]   # the tables are used up exactly
    k = np.arange(size // 2 + 1)
    a, b = src[..., k], np.conj(src[..., (size - k) % size])
    if n_fft % 2:
        return np.stack([(a + b) / 2, (a - b) / 2j], axis=1).reshape(-1, k.shape[0])
    w = table[k]
    out = np.empty(src.shape[:-1] + (size + 1,), dtype)
    out[..., size - k] = np.conj((a + b) / 2 + 1j * w * (a - b) / 2)   # X[L-k], as the kernel
    out[..., k] = (a + b) / 2 - 1j * w * (a - b) / 2                   # X[k]
    return out


@pytest.mark.parametrize("n_fft", THIRTEEN_SMOOTH)
def test_fft_plan_replays_to_numpy(n_fft, rng):
    """The host plan of kernel B-fft (radices, paddings, per-pass twiddle
    tables) replayed as the kernel indexes it gives np.fft's spectrum, for
    every 13-smooth n_fft from 8 to 1024 and those of `PAST_1024`, even and
    odd, at 1e-12 of the max; no slot of a padded buffer is read unwritten,
    and the tables are used up exactly."""
    frames = rng.normal(size=(2, n_fft))
    got, want = replay_fft_plan(n_fft, frames), np.fft.rfft(frames)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
    plan = td._fft_plan(n_fft)
    assert plan.points == plan.length
    assert np.prod(plan.radices) == plan.length and plan.pads[-1] == 0
    assert all(0 <= c < 16 for c in plan.pads) and len(plan.radices) <= cuda_dft._FFT_MAX_PASSES
    assert_buffers_fit(plan)


def check_bluestein_replay(n_fft, points, rng):
    """Bluestein's plan with M = `points` (None: the rule's) replayed in f64
    against np.fft at 1e-12 of the max, and its shape within the kernel's
    limits; returns the plan."""
    frames = rng.normal(size=(2, n_fft))
    got = replay_fft_plan(n_fft, frames, bluestein=True, points=points)
    want = np.fft.rfft(frames)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
    plan = td._bluestein_plan(n_fft, points)
    assert plan.length == (n_fft // 2 if n_fft % 2 == 0 else n_fft)
    assert plan.points >= 2 * plan.length - 1 and np.prod(plan.radices) == plan.points
    assert plan.points <= cuda_dft._FFT_MAX_POINTS
    assert plan.pads[-1] == 0 and all(0 <= c < 16 for c in plan.pads)
    assert len(plan.radices) <= cuda_dft._FFT_MAX_PASSES
    assert_buffers_fit(plan)
    return plan


def check_bluestein_f32(n_fft, points, rng):
    """The replay in f32 (complex64 throughout, the tables cast as the
    kernel's are) on 32 seeded hann-windowed noise frames: each bin within
    1e-4 of that bin's max over the frames against the f64 rfft of the same
    f32 frames."""
    frames = (rng.normal(size=(32, n_fft)) * np.hanning(n_fft)).astype(np.float32)
    got = replay_fft_plan(n_fft, frames, bluestein=True, dtype=np.complex64, points=points)
    want = np.fft.rfft(frames.astype(np.float64))
    assert got.dtype == np.complex64 and got.shape == want.shape
    err, scale = np.abs(got - want).max(axis=0), np.abs(want).max(axis=0)
    assert (err <= 1e-4 * scale).all(), float((err / scale).max())


@pytest.mark.parametrize("n_fft", BLUESTEIN)
def test_bluestein_plan_replays_to_numpy(n_fft, rng):
    """Bluestein's plan of kernel B-fft (the chirp, M, the chirp filter's
    spectrum, the M-point passes, the product, the inverse as conj-FFT-conj
    and the post-pass) replayed in f64 as the kernel indexes it gives
    np.fft's spectrum at 1e-12 of the max, for every n_fft from 8 to 1024
    with a prime factor above 13 and those of `PAST_1024`; M is the rule's
    (`_bluestein_points`: the power of two >= 2L - 1, or the smallest
    13-smooth one where the power of two would nearly double it) and at
    most 131072."""
    plan = check_bluestein_replay(n_fft, None, rng)
    assert plan.points == td._bluestein_points(plan.length)


@pytest.mark.parametrize("n_fft,points", [(1021, 2048), (1031, 4096), (4093, 8192),
                                          (4094, 4096), (1031, 2079), (1031, 2080),
                                          (4093, 8190), (4094, 4095), (997, 2000),
                                          (514, 1024), (541, 1089), (683, 1365),
                                          (2053, 4116), (2053, 8192), (6151, 12320)])
def test_bluestein_plan_replays_at_either_m(n_fft, points, rng):
    """Bluestein's plan on the power-of-two M (the loop kernel's radix-8
    passes) and on the smallest 13-smooth M (the mixed-radix kernel), which
    the card's times choose between, each replayed in f64 at 1e-12 of the
    max and in f32 at the per-bin 1e-4 gate."""
    check_bluestein_replay(n_fft, points, rng)
    check_bluestein_f32(n_fft, points, rng)


@pytest.mark.parametrize("length,points", [(17, 64), (509, 1024), (1021, 2048), (1031, 4096),
                                           (2047, 4096), (4093, 8192), (4097, 16384),
                                           (8191, 16384), (12289, 32768), (16383, 32768),
                                           (32749, 65536), (40009, 131072), (65535, 131072)])
def test_bluestein_points_rule(length, points):
    """The M rule (`_bluestein_points`): the power of two P >= 2L - 1
    (`points`) unless P exceeds the smallest 13-smooth S >= 2L - 1
    (`_smooth_points`) by more than `_SMOOTH_M_RATIO`, then S; both at
    least 2L - 1 and within B-fft's points."""
    smooth = td._smooth_points(length)
    assert points >= 2 * length - 1 > points // 2
    want = smooth if points > td._SMOOTH_M_RATIO * smooth else points
    assert td._bluestein_points(length) == want <= cuda_dft._FFT_MAX_POINTS
    assert 1.0 < td._SMOOTH_M_RATIO < 2.0
    assert cuda_dft._thirteen_smooth(smooth)
    assert td._smooth_points(length) >= 2 * length - 1
    assert not any(cuda_dft._thirteen_smooth(m)
                   for m in range(2 * length - 1, td._smooth_points(length)))


@pytest.mark.parametrize("n_fft,points", [
    (997, 2048), (4093, 8192), (4094, 4096), (802, 1024), (787, 2048), (3079, 6160),
    (6151, 12320), (1367, 2744), (2731, 5488), (683, 1365), (662, 672), (603, 1210),
    (541, 1089), (526, 525), (514, 520), (1031, 2079), (2053, 4116), (8209, 16464)])
def test_bluestein_points_at_the_timed_lengths(n_fft, points):
    """The M the rule gives at each length whose power of two and smallest
    13-smooth M the card timed against each other (scripts/
    torch_kernel_variants.py section 6): the power of two up to P / S =
    1.302 (787), the 13-smooth M from 1.330 (3079)."""
    assert td._bluestein_plan(n_fft).points == points


@pytest.mark.parametrize("n_fft", BLUESTEIN)
def test_bluestein_plan_f32_accuracy(n_fft, rng):
    """The same replay in f32 (complex64 throughout, the tables cast as the
    kernel's are) on 32 seeded hann-windowed noise frames: each bin within
    1e-4 of that bin's max over the frames against the f64 rfft of the same
    f32 frames, the per-bin gate chip_smoke.py holds the kernel to."""
    check_bluestein_f32(n_fft, None, rng)


def fold_frames(frames, n_fft):
    """Windowed frames longer than n_fft folded modulo n_fft as kernel
    B-fft's load folds them (framed_fft.cu): xw[i] = sum_q frame[i + q n_fft]."""
    count, length = frames.shape
    padded = np.zeros((count, -(-length // n_fft) * n_fft))
    padded[:, :length] = frames
    return padded.reshape(count, -1, n_fft).sum(axis=1)


@pytest.mark.parametrize("n_fft", [64, 441, 600, 1031])
@pytest.mark.parametrize("ratio", [1.5, 3])
def test_fold_modulo_n_fft_replays_to_numpy_and_jax(n_fft, ratio, rng):
    """Four hann-windowed frames of 1.5x and 3x n_fft folded modulo n_fft
    as kernel B-fft's load folds them, then its plan replayed in f64 (the
    mixed-radix plan, Bluestein's at the prime 1031; the power-of-two
    kernel folds in its load the same way): np.fft.rfft of the folded
    frames at 1e-12 of the max, and the JAX package's framed_dft (its
    frame_length-row weights, e^{-2 pi i k t / n_fft} periodic in t) at
    1e-4 of the max."""
    frame, hop = int(ratio * n_fft), n_fft // 3
    x = rng.normal(size=frame + 3 * hop).astype(np.float32)
    window = hann_np(frame)
    frames = np.lib.stride_tricks.sliding_window_view(x.astype(np.float64), frame)[::hop]
    folded = fold_frames(frames * window, n_fft)
    got = replay_fft_plan(n_fft, folded, bluestein=not cuda_dft._thirteen_smooth(n_fft))
    want = np.fft.rfft(folded)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
    jax_z = jd.framed_dft(jnp.asarray(x), window, stride=hop, n_fft=n_fft, onesided=True)
    assert_close_to_max(got.astype(np.complex64), np.asarray(jax_z))


def assert_close_per_bin(got, want, rel=1e-4):
    """Each bin (last axis) within rel x that bin's max|want|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).reshape(-1, want.shape[-1]).max(axis=0)
    scale = np.abs(want).reshape(-1, want.shape[-1]).max(axis=0)
    assert (err <= rel * scale).all(), float((err / scale).max())


@pytest.mark.parametrize("n_fft", [20000, 32749, 32768, 65536])
def test_framed_dft_past_16384_matches_jax(n_fft, rng):
    """framed_dft at an n_fft past 16384 (kernel B-fft on the card, its
    plain version here) against the JAX package's framed_dft: a hann frame
    of 256 zero-padded to n_fft, 2 channels, per bin at 1e-4 of the bin's
    max."""
    x = rng.normal(size=(2, 1280)).astype(np.float32)
    window = hann_np(256)
    kw = dict(stride=256, n_fft=n_fft, onesided=True)
    want = jd.framed_dft(jnp.asarray(x), window, **kw)
    got = td.framed_dft(torch.from_numpy(x), torch.from_numpy(window), **kw)
    assert_close_per_bin(got, np.asarray(want).astype(np.complex64))


@pytest.mark.parametrize("budget_gib", [40, 10, 3])
def test_auto_frame_chunks_matches_jax(budget_gib, monkeypatch):
    """The port's frame-chunk plan equals the JAX package's at the same
    budget (the JAX module's `_hbm_budget` patched in this test only): the
    bench chain at 768 x 480 000 fits 40 GiB unchunked (1), and 10 and 3
    GiB need chunks. On a CPU tensor there is no budget, so 'auto' is 1."""
    budget = budget_gib * 1024 ** 3
    monkeypatch.setattr(jd, "_hbm_budget", lambda: budget)
    args = (768, 3747, 514, 768 * 480000)
    want = jd._auto_frame_chunks(*args)
    assert td._auto_frame_chunks(*args, budget) == want
    assert (want == 1) == (budget_gib == 40)
    assert td._memory_budget(torch.device("cpu")) is None
    assert td._auto_frame_chunks(*args, None) == 1


def _route_call(route, x, n_fft):
    """One call of a public route of the framed DFT at this n_fft (hann
    frame of n_fft, hop n_fft / 4)."""
    import importlib

    from nx_signal_tpu_torch.models.pipeline import stft_fir_chain
    from nx_signal_tpu_torch.ops.windows import hann
    from nx_signal_tpu_torch.parallel.streaming import StreamingSTFT
    from nx_signal_tpu_torch.spectral.short_time_fft import ShortTimeFFT

    window, hop = hann(n_fft, device="cpu"), n_fft // 4
    if route == "stft":
        importlib.import_module("nx_signal_tpu_torch.spectral.stft").stft(
            x, window, sampling_rate=1.0, fft_length=n_fft, overlap_length=n_fft - hop)
    elif route == "streaming":
        proc = StreamingSTFT(window, hop=hop, onesided=True)
        proc.process(proc.init_state(x.shape[:-1], device="cpu"), x)
    elif route == "filtered_chain":
        stft_fir_chain(x, np.ones(5) / 5, window, fft_length=n_fft, overlap_length=n_fft - hop)
    else:
        ShortTimeFFT(window.numpy(), hop, 1.0, mfft=n_fft).stft(x)


# where each route calls framed_dft: `stft`, `StreamingSTFT` and the
# filtered `stft_fir_chain` through `spectral.stft._framed_spectrum`,
# `ShortTimeFFT` on its own rule
ROUTE_MODULES = {"stft": "nx_signal_tpu_torch.spectral.stft",
                 "streaming": "nx_signal_tpu_torch.spectral.stft",
                 "filtered_chain": "nx_signal_tpu_torch.spectral.stft",
                 "short_time_fft": "nx_signal_tpu_torch.spectral.short_time_fft"}


@pytest.mark.parametrize("n_fft", [1024, 2048])
@pytest.mark.parametrize("route", sorted(ROUTE_MODULES))
def test_cpu_routes_keep_the_jax_cut(route, n_fft, monkeypatch, rng):
    """On a CPU tensor method='auto' sends the framed DFT where the JAX
    package sends it: `stft`, `StreamingSTFT` and the filtered
    `stft_fir_chain` to framed_dft up to 1024 and to torch.fft past it
    (`stft` at 2048 runs torch.fft), all three through the one route of
    `spectral.stft._framed_spectrum`, `ShortTimeFFT` to its FFT at any
    mfft (the JAX package keeps its matmul DFT off the CPU); the card's own
    cut (`_auto_takes_kernel`) applies to CUDA float32 tensors only, and
    `good_matmul_fft_length` is the JAX function."""
    import importlib

    calls = []
    module = importlib.import_module(ROUTE_MODULES[route])
    real = module.framed_dft
    monkeypatch.setattr(module, "framed_dft",
                        lambda *a, **k: calls.append(k["n_fft"]) or real(*a, **k))
    x = torch.from_numpy(rng.normal(size=(2, 3 * n_fft)).astype(np.float32))
    _route_call(route, x, n_fft)
    jax_cut = jd.good_matmul_fft_length(n_fft) and route != "short_time_fft"
    assert calls == ([n_fft] if jax_cut else [])
    assert cuda_dft._auto_takes_kernel(x, n_fft) == jd.good_matmul_fft_length(n_fft)


@pytest.mark.parametrize("n_fft", [8, 600, 1021, 1024, 1031, 2048, 4093, 4094, 4096, 8191,
                                   8192, 12000, 15625, 16382, 16384, 16385, 3375, 6000, 6561,
                                   19683, 20000, 32749, 32768, 65535, 65536, 65537])
def test_card_cut_by_length_class(n_fft):
    """The card's route rule (`_card_takes_kernel`, which `_auto_takes_kernel`
    applies to a CUDA float32 signal): B-fft wherever it takes the n_fft, up
    to `_CARD_FFT_CUT` for a power of two (radix 8), `_CARD_SMOOTH_CUT` for
    any other 13-smooth n_fft (the mixed-radix kernel) and
    `_CARD_BLUESTEIN_CUT` for the rest (Bluestein's lengths, which lost to
    torch.stft at 1031 on the card), torch.fft elsewhere; every cut within
    B-fft's range and at least the JAX package's 1024."""
    if n_fft & (n_fft - 1) == 0:
        cut = cuda_dft._CARD_FFT_CUT
    elif cuda_dft._thirteen_smooth(n_fft):
        cut = cuda_dft._CARD_SMOOTH_CUT
    else:
        cut = cuda_dft._CARD_BLUESTEIN_CUT
    assert cuda_dft._card_takes_kernel(n_fft) == (cuda_dft.fft_kernel_takes(n_fft)
                                                  and n_fft <= cut)
    for class_cut in (cuda_dft._CARD_FFT_CUT, cuda_dft._CARD_SMOOTH_CUT,
                      cuda_dft._CARD_BLUESTEIN_CUT):
        assert 1024 <= class_cut <= cuda_dft._FFT_MAX
    if n_fft <= 1024 and n_fft >= 8:
        assert cuda_dft._card_takes_kernel(n_fft)   # the JAX cut's lengths stay on B-fft


@pytest.mark.parametrize("num_taps,frame,n_fft,onesided", [
    (255, 512, 512, True),    # the bench chain: 257 bins packed into 256 slots, 4 tiles
    (100, 400, 600, True),    # 301 bins packed into 300 slots
    (4, 441, 441, True),      # odd n_fft, no Nyquist bin: not packed
    (1, 64, 64, False),       # the full spectrum: not packed
])
def test_a_weight_layout_round_trips(num_taps, frame, n_fft, onesided, rng):
    """Kernel A's laid-out weights (`_a_weights`, `_a_columns`) scatter back
    to the (krows, 2*bins) weights: every column once, but for the two
    columns packing drops (the DC bin's Im, exactly zero, and the Nyquist
    bin's Im, below f32 resolution of its Re); zeros elsewhere."""
    w = td.fir_dft_fold_weights(rng.normal(size=num_taps), hann_np(frame), n_fft, onesided,
                                device="cpu")
    krows, bins = w.shape[0], w.shape[1] // 2
    laid, packed = cuda_dft._a_weights(w, bins)
    assert packed == (onesided and n_fft % 2 == 0)
    cols = cuda_dft._a_columns(bins, packed)
    assert laid.shape == (cols.shape[0], -(-krows // cuda_dft._A_CHUNK) * cuda_dft._A_CHUNK,
                          2 * cuda_dft._A_TILE_BINS)
    used = cols >= 0
    assert not laid[:, krows:].any() and not laid[torch.from_numpy(~used)[:, None, :]
                                                  .expand_as(laid)].any()
    index = cols[used]
    dropped = {bins, 2 * bins - 1} if packed else set()
    assert sorted(index.tolist()) == sorted(set(range(2 * bins)) - dropped)
    back = torch.zeros_like(w)
    back[:, torch.from_numpy(index)] = laid[:, :krows].permute(1, 0, 2)[:, torch.from_numpy(used)]
    keep = sorted(set(range(2 * bins)) - dropped)
    assert torch.equal(back[:, keep], w[:, keep])
    if packed:
        assert not w[:, bins].any()
        assert w[:, -1].abs().max() <= 2.0 ** -24 * w[:, bins - 1].abs().max()


@pytest.mark.parametrize("num_taps,frame,n_fft,onesided", [
    (255, 512, 512, True),    # the bench chain: 257 bins packed into 256 slots, 4 tiles
    (100, 400, 600, True),    # 301 bins packed into 300 slots
    (4, 441, 441, True),      # odd n_fft, no Nyquist bin: not packed
    (1, 64, 64, False),       # the full spectrum: not packed
])
@pytest.mark.parametrize("passes", [1, 3])
def test_tc_weight_layout_round_trips(num_taps, frame, n_fft, onesided, passes, rng):
    """Kernel A-tc's laid-out weights (`_tc_weights`, `_tc_columns`) undone
    in numpy give back the unpacked [Re | Im] weights: W_hi = tf32(W) alone
    at one pass ('default'), W_hi then W_lo = tf32(W - W_hi) per stage at
    three ('high'), every column once but for the two packing drops (the DC
    bin's Im, exactly zero, and the Nyquist bin's Im, below f32 resolution
    of its Re), zeros elsewhere; 256 slots (4 tiles, not 5) for the bench
    chain's 257 bins."""
    w = td.fir_dft_fold_weights(rng.normal(size=num_taps), hann_np(frame), n_fft, onesided,
                                device="cpu")
    krows, bins = w.shape[0], w.shape[1] // 2
    laid, packed = cuda_dft._tc_weights(w, bins, passes)
    assert packed == (onesided and n_fft % 2 == 0)
    cols = cuda_dft._tc_columns(bins, packed)
    tiles, krows_pad = cols.shape[0], -(-krows // cuda_dft._TC_CHUNK) * cuda_dft._TC_CHUNK
    if n_fft == 512:
        assert tiles == 4
    rows = cuda_dft._TC_CHUNK // (1 if passes == 1 else 2)
    assert laid.shape == (tiles, krows_pad // rows, rows * 128 * (1 if passes == 1 else 2))
    assert laid.shape[-1] * 4 == 16384   # one stage of the kernel's ring
    # undo the stage image: (stage, part, step, half, group, col, kk) -> (k, n)
    img = laid.numpy().reshape(tiles, krows_pad // rows, -1 if passes == 1 else 2,
                               rows // 8, 2, 16, 8, 4)
    parts = img.transpose(0, 2, 1, 3, 4, 7, 5, 6).reshape(tiles, -1, krows_pad, 128)
    hi, lo = td._tf32_split(w)
    used = cols >= 0
    for p, want in enumerate([hi] if passes == 1 else [hi, lo]):
        got = parts[:, p]
        assert not got[:, krows:].any() and not got[~used[:, None, :].repeat(krows_pad, 1)].any()
        back = np.zeros((krows, 2 * bins), np.float32)
        back[:, cols[used]] = got[:, :krows].transpose(1, 0, 2)[:, used]
        dropped = {bins, 2 * bins - 1} if packed else set()
        keep = sorted(set(range(2 * bins)) - dropped)
        assert sorted(cols[used].tolist()) == keep
        assert_bitwise(back[:, keep], want.numpy()[:, keep])


@pytest.mark.parametrize("pos", [500, 3 * 16 + 1])
def test_fir_framed_dft_power_nan_bins_match_jax(pos, rng):
    """One inf sample: the JAX package's fir_framed_dft(output='power')
    and the port's plain version give NaN at the same bins (the DC bin of
    every frame whose window holds it: x @ W meets the zero DC Im column)
    and inf at the same bins; the finite bins agree at 1e-4 x max."""
    x = rng.normal(size=(2, 6000)).astype(np.float32)
    x[0, pos] = np.inf
    taps, window = rng.normal(size=31), hann_np(64)
    kw = dict(stride=16, n_fft=64, onesided=True, output="power")
    want = np.asarray(jd.fir_framed_dft(jnp.asarray(x), taps, window, **kw))
    got = td.fir_framed_dft(torch.from_numpy(x), taps, window, **kw).numpy()
    assert np.isnan(want).any() and np.isnan(want[..., 0]).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    finite = np.isfinite(want)
    assert_close_to_max(np.where(finite, got, 0.0), np.where(finite, want, 0.0))


@pytest.mark.parametrize("n_fft", [8, 512, 1024, 4096])
def test_fft_twiddles(n_fft):
    want = np.exp(-2j * np.pi * np.arange(n_fft) / n_fft)
    got = td._fft_twiddles(n_fft, device="cpu").numpy()
    assert got.shape == (n_fft, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got[:, 0] + 1j * got[:, 1], want, rtol=0, atol=6e-8)
    assert got[n_fft // 4, 0] == 0.0 and got[n_fft // 4, 1] == -1.0


@pytest.mark.parametrize("onesided", [True, False])
def test_framed_dft_matches_pallas_interpret(onesided, rng):
    x = rng.normal(size=(2, 2048)).astype(np.float32)
    window = hann_np(256)
    want = framed_dft_pallas(jnp.asarray(x), window, stride=128, n_fft=256,
                             onesided=onesided, interpret=True)
    got = td.framed_dft(torch.from_numpy(x), window, stride=128, n_fft=256,
                        onesided=onesided)
    assert_close_to_max(got, np.asarray(want).astype(np.complex64))


@pytest.mark.parametrize("onesided", [True, False])
@pytest.mark.parametrize("bins_delta", [0, -3, 2])   # exact, short (padded), long (cut)
def test_framed_idft(onesided, bins_delta, rng):
    n_fft, frame = 256, 256
    bins = (n_fft // 2 + 1 if onesided else n_fft) + bins_delta
    z = (rng.normal(size=(2, 7, bins)) + 1j * rng.normal(size=(2, 7, bins))).astype(
        np.complex64)
    window = hann_np(frame)
    want = jd.framed_idft(jnp.asarray(z), window, n_fft=n_fft, onesided=onesided)
    got = td.framed_idft(torch.from_numpy(z), window, n_fft=n_fft, onesided=onesided)
    assert got.dtype == (torch.float32 if onesided else torch.complex64)
    assert_close_to_max(got, np.asarray(want).astype(got.numpy().dtype))


def replay_ifft(n_fft, spectra):
    """Kernel B-ifft's algebra (framed_fft.cu: framed_ifft_kernel) in numpy
    f64, in the kernel's order: the imaginary parts of the DC and Nyquist
    bins dropped; the pre-pass on the pairs (k, h - k), k = 0..h/2, with
    the forward table's W^k conjugated, storing conj Z; the forward radix-8
    passes of B-fft over h = n_fft/2 points (the plan's radices and
    twiddles); conj and 1/n_fft; point j as samples 2j and 2j + 1."""
    plan = td._fft_plan(n_fft)
    h = plan.length
    table = plan.table[:, 0] + 1j * plan.table[:, 1]
    x = spectra.astype(np.complex128)
    x[..., 0], x[..., h] = x[..., 0].real, x[..., h].real
    k = np.arange(h // 2 + 1)
    a, b = x[..., k], x[..., h - k]
    s, d = a + np.conj(b), a - np.conj(b)
    p = np.conj(table[k]) * d
    conj_z = np.empty(x.shape[:-1] + (h,), np.complex128)
    conj_z[..., (h - k) % h] = s - 1j * p      # conj Z[h-k]; k = 0 is overwritten next
    conj_z[..., k] = np.conj(s + 1j * p)       # conj Z[k]
    v, end = replay_passes(plan, lambda t: conj_z[..., t], table, h // 2 + 1)
    assert end == table.shape[0]
    out = np.empty(x.shape[:-1] + (n_fft,))
    out[..., 0::2], out[..., 1::2] = v.real / n_fft, -v.imag / n_fft
    return out


@pytest.mark.parametrize("n_fft", [8, 16, 32, 64, 128, 256, 512, 1024])
def test_ifft_prepass_and_half_length_inverse_replay_irfft(n_fft, rng):
    """Kernel B-ifft's pre-pass and half-length inverse, replayed in f64 as
    the kernel orders them (`replay_ifft`), give np.fft.irfft at 1e-12 of
    the max, the DC and Nyquist imaginary parts ignored as irfft ignores
    them, for every power of two B-ifft takes."""
    bins = n_fft // 2 + 1
    spectra = rng.normal(size=(5, bins)) + 1j * rng.normal(size=(5, bins))
    got, want = replay_ifft(n_fft, spectra), np.fft.irfft(spectra, n_fft)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def _frames_events(fn):
    """fn's result and the names of the profiler's CPU events during it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, {e.name for e in prof.events()}


@pytest.mark.parametrize("n_fft,frame,onesided", [
    (256, 256, True), (256, 200, True), (256, 256, False), (600, 600, True), (128, 300, True)])
def test_framed_idft_cpu_route_is_the_dense_product_bitwise(n_fft, frame, onesided, rng):
    """On a CPU tensor framed_idft keeps the dense route, whatever B-ifft
    takes on the card: it enters `nx.weights.idft` and `nx.idft.product`,
    launches nothing, and returns bitwise the exact-f32 product of [Re z |
    Im z] with `_idft_weights`."""
    bins = n_fft // 2 + 1 if onesided else n_fft
    z = torch.from_numpy((rng.normal(size=(2, 9, bins))
                          + 1j * rng.normal(size=(2, 9, bins))).astype(np.complex64))
    window = hann_np(frame)
    before = cuda_dft.framed_ifft_cuda.launches
    got, names = _frames_events(
        lambda: td.framed_idft(z, window, n_fft=n_fft, onesided=onesided))
    assert {"nx.weights.idft", "nx.idft.product"} <= names
    assert cuda_dft.framed_ifft_cuda.launches == before
    weights = torch.from_numpy(td._idft_weights(window, frame, n_fft, onesided, np.float32))
    want = torch.matmul(torch.cat([z.real, z.imag], dim=-1), weights)
    if not onesided:
        want = torch.complex(want[..., :frame], want[..., frame:])
    assert_bitwise(got.numpy(), want.numpy())


def test_istft_cpu_route_builds_the_dense_weights():
    """istft on CPU tensors at a power-of-two n_fft that B-ifft takes on the
    card still builds the dense weights (`nx.weights.idft`) and launches no
    kernel."""
    from nx_signal_tpu_torch.spectral.stft import istft

    z = torch.randn(2, 30, 257, dtype=torch.complex64)
    window = torch.hann_window(512)
    before = cuda_dft.framed_ifft_cuda.launches
    y, names = _frames_events(lambda: istft(z, window, fft_length=512, overlap_length=384,
                                            onesided=True))
    assert {"nx.istft", "nx.weights.idft", "nx.idft.product"} <= names
    assert cuda_dft.framed_ifft_cuda.launches == before and y.shape == (2, 30 * 128 + 384)


@pytest.mark.parametrize("bins_delta", [0, -40, 7])
def test_framed_ifft_cuda_plain_version_on_cpu(bins_delta, rng):
    """On a CPU tensor kernel B-ifft's wrapper returns its plain version,
    framed_idft's dense product, bitwise, and irfft(z, n_fft) x window at
    1e-5 of the max (bins padded or cut as irfft's n does)."""
    n_fft, frame = 128, 100
    bins = n_fft // 2 + 1 + bins_delta
    z = (rng.normal(size=(3, 11, bins)) + 1j * rng.normal(size=(3, 11, bins))).astype(
        np.complex64)
    window = hann_np(frame)
    got = cuda_dft.framed_ifft_cuda(torch.from_numpy(z), window, n_fft=n_fft)
    assert_bitwise(got.numpy(), td.framed_idft(torch.from_numpy(z), window, n_fft=n_fft,
                                               onesided=True).numpy())
    want = np.fft.irfft(z.astype(np.complex128), n_fft)[..., :frame] * window
    assert_close_to_max(got.numpy(), want, rel=1e-5)


FIR_GEOMETRIES = [  # channels, length, taps, frame, hop, n_fft
    (2, 5000, 255, 512, 128, 512),   # the bench chain's shape family
    (1, 3000, 100, 400, 150, 512),   # even taps, hop does not divide the frame
    (2, 2048, 4, 256, 64, 256),      # even taps, short filter
    (1, 2500, 63, 384, 128, 512),    # (frame + K - 1) % hop != 0
]


@pytest.mark.parametrize("geometry", FIR_GEOMETRIES)
def test_fir_framed_dft_power_matches_xla(geometry, rng):
    channels, length, k, frame, hop, n_fft = geometry
    x = rng.normal(size=(channels, length)).astype(np.float32)
    taps = rng.normal(size=k).astype(np.float32)
    window = hann_np(frame)
    want = jd.fir_framed_dft(jnp.asarray(x), taps, window, stride=hop, n_fft=n_fft,
                             onesided=True, output="power", kernel="xla")
    before = cuda_dft.fir_framed_dft_power_cuda.launches
    got = td.fir_framed_dft(torch.from_numpy(x), torch.from_numpy(taps), window,
                            stride=hop, n_fft=n_fft, onesided=True, output="power")
    assert cuda_dft.fir_framed_dft_power_cuda.launches == before  # CPU: plain version
    assert got.dtype == torch.float32
    assert_close_to_max(got, np.asarray(want).astype(np.float32))


@pytest.mark.parametrize("channels,length,k,frame", [(2, 5000, 255, 512), (1, 3000, 100, 256)])
def test_fir_framed_dft_power_matches_pallas_interpret(channels, length, k, frame, rng):
    x = rng.normal(size=(channels, length)).astype(np.float32)
    taps = rng.normal(size=k).astype(np.float32)
    window = hann_np(frame)
    want = fir_framed_dft_power_pallas(jnp.asarray(x), taps, window, stride=128,
                                       n_fft=frame, interpret=True)
    got = td.fir_framed_dft(torch.from_numpy(x), taps, window, stride=128, n_fft=frame,
                            onesided=True, output="power")
    assert_close_to_max(got, np.asarray(want))


@pytest.mark.parametrize("onesided", [True, False])
def test_fir_framed_dft_complex(onesided, rng):
    x = rng.normal(size=(2, 3000)).astype(np.float32)
    taps = rng.normal(size=31).astype(np.float32)
    window = hann_np(256)
    want = jd.fir_framed_dft(jnp.asarray(x), taps, window, stride=100, n_fft=256,
                             onesided=onesided, output="complex", kernel="xla")
    got = td.fir_framed_dft(torch.from_numpy(x), taps, window, stride=100, n_fft=256,
                            onesided=onesided, output="complex")
    assert got.dtype == torch.complex64
    assert_close_to_max(got, np.asarray(want).astype(np.complex64))


@pytest.mark.parametrize("frame_chunks", [2, 3, "auto"])
def test_fir_framed_dft_frame_chunks(frame_chunks, rng):
    x = rng.normal(size=(2, 4000)).astype(np.float32)
    taps = rng.normal(size=101).astype(np.float32)
    window = hann_np(256)
    want = jd.fir_framed_dft(jnp.asarray(x), taps, window, stride=64, n_fft=256,
                             onesided=True, output="power", kernel="xla")
    got = td.fir_framed_dft(torch.from_numpy(x), taps, window, stride=64, n_fft=256,
                            onesided=True, output="power", frame_chunks=frame_chunks,
                            kernel="torch")
    assert_close_to_max(got, np.asarray(want).astype(np.float32))


def test_fir_framed_dft_kernel_routes(rng):
    x = torch.from_numpy(rng.normal(size=(2, 3000)).astype(np.float32))
    taps, window = rng.normal(size=51), hann_np(256)
    kw = dict(stride=128, n_fft=256, onesided=True, output="power")
    plain = td.fir_framed_dft(x, taps, window, kernel="torch", **kw)
    # 'auto' and 'cuda' go through the kernel wrapper, which on a CPU tensor
    # is the plain version itself; frame_chunks never takes a call off it
    assert torch.equal(td.fir_framed_dft(x, taps, window, kernel="auto", **kw), plain)
    assert torch.equal(td.fir_framed_dft(x, taps, window, kernel="cuda", **kw), plain)
    assert torch.equal(td.fir_framed_dft(x, taps, window, frame_chunks=3, **kw), plain)
    assert torch.equal(td.fir_framed_dft(x, taps, window, kernel="cuda", frame_chunks=3,
                                         **kw), plain)


def test_fir_framed_dft_errors(rng):
    x = torch.zeros(2, 1000)
    taps, window = np.ones(5), hann_np(128)
    kw = dict(stride=64, n_fft=128, onesided=True)
    with pytest.raises(ValueError, match="kernel"):
        td.fir_framed_dft(x, taps, window, output="power", kernel="pallas", **kw)
    with pytest.raises(ValueError, match="kernel='cuda' requires"):
        td.fir_framed_dft(x, taps, window, output="complex", kernel="cuda", **kw)
    with pytest.raises(ValueError, match="edge must be 'pad' or 'conv'"):
        td.fir_framed_dft(x, taps, window, output="power", edge="wrap", **kw)
    with pytest.raises(ValueError, match="exceeds signal length"):
        td.fir_framed_dft(torch.zeros(100), taps, window, output="power", **kw)
    with pytest.raises(ValueError, match="precision"):
        td.fir_framed_dft(x, taps, window, output="power", precision="fast", **kw)
    for bad in (0, 2.5, "many"):
        with pytest.raises(ValueError, match="frame_chunks"):
            td.fir_framed_dft(x, taps, window, output="power", frame_chunks=bad, **kw)


def test_framed_dft_errors():
    with pytest.raises(ValueError, match="exceeds signal length"):
        td.framed_dft(torch.zeros(100), hann_np(128), stride=64, n_fft=128)
    with pytest.raises(ValueError, match="real signal"):
        td.framed_dft(torch.zeros(300, dtype=torch.complex64), hann_np(128), stride=64,
                      n_fft=128)
    with pytest.raises(ValueError, match="output"):
        td.framed_dft(torch.zeros(300), hann_np(128), stride=64, n_fft=128, output="abs")


@pytest.mark.parametrize("n_fft", [64, 512, 1024, 1025, 4096])
def test_good_matmul_fft_length(n_fft):
    assert td.good_matmul_fft_length(n_fft) == jd.good_matmul_fft_length(n_fft)


@pytest.mark.parametrize("name", ["nx_framed_dft_f32", "nx_framed_fft_f32",
                                  "nx_framed_dft_tc_frames", "nx_framed_dft_tc_power_f32",
                                  "nx_overlap_add_f32",
                                  "nx_shared_dft_power_f32", "nx_shared_dft_ctas_per_sm",
                                  "nx_stream_ops_init", "nx_stream_wait_geq",
                                  "nx_stream_write", "nx_halo_alloc", "nx_halo_free",
                                  "nx_pointer_device", "nx_ipc_get_handle",
                                  "nx_ipc_open_handle", "nx_ipc_close_handle",
                                  "nx_halo_put", "nx_halo_interior", "nx_halo_edges"])
def test_ctypes_signatures_match_the_sources(name):
    """The argtypes declared for each C entry point match its prototype in
    kernels/csrc (ctypes cannot check this, and the card is not here)."""
    import ctypes
    import re
    from pathlib import Path

    from nx_signal_tpu_torch.kernels import _build

    src = "".join(Path(_build._CSRC, f).read_text() for f in _build._SOURCES)
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1).split(",")
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int64 for p in params]
    assert list(_build._SIGNATURES[name]) == kinds


@pytest.mark.parametrize("source,constants", [
    ("framed_fft.cu", {"kMinFft": "_FFT_MIN", "kMaxFft": "_FFT_MAX",
                       "kMaxPasses": "_FFT_MAX_PASSES", "kMaxPoints": "_FFT_MAX_POINTS",
                       "kLargeFft": "_FULL_PAD_POINTS", "kMaxSmallFft": "_SMALL_FFT_MAX"}),
    ("framed_dft.cu", {"kTileBins": "_A_TILE_BINS", "kChunk": "_A_CHUNK"}),
    ("framed_dft_tc.cu", {"kTileBins": "_TC_TILE_BINS", "kChunk": "_TC_CHUNK"}),
])
def test_kernel_constants_match_the_sources(source, constants):
    """The wrappers' copies of each kernel's limits and weight layout (and
    the plans' padding threshold of kernels/dft.py) equal the constants the
    CUDA source declares."""
    import re
    from pathlib import Path

    from nx_signal_tpu_torch.kernels import _build

    text = Path(_build._CSRC, source).read_text()
    for c_name, py_name in constants.items():
        value = re.search(rf"constexpr int {c_name} = (\d+);", text).group(1)
        assert int(value) == getattr(cuda_dft if hasattr(cuda_dft, py_name) else td,
                                     py_name), c_name
