"""Kernel D's host side in the PyTorch port, on the CPU: the weight and
twiddle layout of `kernels/cuda_dft.py` (`_d_columns`, `_d_weights`,
`_d_twiddles`) and numpy replays of the kernel's arithmetic
(`kernels/csrc/shared_dft.cu`), which cannot run here.

Tolerances:
* the layouts: exact (a gather of f32 values).
* the f32 replay of stage A's summation order (32-row chunk sums, then the
  sum of the chunks) with the plain stages B and C, against the f64
  reference of the chain: each bin within 1e-4 of that bin's max, the
  per-bin gate chip_smoke.py holds the kernel to.
* the tiles' mirror columns and window neighbours against numpy's FFT of
  a frame, in f64: within 1e-9 (the values are O(10)).
"""

import numpy as np
import pytest
import torch

from nx_signal_tpu_torch.kernels import cuda_dft
from nx_signal_tpu_torch.kernels import dft as td
from nx_signal_tpu_torch.ops import windows as tw
from nx_signal_tpu_torch.ops.filters import firwin

SLOTS = 96  # bin columns per tile (shared_dft.cu kSlots)


def mirror(kl, bins, halo):
    """The bin whose partial DFT bin position kl reads, or -1."""
    if kl < -halo or kl > bins - 1 + halo:
        return -1
    if kl < 0:
        return -kl
    if kl > bins - 1:
        return 2 * (bins - 1) - kl
    return kl


def tile_columns(t, bins, halo):
    """(column s, bin position kl, position of its Re weight in a laid-out
    row) of tile t, from the kernel's description: column s = wn*32 + bg +
    8j sits at wn*64 + bg*4 + j, its Im 32 further."""
    for wn in range(3):
        for bg in range(8):
            for j in range(4):
                s = wn * 32 + bg + 8 * j
                yield s, t * (SLOTS - 2 * halo) - halo + s, wn * 64 + bg * 4 + j


def halo_of(window_name, n_fft):
    window = getattr(tw, window_name)(n_fft, dtype=torch.float64, device="cpu")
    return len(td.recognize_cosine_window(window, n_fft)) - 1


@pytest.mark.parametrize("window_name", ["hann", "hamming", "blackman"])
@pytest.mark.parametrize("n_fft", [512, 1024])
@pytest.mark.parametrize("stride", [128, 50])
def test_d_layout_round_trips(window_name, n_fft, stride, rng):
    """Kernel D's laid-out weights and twiddles scatter back to the plain
    (krows, 2*bins) weights and (2, J, bins) twiddles: every column of every
    tile holds its bin's Re and Im weights and twiddles, a column within the
    halo past DC or Nyquist its mirror bin's, any other zeros; zero rows up
    to a multiple of 32; and the output columns of the tiles cover every bin
    exactly once."""
    halo = halo_of(window_name, n_fft)
    bins = n_fft // 2 + 1
    weights = td.shared_fold_weights(rng.normal(size=63), stride, n_fft, device="cpu")
    twiddles = td.shared_twiddles(stride, n_fft, device="cpu")
    krows = weights.shape[0]
    laid = cuda_dft._d_weights(weights, bins, halo)
    laid_tw = cuda_dft._d_twiddles(twiddles, bins, halo)
    tiles = -(-bins // (SLOTS - 2 * halo))
    assert laid.shape == (tiles, -(-krows // 32) * 32, 2 * SLOTS)
    assert laid_tw.shape == (tiles, twiddles.shape[1], 2 * SLOTS)
    assert not laid[:, krows:].any()
    covered = []
    for t in range(tiles):
        for s, kl, pos in tile_columns(t, bins, halo):
            kp = mirror(kl, bins, halo)
            re, im = laid[t, :krows, pos], laid[t, :krows, pos + 32]
            cos, sin = laid_tw[t, :, pos], laid_tw[t, :, pos + 32]
            if kp < 0:
                assert not re.any() and not im.any() and not cos.any() and not sin.any()
                continue
            assert torch.equal(re, weights[:, kp]) and torch.equal(im, weights[:, bins + kp])
            assert torch.equal(cos, twiddles[0, :, kp]) and torch.equal(sin, twiddles[1, :, kp])
            if halo <= s < SLOTS - halo and kl < bins:
                covered.append(kl)
    assert sorted(covered) == list(range(bins))


def blocks_of(x, *, stride, pad_left, num_blocks, rows):
    """(channels, num_blocks, rows) f32: block b is x[b*stride - pad_left :
    ... + rows], zeros outside the signal."""
    channels, length = x.shape
    xp = np.zeros((channels, pad_left + num_blocks * stride + rows), np.float32)
    xp[:, pad_left:pad_left + length] = x
    idx = np.arange(num_blocks)[:, None] * stride + np.arange(rows)[None, :]
    return xp[:, idx]


def stage_a_f32(blocks, w):
    """Kernel D's stage A replayed in f32: each 32-row chunk summed with
    f32 fused multiply-adds in row order (the product exact in f64, the sum
    rounded to f32), the chunk sums added in chunk order."""
    p = None
    for c0 in range(0, w.shape[0], 32):
        acc = np.zeros((*blocks.shape[:2], w.shape[1]), np.float32)
        for r in range(c0, c0 + 32):
            acc = (acc + blocks[..., r:r + 1].astype(np.float64)
                   * w[r].astype(np.float64)).astype(np.float32)
        p = acc if p is None else p + acc
    return p


def bench_geometry(rng, channels=2, length=6000):
    """The bench chain (firwin 255 taps at 48 kHz, cutoff 2 kHz; hann 512,
    hop 128, n_fft 512) on a few seeded noise channels."""
    x = rng.normal(size=(channels, length)).astype(np.float32)
    taps = firwin(255, [2000.0], sampling_rate=48000.0, device="cpu").numpy()
    return x, taps, 128, 512, "hann"


def test_d_stage_a_f32_order_meets_the_bin_gate(rng):
    """The f32 replay of stage A's two-level sum on the bench chain, then
    the plain stages B and C (`_shared_epilogue_torch`), against the f64
    chain (np.convolve 'same', frames, the periodic hann in f64, rfft,
    |.|^2): every bin, the low-pass stopband's included (where the window
    cancels the hop block's leakage ~660x), within 1e-4 of its own max."""
    x, taps, stride, n_fft, _ = bench_geometry(rng)
    length, bins, k = x.shape[-1], n_fft // 2 + 1, taps.size
    num_frames = (length - n_fft) // stride + 1
    pad_left = td._same_pad_left(k)
    weights = td.shared_fold_weights(taps, stride, n_fft, device="cpu").numpy()
    rows = -(-weights.shape[0] // 32) * 32
    w = np.zeros((rows, weights.shape[1]), np.float32)
    w[:weights.shape[0]] = weights
    j_taps = n_fft // stride
    blocks = blocks_of(x, stride=stride, pad_left=pad_left, num_blocks=num_frames + j_taps - 1,
                       rows=rows)
    p = torch.from_numpy(stage_a_f32(blocks, w))
    hann64 = tw.hann(n_fft, dtype=torch.float64, device="cpu")
    coeffs = td.recognize_cosine_window(hann64, n_fft)
    twiddles = td.shared_twiddles(stride, n_fft, device="cpu")
    out_r, out_i = td._shared_epilogue_torch(p, twiddles, coeffs,
                                             num_frames=num_frames, bins=bins, onesided=True)
    got = (out_r ** 2 + out_i ** 2).numpy().astype(np.float64)

    x64 = x.astype(np.float64)
    y = np.stack([np.convolve(c, taps)[(k - 1) // 2:][:length] for c in x64])
    frames = np.lib.stride_tricks.sliding_window_view(y, n_fft, axis=-1)[:, ::stride]
    want = np.abs(np.fft.rfft(frames[:, :num_frames] * hann64.numpy())) ** 2
    assert got.shape == want.shape
    err = np.abs(got - want).reshape(-1, bins).max(axis=0)
    scale = np.abs(want).reshape(-1, bins).max(axis=0)
    stopband = np.arange(bins) * 48000.0 / n_fft > 3000.0
    assert scale[stopband].max() < 1e-3 * scale.max()   # the cancellation is there
    assert (err <= 1e-4 * scale).all(), float((err / scale).max())


@pytest.mark.parametrize("n_fft,window_name", [
    (512, "hann"),        # the bench chain: 3 tiles of 94 bins
    (512, "blackman"),    # 2 neighbour bins
    (1024, "blackman"),   # 6 tiles of 92 bins
    (400, "blackman"),    # 201 bins: 3 tiles, the last one mostly past Nyquist
    (374, "hann"),        # 188 bins: the last tile ends on its edge
    (512, "hamming"),
])
def test_d_tiles_mirror_and_neighbour_columns(n_fft, window_name, rng):
    """What kernel D's stages B and C read from the layout of `_d_columns`
    (f64, no rounding): a column whose bin position kl lies past DC or
    Nyquist, its mirror bin's value with the Im negated, is the two-sided
    DFT's bin kl (mod n_fft) of a real frame; and each output column's
    window sum over the columns s - c and s + c of its own tile is the
    windowed frame's DFT at kl, DC and Nyquist included."""
    halo = halo_of(window_name, n_fft)
    bins = n_fft // 2 + 1
    window = getattr(tw, window_name)(n_fft, dtype=torch.float64, device="cpu")
    coeffs = td.recognize_cosine_window(window, n_fft)
    a = [coeffs[0]] + [b / 2.0 for b in coeffs[1:]]
    frame = rng.normal(size=n_fft)
    spectrum, want = np.fft.fft(frame), np.fft.rfft(frame * window.numpy())
    cols = cuda_dft._d_columns(bins, halo)
    covered = []
    for t in range(cols.shape[0]):
        kls, xs = np.empty(SLOTS, int), np.zeros(SLOTS, complex)
        for s, kl, pos in tile_columns(t, bins, halo):
            kls[s] = kl
            if cols[t, pos] >= 0:
                assert cols[t, pos + 32] == bins + cols[t, pos]
                x = spectrum[cols[t, pos]]
                xs[s] = x.conjugate() if kl < 0 or kl > bins - 1 else x
                assert xs[s] == pytest.approx(spectrum[kl % n_fft], abs=1e-9)
        for s in range(halo, SLOTS - halo):
            if kls[s] < bins:
                got = a[0] * xs[s] + sum(a[c] * (xs[s - c] + xs[s + c])
                                         for c in range(1, halo + 1))
                assert got == pytest.approx(want[kls[s]], abs=1e-9)
                covered.append(kls[s])
    assert sorted(covered) == list(range(bins))
