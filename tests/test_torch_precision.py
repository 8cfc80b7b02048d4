"""The precision modes of the fused power chain (kernel A-tc's plain version)
against the JAX package, on the CPU, and the TF32 rounding they rest on.

'high' is 3xTF32 (x_lo W_hi + x_hi W_lo + x_hi W_hi with x and W split by
`_round_tf32`), 'default' one TF32 pass (x_hi W_hi); on a CPU tensor both
run `kernels.dft._framed_matmul_tf32_torch`, the products summed in f64.

Tolerances:
* 'high' against the JAX Pallas kernel at precision='high' (interpret mode,
  its bf16x3 split) and against the JAX XLA path at 'highest': 1e-4 x
  max|reference|, the JAX package's own gate for its split
  (tests/test_pallas_kernels.py:65-78).
* 'default' against the JAX XLA path at 'highest': 1e-2 x max, since TF32
  keeps 11 significant bits (~3 digits) of each operand.
* the rounding: exact (bit patterns).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nx_signal_tpu.kernels import dft as jd
from nx_signal_tpu.kernels.pallas_dft import fir_framed_dft_power_pallas
from nx_signal_tpu.ops import windows as jw
from nx_signal_tpu_torch.kernels import cuda_dft
from nx_signal_tpu_torch.kernels import dft as td


def assert_close_to_max(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("value,want", [
    (1.0, 1.0),                                     # already TF32
    (-1.5, -1.5),
    (2.0 ** -10 * 1023, 2.0 ** -10 * 1023),
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),           # a tie rounds away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -9),        # a tie above an odd TF32 value too
    (1.0 + 2.0 ** -12, 1.0),                        # below half an ulp
    (-(1.0 + 2.0 ** -12), -1.0),
    (1.0 + 2.0 ** -11 + 2.0 ** -20, 1.0 + 2.0 ** -10),
    (2.0 - 2.0 ** -11, 2.0),                        # the carry reaches the exponent
    (0.0, 0.0),
])
def test_round_tf32(value, want):
    got = td._round_tf32(torch.tensor([value], dtype=torch.float32))
    assert got.item() == want
    assert int(got.view(torch.int32)) & 0x1FFF == 0


def test_tf32_split_keeps_22_bits(rng):
    x = torch.from_numpy(rng.normal(size=10000).astype(np.float32) * 10.0 ** rng.integers(
        -6, 6, size=10000).astype(np.float32))
    hi, lo = td._tf32_split(x)
    assert not bool((hi.view(torch.int32) & 0x1FFF).any())
    assert not bool((lo.view(torch.int32) & 0x1FFF).any())
    assert torch.equal(td._round_tf32(hi), hi)                 # idempotent
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
    assert torch.equal(td._round_tf32(-x), -hi)                # both signs alike


PRECISION_GEOMETRIES = [  # batch, length, taps, frame, hop, n_fft
    ((2,), 5000, 255, 512, 128, 512),   # the bench chain's shape family
    ((1,), 3000, 100, 256, 128, 256),   # even taps
    ((2,), 3000, 64, 400, 100, 512),    # hop 100 (no Pallas kernel), frame < n_fft
    ((), 4000, 63, 256, 128, 256),      # a 1-D signal
]


@pytest.mark.parametrize("geometry", PRECISION_GEOMETRIES)
def test_high_matches_jax(geometry, rng):
    batch, length, k, frame, hop, n_fft = geometry
    x = rng.normal(size=(*batch, length)).astype(np.float32)
    taps = rng.normal(size=k).astype(np.float32)
    window = np.asarray(jw.hann(frame))
    kw = dict(stride=hop, n_fft=n_fft, onesided=True, output="power")
    got = td.fir_framed_dft(torch.from_numpy(x), taps, window, precision="high", **kw)
    exact = np.asarray(jd.fir_framed_dft(jnp.asarray(x), taps, window, precision="highest",
                                         kernel="xla", **kw))
    assert got.dtype == torch.float32
    assert_close_to_max(got, exact, 1e-4)
    if hop % 128 == 0:
        split = np.asarray(fir_framed_dft_power_pallas(
            x, taps, window, stride=hop, n_fft=n_fft, precision="high", interpret=True))
        assert_close_to_max(got, split, 1e-4)


@pytest.mark.parametrize("geometry", PRECISION_GEOMETRIES[:3])
def test_default_matches_jax_to_tf32(geometry, rng):
    batch, length, k, frame, hop, n_fft = geometry
    x = rng.normal(size=(*batch, length)).astype(np.float32)
    taps = rng.normal(size=k).astype(np.float32)
    window = np.asarray(jw.hann(frame))
    kw = dict(stride=hop, n_fft=n_fft, onesided=True, output="power")
    got = td.fir_framed_dft(torch.from_numpy(x), taps, window, precision="default", **kw)
    exact = np.asarray(jd.fir_framed_dft(jnp.asarray(x), taps, window, precision="highest",
                                         kernel="xla", **kw))
    assert_close_to_max(got, exact, 1e-2)
    high = td.fir_framed_dft(torch.from_numpy(x), taps, window, precision="high", **kw)
    assert not torch.equal(got, high)   # one pass, not three


@pytest.mark.parametrize("precision,passes", [("high", 3), ("default", 1)])
def test_precision_routes_to_the_tc_plain_version(precision, passes, rng):
    """On a CPU tensor, 'high' and 'default' are kernel A-tc's plain version
    (no kernel launches) and 'highest' kernel A's; the TF32 plain version
    sums x_hi (W_hi + W_lo) + x_lo W_hi in f64."""
    x = torch.from_numpy(rng.normal(size=(2, 3000)).astype(np.float32))
    taps, window = rng.normal(size=51), np.asarray(jw.hann(256))
    weights = td.fir_dft_fold_weights(taps, window, 256, True, device="cpu")
    args = dict(stride=128, pad_left=td._same_pad_left(51), num_frames=(3000 - 256) // 128 + 1,
                bins=129)
    before = (cuda_dft.fir_framed_dft_power_cuda.launches,
              cuda_dft.fir_framed_dft_power_tc_cuda.launches)
    got = td.fir_framed_dft(x, taps, window, stride=128, n_fft=256, onesided=True,
                            output="power", precision=precision)
    assert torch.equal(got, cuda_dft.fir_framed_dft_power_tc_cuda(x, weights, precision=precision,
                                                                  **args))
    assert torch.equal(got, td._framed_matmul_tf32_torch(x, weights, passes=passes, **args))
    assert (cuda_dft.fir_framed_dft_power_cuda.launches,
            cuda_dft.fir_framed_dft_power_tc_cuda.launches) == before
    highest = td.fir_framed_dft(x, taps, window, stride=128, n_fft=256, onesided=True,
                                output="power", precision="highest")
    assert torch.equal(highest, td._framed_matmul_torch(x, weights, power=True, **args))
    x_hi, x_lo = td._tf32_split(x)
    w_hi, w_lo = td._tf32_split(weights)
    terms = [(x_hi, w_hi)] + ([(x_hi, w_lo), (x_lo, w_hi)] if passes == 3 else [])
    ref = sum(td._frame_contract(a, b, stride=128, pad_left=args["pad_left"],
                                 num_frames=args["num_frames"], dtype=torch.float64)
              for a, b in terms).float()
    assert_close_to_max(got, (ref[..., :129] ** 2 + ref[..., 129:] ** 2).numpy(), 1e-6)


def test_tf32_passes_rejects_other_precisions():
    with pytest.raises(ValueError, match="'high' or 'default'"):
        td._tf32_passes("highest")


def test_tc_weight_layout(rng):
    """Kernel A-tc's weights at 'high' (`_tc_weights` with 3 passes; random
    weights, so not packed): per tile of 64 bins, rows padded to the chunk,
    Re then Im columns of the tile's bins, W_hi and W_lo of each stage's
    rows laid out as wgmma's K-major core matrices; undone, each (hi, lo)
    TF32 pair adds back to the f32 weight within 2^-22."""
    krows, bins = 130, 129
    w = torch.from_numpy(rng.normal(size=(krows, 2 * bins)).astype(np.float32))
    laid, packed = cuda_dft._tc_weights(w, bins, 3)
    assert not packed and laid.is_contiguous()
    tiles = -(-bins // cuda_dft._TC_TILE_BINS)
    krows_pad = -(-krows // cuda_dft._TC_CHUNK) * cuda_dft._TC_CHUNK
    rows = cuda_dft._TC_CHUNK // 2   # per stage: W_hi then W_lo of these rows
    assert laid.shape == (tiles, krows_pad // rows, 2 * rows * 2 * cuda_dft._TC_TILE_BINS)
    # (tile, stage, part, step, half, group, col, kk) -> (tile, part, k, n)
    t = laid.reshape(tiles, krows_pad // rows, 2, rows // 8, 2, 16, 8, 4).permute(
        0, 2, 1, 3, 4, 7, 5, 6).reshape(tiles, 2, krows_pad, 2 * cuda_dft._TC_TILE_BINS)
    assert not bool(t[:, :, krows:].any())
    pair = t[:, 0].double() + t[:, 1].double()
    for b in range(bins):
        tile, col = divmod(b, cuda_dft._TC_TILE_BINS)
        for part in (0, 1):
            got = pair[tile, :krows, part * cuda_dft._TC_TILE_BINS + col]
            want = w[:, part * bins + b].double()
            assert bool(((got - want).abs() <= 2.0 ** -22 * want.abs()).all())
    last = bins - (tiles - 1) * cuda_dft._TC_TILE_BINS
    assert not bool(t[-1, :, :, last:cuda_dft._TC_TILE_BINS].any())
    assert not bool(t[-1, :, :, cuda_dft._TC_TILE_BINS + last:].any())
