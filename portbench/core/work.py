"""Operation counts of the least-work route of each stage, shared by the
stage files (portbench/stages/): an FFT of n real points is 2.5 n log2 n
operations, and a FIR of K taps is an FFT overlap-save convolution of
length 2 x the power of two >= K."""

import math


def rfft_flops(n: int) -> float:
    return 2.5 * n * math.log2(n)


def fir_flops(length: int, num_taps: int) -> float:
    """A forward and an inverse real FFT and a complex product per block of
    n - K + 1 outputs of one row of `length` samples."""
    n = 2 * (1 << (num_taps - 1).bit_length())
    blocks = -(-length // (n - num_taps + 1))
    return blocks * (2 * rfft_flops(n) + 6.0 * (n // 2 + 1))


def frames(cfg: dict, length: int = None) -> int:
    length = cfg["samples"] if length is None else length
    return (length - cfg["window"]["length"]) // cfg["frame"]["hop"] + 1


def bins(cfg: dict) -> int:
    return cfg["frame"]["n_fft"] // 2 + 1


def power_flops(cfg: dict, num_frames: int) -> float:
    """The window, one real FFT and |.|^2 of each frame."""
    return num_frames * (cfg["window"]["length"] + rfft_flops(cfg["frame"]["n_fft"])
                         + 3.0 * bins(cfg))
