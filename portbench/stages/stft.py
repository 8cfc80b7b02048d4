"""Stage `stft`: the one-sided STFT of one call. Bytes: the signal read
(float32) and the complex64 spectrum written. Operations: the window and
a real FFT a frame."""

from portbench.core.work import bins, frames, rfft_flops


def work(cfg):
    rows, m = cfg["channels"], frames(cfg)
    flops = rows * m * (cfg["window"]["length"] + rfft_flops(cfg["frame"]["n_fft"]))
    return flops, rows * (4.0 * cfg["samples"] + 8.0 * m * bins(cfg))
