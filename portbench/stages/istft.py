"""Stage `istft`: the one-sided inverse STFT of one call. Bytes: the
complex64 spectrum read and the float32 signal written. Operations: an
inverse real FFT, the window and the overlap-add a frame, and one division
a sample."""

from portbench.core.work import bins, frames, rfft_flops


def work(cfg):
    rows, m = cfg["channels"], frames(cfg)
    frame, hop = cfg["window"]["length"], cfg["frame"]["hop"]
    out = (m - 1) * hop + frame
    flops = rows * (m * (rfft_flops(cfg["frame"]["n_fft"]) + 2.0 * frame) + out)
    return flops, rows * (8.0 * m * bins(cfg) + 4.0 * out)
