"""Stage `chain_power`: the FIR + framed power chain of one call, all rows.
Bytes: the signal read once and the power written once (float32).
Operations: the FIR by FFT, then the window, a real FFT and |.|^2 a frame.
At 768 x 480 000 (255 taps, hann 512, hop 128): 72.0 GFLOP, 4.43 GB."""

from portbench.core.work import bins, fir_flops, frames, power_flops


def work(cfg):
    rows, length = cfg["channels"], cfg["samples"]
    m = frames(cfg)
    flops = rows * (fir_flops(length, cfg["fir"]["taps"]) + power_flops(cfg, m))
    return flops, 4.0 * rows * (length + m * bins(cfg))
