"""Stage `chain_filtered`: the chain of one call that also returns the
filtered signal. Bytes: the signal read, the filtered signal and the power
written (float32). Operations: as `chain_power`."""

from portbench.core.work import bins, fir_flops, frames, power_flops


def work(cfg):
    rows, length = cfg["channels"], cfg["samples"]
    m = frames(cfg)
    flops = rows * (fir_flops(length, cfg["fir"]["taps"]) + power_flops(cfg, m))
    return flops, 4.0 * rows * (2 * length + m * bins(cfg))
