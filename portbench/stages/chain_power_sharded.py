"""Stage `chain_power_sharded`: one rank's part of the sharded chain, on a
(1, n_block) mesh: its time block of every row (block_len samples, a
multiple of the hop) read once, and its block's frames of power written
once (float32). Operations: as `chain_power` over the block."""

from portbench.core.work import bins, fir_flops, power_flops


def work(cfg):
    rows, hop, n_block = cfg["channels"], cfg["frame"]["hop"], cfg["mesh"][1]
    block_len = -(-cfg["samples"] // (n_block * hop)) * hop
    m = block_len // hop
    flops = rows * (fir_flops(block_len, cfg["fir"]["taps"]) + power_flops(cfg, m))
    return flops, 4.0 * rows * (block_len + m * bins(cfg))
