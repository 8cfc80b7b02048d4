"""Entry `chain_power_sharded`: `sharded_fir_framed_dft_power(x, taps,
window, mesh=mesh, stride=hop, n_fft=n_fft, precision=...)` on each rank
of a (1, n_block) mesh, one rank a card, as the port's sharded tests call
it: every rank holds the whole signal on its card (made from the seed, so
alike on every rank) with the taps and window on the host; each folds the
weights, takes its time block with kernel E's halos from its neighbours
and contracts it (kernel A-tc at 'high'). Returns the rank's (channels,
frames per block, bins) shard.

Checked: on every rank, every row of the real frames of its shard of the
last output of each block against the float64 reference of the whole
signal's chain (references/chain_power.py) over the same frames, so the
frames that span a block edge, which take their samples from the
neighbours' halos, are held to the single-device reference. Number
compared: `bin_rel_err`, merged over the ranks as one spectrogram.

Control: the program's own lower path, the traffic's `control` precision.
"""

import torch

from portbench.core.compare import merge, worst_ratio
from portbench.core.design import signals, taps_and_window

REFERENCE = "chain_power"


class Entry:
    def __init__(self, cfg, traffic, *, device, gen, mode, mesh, bench):
        from nx_signal_tpu_torch.parallel.mesh import mesh_coordinate
        from nx_signal_tpu_torch.parallel.sharded import sharded_fir_framed_dft_power

        self.fn = sharded_fir_framed_dft_power
        self.mesh = mesh
        taps, window = taps_and_window(cfg)
        self.taps, self.window = torch.from_numpy(taps), torch.from_numpy(window)
        self.hop, self.n_fft = cfg["frame"]["hop"], cfg["frame"]["n_fft"]
        self.blocks = traffic["blocks"]
        self.precision = (traffic["precision"] if mode == "program"
                          else traffic["control"]["precision"])
        length, n_block = cfg["samples"], cfg["mesh"][1]
        self.x = signals(gen, self.blocks, cfg["channels"], length, device)
        self.samples_per_call = cfg["channels"] * length
        block_len = -(-length // (n_block * self.hop)) * self.hop
        per_block = block_len // self.hop
        total = (length - window.shape[0]) // self.hop + 1
        _, b = mesh_coordinate(mesh)
        self.f0, self.f1 = b * per_block, min((b + 1) * per_block, total)
        self.ref = bench.module("references", REFERENCE)

    def call(self, i):
        return self.fn(self.x[i % self.blocks], self.taps, self.window, mesh=self.mesh,
                       stride=self.hop, n_fft=self.n_fft, onesided=True,
                       precision=self.precision)

    def free(self):
        self.fn = None

    def judge(self, keep):
        if self.f1 <= self.f0:
            return {"bins": []}
        parts = [self.ref.power_errors(self.x[b], out[:, :self.f1 - self.f0], self.taps,
                                       self.window, self.hop, self.n_fft, self.f0, self.f1)
                 for b, out in keep.items()]
        return {"bins": parts}


def verdict(parts):
    """The numbers compared, over every rank's part."""
    return {"bin_rel_err": worst_ratio(*merge([p for part in parts for p in part["bins"]]))}
