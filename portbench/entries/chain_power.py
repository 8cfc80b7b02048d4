"""Entry `chain_power`: the fused STFT+FIR power chain as users hold it, an
`StftFirChain` built once at set-up by `from_numpy` from the benchmark's
taps and window, called on each block: `chain(x)` -> (channels, frames,
bins) power. At precision 'high' kernel A-tc does the contraction, after
the wrapper lays the weights out for it on every call.

Checked: every row of the last output of each block against the float64
reference of the chain (references/chain_power.py), which works the
filter, frames and DFT out again from the taps and window and never reads
the module's folded weights. Number compared: `bin_rel_err`, the largest
over bins of max |p - p_ref| / max |p_ref| in that bin.

Control: the program's own lower path, the traffic's `control` precision
('default', one TF32 pass).
"""

import torch

from portbench.core.compare import merge, worst_ratio
from portbench.core.design import signals, taps_and_window

REFERENCE = "chain_power"


class Entry:
    def __init__(self, cfg, traffic, *, device, gen, mode, mesh, bench):
        from nx_signal_tpu_torch.models.pipeline import StftFirChain

        self.taps, self.window = taps_and_window(cfg)
        self.hop, self.n_fft = cfg["frame"]["hop"], cfg["frame"]["n_fft"]
        self.blocks = traffic["blocks"]
        self.x = signals(gen, self.blocks, cfg["channels"], cfg["samples"], device)
        self.samples_per_call = cfg["channels"] * cfg["samples"]
        self.frames = (cfg["samples"] - self.window.shape[0]) // self.hop + 1
        precision = traffic["precision"] if mode == "program" else traffic["control"]["precision"]
        self.chain = StftFirChain.from_numpy(self.taps, self.window, stride=self.hop,
                                             n_fft=self.n_fft, precision=precision, device=device)
        self.ref = bench.module("references", REFERENCE)

    def call(self, i):
        return self.chain(self.x[i % self.blocks])

    def free(self):
        del self.chain

    def judge(self, keep):
        parts = [self.ref.power_errors(self.x[b], out, torch.from_numpy(self.taps),
                                       torch.from_numpy(self.window), self.hop, self.n_fft,
                                       0, self.frames)
                 for b, out in keep.items()]
        return {"bins": parts}


def verdict(parts):
    """The numbers compared, over every rank's part."""
    return {"bin_rel_err": worst_ratio(*merge([p for part in parts for p in part["bins"]]))}
