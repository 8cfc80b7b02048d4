"""Entry `chain_filtered`: `stft_fir_chain(x, taps, window, ...,
fir_method='direct', return_filtered=True)` on each block, the function's
default form, returning the filtered signal and its power. The direct FIR
is an exact float32 convolution and the power kernel B-fft's framed FFT;
the fused contraction (kernels A, A-tc) is bypassed.

Checked: every row of the last output of each block against the float64
reference (references/chain_power.py). Numbers compared: `y_rel_err`,
max |y - y_ref| over max |y_ref|, and `bin_rel_err`, the largest over
bins of max |p - p_ref| / max |p_ref| in that bin.

Control: the reference's arithmetic in TF32 (`control_fir`,
`control_spectrum`) in the program's place; the program has no lower path
of its own here.
"""

import torch

from portbench.core.compare import merge, worst_ratio
from portbench.core.design import signals, taps_and_window

REFERENCE = "chain_power"


class Entry:
    def __init__(self, cfg, traffic, *, device, gen, mode, mesh, bench):
        from nx_signal_tpu_torch.models.pipeline import stft_fir_chain

        self.stft_fir_chain = stft_fir_chain
        taps, window = taps_and_window(cfg)
        self.taps, self.window = torch.from_numpy(taps), torch.from_numpy(window)
        self.taps_dev, self.window_dev = self.taps.to(device), self.window.to(device)
        self.rate = cfg["sampling_rate"]
        self.hop, self.n_fft = cfg["frame"]["hop"], cfg["frame"]["n_fft"]
        self.blocks = traffic["blocks"]
        self.precision = traffic["precision"]
        self.x = signals(gen, self.blocks, cfg["channels"], cfg["samples"], device)
        self.samples_per_call = cfg["channels"] * cfg["samples"]
        self.frames = (cfg["samples"] - window.shape[0]) // self.hop + 1
        self.ref = bench.module("references", REFERENCE)
        self.control = mode == "control"

    def call(self, i):
        x = self.x[i % self.blocks]
        if self.control:
            y = self.ref.control_fir(x, self.taps_dev)
            re, im = self.ref.control_spectrum(y, self.window_dev, self.hop, self.n_fft)
            return y, re * re + im * im
        return self.stft_fir_chain(
            x, self.taps_dev, self.window_dev, fft_length=self.n_fft,
            overlap_length=self.window.shape[0] - self.hop, sampling_rate=self.rate,
            fir_method="direct", onesided=True, return_filtered=True, precision=self.precision)

    def free(self):
        self.stft_fir_chain = None

    def judge(self, keep):
        bins, ys = [], []
        taps, window = self.taps.to(self.x.device), self.window.to(self.x.device)
        rows = self.ref.ROWS
        for b, (y, p) in keep.items():
            x = self.x[b]
            err = scale = 0.0
            for r in range(0, x.shape[0], rows):
                y_ref = self.ref.fir_same(x[r:r + rows], taps, 0, x.shape[-1])
                err = max(err, float((y[r:r + rows].double() - y_ref).abs().max()))
                scale = max(scale, float(y_ref.abs().max()))
                bins.append(self.ref.bin_errors(
                    p[r:r + rows], self.ref.frames_power(y_ref, window, self.hop, self.n_fft)))
            ys.append((err, scale))
        return {"bins": [tuple(t.cpu() for t in merge(bins))], "y": ys}


def verdict(parts):
    """The numbers compared, over every rank's part."""
    ys = [pair for part in parts for pair in part["y"]]
    return {"y_rel_err": max(e for e, _ in ys) / max(s for _, s in ys),
            "bin_rel_err": worst_ratio(*merge([p for part in parts for p in part["bins"]]))}
