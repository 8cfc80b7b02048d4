"""Entry `roundtrip`: `stft(x, window, ..., onesided=True)` then
`istft(z, window, ..., onesided=True)` on each block, each call's z fed
straight to istft, each in a span of its own ('stft', 'istft'). stft runs
kernel B-fft; istft the framed inverse DFT (an exact float32 product), the
window, kernel C's overlap-add and the envelope's division.

Checked: every row of the last output of each block against the float64
reference (references/roundtrip.py). Numbers compared: `z_bin_rel_err`,
the largest over bins of max |z - z_ref| / max |z_ref| in that bin, and
`y_rel_err`, the largest |y - y_ref| weighted by the overlap-added squared
window over its largest value, over max |y_ref|.

Control: the reference's arithmetic in TF32 in the program's place.
"""

import torch
from torch.profiler import record_function

from portbench.core.compare import merge, worst_ratio
from portbench.core.design import signals, taps_and_window

REFERENCE = "roundtrip"


class Entry:
    def __init__(self, cfg, traffic, *, device, gen, mode, mesh, bench):
        from nx_signal_tpu_torch.spectral.stft import istft, stft

        self.stft, self.istft = stft, istft
        _, window = taps_and_window(cfg)
        self.window = torch.from_numpy(window)
        self.window_dev = self.window.to(device)
        self.rate = cfg["sampling_rate"]
        self.hop, self.n_fft = cfg["frame"]["hop"], cfg["frame"]["n_fft"]
        self.overlap = window.shape[0] - self.hop
        self.blocks = traffic["blocks"]
        self.x = signals(gen, self.blocks, cfg["channels"], cfg["samples"], device)
        self.samples_per_call = cfg["channels"] * cfg["samples"]
        self.ref = bench.module("references", REFERENCE)
        self.control = mode == "control"

    def call(self, i):
        x = self.x[i % self.blocks]
        if self.control:
            return self.ref.control_roundtrip(x, self.window_dev, self.hop, self.n_fft)
        with record_function("stft"):
            z = self.stft(x, self.window_dev, sampling_rate=self.rate, fft_length=self.n_fft,
                          overlap_length=self.overlap, onesided=True).z
        with record_function("istft"):
            y = self.istft(z, self.window_dev, fft_length=self.n_fft,
                           overlap_length=self.overlap, onesided=True)
        return z, y

    def free(self):
        self.stft = self.istft = None

    def judge(self, keep):
        zs, ys = [], []
        for b, (z, y) in keep.items():
            z_err, z_scale, y_err, y_scale = self.ref.errors(
                self.x[b], z, y, self.window.to(self.x.device), self.hop, self.n_fft)
            zs.append((z_err, z_scale))
            ys.append((y_err, y_scale))
        return {"z": zs, "y": ys}


def verdict(parts):
    """The numbers compared, over every rank's part."""
    ys = [pair for part in parts for pair in part["y"]]
    return {"z_bin_rel_err": worst_ratio(*merge([p for part in parts for p in part["z"]])),
            "y_rel_err": max(e for e, _ in ys) / max(s for _, s in ys)}
