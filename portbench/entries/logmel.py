"""Entry `logmel`: `WhisperLogMel(n_mels)(x)` on each block of clips, the
module built once at set-up (its window and filterbank are buffers). It
runs the centred STFT with reflect padding (kernel B-fft on the card), the
power, the exact-float32 mel product, the log, each clip's floor and the
scaling.

The inputs: `channels` clips of `samples` float32 samples a block, unit
white noise, each clip cut to a length drawn log-normal in seconds and
zero-padded to the chunk (`traffic.clip_seconds`, scaled to `samples`
where a test cuts them), each at a gain drawn uniform in dB
(`traffic.gain_db`), all drawn on the device from the seed.

Checked: every clip of the last output of each block against the float64
reference (references/logmel.py). The number compared, `logmel_abs_err`,
is the largest error of a log-mel value, each weighed by how well the
reference's value is conditioned (`references/logmel.py:errors`); inf for
a wrong shape.

Control: the reference's arithmetic in float32 with the mel product in
TF32, in the program's place.
"""

import math

import torch

from portbench.core.design import signals

REFERENCE = "logmel"


def clips(gen, blocks: int, rows: int, samples: int, cfg: dict, traffic: dict, device):
    """`blocks` (rows, samples) float32 blocks of clips: white noise, zero
    past each clip's drawn length, times its drawn gain."""
    x = signals(gen, blocks, rows, samples, device)
    c = traffic["clip_seconds"]
    draw = torch.randn((blocks, rows), generator=gen, device=device, dtype=torch.float64)
    seconds = torch.exp(math.log(c["median"]) + c["sigma"] * draw).clamp(c["min"], c["max"])
    length = torch.round(seconds / cfg["chunk_seconds"] * samples)
    lo, hi = traffic["gain_db"]
    gain_db = lo + (hi - lo) * torch.rand((blocks, rows), generator=gen, device=device,
                                          dtype=torch.float64)
    gain = torch.pow(10.0, gain_db / 20.0).float()
    t = torch.arange(samples, device=device)
    for b in range(blocks):
        x[b].mul_(t < length[b, :, None]).mul_(gain[b, :, None])
    return x


class Entry:
    def __init__(self, cfg, traffic, *, device, gen, mode, mesh, bench):
        from nx_signal_tpu_torch.models.pipeline import WhisperLogMel

        frame = cfg["frame"]
        self.args = (cfg["mel"]["bins"], cfg["sampling_rate"], frame["n_fft"], frame["hop"])
        self.frontend = WhisperLogMel(self.args[0], device=device)
        self.blocks = traffic["blocks"]
        self.x = clips(gen, self.blocks, cfg["channels"], cfg["samples"], cfg, traffic, device)
        self.samples_per_call = cfg["channels"] * cfg["samples"]
        self.ref = bench.module("references", REFERENCE)
        self.control = mode == "control"

    def call(self, i):
        x = self.x[i % self.blocks]
        if self.control:
            return self.ref.control_log_mel(x, *self.args)
        return self.frontend(x)

    def free(self):
        self.frontend = None

    def judge(self, keep):
        return {"errs": [self.ref.errors(m, self.x[b], *self.args) for b, m in keep.items()]}


def verdict(parts):
    """The number compared, over every rank's part: NaN where any block's
    is, inf where no block was judged."""
    errs = [e for part in parts for e in part["errs"]]
    if any(math.isnan(e) for e in errs):
        return {"logmel_abs_err": math.nan}
    return {"logmel_abs_err": max(errs, default=math.inf)}
