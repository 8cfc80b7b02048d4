"""Stage `logmel`: Whisper's log-mel front end of one call, counted as its
work whatever implements it. Bytes: the clips read (float32) and the
log-mel written (float32, mels x the frames kept). Operations: the window,
a real FFT and |.|^2 of each centred frame, and a multiply-add for each
nonzero of the filterbank in each frame kept; the dense product over every
bin is not counted."""

from portbench.core.work import rfft_flops
from portbench.references.logmel import filterbank


def work(cfg):
    rows, length = cfg["channels"], cfg["samples"]
    n_fft, hop, mels = cfg["frame"]["n_fft"], cfg["frame"]["hop"], cfg["mel"]["bins"]
    frames = length // hop + 1          # centred frames; the last is dropped
    nonzeros = int((filterbank(mels, cfg["sampling_rate"], n_fft) != 0).sum())
    per_frame = cfg["window"]["length"] + rfft_flops(n_fft) + 3.0 * (n_fft // 2 + 1)
    flops = rows * (frames * per_frame + (frames - 1) * 2.0 * nonzeros)
    return flops, 4.0 * rows * (length + mels * (frames - 1))
