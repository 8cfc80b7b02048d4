"""Faults planted in WhisperLogMel underneath a run of `logmel16k.whisper`
(`run.py --patch portbench.tests.logmel_faults:<name>`), each a departure
from Whisper's front end that a test sees come out not correct.

* `batch_floor`: the floor max - 8 taken over the whole batch, not per clip.
* `last_frame_kept`: the STFT's last frame kept (3001 frames, not 3000).
* `edge_3016`: the filterbank's top edge at NxSignal's rounded 3016.0.
* `no_floor`: the floor left out.
"""

import functools

import torch


def _pipeline():
    import nx_signal_tpu_torch.models.pipeline as pipeline

    return pipeline


def batch_floor():
    pipeline = _pipeline()
    log_mel = pipeline._log_mel

    def floored_over_the_batch(power, filters, freq_size, **_):
        return log_mel(power, filters, freq_size).transpose(-1, -2).contiguous()

    pipeline._log_mel = floored_over_the_batch


def edge_3016():
    pipeline = _pipeline()
    mel_filters = pipeline.mel_filters
    pipeline.mel_filters = lambda *a, **k: mel_filters(*a, **{**k, "max_mel": 3016.0})


def last_frame_kept():
    pipeline = _pipeline()
    stft = pipeline.stft

    @functools.wraps(stft)
    def one_more(*a, **k):
        out = stft(*a, **k)                 # the caller drops this extra frame
        return out._replace(z=torch.cat([out.z, out.z[..., -1:, :]], dim=-2))

    pipeline.stft = one_more


def no_floor():
    def log_mel(power, filters, freq_size, **_):
        mel = filters[:, :freq_size] @ power[..., :freq_size].transpose(-1, -2)
        return (torch.log10(torch.clamp(mel, min=1e-10)) + 4.0) / 4.0

    _pipeline()._log_mel = log_mel
