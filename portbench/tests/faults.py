"""Faults planted in the program underneath a run (`run.py --patch
portbench.tests.faults:<name>`), each at the place where the program
produces the answer, so that a test can see `correct` come out false.

* `alter_answer`: one frame of the first row takes its neighbour's value.
* `half_batch`: the second half of the rows is never produced (zeros).
* `stale_answer`: a call returns the answer of the call before it, as a
  step that leaves its state unchanged would.
* `no_exchange`: the sharded chain's halos are zeros, as if the exchange
  between cards were left out.
"""

import functools

import torch

# where each cell's answers are produced: (module, name)
SITES = (
    ("nx_signal_tpu_torch.models.pipeline", "fir_framed_dft_power_cuda"),   # StftFirChain
    ("nx_signal_tpu_torch.models.pipeline", "framed_dft"),                  # filtered power
    ("nx_signal_tpu_torch.models.pipeline", "convolve"),                    # filtered signal
    ("nx_signal_tpu_torch.spectral.stft", "framed_dft"),                    # stft's spectrum
    ("nx_signal_tpu_torch.spectral.stft", "_ola_fold"),                     # istft's fold
    ("nx_signal_tpu_torch.parallel.sharded", "fir_framed_dft_power_cuda"),  # a rank's shard
)


def _wrap_all(change):
    import importlib

    for module, name in SITES:
        mod = importlib.import_module(module)
        setattr(mod, name, change(getattr(mod, name)))


def _alter(out):
    out = out.clone()
    if out.ndim >= 3:
        out[0, 1] = out[0, 2].clone()
    else:
        row = out.reshape(-1, out.shape[-1])[0]
        row[1000:1100] = row[1100:1200].clone()
    return out


def alter_answer():
    _wrap_all(lambda fn: functools.wraps(fn)(lambda *a, **k: _alter(fn(*a, **k))))


def _half(out):
    out = out.clone()
    if out.ndim >= 2 and out.shape[0] > 1:
        out[out.shape[0] // 2:] = 0
    return out


def half_batch():
    _wrap_all(lambda fn: functools.wraps(fn)(lambda *a, **k: _half(fn(*a, **k))))


def stale_answer():
    def change(fn):
        last = {}

        @functools.wraps(fn)
        def stale(*a, **k):
            out = fn(*a, **k)
            key = tuple(out.shape)
            previous = last.get(key, out)
            last[key] = out
            return previous
        return stale

    _wrap_all(change)


def no_exchange():
    import nx_signal_tpu_torch.parallel.sharded as sharded

    def zeros(x_blk, pad_left, pad_right, *, mesh):
        return torch.nn.functional.pad(x_blk, (pad_left, pad_right))

    sharded.halo_extend_cuda = zeros
