"""Where the port's entry points put their data: one rule for all of them.

* A tensor argument keeps its device.
* A numpy array or a list given as a signal goes to the card (`as_signal`).
* An entry point given no tensor at all (only sizes, scalars, numpy
  coefficients or strings: a window, a filter design, a frequency
  response, a filterbank, a wavelet, a set of chirp-z points) builds and
  computes on the card unless given `device=` (`target_device`).
* Where there is no card, that is a RuntimeError naming `device='cpu'`,
  never a quiet run on the CPU.

The caller asks for the CPU by passing a CPU tensor or `device='cpu'`;
code of the port that wants a host result (a window it reads as numpy, a
prototype it lays out on the host) names `device='cpu'` where it calls.
"""

import torch

__all__ = ["card_device", "target_device", "as_signal"]


def card_device() -> torch.device:
    """The current CUDA device; a RuntimeError that says how to ask for the
    CPU where there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: nx_signal_tpu_torch runs on the card unless asked for the "
            "CPU; pass a CPU tensor (e.g. torch.from_numpy(x)) or device='cpu'")
    return torch.device("cuda", torch.cuda.current_device())


def target_device(device=None) -> torch.device:
    """The device an entry point given no tensor builds on: `device` as
    given, None the card (`card_device`).

    Examples:

    >>> from nx_signal_tpu_torch.utils.devices import target_device
    >>> target_device("cpu")
    device(type='cpu')
    """
    return card_device() if device is None else torch.device(device)


def as_signal(x) -> torch.Tensor:
    """`x` as a tensor: a tensor as it is, on its own device; anything else
    on the CUDA device (`card_device`).

    Examples:

    >>> import numpy as np, torch
    >>> from nx_signal_tpu_torch.utils.devices import as_signal
    >>> as_signal(torch.from_numpy(np.ones(3, np.float32)))
    tensor([1., 1., 1.])
    """
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, device=card_device())
