"""Where the port's entry points put their data.

The port runs on the card unless the caller asks for the CPU: a signal
given as a tensor stays on its own device, and anything else (a numpy
array, a list) goes to the CUDA device. With no CUDA device that is an
error, never a quiet run on the CPU; the caller asks for the CPU by
passing a CPU tensor or `device='cpu'`.
"""

import torch

__all__ = ["card_device", "as_signal"]


def card_device() -> torch.device:
    """The current CUDA device; a RuntimeError that says how to ask for the
    CPU where there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: nx_signal_tpu_torch runs on the card unless asked for the "
            "CPU; pass a CPU tensor (e.g. torch.from_numpy(x)) or device='cpu'")
    return torch.device("cuda", torch.cuda.current_device())


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
