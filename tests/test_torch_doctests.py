"""The docstring examples of the PyTorch port, run in this process on the
CPU (the JAX package's examples run through tests/doctest_runner.py)."""

import doctest
import importlib

import pytest

#: every module of nx_signal_tpu_torch with >>> examples
MODULES = [
    "nx_signal_tpu_torch.kernels.cuda_dft",
    "nx_signal_tpu_torch.kernels.cuda_halo",
    "nx_signal_tpu_torch.kernels.dft",
    "nx_signal_tpu_torch.models.pipeline",
    "nx_signal_tpu_torch.ops.convolution",
    "nx_signal_tpu_torch.ops.filters",
    "nx_signal_tpu_torch.ops.ltisys",
    "nx_signal_tpu_torch.ops.transforms",
    "nx_signal_tpu_torch.ops.waveforms",
    "nx_signal_tpu_torch.ops.windows",
    "nx_signal_tpu_torch.parallel.estimation",
    "nx_signal_tpu_torch.parallel.mesh",
    "nx_signal_tpu_torch.parallel.sharded",
    "nx_signal_tpu_torch.spectral.estimation",
    "nx_signal_tpu_torch.spectral.framing",
    "nx_signal_tpu_torch.spectral.mel",
    "nx_signal_tpu_torch.spectral.short_time_fft",
    "nx_signal_tpu_torch.spectral.spectrogram",
    "nx_signal_tpu_torch.spectral.stft",
    "nx_signal_tpu_torch.utils.devices",
    "nx_signal_tpu_torch.utils.dtypes",
    "nx_signal_tpu_torch.utils.shapes",
]


@pytest.mark.parametrize("name", MODULES)
def test_docstring_examples(name):
    result = doctest.testmod(importlib.import_module(name),
                             optionflags=doctest.NORMALIZE_WHITESPACE)
    assert result.attempted > 0, f"{name} has no examples"
    assert result.failed == 0, f"{result.failed} of {result.attempted} examples failed"
