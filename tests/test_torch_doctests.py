"""The docstring examples of the PyTorch port, run in this process on the
CPU (the JAX package's examples run through tests/doctest_runner.py)."""

import doctest
import importlib

import pytest

#: every module of nx_signal_tpu_torch with >>> examples
MODULES = [
    "nx_signal_tpu_torch.io.checkpoint",
    "nx_signal_tpu_torch.io.raw",
    "nx_signal_tpu_torch.io.wav",
    "nx_signal_tpu_torch.kernels.cuda_dft",
    "nx_signal_tpu_torch.kernels.cuda_halo",
    "nx_signal_tpu_torch.kernels.cuda_mel",
    "nx_signal_tpu_torch.kernels.dft",
    "nx_signal_tpu_torch.models.pipeline",
    "nx_signal_tpu_torch.ops.convolution",
    "nx_signal_tpu_torch.ops.czt",
    "nx_signal_tpu_torch.ops.filters",
    "nx_signal_tpu_torch.ops.find_peaks",
    "nx_signal_tpu_torch.ops.fir_design",
    "nx_signal_tpu_torch.ops.iir",
    "nx_signal_tpu_torch.ops.iir_design",
    "nx_signal_tpu_torch.ops.lambert_w",
    "nx_signal_tpu_torch.ops.ltisys",
    "nx_signal_tpu_torch.ops.mixing",
    "nx_signal_tpu_torch.ops.peak_finding",
    "nx_signal_tpu_torch.ops.resample",
    "nx_signal_tpu_torch.ops.splines",
    "nx_signal_tpu_torch.ops.transforms",
    "nx_signal_tpu_torch.ops.waveforms",
    "nx_signal_tpu_torch.ops.wavelets",
    "nx_signal_tpu_torch.ops.windows",
    "nx_signal_tpu_torch.parallel.estimation",
    "nx_signal_tpu_torch.parallel.failure",
    "nx_signal_tpu_torch.parallel.mesh",
    "nx_signal_tpu_torch.parallel.multihost",
    "nx_signal_tpu_torch.parallel.sharded",
    "nx_signal_tpu_torch.parallel.streaming",
    "nx_signal_tpu_torch.registry",
    "nx_signal_tpu_torch.spectral.estimation",
    "nx_signal_tpu_torch.spectral.framing",
    "nx_signal_tpu_torch.spectral.mel",
    "nx_signal_tpu_torch.spectral.short_time_fft",
    "nx_signal_tpu_torch.spectral.spectrogram",
    "nx_signal_tpu_torch.spectral.stft",
    "nx_signal_tpu_torch.utils.checks",
    "nx_signal_tpu_torch.utils.devices",
    "nx_signal_tpu_torch.utils.dtypes",
    "nx_signal_tpu_torch.utils.metrics",
    "nx_signal_tpu_torch.utils.profiling",
    "nx_signal_tpu_torch.utils.shapes",
]


@pytest.mark.parametrize("name", MODULES)
def test_docstring_examples(name):
    result = doctest.testmod(importlib.import_module(name),
                             optionflags=doctest.NORMALIZE_WHITESPACE)
    assert result.attempted > 0, f"{name} has no examples"
    assert result.failed == 0, f"{result.failed} of {result.attempted} examples failed"
