"""The port's top level: every name of the JAX package's `__all__` that the
port defines somewhere (a public name of one of its modules, or one of its
submodules) imports from `nx_signal_tpu_torch`, as it does from
`nx_signal_tpu`. The seed of a registry meta-test for the port's exports.
"""

import ast
import importlib
import inspect
import os
import pathlib
import pkgutil
import subprocess
import sys

import pytest

import nx_signal_tpu
import nx_signal_tpu_torch


def _port_definitions():
    """name -> the port object: the names in each module's __all__, the
    public functions and classes each module defines, then the modules."""
    defined, modules = {}, {}
    for info in pkgutil.walk_packages(nx_signal_tpu_torch.__path__, "nx_signal_tpu_torch."):
        module = importlib.import_module(info.name)
        modules.setdefault(info.name.rsplit(".", 1)[-1], module)
        for name in getattr(module, "__all__", ()):
            defined.setdefault(name, getattr(module, name))
        for name, obj in vars(module).items():
            if not name.startswith("_") and getattr(obj, "__module__", None) == info.name:
                defined.setdefault(name, obj)
    for name, module in modules.items():
        defined.setdefault(name, module)
    return defined


DEFINED = _port_definitions()
SHARED = sorted(set(nx_signal_tpu.__all__) & set(DEFINED))


@pytest.mark.parametrize("name", SHARED)
def test_ported_name_imports_from_the_top_level(name):
    assert name in nx_signal_tpu_torch.__all__
    exported = getattr(nx_signal_tpu_torch, name)
    if name in ("windows", "waveforms", "transforms", "convolution", "filters", "iir",
                "iir_design", "ltisys"):
        assert exported is importlib.import_module(f"nx_signal_tpu_torch.ops.{name}")
    else:
        assert exported is DEFINED[name]


def test_the_faults_names_are_exported():
    """The 15 names that were defined but not exported (boxcar, triang and
    kaiser_bessel_derived are imported at the JAX package's top level,
    outside its __all__), and the IIR slice's."""
    for name in ("check_COLA", "check_NOLA", "correlation_lags", "deconvolve",
                 "choose_conv_method", "findfreqs", "sinc", "windows", "waveforms",
                 "transforms", "convolution", "filters", "lfilter", "sosfiltfilt", "butter",
                 "band_stop_obj", "iirdesign", "remez", "normalize", "BadCoefficients", "iir",
                 "iir_design", "ltisys"):
        assert name in SHARED
    for name in ("boxcar", "triang", "kaiser_bessel_derived"):
        assert getattr(nx_signal_tpu_torch, name) is DEFINED[name]
        assert hasattr(nx_signal_tpu, name)
    from nx_signal_tpu_torch import deconvolve  # noqa: F401


def test_the_resampling_slice_names_are_exported():
    """The six names of the JAX `ops/resample.py` `__all__`, the two of
    `mixing.py`, hilbert / hilbert2 / envelope and the three sharded
    polyphase functions import from the port's top level (the JAX top level
    has all but `pfb_footprint_bytes` and the sharded ones in its
    `__all__`)."""
    from nx_signal_tpu.ops import mixing, resample

    names = [*resample.__all__, *mixing.__all__, "hilbert", "hilbert2", "envelope",
             "sharded_upfirdn", "sharded_resample_poly", "sharded_pfb_analyze"]
    for name in names:
        assert name in nx_signal_tpu_torch.__all__
        assert getattr(nx_signal_tpu_torch, name) is DEFINED[name]
    assert set(names) - set(SHARED) == {"pfb_footprint_bytes", "sharded_upfirdn",
                                        "sharded_resample_poly", "sharded_pfb_analyze"}
    assert nx_signal_tpu_torch.mixing is importlib.import_module("nx_signal_tpu_torch.ops.mixing")


@pytest.mark.parametrize("module", ["io", "io.checkpoint", "io.wav", "io.raw",
                                    "parallel.streaming", "parallel.failure"])
def test_the_streaming_slice_modules_have_the_jax_names(module):
    """The modules of the streaming, IO, checkpoint and recovery slice export
    the JAX modules' `__all__`, each name defined by the port."""
    jax_module = importlib.import_module(f"nx_signal_tpu.{module}")
    port_module = importlib.import_module(f"nx_signal_tpu_torch.{module}")
    assert port_module.__all__ == jax_module.__all__
    for name in port_module.__all__:
        assert getattr(port_module, name).__module__.startswith("nx_signal_tpu_torch.")


def test_the_pipeline_slice_names():
    """WidebandReceiver and channelize_power_stream complete the JAX
    `models/pipeline.py` `__all__` in the port."""
    from nx_signal_tpu.models import pipeline as jax_pipeline
    from nx_signal_tpu_torch.models import pipeline as port_pipeline

    assert set(port_pipeline.__all__) == set(jax_pipeline.__all__) | {"StftFirChain",
                                                                       "WhisperLogMel"}
    for name in ("WidebandReceiver", "channelize_power_stream"):
        assert DEFINED[name] is getattr(port_pipeline, name)


def test_every_jax_name_is_exported():
    """After the rest of `ltisys`, every name of the JAX `__all__` has a
    counterpart at the port's top level; `peak_finding` is the module,
    `__version__` the JAX package's."""
    missing = set(nx_signal_tpu.__all__) - set(nx_signal_tpu_torch.__all__)
    assert missing == set()
    assert nx_signal_tpu_torch.__version__ == nx_signal_tpu.__version__
    assert nx_signal_tpu_torch.peak_finding is importlib.import_module(
        "nx_signal_tpu_torch.ops.peak_finding")
    for module in ("waveforms", "peak_finding", "wavelets", "find_peaks", "czt", "lambert_w",
                   "splines", "ltisys"):
        jax_module = importlib.import_module(f"nx_signal_tpu.ops.{module}")
        port_module = importlib.import_module(f"nx_signal_tpu_torch.ops.{module}")
        assert port_module.__all__ == jax_module.__all__
        for name in port_module.__all__:
            assert name in nx_signal_tpu_torch.__all__ or name == "Extrema"
            assert getattr(port_module, name).__module__ == port_module.__name__


@pytest.mark.parametrize("package", ["spectral", "utils"])
def test_the_subpackages_export_the_jax_names(package):
    """`nx_signal_tpu_torch.spectral` and `.utils` re-export the JAX
    subpackages' `__all__`, each name the object its port module defines;
    `stft` and `spectrogram` are the functions, as in the JAX package."""
    jax_package = importlib.import_module(f"nx_signal_tpu.{package}")
    port_package = importlib.import_module(f"nx_signal_tpu_torch.{package}")
    assert port_package.__all__ == jax_package.__all__
    for name in port_package.__all__:
        namespace = {}
        exec(f"from nx_signal_tpu_torch.{package} import {name}", namespace)
        obj = namespace[name]
        assert not inspect.ismodule(obj), name
        owner = getattr(obj, "__module__", None) or ""
        if not owner.startswith(f"nx_signal_tpu_torch.{package}."):  # DEFAULT_FLOAT
            owner = f"nx_signal_tpu_torch.{package}.dtypes"
        assert getattr(importlib.import_module(owner), name) is obj, name
    if package == "spectral":
        stft_module = importlib.import_module("nx_signal_tpu_torch.spectral.stft")
        assert port_package.stft is stft_module.stft
        assert port_package.spectrogram is importlib.import_module(
            "nx_signal_tpu_torch.spectral.spectrogram").spectrogram


_ROOT = pathlib.Path(nx_signal_tpu_torch.__file__).parent
_WHOLE_PORT = """
import importlib, pkgutil
import nx_signal_tpu_torch
for info in pkgutil.walk_packages(nx_signal_tpu_torch.__path__, "nx_signal_tpu_torch."):
    importlib.import_module(info.name)
from nx_signal_tpu_torch.spectral import *
from nx_signal_tpu_torch.utils import *
import nx_signal_tpu_torch.spectral as spectral
assert callable(spectral.stft) and callable(spectral.spectrogram)
assert callable(welch) and callable(next_fast_len)
"""


def test_the_whole_port_imports_whatever_module_comes_first():
    """A fresh interpreter imports the package, every module of the port,
    then the subpackages' names. Whatever module a program imports first,
    the package's `__init__` runs before it, its imports in the linter's
    order and with no order of its own: no subpackage reaches back into one
    that is still being built (the kernels import nothing above `utils`,
    test_kernels_import_nothing_from_the_layers_above_them), so this one
    start covers every start."""
    env = {**os.environ, "PYTHONPATH": str(_ROOT.parent)}
    out = subprocess.run([sys.executable, "-c", _WHOLE_PORT], cwd=_ROOT.parent, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]


def _imported_modules(path):
    """Every module the file imports, at the top or inside a function."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            yield from (f"{node.module}.{alias.name}" for alias in node.names)


def test_kernels_import_nothing_from_the_layers_above_them():
    """No module of `kernels/` imports `spectral` or `models`, at the top
    or inside a function: the kernels and their plain versions sit below
    the entry points that route to them."""
    root = pathlib.Path(nx_signal_tpu_torch.__file__).parent / "kernels"
    files = sorted(root.glob("*.py"))
    assert len(files) >= 5
    for path in files:
        for name in _imported_modules(path):
            parts = name.split(".")
            assert not (parts[0] == "nx_signal_tpu_torch" and len(parts) > 1
                        and parts[1] in ("spectral", "models")), (path.name, name)


def test_port_sources_import_no_jax_scipy_or_the_jax_package():
    """The port imports torch and numpy (and the standard library) only."""
    root = pathlib.Path(nx_signal_tpu_torch.__file__).parent
    files = sorted(root.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        for line in path.read_text().splitlines():
            words = line.strip().replace(",", " ").split()
            if words[:1] not in (["import"], ["from"]) or len(words) < 2:
                continue
            top = words[1].split(".")[0]
            assert top not in ("jax", "jaxlib", "scipy", "nx_signal_tpu"), (path, line)
