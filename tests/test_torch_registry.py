"""The port's registry (nx_signal_tpu_torch/registry.py): the five checks of
the JAX package's meta-test (tests/test_registry.py) over the port's
modules, and every entry of the JAX registry has its counterpart, with the
same category, under the stated mapping of the Pallas kernels to their
Hopper counterparts."""

import importlib
import inspect

import pytest

from nx_signal_tpu import registry as jax_registry
from nx_signal_tpu_torch.registry import FUNCTION_TYPES, TAXONOMY, function_type

# types, containers and constants re-exported for convenience, as in the
# JAX meta-test
_EXEMPT = {"STFTResult", "Extrema", "GaussianPulse", "CHANNEL_AXIS", "BLOCK_AXIS"}

# (JAX module, JAX name) -> [(port module, port name)] where they differ:
# each Pallas kernel goes to the Hopper kernel(s) of its contract
KERNEL_MAP = {
    ("kernels.pallas_dft", "fir_framed_dft_power_pallas"): [
        ("kernels.cuda_dft", "fir_framed_dft_power_cuda"),
        ("kernels.cuda_dft", "fir_framed_dft_power_tc_cuda")],
    ("kernels.pallas_dft", "framed_dft_pallas"): [
        ("kernels.cuda_dft", "framed_fft_cuda"), ("kernels.cuda_dft", "framed_dft_cuda")],
    ("kernels.pallas_dft", "overlap_add_pallas"): [("kernels.cuda_dft", "overlap_add_cuda")],
    ("kernels.pallas_dft", "fir_framed_dft_power_shared_pallas"): [
        ("kernels.cuda_dft", "fir_framed_dft_power_shared_cuda")],
    ("kernels.pallas_dft", "pallas_dft_supported"): [("kernels.cuda_dft", "fft_kernel_takes")],
    ("kernels.pallas_halo", "halo_extend_dma"): [("kernels.cuda_halo", "halo_extend_cuda")],
}

ENTRIES = sorted((module, name) for module, functions in FUNCTION_TYPES.items()
                 for name in functions)


def _port(module):
    return importlib.import_module(f"nx_signal_tpu_torch.{module}")


def test_all_categories_valid():
    assert TAXONOMY == jax_registry.TAXONOMY
    for module, functions in FUNCTION_TYPES.items():
        for name, category in functions.items():
            assert category in TAXONOMY, f"{module}.{name} has invalid category {category!r}"


@pytest.mark.parametrize("module", sorted(FUNCTION_TYPES))
def test_registered_functions_exist(module):
    mod = _port(module)
    for name in FUNCTION_TYPES[module]:
        assert hasattr(mod, name), f"registered {module}.{name} does not exist"


@pytest.mark.parametrize("module", sorted(FUNCTION_TYPES))
def test_every_public_export_is_registered(module):
    for name in getattr(_port(module), "__all__", []):
        if name in _EXEMPT:
            continue
        assert function_type(module, name) is not None, (
            f"public export {module}.{name} is not registered in "
            "nx_signal_tpu_torch.registry.FUNCTION_TYPES")


def test_registered_functions_have_docstrings():
    for module, name in ENTRIES:
        assert (getattr(_port(module), name).__doc__ or "").strip(), f"{module}.{name}"


def test_every_registered_export_has_executed_examples():
    """Every registered name carries a `>>>` example, which
    tests/test_torch_doctests.py runs."""
    missing = [f"{module}.{name}" for module, name in ENTRIES
               if ">>>" not in (inspect.getdoc(getattr(_port(module), name)) or "")]
    assert not missing, f"exports without doc examples: {missing}"


@pytest.mark.parametrize("module", sorted(jax_registry.FUNCTION_TYPES))
def test_every_jax_entry_has_its_counterpart(module):
    """Each (module, name, category) of the JAX registry is registered in the
    port with the same category: at the same module and name, or where
    KERNEL_MAP sends a Pallas kernel."""
    for name, category in jax_registry.FUNCTION_TYPES[module].items():
        for port_module, port_name in KERNEL_MAP.get((module, name), [(module, name)]):
            assert function_type(port_module, port_name) == category, (module, name)


def test_the_port_adds_only_its_kernels_and_its_own_names():
    """The port's entries are the JAX registry's (mapped) plus the public
    names its modules add: 281, 283 once A and B-fft/B split their Pallas
    kernels, and 6 more."""
    jax_entries = {(m, n) for m, fns in jax_registry.FUNCTION_TYPES.items() for n in fns}
    mapped = set()
    for entry in jax_entries:
        mapped.update(KERNEL_MAP.get(entry, [entry]))
    extra = set(ENTRIES) - mapped
    assert len(jax_entries) == 281 and len(mapped) == 283 and len(ENTRIES) == 289
    assert extra == {("kernels.dft", "shared_fold_weights"), ("kernels.dft", "shared_twiddles"),
                     ("kernels.cuda_halo", "close_halo_buffers"),
                     ("kernels.cuda_halo", "halo_plan"), ("parallel.mesh", "mesh_device"),
                     ("parallel.sharded", "gather_blocks")}
    assert not {m for m, _ in ENTRIES} & {"kernels.pallas_dft", "kernels.pallas_halo"}
