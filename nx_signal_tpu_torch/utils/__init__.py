"""Helpers of the port (counterpart of nx_signal_tpu/utils): the names the
JAX subpackage re-exports, each from its port module."""

from nx_signal_tpu_torch.utils.dtypes import (
    DEFAULT_FLOAT,
    complex_part_dtype,
    default_complex,
    is_complex_dtype,
    result_real_dtype,
)
from nx_signal_tpu_torch.utils.shapes import next_fast_len, next_power_of_two

__all__ = [
    "DEFAULT_FLOAT",
    "complex_part_dtype",
    "default_complex",
    "is_complex_dtype",
    "result_real_dtype",
    "next_fast_len",
    "next_power_of_two",
]
