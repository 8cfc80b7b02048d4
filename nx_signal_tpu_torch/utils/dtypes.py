"""Dtype policy: float32 first, as in nx_signal_tpu/utils/dtypes.py.

Every op that produces floating-point data defaults to float32; complex
results are complex64, the complex counterpart of DEFAULT_FLOAT. float64
inputs stay float64 where the JAX package (with x64 on) keeps them.
"""

import torch

DEFAULT_FLOAT = torch.float32
DEFAULT_COMPLEX = torch.complex64


def is_complex_dtype(dtype) -> bool:
    """True for a complex torch dtype.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.utils.dtypes import is_complex_dtype
    >>> is_complex_dtype(torch.complex64), is_complex_dtype(torch.float32)
    (True, False)
    """
    return dtype.is_complex


def default_complex(float_dtype=DEFAULT_FLOAT):
    """Complex dtype whose parts have the given float dtype (complex64 for
    float32 and narrower, complex128 for float64).

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.utils.dtypes import default_complex
    >>> default_complex(torch.float64)
    torch.complex128
    """
    return torch.complex128 if float_dtype == torch.float64 else torch.complex64


def complex_part_dtype(complex_dtype):
    """Float dtype of the real and imaginary parts of a complex dtype.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.utils.dtypes import complex_part_dtype
    >>> complex_part_dtype(torch.complex64)
    torch.float32
    """
    return torch.float64 if complex_dtype == torch.complex128 else torch.float32


def result_real_dtype(*dtypes):
    """Float dtype for results of float math on the given input dtypes:
    integer and bool inputs promote to float32, float16 and bfloat16 to
    float32, float64 (or complex128) to float64.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.utils.dtypes import result_real_dtype
    >>> result_real_dtype(torch.int32), result_real_dtype(torch.float32, torch.complex128)
    (torch.float32, torch.float64)
    """
    out = DEFAULT_FLOAT
    for d in dtypes:
        if d.is_complex:
            d = complex_part_dtype(d)
        if d.is_floating_point:
            out = torch.promote_types(out, d)
    return out
