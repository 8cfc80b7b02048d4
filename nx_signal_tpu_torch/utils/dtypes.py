"""Dtype policy: float32 first, as in nx_signal_tpu/utils/dtypes.py.

Every op that produces floating-point data defaults to float32; complex
results are complex64, the complex counterpart of DEFAULT_FLOAT.
"""

import torch

DEFAULT_FLOAT = torch.float32
DEFAULT_COMPLEX = torch.complex64
