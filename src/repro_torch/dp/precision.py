"""Mixed-precision policy for DP inference (``DPConfig.dtype``).

Same policy as ``repro/dp/precision.py``: for ``dtype="bfloat16"`` the
embedding/fitting MLP matmuls and every attention contraction take bf16
*operands* with fp32 accumulation; the environment matrix, switch envelope,
angular gate, softmax, residual adds, layer norms, the bilinear G^T R R^T G
reduction, energies and forces stay fp32.  ``dtype="float32"`` is the
identity policy.
"""
from __future__ import annotations

import torch

# bf16 operand rounding, shared with the kernels' plain versions
from ..kernels.ref import round_operand  # noqa: F401

DTYPES = ("float32", "bfloat16")


def validate_dtype(dtype: str) -> str:
    if dtype not in DTYPES:
        raise ValueError(f"DPConfig.dtype must be one of {DTYPES}, "
                         f"got {dtype!r}")
    return dtype


def compute_dtype(dtype: str):
    """Matmul-operand dtype for the policy (None = plain fp32 path)."""
    validate_dtype(dtype)
    return torch.bfloat16 if dtype == "bfloat16" else None

