"""PyTorch/CUDA port of the DP force path for NVIDIA Hopper.

Mirrors ``repro`` module for module (``repro_torch/dp/model.py`` <->
``repro/dp/model.py``) with the same dataclass, field and function names.
Plain tensor code is PyTorch; the descriptor's two hot spots run as kernels
written for ``sm_90a`` (``repro_torch.kernels``).  The package imports torch
and numpy only: no JAX and nothing of ``repro``.

Device rule: entry points take ``device=`` and default to ``"cuda"``; without
a CUDA device they raise unless the caller passes ``device="cpu"``.  Kernel
wrappers dispatch on the tensor's device (CUDA -> kernel, CPU -> plain
version), and a kernel that cannot build or launch raises.
"""
from .device import resolve_device  # noqa: F401
