"""Hand-written Hopper kernels of the port, with their plain versions.

- ``env_mat_fwd`` / ``env_mat_bwd``: Triton (``env_mat_triton.py``), replacing
  ``repro/kernels/env_mat.py::_env_mat_kernel`` / ``_env_mat_bwd_kernel``;
- ``nbr_attention_stack_fwd`` / ``_bwd``: CUDA C++ for ``sm_90a``
  (``csrc/nbr_attn.cu``), replacing ``repro/kernels/nbr_attn.py::
  _stack_fwd_kernel`` / ``_stack_bwd_kernel``;
- ``cell_filter``: CUDA C++ for ``sm_90a`` (``csrc/cell_filter.cu``),
  replacing ``repro/kernels/cell_gather.py::_cell_filter_kernel``, with the
  candidate gather fused in;
- ``force_scatter``: CUDA C++ for ``sm_90a`` (``csrc/force_scatter.cu``), the
  backward of the neighbour gather (``neighbor_gather``: the DP force path,
  the classical pair and bonded tables) and the DD force reduction, where
  the JAX reference leaves XLA a scatter-add: no TPU kernel; its reverse
  list is a stable radix sort written by hand, its sums one add chain per
  (atom, component);
- ``flash_attention`` / ``flash_decode``: CUDA C++ for ``sm_90a``
  (``csrc/flash_attn.cu``), replacing ``repro/kernels/flash_attn.py::
  _flash_kernel``: the attention of the LM serving path (causal, GQA,
  sliding window, softcap, q_offset); ``flash_decode`` is the decode step's
  entry over a whole cache, its position a device tensor.

Importing this package needs neither ``triton`` nor ``nvcc``: kernels are
compiled at their first launch on a CUDA tensor.
"""
from . import cell_filter as _cell_filter_mod
from . import flash_attn as _flash_attn_mod
from . import force_scatter as _force_scatter_mod
from .env_mat import env_mat_bwd, env_mat_fwd
from .nbr_attn import nbr_attention_stack_bwd, nbr_attention_stack_fwd

KERNELS = {
    "env_mat_fwd": env_mat_fwd,
    "env_mat_bwd": env_mat_bwd,
    "nbr_attention_stack_fwd": nbr_attention_stack_fwd,
    "nbr_attention_stack_bwd": nbr_attention_stack_bwd,
    "cell_filter": _cell_filter_mod.cell_filter,
    "flash_attention": _flash_attn_mod.flash_attention,
    "flash_decode": _flash_attn_mod.flash_decode,
    "force_scatter": _force_scatter_mod.force_scatter,
}


def launch_counts() -> dict[str, int]:
    """Kernel launches counted by each wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
