"""Public differentiable entry points of the kernels (``repro/kernels/ops.py``).

The JAX ``use_pallas``/``interpret`` switches are gone: the tensors' device
selects the kernel (CUDA) or the plain version (CPU).  The TPU's 128-lane
padding of the neighbour axis is gone too: the kernels take any K.
"""
from __future__ import annotations

from . import flash_attn
from .env_mat import env_mat
from .nbr_attn import nbr_attention_stack


def env_mat_op(dx, dy, dz, mask, rcut_smth: float, rcut: float):
    """Env-matrix planes (s, s*x/r, s*y/r, s*z/r), differentiable in dx/dy/dz."""
    return env_mat(dx, dy, dz, mask, rcut_smth, rcut)


def nbr_attention_stack_op(g, rx, ry, rz, sw, mask, wq, wk, wv, wo, gamma,
                           beta, heads: int = 1,
                           compute_dtype: str = "float32"):
    """The fused l_a-layer DPA-1 attention stack (differentiable both ways).
    Params are stacked along a leading layer axis: wq/wk/wv (L, M, H),
    wo (L, H, M), gamma/beta (L, M)."""
    return nbr_attention_stack(g, rx, ry, rz, sw, mask, wq, wk, wv, wo, gamma,
                               beta, heads=heads, compute_dtype=compute_dtype)


def attention_op(q, k, v, causal: bool = True, window: int = 0,
                 softcap: float = 0.0, q_offset: int = 0):
    """Blockwise attention with causal, GQA, window, softcap and q_offset:
    q (B, Hq, Sq, D), k (B, Hkv, Sk, D), v (B, Hkv, Sk, DV) (DV != D for
    MLA).  Forward only."""
    return flash_attn.flash_attention(q, k, v, causal, window, softcap,
                                      q_offset)


def decode_attention_op(q, k_cache, v_cache, pos, window: int = 0,
                        softcap: float = 0.0):
    """Decode attention over a whole cache, the position a 0-d int64 tensor
    (``flash_attn.flash_decode``): causal, keys < pos + Sq.  Forward only."""
    return flash_attn.flash_decode(q, k_cache, v_cache, pos, window, softcap)
