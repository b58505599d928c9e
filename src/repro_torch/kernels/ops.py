"""Public differentiable entry points of the kernels (``repro/kernels/ops.py``).

The JAX ``use_pallas``/``interpret`` switches are gone: the tensors' device
selects the kernel (CUDA) or the plain version (CPU).  The TPU's 128-lane
padding of the neighbour axis is gone too: the kernels take any K.
"""
from __future__ import annotations

import torch

from . import flash_attn, ref
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


class FlashAttention(torch.autograd.Function):
    """The attention under autograd (LM training).  Forward: the flash
    kernel with the rows' log-sum-exp on CUDA tensors
    (``flash_attention(..., return_lse=True)``), ``attention_ref`` and
    ``attention_lse_ref`` on CPU tensors.  Backward:
    ``ref.attention_bwd_ref`` (a plain chunked recompute from q, k, v, the
    output and the log-sum-exp) on both devices, so the CPU tests run the
    code the card runs; the JAX package has no backward kernel here (its
    LM trains through the plain ``chunked_attention``).  First order only:
    a backward asked to build a graph (``create_graph=True``) raises, as
    ``env_mat`` does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset):
        out, lse = flash_attn.flash_attention(q, k, v, causal, window,
                                              softcap, q_offset,
                                              return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, softcap, q_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        if torch.is_grad_enabled():
            raise RuntimeError(
                "flash attention is differentiable once: its backward "
                "cannot build a graph for a second derivative "
                "(create_graph=True)")
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ref.attention_bwd_ref(q, k, v, out, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None


def attention_op(q, k, v, causal: bool = True, window: int = 0,
                 softcap: float = 0.0, q_offset: int = 0):
    """Blockwise attention with causal, GQA, window, softcap and q_offset:
    q (B, Hq, Sq, D), k (B, Hkv, Sk, D), v (B, Hkv, Sk, DV) (DV != D for
    MLA).  Differentiable (:class:`FlashAttention`) when grad mode is on
    and q, k or v requires grad; otherwise the forward-only call that
    serving makes, with its bits."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, softcap,
                                    q_offset)
    return flash_attn.flash_attention(q, k, v, causal, window, softcap,
                                      q_offset)


def decode_attention_op(q, k_cache, v_cache, pos, window: int = 0,
                        softcap: float = 0.0):
    """Decode attention over a whole cache, the position a 0-d int64 tensor
    (``flash_attn.flash_decode``): causal, keys < pos + Sq.  Forward only."""
    return flash_attn.flash_decode(q, k_cache, v_cache, pos, window, softcap)
