"""LM building blocks of the attention and dense-MLP families
(``repro/lm/layers.py``).

Apply-style functions over parameter dicts, with the JAX module's names and
layouts: activations (B, S, D); attention heads split as (B, H, S, hd);
parameters in ``cfg.dtype`` (bf16 by default), norms, rope angles and the
attention's softmax in fp32.  Every sequence mixer has a prefill form (full
sequence) and a decode form (one token against a cache); ``serve_lib``
wires the latter.

The attention itself is ``kernels.ops.attention_op``: the hand-written
flash kernel on CUDA tensors, its plain version on CPU tensors.  Not
ported: the mla, mamba, rwkv, cross and moe mixers (asking for one raises,
naming ROADMAP Queue 1 item 13), and the JAX mesh knobs (``GQA_REPEAT``,
``FLASH_DECODE``, ``maybe_constrain``), which one card does not need.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig, LayerSpec
from ..kernels.ops import attention_op, decode_attention_op

ATTN_MIXERS = ("attn", "attn_local")


def unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1 item 13): the port's LM "
        "has the attention (attn, attn_local) and dense-MLP families")


def dt(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def normal(generator: torch.Generator, shape, std: float, dtype,
           device) -> torch.Tensor:
    """N(0, std^2) in ``dtype`` on ``device``; drawn in fp32 on the
    generator's device, so one seed gives the same weights wherever they
    are put."""
    x = torch.randn(shape, generator=generator, device=generator.device)
    return (x * std).to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# Norms / activations / rope
# ---------------------------------------------------------------------------

def rms_norm(x, gamma, eps=1e-6):
    """Normalise in fp32, round to x's dtype, then scale by (1 + gamma)."""
    x32 = x.to(torch.float32)
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * (1.0 + gamma)


def act_fn(name: str):
    # jax.nn.gelu is the tanh approximation by default
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def rope(x, positions, theta: float):
    """x (..., S, hd) rotated pairwise; positions (S,) or (B, S).  Angles in
    fp32, the result cast to x's dtype."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., :, None].to(torch.float32) * freq   # (..., S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    # broadcast over the head axis: x is (B, H, S, hd), ang (B?, S, half)
    while cos.ndim < x.ndim:
        cos, sin = cos.unsqueeze(-3), sin.unsqueeze(-3)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def chunked_attention(q, k, v, causal=True, window=0, softcap=0.0,
                      q_offset=0, kv_len=None, chunk=512):
    """q (B,Hq,Sq,hd), k/v (B,Hkv,Sk,hd).  ``kv_len`` masks keys >= kv_len
    (decode against a partially filled cache): the keys are sliced to
    ``[:kv_len]``, a view.  The flash kernel on CUDA tensors, the plain
    version on CPU tensors; ``chunk`` (the JAX scan's KV chunk) is unused.

    The probabilities stay fp32 into the PV product, as in the TPU kernel;
    the JAX function rounds them to v's dtype first, so bf16 results differ
    from it within bf16 error."""
    if kv_len is not None:
        k, v = k[:, :, :kv_len], v[:, :, :kv_len]
    return attention_op(q, k, v, causal=causal, window=window,
                        softcap=softcap, q_offset=q_offset)


def init_attention(generator, cfg: ArchConfig, dtype, device,
                   lead=()) -> dict:
    """Attention weights; ``lead`` prepends axes (the stacked steps)."""
    hd = cfg.resolved_head_dim
    std = cfg.d_model ** -0.5
    d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    draw = lambda *shape: normal(generator, (*lead, *shape), std, dtype, device)
    zeros = lambda *shape: torch.zeros((*lead, *shape), dtype=dtype,
                                       device=device)
    p = {"wq": draw(d, h, hd), "wk": draw(d, kv, hd), "wv": draw(d, kv, hd),
         "wo": draw(h, hd, d)}
    if cfg.qkv_bias:
        p.update(bq=zeros(h, hd), bk=zeros(kv, hd), bv=zeros(kv, hd))
    if cfg.qk_norm:
        p.update(q_norm=zeros(hd), k_norm=zeros(hd))
    return p


def attention_qkv(p, x, cfg: ArchConfig, positions):
    """Returns q (B,H,S,hd), k/v (B,Hkv,S,hd) with rope/norm/bias applied."""
    q = torch.einsum("bsd,dhe->bhse", x, p["wq"])
    k = torch.einsum("bsd,dhe->bhse", x, p["wk"])
    v = torch.einsum("bsd,dhe->bhse", x, p["wv"])
    if cfg.qkv_bias:
        # the reference reshapes bq's transpose (as written in JAX)
        q = q + p["bq"].T.reshape(1, cfg.n_heads, 1, -1)
        k = k + p["bk"].reshape(1, cfg.n_kv_heads, 1, -1)
        v = v + p["bv"].reshape(1, cfg.n_kv_heads, 1, -1)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def layer_window(cfg: ArchConfig, spec: LayerSpec) -> int:
    return cfg.window if spec.mixer == "attn_local" else 0


def attention_layer(p, x, cfg: ArchConfig, spec: LayerSpec, positions,
                    causal=True):
    q, k, v = attention_qkv(p, x, cfg, positions)
    o = chunked_attention(q, k, v, causal=causal,
                          window=layer_window(cfg, spec),
                          softcap=cfg.attn_softcap)
    return torch.einsum("bhse,hed->bsd", o, p["wo"])


def decode_position(pos, device) -> torch.Tensor:
    """``pos`` as the decode path takes it: a 0-d int64 tensor on
    ``device`` (an int is copied there, another integer type cast)."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int64)
    return torch.tensor(pos, dtype=torch.int64, device=device)


def attention_decode(p, x, cfg: ArchConfig, spec: LayerSpec, cache, pos):
    """One-token decode.  cache = {"k","v"} (B, Hkv, S_max, hd), written in
    place at position ``pos``, an int or a 0-d integer tensor (the
    reference's traced ``pos``).  Nothing here reads it on the host: the
    rope angles take it on the device, the cache write is an
    ``index_copy_`` at it (the reference's ``dynamic_update_slice_in_dim``)
    and the attention runs over the whole cache with the length pos + 1
    read by the kernel (``flash_decode``; its plain version on the CPU)."""
    pos = decode_position(pos, x.device)
    q, k_new, v_new = attention_qkv(p, x, cfg, pos.expand(x.shape[0], 1))
    idx = pos.reshape(1)
    cache["k"].index_copy_(2, idx, k_new)
    cache["v"].index_copy_(2, idx, v_new)
    o = decode_attention_op(q, cache["k"], cache["v"], pos,
                            window=layer_window(cfg, spec),
                            softcap=cfg.attn_softcap)
    return torch.einsum("bhse,hed->bsd", o, p["wo"]), cache


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------

def init_mlp(generator, d_model: int, d_ff: int, dtype, device,
             lead=()) -> dict:
    draw = lambda std, *shape: normal(generator, (*lead, *shape), std, dtype,
                                      device)
    return {"w_gate": draw(d_model ** -0.5, d_model, d_ff),
            "w_up": draw(d_model ** -0.5, d_model, d_ff),
            "w_down": draw(d_ff ** -0.5, d_ff, d_model)}


def mlp_layer(p, x, act="silu"):
    g = act_fn(act)(x @ p["w_gate"])
    return (g * (x @ p["w_up"])) @ p["w_down"]
