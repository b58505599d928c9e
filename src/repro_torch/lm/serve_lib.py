"""Serving: prefill (fill the caches) and single-token decode steps
(``repro/lm/serve_lib.py``).

The cache layout mirrors the model's pattern grouping: ``prefix`` is a list
of per-layer caches, ``pattern`` a list (per pattern position) of caches
stacked along a leading ``(n_steps,)`` axis.  An attention layer's cache is
``{"k", "v"}`` of shape (B, Hkv, S_max, hd) in ``cfg.dtype``.  Unlike the
JAX functions, which return new caches, the port writes the cache in place:
prefill fills positions ``[:S]``, a decode step position ``pos``.  Both run
under ``torch.no_grad()``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ArchConfig, LayerSpec
from . import layers as L
from . import model as M


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device) -> dict:
    """Zero-filled cache for ``batch`` sequences of up to ``max_len``."""
    prefix_n, n_steps, pattern = cfg.scan_pattern()
    shape = (batch, cfg.n_kv_heads, max_len, cfg.resolved_head_dim)
    zeros = lambda lead: torch.zeros((*lead, *shape), dtype=L.dt(cfg),
                                     device=device)
    return {"prefix": [{"k": zeros(()), "v": zeros(())}
                       for _ in range(prefix_n)],
            "pattern": [{"k": zeros((n_steps,)), "v": zeros((n_steps,))}
                        for _ in pattern]}


def layer_caches(cache, cfg: ArchConfig):
    """Each layer's cache, as views, in execution order."""
    prefix_n, n_steps, pattern = cfg.scan_pattern()
    out = list(cache["prefix"])
    for s in range(n_steps):
        out += [M.step_params(cache["pattern"][j], s)
                for j in range(len(pattern))]
    return out


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def decode_layer(p, x, cfg: ArchConfig, spec: LayerSpec, cache, pos):
    M._check_supported(cfg, spec)
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    m, cache = L.attention_decode(p["mixer"], h, cfg, spec, cache, pos)
    x = x + m
    h = L.rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + L.mlp_layer(p["mlp"], h, cfg.act), cache


def make_serve_step(cfg: ArchConfig, mesh=None):
    """serve_step(params, cache, tokens (B,1), pos) -> (logits (B,1,V),
    cache); the cache is written in place.  ``pos`` is an int or a 0-d
    integer tensor, as the reference's ``pos ()``: the step reads it on the
    device only, so on the card it can be captured as a CUDA graph whose
    ``pos`` and ``tokens`` are static tensors (``launch/serve.py``)."""
    if mesh is not None:
        raise L.unported("a serving mesh")

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        pos = L.decode_position(pos, tokens.device)
        x = params["embed"][tokens]
        for (layer_p, spec), c in zip(M.layers_in_order(params, cfg),
                                      layer_caches(cache, cfg)):
            x, _ = decode_layer(layer_p, x, cfg, spec, c, pos)
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = M.final_softcap(cfg, M.logits_head(params, cfg, x))
        return logits, cache

    return serve_step


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def _prefill_layer(p, x, cfg, spec, positions, cache):
    """apply_layer, writing this layer's k/v into ``cache[..., :S, :]``."""
    M._check_supported(cfg, spec)
    s = x.shape[1]
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    q, k, v = L.attention_qkv(p["mixer"], h, cfg, positions)
    o = L.chunked_attention(q, k, v, causal=True,
                            window=L.layer_window(cfg, spec),
                            softcap=cfg.attn_softcap)
    m = torch.einsum("bhse,hed->bsd", o, p["mixer"]["wo"])
    cache["k"][:, :, :s] = k
    cache["v"][:, :, :s] = v
    x = x + m
    h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + L.mlp_layer(p["mlp"], h2, cfg.act), cache


def make_prefill(cfg: ArchConfig, max_len: Optional[int] = None, mesh=None):
    """prefill(params, tokens, context=None) -> (last_logits (B,1,V), cache).

    As in the reference, the last logits are not soft-capped
    (``final_softcap``), unlike ``serve_step``'s and ``forward``'s; the
    greedy token is the same, tanh being monotone.  ``mesh``,
    ``context`` and ``remat`` are not ported (no gradients are kept here)."""
    if mesh is not None:
        raise L.unported("a serving mesh")

    @torch.no_grad()
    def prefill(params, tokens, context=None):
        if context is not None:
            raise L.unported("prefill with context")
        b, s = tokens.shape
        cache = init_cache(cfg, b, max_len or s, tokens.device)
        positions = torch.arange(s, device=tokens.device)
        x = params["embed"][tokens]
        for (layer_p, spec), c in zip(M.layers_in_order(params, cfg),
                                      layer_caches(cache, cfg)):
            x, _ = _prefill_layer(layer_p, x, cfg, spec, positions, c)
        x = L.rms_norm(x[:, -1:, :], params["final_norm"], cfg.norm_eps)
        return M.logits_head(params, cfg, x), cache

    return prefill
