"""Serving: prefill (fill the caches) and single-token decode steps
(``repro/lm/serve_lib.py``).

The cache layout mirrors the model's pattern grouping: ``prefix`` is a list
of per-layer caches, ``pattern`` a list (per pattern position) of caches
stacked along a leading ``(n_steps,)`` axis.  Cache kinds per mixer (the
reference's ``_layer_cache_shape``), ``ssm`` and ``S`` in fp32, the rest in
``cfg.dtype``:

  attn / attn_local : {"k", "v"} (B, Hkv, S_max, hd)
  mla               : {"ckv" (B, S_max, kv_lora_rank), "k_rope" (B, S_max,
                      qk_rope)}: the absorbed decode's latent cache
  mamba             : {"conv" (B, K, Di), "ssm" (B, Di, N)}
  rwkv              : {"S" (B, H, hd, hd), "shift" (B, 1, D), "cmix_shift"
                      (B, 1, D)}
  cross             : {"ck", "cv"} (B, Hkv, T_ctx, hd), static after prefill

Unlike the JAX functions, which return new caches, the port writes the
cache in place: prefill fills positions ``[:S]`` and the recurrent state, a
decode step position ``pos`` and the state.  Both run under
``torch.no_grad()``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ArchConfig, LayerSpec
from . import layers as L
from . import model as M
from . import sharding as S

# how a decode step writes each cache leaf: at its position (a replayed
# step writes the same entry again), never (filled by the prefill), or by
# advancing it (recurrent state: a step run twice moves it twice)
POSITIONAL = ("k", "v", "ckv", "k_rope")
STATIC = ("ck", "cv")
RECURRENT = ("conv", "ssm", "S", "shift", "cmix_shift")


def _layer_cache(cfg: ArchConfig, spec: LayerSpec, batch: int, max_len: int,
                 ctx_len: int, device, lead=()) -> dict:
    dtype = L.dt(cfg)
    z = lambda *shape, dt=dtype: torch.zeros((*lead, batch, *shape), dtype=dt,
                                             device=device)
    hd = cfg.resolved_head_dim
    if spec.mixer in L.ATTN_MIXERS:
        return {"k": z(cfg.n_kv_heads, max_len, hd),
                "v": z(cfg.n_kv_heads, max_len, hd)}
    if spec.mixer == "mla":
        return {"ckv": z(max_len, cfg.kv_lora_rank),
                "k_rope": z(max_len, cfg.qk_rope_dim)}
    if spec.mixer == "mamba":
        di = cfg.ssm_expand * cfg.d_model
        return {"conv": z(cfg.ssm_conv, di),
                "ssm": z(di, cfg.ssm_d_state, dt=torch.float32)}
    if spec.mixer == "rwkv":
        hd_r = cfg.rwkv_head_dim
        return {"S": z(cfg.d_model // hd_r, hd_r, hd_r, dt=torch.float32),
                "shift": z(1, cfg.d_model), "cmix_shift": z(1, cfg.d_model)}
    if spec.mixer == "cross":
        return {"ck": z(cfg.n_kv_heads, ctx_len, hd),
                "cv": z(cfg.n_kv_heads, ctx_len, hd)}
    raise ValueError(spec.mixer)


def context_len(cfg: ArchConfig) -> int:
    """The cross-attention cache's T: audio frames or image tokens."""
    return cfg.n_audio_frames if cfg.enc_dec else cfg.n_image_tokens


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device,
               ctx_len: Optional[int] = None) -> dict:
    """Zero-filled cache for ``batch`` sequences of up to ``max_len``
    (``ctx_len`` context rows for cross-attention; default the config's)."""
    prefix_n, n_steps, pattern = cfg.scan_pattern()
    specs = cfg.layer_specs()
    t = context_len(cfg) if ctx_len is None else ctx_len
    return {"prefix": [_layer_cache(cfg, specs[i], batch, max_len, t, device)
                       for i in range(prefix_n)],
            "pattern": [_layer_cache(cfg, spec, batch, max_len, t, device,
                                     lead=(n_steps,)) for spec in pattern]}


def abstract_cache(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """The cache tree on the ``meta`` device: shapes and dtypes, no
    storage (the dry run's input, as the reference's ShapeDtypeStructs)."""
    return init_cache(cfg, batch, max_len, "meta")


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
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    if spec.mixer in L.ATTN_MIXERS:
        m, cache = L.attention_decode(p["mixer"], h, cfg, spec, cache, pos)
    elif spec.mixer == "mla":
        m, cache = L.mla_decode(p["mixer"], h, cfg, spec, cache, pos)
    elif spec.mixer == "mamba":
        m, cache = L.mamba_decode(p["mixer"], h, cfg, cache, pos)
    elif spec.mixer == "rwkv":
        m, cache = L.rwkv_decode(p["mixer"], h, cfg, cache, pos)
    elif spec.mixer == "cross":
        m = L.cross_attend(p["mixer"], h, cache["ck"], cache["cv"])
    else:
        raise ValueError(spec.mixer)
    x = x + m
    h = L.rms_norm(x, p["norm2"], cfg.norm_eps)
    if spec.mlp == "moe":
        o, _ = L.moe_layer(p["mlp"], h, cfg, cfg.act)
    elif cfg.family == "ssm":
        o = L.rwkv_cmix(p["mlp"], h, shift_state=cache["cmix_shift"])
        cache["cmix_shift"].copy_(h)
    else:
        o = L.mlp_layer(p["mlp"], h, cfg.act)
    return x + o, cache


def make_serve_step(cfg: ArchConfig, mesh=None):
    """serve_step(params, cache, tokens (B,1), pos) -> (logits (B,1,V),
    cache); the cache is written in place.  ``pos`` is an int or a 0-d
    integer tensor, as the reference's ``pos ()``: the step reads it on the
    device only, so on the card it can be captured as a CUDA graph whose
    ``pos`` and ``tokens`` are static tensors (``launch/serve.py``).
    ``mesh``: None or a layout of one device, run as no mesh."""
    S.require_one_card(mesh, "serving")

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

def _prefill_layer(p, x, cfg, spec, positions, ctx, cache):
    """apply_layer, filling this layer's cache: k/v (or MLA's latent cache)
    at ``[:S]``, the recurrent state after the last token, the context's
    k/v.  MLA's compression runs once (the reference runs it twice, with
    the same values)."""
    s = x.shape[1]
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    mp = p["mixer"]
    if spec.mixer in L.ATTN_MIXERS:
        q, k, v = L.attention_qkv(mp, h, cfg, positions)
        o = L.chunked_attention(q, k, v, causal=True,
                                window=L.layer_window(cfg, spec),
                                softcap=cfg.attn_softcap)
        m = torch.einsum("bhse,hed->bsd", o, mp["wo"])
        cache["k"][:, :, :s] = k
        cache["v"][:, :, :s] = v
    elif spec.mixer == "mla":
        q_nope, q_rope, ckv, krope = L.mla_compress(mp, h, cfg, positions)
        m = L.mla_attend(mp, cfg, q_nope, q_rope, ckv, krope)
        cache["ckv"][:, :s] = ckv
        cache["k_rope"][:, :s] = krope[:, 0]
    elif spec.mixer in ("mamba", "rwkv"):
        layer = L.mamba_layer if spec.mixer == "mamba" else L.rwkv_layer
        m, state = layer(mp, h, cfg, return_state=True)
        for name, t in state.items():
            cache[name].copy_(t)
    elif spec.mixer == "cross":
        if ctx is None:
            raise ValueError(f"{cfg.name}'s cross-attention layers need a "
                             "context (frame or patch embeddings)")
        k, v = L.cross_kv(mp, ctx, cfg)
        m = L.cross_attend(mp, h, k, v)
        cache["ck"].copy_(k)
        cache["cv"].copy_(v)
    else:
        raise ValueError(spec.mixer)
    x = x + m
    h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
    o, _ = M.apply_mlp(p["mlp"], h2, cfg, spec)
    if cfg.family == "ssm":
        cache["cmix_shift"].copy_(h2[:, -1:, :])
    return x + o, cache


def make_prefill(cfg: ArchConfig, max_len: Optional[int] = None, mesh=None):
    """prefill(params, tokens, context=None) -> (last_logits (B,1,V), cache).

    ``context``: frame or patch embeddings (B, T, D), through the model's
    context stub.  As in the reference, the last logits are not soft-capped
    (``final_softcap``), unlike ``serve_step``'s and ``forward``'s; the
    greedy token is the same, tanh being monotone.  ``mesh``: None or a
    layout of one device, run as no mesh."""
    S.require_one_card(mesh, "serving")

    @torch.no_grad()
    def prefill(params, tokens, context=None):
        b, s = tokens.shape
        ctx = M.encode_context(params, cfg, context)
        cache = init_cache(cfg, b, max_len or s, tokens.device,
                           None if ctx is None else ctx.shape[1])
        positions = torch.arange(s, device=tokens.device)
        x = params["embed"][tokens]
        for (layer_p, spec), c in zip(M.layers_in_order(params, cfg),
                                      layer_caches(cache, cfg)):
            x, _ = _prefill_layer(layer_p, x, cfg, spec, positions, ctx, c)
        x = L.rms_norm(x[:, -1:, :], params["final_norm"], cfg.norm_eps)
        return M.logits_head(params, cfg, x), cache

    return prefill
