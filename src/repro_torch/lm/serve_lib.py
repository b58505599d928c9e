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

Over a ``("data", "model")`` process mesh (``launch/mesh.py::LMMesh``,
every registry architecture) the parameters and the cache are DTensors
laid out by ``lm/sharding.py``'s specs (the cache by ``cache_shardings``:
batch over "data"; K/V and ck/cv by KV heads over "model", or the
sequence where the heads are too few, the flash-decoding layout; MLA's
latent cache by its sequence; Mamba's and RWKV6's state by channels or
heads; ``distribute_cache(..., long_context=True)``: the reference's
layout for a batch that "data" does not divide, the sequence over
"data"); each process writes its block of the cache in place; prefill and
decode steps run eager (a CUDA graph does not capture the collectives)
and return logits as DTensors (batch over "data", vocabulary over
"model").
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


def init_cache_mesh(cfg: ArchConfig, batch: int, max_len: int, mesh,
                    ctx_len: Optional[int] = None) -> dict:
    """:func:`init_cache` over an ``LMMesh``: each process allocates only
    its zero block of every leaf (``sharding.cache_shardings``), held as
    DTensors."""
    whole = init_cache(cfg, batch, max_len, "meta", ctx_len)
    spec_of = dict(S.leaves_with_paths(S.cache_shardings(whole, mesh)))

    def block(path, leaf):
        spec = spec_of[path]
        local = torch.zeros(S.shard_shape(leaf.shape, spec, mesh),
                            dtype=leaf.dtype, device=mesh.device)
        return S.from_local(local, mesh, S.placements(spec, mesh), leaf.shape)

    return S.map_with_paths(block, whole)


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


def decode_layer_mesh(p, x, cfg: ArchConfig, spec: LayerSpec, cache, pos,
                      run, layouts):
    """:func:`decode_layer` over a mesh: ``x`` a DTensor, ``cache`` this
    process's block of the layer's cache (``layouts``: by kind, from
    ``layers.cache_layouts``), written in place."""
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    mp = p["mixer"]
    if spec.mixer in L.ATTN_MIXERS:
        m = L.attention_decode_mesh(mp, h, cfg, spec, cache, pos, run,
                                    layouts["kv"])
    elif spec.mixer == "mla":
        m = L.mla_decode_mesh(mp, h, cfg, spec, cache, pos, run,
                              layouts["mla"])
    elif spec.mixer == "mamba":
        m = L.mamba_decode_mesh(mp, h, cfg, cache, pos, run)
    elif spec.mixer == "rwkv":
        m = L.rwkv_decode_mesh(mp, h, cfg, cache, pos, run)
    elif spec.mixer == "cross":
        m = L.cross_decode_mesh(mp, h, cfg, cache, run, layouts["cross"])
    else:
        raise ValueError(spec.mixer)
    x = x + m
    h = L.rms_norm(x, p["norm2"], cfg.norm_eps)
    if spec.mlp == "moe":
        o, _ = L.moe_mesh(p["mlp"], h, cfg, run, cfg.act)
    elif cfg.family == "ssm":
        o = L.cmix_mesh(p["mlp"], h, cfg, run,
                        shift_state=cache["cmix_shift"])
        cache["cmix_shift"].copy_(run.act(h, False))
    else:
        o = L.mlp_mesh(p["mlp"], h, cfg, run)
    return x + o


def _mesh_layers(params, cfg: ArchConfig):
    """(layer params, spec) in execution order for DTensor parameters
    (the stacked pattern unbound on its blocks)."""
    prefix_n, n_steps, pattern = cfg.scan_pattern()
    specs = cfg.layer_specs()
    out = [(params["prefix"][i], specs[i]) for i in range(prefix_n)]
    steps = [M.unstack(p, n_steps) for p in params["pattern"]]
    for st in range(n_steps):
        out += [(steps[j][st], spec) for j, spec in enumerate(pattern)]
    return out


def _local_layers(cache, cfg: ArchConfig):
    """Each layer's block of a DTensor cache, as views of this process's
    local tensors (written in place)."""
    local = S.map_with_paths(lambda _, t: t.to_local(), cache)
    return layer_caches(local, cfg)


def make_serve_step(cfg: ArchConfig, mesh=None):
    """serve_step(params, cache, tokens (B,1), pos) -> (logits (B,1,V),
    cache); the cache is written in place.  ``pos`` is an int or a 0-d
    integer tensor, as the reference's ``pos ()``: the step reads it on the
    device only, so on the card it can be captured as a CUDA graph whose
    ``pos`` and ``tokens`` are static tensors (``launch/serve.py``).
    ``mesh``: None or a layout of one device, run as no mesh; an
    ``LMMesh``: ``params`` and ``cache`` DTensors (``init_cache_mesh`` or
    a prefill's), ``tokens`` a DTensor or the whole (B, 1) on every
    process, the logits a DTensor; eager, with the ``layers.FLASH_DECODE``
    and ``layers.GQA_REPEAT`` knobs; the cache's layout (the long-context
    one too: ``sharding.distribute_cache(..., long_context=True)``) is
    read from its placements."""
    mesh = S.executing_mesh(mesh, "serving")
    if mesh is not None:
        return _serve_step_mesh(cfg, mesh)

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


def _serve_step_mesh(cfg: ArchConfig, mesh):
    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        dt = S.dt_api()
        run = S.MeshRun(mesh, tokens.shape[0])
        tokens = run.batch(tokens)
        pos = L.decode_position(pos, mesh.device)
        layouts = L.cache_layouts(cache, run)
        x = M.embed_mesh(params, cfg, tokens, run, (run.bp, dt.Replicate()))
        for (layer_p, spec), c in zip(_mesh_layers(params, cfg),
                                      _local_layers(cache, cfg)):
            x = decode_layer_mesh(layer_p, x, cfg, spec, c, pos, run,
                                  layouts)
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return M.head_mesh(params, cfg, x, run), cache

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


def _prefill_layer_mesh(p, x, cfg, spec, positions, ctx, cache, run,
                        layouts):
    """:func:`_prefill_layer` over a mesh: ``x`` and ``ctx`` DTensors,
    ``cache`` this process's block of the layer's cache, filled in place
    (its heads, channels or sequence slice, ``layouts``)."""
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    mp = p["mixer"]
    if spec.mixer in L.ATTN_MIXERS:
        m, k, v = L.attention_mesh(mp, h, cfg, spec, positions, run)
        layouts["kv"].write_prefill(cache, k, v)
    elif spec.mixer == "mla":
        m, ckv, krope = L.mla_mesh(mp, h, cfg, spec, positions, run)
        layouts["mla"].write_prefill(cache, ckv, krope)
    elif spec.mixer in ("mamba", "rwkv"):
        layer = L.mamba_mesh if spec.mixer == "mamba" else L.rwkv_mesh
        m, state = layer(mp, h, cfg, run, return_state=True)
        for name, t in state.items():
            cache[name].copy_(t)
    elif spec.mixer == "cross":
        if ctx is None:
            raise ValueError(f"{cfg.name}'s cross-attention layers need a "
                             "context (frame or patch embeddings)")
        m, k, v = L.cross_mesh(mp, h, ctx, cfg, run)
        layouts["cross"].write_prefill(cache, k, v)
    else:
        raise ValueError(spec.mixer)
    x = x + m
    h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
    o, _ = M.apply_mlp_mesh(p["mlp"], h2, cfg, spec, run)
    if cfg.family == "ssm":
        cache["cmix_shift"].copy_(run.act(h2, False)[:, -1:, :])
    return x + o


def make_prefill(cfg: ArchConfig, max_len: Optional[int] = None, mesh=None):
    """prefill(params, tokens, context=None) -> (last_logits (B,1,V), cache).

    ``context``: frame or patch embeddings (B, T, D), through the model's
    context stub.  As in the reference, the last logits are not soft-capped
    (``final_softcap``), unlike ``serve_step``'s and ``forward``'s; the
    greedy token is the same, tanh being monotone.  ``mesh``: None or a
    layout of one device, run as no mesh; an ``LMMesh``: DTensor
    ``params``, ``tokens`` and ``context`` DTensors or the whole batch,
    the residual stream under the reference's ``activation_constraint``,
    the cache made by ``init_cache_mesh`` and filled block by block, the
    last logits a DTensor."""
    mesh = S.executing_mesh(mesh, "serving")
    if mesh is not None:
        return _prefill_mesh(cfg, max_len, mesh)

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


def _prefill_mesh(cfg: ArchConfig, max_len: Optional[int], mesh):
    @torch.no_grad()
    def prefill(params, tokens, context=None):
        dt = S.dt_api()
        b, s = tokens.shape
        run = S.MeshRun(mesh, b)
        tokens = run.batch(tokens)
        ctx = M.encode_context_mesh(params, cfg, context, run)
        t = None if ctx is None else ctx.shape[1]
        cache = init_cache_mesh(cfg, b, max_len or s, mesh, t)
        layouts = L.cache_layouts(cache, run)
        positions = torch.arange(s, device=mesh.device)
        x = M.embed_mesh(params, cfg, tokens, run, (run.bp, dt.Replicate()))
        x = S.activation_constraint(x, mesh)
        for (layer_p, spec), c in zip(_mesh_layers(params, cfg),
                                      _local_layers(cache, cfg)):
            x = _prefill_layer_mesh(layer_p, x, cfg, spec, positions, ctx, c,
                                    run, layouts)
        whole = (run.bp, dt.Replicate())
        last = S.from_local(x.redistribute(run.dm, whole).to_local()[:, -1:],
                            mesh, whole)
        last = L.rms_norm(last, params["final_norm"], cfg.norm_eps)
        return M.head_mesh(params, cfg, last, run, softcap=False), cache

    return prefill
