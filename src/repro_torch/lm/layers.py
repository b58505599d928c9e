"""LM building blocks (``repro/lm/layers.py``): attention variants, MLA,
cross-attention, the dense MLP and MoE, Mamba, RWKV6 and its channel mix.

Apply-style functions over parameter dicts, with the JAX module's names and
layouts: activations (B, S, D); attention heads split as (B, H, S, hd);
parameters in ``cfg.dtype`` (bf16 by default), norms, rope angles, the
attention's softmax, router scores and the recurrent scans in fp32.  Every
sequence mixer has a prefill form (full sequence) and a decode form (one
token against a cache or state); ``serve_lib`` wires the latter.  The decode
forms write their cache or state in place and read the position on the
device only, so a decode step can be captured as a CUDA graph.

The attention itself is ``kernels.ops.attention_op``: the hand-written
flash kernel on CUDA tensors, its plain version on CPU tensors (MLA's
prefill takes the kernel's (192, 128) instance; its absorbed decode, over a
576-wide latent cache, stays plain, as the JAX package computes it outside
any kernel).  MoE, Mamba and RWKV6 are plain PyTorch, as the JAX package
leaves them to XLA.

Over a ``("data", "model")`` process mesh (``launch/mesh.py::LMMesh``)
every block runs on local shards (``lm/sharding.py::MeshRun``): the
``*_mesh`` functions take the normed residual stream as a DTensor, call
the plain functions above them (and the kernels) on this process's batch
rows, heads, channels, experts or cache slice, and put their outputs back
in the stream's placements: :func:`attention_mesh`, :func:`mla_mesh`,
:func:`cross_mesh`, :func:`mamba_mesh`, :func:`rwkv_mesh`,
:func:`mlp_mesh`, :func:`moe_mesh` (routed over the whole batch, as GSPMD
routes the reference's), :func:`cmix_mesh` and their decode forms, with
the reference's two mesh knobs, :data:`GQA_REPEAT` and
:data:`FLASH_DECODE` (off by default, as there), and the long-context
cache layout (the sequence over "data", decoded slice by slice and merged
by the log-sum-exp over "data").  The reference's ``maybe_constrain`` has
no counterpart.  A decode step over more than one device runs eager (a
CUDA graph does not capture the collectives).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig, LayerSpec
from ..kernels import flash_attn
from ..kernels.ops import attention_op, decode_attention_op

ATTN_MIXERS = ("attn", "attn_local")

# The reference's mesh knobs (repro/lm/layers.py), off by default.
# GQA_REPEAT: where the "model" axis does not divide the KV heads, repeat
# K/V to the query heads and shard those (off: that attention runs
# replicated over "model", as XLA runs the reference's).  FLASH_DECODE:
# decode over a cache sharded by its sequence over "model" attends each
# slice locally and merges the slices by their log-sum-exp (off: the cache
# is gathered first).
GQA_REPEAT = False
FLASH_DECODE = False


def set_gqa_repeat(v: bool) -> None:
    global GQA_REPEAT
    GQA_REPEAT = v


def set_flash_decode(v: bool) -> None:
    global FLASH_DECODE
    FLASH_DECODE = v


# tensors above this many elements are drawn slice by slice along their
# leading axes, so the fp32 draw's transient stays ~1 GiB (deepseek-v3's
# stacked w_gate alone is 3.76 G elements)
DRAW_WHOLE = 2 ** 28


def unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported: multi-card execution runs over devices "
        "(ROADMAP Queue 1 item 14); the port trains (any optimizer), "
        "prefills and decodes (the long-context cache layout too) every "
        "registry architecture over an LMMesh "
        "(launch/mesh.py::make_lm_mesh) and on one card")


def dt(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def normal(generator: torch.Generator, shape, std: float, dtype,
           device) -> torch.Tensor:
    """N(0, std^2) in ``dtype`` on ``device``; drawn in fp32 on the
    generator's device, so one seed gives the same weights wherever they
    are put.  A tensor of more than ``DRAW_WHOLE`` elements is drawn in
    slices along its leading axes, each cast into the result as it comes."""
    shape = tuple(shape)
    if torch.device(device).type == "meta":   # shapes only: nothing drawn
        return torch.empty(shape, dtype=dtype, device=device)
    if math.prod(shape) <= DRAW_WHOLE or len(shape) < 3:
        x = torch.randn(shape, generator=generator, device=generator.device)
        return (x * std).to(device=device, dtype=dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    rows = out.view(-1, *shape[-2:])
    per = max(1, DRAW_WHOLE // (shape[-2] * shape[-1]))
    for i in range(0, rows.shape[0], per):
        n = min(per, rows.shape[0] - i)
        x = torch.randn((n, *shape[-2:]), generator=generator,
                        device=generator.device)
        rows[i:i + n] = x.mul_(std)
    return out


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


def attention_qkv(p, x, cfg: ArchConfig, positions, heads=slice(None),
                  kv_heads=slice(None)):
    """Returns q (B,H,S,hd), k/v (B,Hkv,S,hd) with rope/norm/bias applied.
    Over a mesh ``wq`` holds the query heads ``heads`` and ``wk``/``wv``
    the KV heads ``kv_heads`` of the whole biases (whose layout mixes the
    heads: the reference reshapes bq's transpose)."""
    q = torch.einsum("bsd,dhe->bhse", x, p["wq"])
    k = torch.einsum("bsd,dhe->bhse", x, p["wk"])
    v = torch.einsum("bsd,dhe->bhse", x, p["wv"])
    if cfg.qkv_bias:
        # the reference reshapes bq's transpose (as written in JAX)
        q = q + p["bq"].T.reshape(1, cfg.n_heads, 1, -1)[:, heads]
        k = k + p["bk"].reshape(1, cfg.n_kv_heads, 1, -1)[:, kv_heads]
        v = v + p["bv"].reshape(1, cfg.n_kv_heads, 1, -1)[:, kv_heads]
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
# The dense-attention slice over a process mesh (lm/sharding.py::MeshRun)
# ---------------------------------------------------------------------------

def attn_mode(cfg: ArchConfig, mp: int) -> str:
    """How the attention shards over a "model" axis of ``mp``: ``"heads"``
    (q and K/V heads over "model"), ``"repeat"`` (GQA_REPEAT: K/V repeated
    to the query heads, which shard) or ``"replicated"``."""
    if cfg.n_kv_heads >= mp and cfg.n_kv_heads % mp == 0:
        return "heads"
    if GQA_REPEAT and cfg.n_heads >= mp and cfg.n_heads % mp == 0:
        return "repeat"
    return "replicated"


def _qkv_mesh(p, hl, cfg: ArchConfig, positions, run, mode: str,
              q_tp=None):
    """q, k, v on local tensors: q's heads this process's (all where
    ``mode`` is "replicated", or as ``q_tp`` says), K/V's this process's
    in the "heads" mode and all of them otherwise."""
    tp = mode != "replicated"
    q_tp = tp if q_tp is None else q_tp
    lp = {"wq": run.weight(p["wq"], q_tp, tp)}
    lp.update({k: run.weight(p[k], tp, tp) for k in ("wk", "wv")})
    for k in ("bq", "bk", "bv", "q_norm", "k_norm"):
        if k in p:
            lp[k] = run.weight(p[k], False, tp)
    return attention_qkv(lp, hl, cfg, positions,
                         run.heads(cfg.n_heads, q_tp),
                         run.heads(cfg.n_kv_heads, mode == "heads"))


def _repeat_kv(k, v, cfg: ArchConfig, run):
    """GQA_REPEAT: K/V (all KV heads) repeated to the query heads, this
    process's block of them (``jnp.repeat`` along the heads)."""
    g = cfg.n_heads // cfg.n_kv_heads
    heads = run.heads(cfg.n_heads, True)
    return (k.repeat_interleave(g, dim=1)[:, heads].contiguous(),
            v.repeat_interleave(g, dim=1)[:, heads].contiguous())


def _out_proj(p, o, run, tp: bool):
    """o (B, H, S, hd) of this process's heads (all without ``tp``) times
    its block of ``wo``: a partial sum over "model" where ``tp``."""
    return torch.einsum("bhse,hed->bsd", o, run.weight(p["wo"], tp, tp))


def attention_mesh(p, h, cfg: ArchConfig, spec: LayerSpec, positions, run,
                   causal=True):
    """:func:`attention_layer` over a mesh: ``h`` the normed stream (a
    DTensor), gathered along the sequence; the attention kernel on this
    process's batch rows and heads (:func:`attn_mode`); the output
    projection's partial sums reduce-scattered back to ``h``'s placements.
    Returns (out, k, v): k/v (B_local, Hkv_local or Hkv, S, hd) before any
    repeat, what a cache keeps."""
    mode = attn_mode(cfg, run.mp)
    tp = mode != "replicated"
    hl = run.act(h, tp)
    q, k, v = _qkv_mesh(p, hl, cfg, positions, run, mode)
    kk, vv = _repeat_kv(k, v, cfg, run) if mode == "repeat" else (k, v)
    o = chunked_attention(q, kk, vv, causal=causal,
                          window=layer_window(cfg, spec),
                          softcap=cfg.attn_softcap)
    return run.out(_out_proj(p, o, run, tp), tp, h.placements), k, v


def mlp_mesh(p, h, cfg: ArchConfig, run):
    """:func:`mlp_layer` over a mesh: the hidden width (``d_ff``, or the
    shared experts') over "model" where it divides (column- then
    row-parallel), else replicated."""
    f = p["w_gate"].shape[-1]
    tp = f >= run.mp and f % run.mp == 0
    hl = run.act(h, tp)
    lp = {k: run.weight(p[k], tp, tp) for k in ("w_gate", "w_up", "w_down")}
    return run.out(mlp_layer(lp, hl, cfg.act), tp, h.placements)


class CacheLayout:
    """How a layer's cache lies over the mesh, read from its placements
    (``sharding.cache_spec``): K/V (B, Hkv, S_max, hd), and the
    cross-attention's ck/cv (B, Hkv, T, hd), with their KV heads over
    "model" (``heads``) or whole, and their sequence over ``seq_axis``:
    "model" (the flash-decoding layout), "data" (the long-context layout,
    where the batch does not divide over "data") or None; MLA's latent
    ckv/k_rope (B, S_max, r), which has no head dim, the sequence at
    ``dim`` 1.  This process's slice of the sequence starts at key
    ``base`` and holds ``s_loc`` keys.  ``mode`` names the model-axis
    layout: ``"heads"``, ``"seq"`` (the sequence over "model") or
    ``"replicated"``."""

    def __init__(self, names, dim: int, s_max: int, run, heads: bool = False,
                 seq_axis=None):
        self.names, self.dim = names, dim
        self.heads, self.seq_axis = heads, seq_axis
        self.s_loc = s_max // run.size(seq_axis) if seq_axis else s_max
        self.base = run.index(seq_axis) * self.s_loc if seq_axis else 0

    @property
    def mode(self) -> str:
        if self.heads:
            return "heads"
        return "seq" if self.seq_axis == "model" else "replicated"

    @classmethod
    def of(cls, path: str, t, names, dim: int, head_dim, run):
        """The layout of cache leaf ``t`` (a DTensor at ``path``; a
        stacked pattern leaf has a leading layer dim)."""
        off = 1 if path.startswith("pattern") else 0
        heads, seq_axis = False, None
        for axis, pl in zip(run.mesh.axis_names, t.placements):
            d = getattr(pl, "dim", None)
            if d is None:
                continue
            if head_dim is not None and d == head_dim + off:
                heads = heads or axis == "model"
            elif d == dim + off:
                seq_axis = axis
        return cls(names, dim, t.shape[dim + off], run, heads, seq_axis)

    def write_prefill(self, cache, *new):
        """Positions [0, S) of each of ``names``' new entries into this
        process's rows."""
        d = self.dim
        s = new[0].shape[d]
        lo, hi = self.base, min(self.base + self.s_loc, s)
        if hi > lo:
            for name, t in zip(self.names, new):
                cache[name].narrow(d, 0, hi - lo).copy_(t.narrow(d, lo,
                                                                 hi - lo))

    def write_decode(self, cache, *new_and_pos):
        """Position ``pos`` (a device tensor, last) of each new entry into
        the slice that owns it, with no host read: elsewhere the row at
        the clamped index is written back unchanged."""
        *new, pos = new_and_pos
        d = self.dim
        if self.seq_axis is None:
            for name, t in zip(self.names, new):
                cache[name].index_copy_(d, pos.reshape(1), t)
            return
        r = (pos - self.base).clamp(0, self.s_loc - 1).reshape(1)
        own = (pos >= self.base) & (pos < self.base + self.s_loc)
        for name, t in zip(self.names, new):
            c = cache[name]
            c.index_copy_(d, r, torch.where(own, t, c.index_select(d, r)))


# cache kind -> (leaf names, sequence dim, head dim) of a layer's view
CACHE_KINDS = {"kv": (("k", "v"), 2, 1), "mla": (("ckv", "k_rope"), 1, None),
               "cross": (("ck", "cv"), 2, 1)}


def cache_layouts(cache, run) -> dict:
    """The layer caches' layouts by kind ("kv", "mla", "cross"), read
    from the placements of the first leaf of each kind in the DTensor
    ``cache`` (every layer of a kind lies alike)."""
    from . import sharding as S
    out = {}
    for path, t in S.leaves_with_paths(cache):
        for kind, (names, dim, head_dim) in CACHE_KINDS.items():
            if kind not in out and path.split("/")[-1] == names[0]:
                out[kind] = CacheLayout.of(path, t, names, dim, head_dim,
                                           run)
    return out


def lse_merge(o, lse, run, axis: str = "model"):
    """The outputs ``o`` (..., d) of each process's slice of the keys
    merged over ``axis`` (the axis the cache's sequence lies on) by their
    log-sum-exp ``lse`` (o's shape without its last dim): m = max lse, w =
    exp(lse - m), O = sum(w o) / sum(w), in fp32, on every process; three
    all-reduces.  A slice that sees no key (lse -inf, or ~-1e30 from a
    finite mask) has weight 0."""
    w = torch.exp(lse - run.reduce(lse, "max", axis))[..., None]
    return (run.reduce(w * o.to(torch.float32), "sum", axis)
            / run.reduce(w, "sum", axis))


def flash_decode_sharded(q, k_slice, v_slice, pos, window: int,
                         softcap: float, run, base: int,
                         axis: str = "model"):
    """Distributed flash decoding (the reference's
    ``_flash_decode_sharded``): q (B, Hq, 1, hd) with the same heads on
    every process of ``axis``, K/V this process's sequence slice of the
    cache, whose row 0 is key ``base``.  The decode kernel attends the
    slice (keys < pos + 1 by their global index, ``kv_base``) and returns
    its rows' log-sum-exp; the slices merge over ``axis`` by
    :func:`lse_merge`: three all-reduces of (B, Hq, 1[, hd]) values and no
    gather of the cache."""
    o, lse = flash_attn.flash_decode(q, k_slice, v_slice, pos, window,
                                     softcap, kv_base=base, return_lse=True)
    return lse_merge(o, lse, run, axis).to(q.dtype)


def attention_decode_mesh(p, h, cfg: ArchConfig, spec: LayerSpec, cache,
                          pos, run, layout: CacheLayout):
    """:func:`attention_decode` over a mesh, eager: ``h`` (B, 1, D) a
    DTensor replicated over "model", ``cache`` this process's block of the
    layer's K/V (``layout``), written in place at ``pos`` (a 0-d device
    tensor) by the process that owns it.

    * "heads" cache: q and K/V heads over "model", the decode kernel on
      this process's heads, the output projection's partial sums reduced.
    * "seq" cache (too few KV heads for "model"): with FLASH_DECODE,
      :func:`flash_decode_sharded` on this process's slice (q gathered to
      every head), no gather of the cache; without it the cache is
      all-gathered (as GSPMD gathers it for the reference) and attended
      whole, by heads with GQA_REPEAT (K/V repeated), else replicated.
      The reference's knob runs the sharded decode wherever S_max divides,
      resharding a cache laid out by heads; here a cache laid out by heads
      decodes its heads locally, which needs no merge; the two agree
      within fp32 rounding.
    * "replicated" cache: attended whole, as the seq cache after its
      gather.
    * The long-context layout (the sequence over "data"; the batch, which
      "data" does not divide, replicated there): every process attends
      its slice on the heads the layouts above give it (the cache's KV
      heads over "model", or every head, repeated with GQA_REPEAT) by
      :func:`flash_decode_sharded`, the slices merged over "data", whatever
      FLASH_DECODE says: no gather of the cache."""
    pos = decode_position(pos, h.device)
    mode = attn_mode(cfg, run.mp)
    tp = mode != "replicated"
    flash = layout.mode == "seq" and FLASH_DECODE
    # the flash-decoding path projects q by heads and gathers q (B, Hq, 1,
    # hd), not the weight
    q_tp = (cfg.n_heads >= run.mp and cfg.n_heads % run.mp == 0) \
        if flash else tp
    hl = run.act(h, tp)
    q, k_new, v_new = _qkv_mesh(p, hl, cfg, pos.expand(hl.shape[0], 1),
                                run, mode, q_tp)
    layout.write_decode(cache, k_new, v_new, pos)
    window, cap = layer_window(cfg, spec), cfg.attn_softcap
    if layout.seq_axis == "data":
        k, v = cache["k"], cache["v"]
        if mode == "repeat" and not layout.heads:
            k, v = _repeat_kv(k, v, cfg, run)
        o = flash_decode_sharded(q, k, v, pos, window, cap, run, layout.base,
                                 "data")
        out_tp = tp
    elif layout.mode == "heads":
        o = decode_attention_op(q, cache["k"], cache["v"], pos, window, cap)
        out_tp = True
    elif flash:
        qa = run.gather(q, 1) if q_tp else q
        o = flash_decode_sharded(qa, cache["k"], cache["v"], pos, window,
                                 cap, run, layout.base)
        out_tp = q_tp
        if out_tp:
            o = o[:, run.heads(cfg.n_heads, True)]
    else:
        k, v = cache["k"], cache["v"]
        if layout.mode == "seq":
            k, v = run.gather(k, 2), run.gather(v, 2)
        if mode == "repeat":
            k, v = _repeat_kv(k, v, cfg, run)
        o = decode_attention_op(q, k, v, pos, window, cap)
        out_tp = tp
    return run.out(_out_proj(p, o, run, out_tp), out_tp, h.placements)


# ---------------------------------------------------------------------------
# MLA (deepseek-v3): low-rank q/kv compression; absorbed decode
# ---------------------------------------------------------------------------

def init_mla(generator, cfg: ArchConfig, dtype, device, lead=()) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    draw = lambda std, *shape: normal(generator, (*lead, *shape), std, dtype,
                                      device)
    zeros = lambda n: torch.zeros((*lead, n), dtype=dtype, device=device)
    std = d ** -0.5
    return {"w_dq": draw(std, d, qr), "q_norm": zeros(qr),
            "w_uq": draw(qr ** -0.5, qr, h, dn + dr),
            "w_dkv": draw(std, d, kvr), "kv_norm": zeros(kvr),
            "w_kr": draw(std, d, dr),
            "w_uk": draw(kvr ** -0.5, kvr, h, dn),
            "w_uv": draw(kvr ** -0.5, kvr, h, dv),
            "wo": draw((h * dv) ** -0.5, h, dv, d)}


def mla_compress(p, x, cfg: ArchConfig, positions):
    """Shared compression: returns (q_nope, q_rope, ckv, k_rope)."""
    cq = rms_norm(x @ p["w_dq"], p["q_norm"], cfg.norm_eps)
    q = torch.einsum("bsr,rhe->bhse", cq, p["w_uq"])
    q_nope = q[..., :cfg.qk_nope_dim]
    q_rope = rope(q[..., cfg.qk_nope_dim:], positions, cfg.rope_theta)
    ckv = rms_norm(x @ p["w_dkv"], p["kv_norm"], cfg.norm_eps)   # (B,S,kvr)
    k_rope = rope((x @ p["w_kr"])[:, None], positions,
                  cfg.rope_theta)                                # (B,1,S,dr)
    return q_nope, q_rope, ckv, k_rope


def mla_attend(p, cfg: ArchConfig, q_nope, q_rope, ckv, k_rope):
    """Prefill from the compressed tensors: K/V decompressed per layer, the
    attention with D = qk_nope + qk_rope and DV = v_head_dim (the flash
    kernel's (192, 128) instance at deepseek-v3's widths)."""
    k_nope = torch.einsum("bsr,rhe->bhse", ckv, p["w_uk"])
    v = torch.einsum("bsr,rhe->bhse", ckv, p["w_uv"])
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:-1],
                                         cfg.qk_rope_dim)], -1)
    o = chunked_attention(q, k, v, causal=True)
    return torch.einsum("bhse,hed->bsd", o, p["wo"])


def mla_layer(p, x, cfg: ArchConfig, spec: LayerSpec, positions):
    """Training/prefill: decompress k/v per layer (standard path)."""
    return mla_attend(p, cfg, *mla_compress(p, x, cfg, positions))


def _mla_scores(cfg: ArchConfig, q_c, q_rope, ckv32, k_rope, pos, base=0):
    """The absorbed decode's scores (B, H, 1, T) in fp32 over a latent
    cache whose row 0 is key ``base``: (q_c ckv^T + q_rope k_rope^T) /
    sqrt(qk_nope + qk_rope), -1e30 past ``pos``."""
    s = (torch.einsum("bhsr,btr->bhst", q_c.to(torch.float32), ckv32)
         + torch.einsum("bhse,bte->bhst", q_rope.to(torch.float32),
                        k_rope.to(torch.float32)))
    s = s / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)   # no host copy
    keys = torch.arange(ckv32.shape[1], device=s.device)
    mask = (keys + base if base else keys) <= pos
    return torch.where(mask, s, torch.full((), -1e30, device=s.device))


def mla_decode(p, x, cfg: ArchConfig, spec: LayerSpec, cache, pos):
    """Absorbed decode over the ``ckv`` (B, S_max, kv_lora_rank) and
    ``k_rope`` (B, S_max, qk_rope) cache, written in place at ``pos``:
    score = (q_nope W_uk) ckv^T + q_rope k_rope^T, out = (attn ckv) W_uv,
    the softmax over the whole cache in fp32 under the mask t <= pos.
    Plain PyTorch: its head width, kv_lora_rank + qk_rope = 576, has no
    kernel in the JAX package either."""
    pos = decode_position(pos, x.device)
    q_nope, q_rope, ckv_new, kr_new = mla_compress(
        p, x, cfg, pos.expand(x.shape[0], 1))
    idx = pos.reshape(1)
    cache["ckv"].index_copy_(1, idx, ckv_new)
    cache["k_rope"].index_copy_(1, idx, kr_new[:, 0])
    ckv = cache["ckv"].to(torch.float32)
    q_c = torch.einsum("bhse,rhe->bhsr", q_nope, p["w_uk"])      # absorb W_uk
    w = torch.softmax(_mla_scores(cfg, q_c, q_rope, ckv, cache["k_rope"],
                                  pos), dim=-1)
    o_c = torch.einsum("bhst,btr->bhsr", w, ckv)
    o = torch.einsum("bhsr,rhe->bhse", o_c.to(x.dtype), p["w_uv"])
    return torch.einsum("bhse,hed->bsd", o, p["wo"]), cache


MLA_HEAD_KEYS = ("w_uq", "w_uk", "w_uv", "wo")


def _mla_weights(p, cfg: ArchConfig, run):
    """MLA's weights on this process and whether its heads are split: the
    head-parallel ones (``MLA_HEAD_KEYS``) this process's heads where
    "model" divides the heads, the compressions and norms whole."""
    tp = cfg.n_heads >= run.mp and cfg.n_heads % run.mp == 0
    return {k: run.weight(w, tp and k in MLA_HEAD_KEYS, tp)
            for k, w in p.items()}, tp


def mla_mesh(p, h, cfg: ArchConfig, spec: LayerSpec, positions, run):
    """:func:`mla_layer` over a mesh: the compressions on every process of
    "model" (whole: they are FSDP-sharded only), the decompression, the
    attention (the flash kernel's (192, 128) instance at deepseek-v3's
    widths) and the output projection on this process's heads.  Returns
    (out, ckv (B_local, S, r), k_rope (B_local, S, qk_rope)): the latent
    cache's entries."""
    lp, tp = _mla_weights(p, cfg, run)
    q_nope, q_rope, ckv, k_rope = mla_compress(lp, run.act(h, tp), cfg,
                                               positions)
    o = mla_attend(lp, cfg, q_nope, q_rope, ckv, k_rope)
    return run.out(o, tp, h.placements), ckv, k_rope[:, 0]


def mla_decode_mesh(p, h, cfg: ArchConfig, spec: LayerSpec, cache, pos,
                    run, layout: CacheLayout):
    """:func:`mla_decode` over a mesh: ``cache`` this process's block of
    the latent cache (``layout``, the sequence over "model" where it
    divides), written in place at ``pos`` by the process that owns it.
    Over a sequence-sharded cache every process scores all heads' queries
    (gathered over "model": one all-gather of (B, H, 1, r + qk_rope))
    against its slice, and the slices merge by their log-sum-exp
    (:func:`lse_merge`: three all-reduces of (B, H, 1[, r]) values, no
    gather of the cache); the latent output then goes through
    this process's heads of W_uv and wo (one all-reduce).  With the
    long-context layout (the sequence over "data", the batch replicated
    there) each process scores its own heads against its slice and the
    slices merge over "data" the same way, with no gather of the queries."""
    pos = decode_position(pos, h.device)
    lp, tp = _mla_weights(p, cfg, run)
    hl = run.act(h, tp)
    q_nope, q_rope, ckv_new, kr_new = mla_compress(
        lp, hl, cfg, pos.expand(hl.shape[0], 1))
    layout.write_decode(cache, ckv_new, kr_new[:, 0], pos)
    ckv = cache["ckv"].to(torch.float32)
    q_c = torch.einsum("bhse,rhe->bhsr", q_nope, lp["w_uk"])
    if layout.seq_axis == "data":
        s = _mla_scores(cfg, q_c, q_rope, ckv, cache["k_rope"], pos,
                        layout.base)
        m = s.amax(-1, keepdim=True)
        e = torch.exp(s - m)
        tot = e.sum(-1, keepdim=True)
        o_c = lse_merge(torch.einsum("bhst,btr->bhsr", e / tot, ckv),
                        (m + torch.log(tot))[..., 0], run, "data")
    elif layout.mode == "seq" and run.mp > 1:
        r = q_c.shape[-1]
        qq = torch.cat([q_c, q_rope.to(q_c.dtype)], -1)
        if tp:
            qq = run.gather(qq, 1)
        s = _mla_scores(cfg, qq[..., :r], qq[..., r:], ckv, cache["k_rope"],
                        pos, layout.base)
        m = s.amax(-1, keepdim=True)
        e = torch.exp(s - m)
        tot = e.sum(-1, keepdim=True)
        o_c = lse_merge(torch.einsum("bhst,btr->bhsr", e / tot, ckv),
                        (m + torch.log(tot))[..., 0], run)
        if tp:
            o_c = o_c[:, run.heads(cfg.n_heads, True)]
    else:
        w = torch.softmax(_mla_scores(cfg, q_c, q_rope, ckv,
                                      cache["k_rope"], pos), dim=-1)
        o_c = torch.einsum("bhst,btr->bhsr", w, ckv)
    o = torch.einsum("bhsr,rhe->bhse", o_c.to(hl.dtype), lp["w_uv"])
    return run.out(torch.einsum("bhse,hed->bsd", o, lp["wo"]), tp,
                   h.placements)


# ---------------------------------------------------------------------------
# Cross attention (whisper decoder, llama-3.2-vision)
# ---------------------------------------------------------------------------

def init_cross_attention(generator, cfg: ArchConfig, dtype, device,
                         lead=()) -> dict:
    """wq, wk, wv, wo as in :func:`init_attention` (no bias or qk norm),
    and the context's norm ``ctx_norm``."""
    hd = cfg.resolved_head_dim
    d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    draw = lambda *shape: normal(generator, (*lead, *shape), d ** -0.5, dtype,
                                 device)
    return {"wq": draw(d, h, hd), "wk": draw(d, kv, hd), "wv": draw(d, kv, hd),
            "wo": draw(h, hd, d),
            "ctx_norm": torch.zeros((*lead, d), dtype=dtype, device=device)}


def cross_kv(p, context, cfg: ArchConfig):
    """The context's k/v (B, Hkv, T, hd) after the layer's ``ctx_norm``."""
    ctx = rms_norm(context, p["ctx_norm"], cfg.norm_eps)
    return (torch.einsum("btd,dhe->bhte", ctx, p["wk"]),
            torch.einsum("btd,dhe->bhte", ctx, p["wv"]))


def cross_attend(p, x, k, v):
    """Non-causal attention of x's queries over the context's k/v."""
    q = torch.einsum("bsd,dhe->bhse", x, p["wq"])
    o = chunked_attention(q, k, v, causal=False)
    return torch.einsum("bhse,hed->bsd", o, p["wo"])


def cross_attention_layer(p, x, context, cfg: ArchConfig):
    """context (B, T, D): image patches / audio frames (modality stub).
    Keys past T are masked by the kernel (the Pallas kernel attends to its
    zero padding there; the JAX LM's ``chunked_attention`` masks them)."""
    return cross_attend(p, x, *cross_kv(p, context, cfg))


def cross_mesh(p, h, context, cfg: ArchConfig, run):
    """:func:`cross_attention_layer` over a mesh: ``h`` the normed stream
    and ``context`` (B, T, D) DTensors over the batch; q and the context's
    K/V by heads as :func:`attn_mode` says, the non-causal attention on
    this process's heads and batch rows.  Returns (out, k, v): k/v (B_local,
    Hkv_local or Hkv, T, hd) before any repeat, what the cache keeps."""
    mode = attn_mode(cfg, run.mp)
    tp = mode != "replicated"
    lp = {"wq": run.weight(p["wq"], tp, tp),
          "ctx_norm": run.weight(p["ctx_norm"], False, tp)}
    lp.update({k: run.weight(p[k], mode == "heads", tp) for k in ("wk", "wv")})
    k, v = cross_kv(lp, run.act(context, tp), cfg)
    kk, vv = _repeat_kv(k, v, cfg, run) if mode == "repeat" else (k, v)
    q = torch.einsum("bsd,dhe->bhse", run.act(h, tp), lp["wq"])
    o = chunked_attention(q, kk, vv, causal=False)
    return run.out(_out_proj(p, o, run, tp), tp, h.placements), k, v


def cross_decode_mesh(p, h, cfg: ArchConfig, cache, run, layout: CacheLayout):
    """The cross-attention's decode over a mesh against this process's
    block of the static ``ck``/``cv`` cache (``layout``): local by heads,
    all-gathered along T where the cache lies sharded by it; the decode
    kernel (one query row) on this process's heads."""
    mode = attn_mode(cfg, run.mp)
    tp = mode != "replicated"
    q = torch.einsum("bsd,dhe->bhse", run.act(h, tp),
                     run.weight(p["wq"], tp, tp))
    k, v = cache["ck"], cache["cv"]
    if layout.seq_axis is not None:
        k, v = (run.gather(k, 2, layout.seq_axis),
                run.gather(v, 2, layout.seq_axis))
    if mode == "repeat":
        k, v = _repeat_kv(k, v, cfg, run)
    o = chunked_attention(q, k, v, causal=False)
    return run.out(_out_proj(p, o, run, tp), tp, h.placements)


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


# ---------------------------------------------------------------------------
# MoE: dropping experts with cumsum positions
# ---------------------------------------------------------------------------

def init_moe(generator, cfg: ArchConfig, dtype, device, lead=()) -> dict:
    e = cfg.n_experts
    dff = cfg.moe_d_ff or cfg.d_ff
    d = cfg.d_model
    draw = lambda std, *shape: normal(generator, (*lead, *shape), std, dtype,
                                      device)
    p = {"router": normal(generator, (*lead, d, e), d ** -0.5, torch.float32,
                          device),
         "w_gate": draw(d ** -0.5, e, d, dff),
         "w_up": draw(d ** -0.5, e, d, dff),
         "w_down": draw(dff ** -0.5, e, dff, d)}
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(generator, d, dff * cfg.n_shared_experts,
                               dtype, device, lead)
    return p


def moe_route(p, xf, cfg: ArchConfig):
    """Routing of xf (T, D): (topw (T, k) fp32, topi (T, k) int64, pos
    (T, k) slot within the expert, clamped to C - 1, keep (T, k) bool,
    capacity C, aux loss).  ``topi`` is the first k of a stable descending
    sort of the scores, so ties go to the lower expert index, as
    ``jax.lax.top_k`` breaks them; positions come from k cumsum passes in
    the reference's order.  No host read: a decode step with MoE can be
    captured as a CUDA graph."""
    t = xf.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    logits = xf.to(torch.float32) @ p["router"]
    if cfg.router_scores == "sigmoid":      # deepseek-v3 aux-free style
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, -1)
    topw, topi = torch.sort(scores, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :k], topi[:, :k]
    topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)

    # load-balance aux loss (Switch-style): f_e * p_e
    pe = (scores if cfg.router_scores == "softmax"
          else torch.softmax(logits, -1)).mean(0)
    experts = torch.arange(e, device=xf.device)
    fe = (topi.reshape(-1, 1) == experts).sum(0).to(torch.float32) / (t * k)
    aux = e * (pe * fe).sum()

    # slots per expert, from the call's token count (the reference's: a
    # prefill and a decode step route under different capacities)
    capacity = max(int(t * k / e * cfg.capacity_factor), 4)
    pos_list, keep_list = [], []
    counts = torch.zeros((e,), dtype=torch.int64, device=xf.device)
    for j in range(k):
        onehot = (topi[:, j:j + 1] == experts).to(torch.int64)      # (T, E)
        before = (onehot.cumsum(0) - onehot).gather(1, topi[:, j:j + 1])
        pos_j = counts[topi[:, j]] + before[:, 0]
        counts = counts + onehot.sum(0)
        keep_list.append(pos_j < capacity)
        pos_list.append(pos_j.clamp_max(capacity - 1))
    return (topw, topi, torch.stack(pos_list, 1), torch.stack(keep_list, 1),
            capacity, aux)


def moe_layer(p, x, cfg: ArchConfig, act="silu"):
    """Dropping MoE (the reference's ``moe_layer``).  Returns (out, aux).

    The dispatch buffer (E * C, D) is a gather, not the reference's
    scatter-add: the kept (token, slot) pairs have distinct slots (their
    positions count up per expert), so a slot -> token map written with
    them (dropped pairs write a spare slot) and a gather from x padded with
    a zero row give the same buffer, and the same bits on every call (a
    CUDA ``index_add_`` adds colliding rows in no fixed order)."""
    b, s, d = x.shape
    t = b * s
    e = cfg.n_experts
    xf = x.reshape(t, d)
    topw, topi, pos, keep, capacity, aux = moe_route(p, xf, cfg)
    dest = topi * capacity + pos                                  # (T, k)
    slot_token = torch.full((e * capacity + 1,), t, dtype=torch.int64,
                            device=x.device)
    tokens = torch.arange(t, device=x.device).unsqueeze(1).expand_as(dest)
    slot_token.scatter_(0, torch.where(keep, dest, e * capacity).reshape(-1),
                        tokens.reshape(-1))
    xpad = torch.cat([xf, xf.new_zeros((1, d))])
    # gathers as F.embedding: under autograd its backward sums a token's
    # slots in a fixed order on the card too (indexing's may not)
    buf = F.embedding(slot_token[:-1], xpad).view(e, capacity, d)

    g = act_fn(act)(torch.bmm(buf, p["w_gate"]))
    u = torch.bmm(buf, p["w_up"])
    h = torch.bmm(g * u, p["w_down"]).view(e * capacity, d)

    out = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for j in range(cfg.top_k):
        w_j = (topw[:, j] * keep[:, j]).to(x.dtype)
        out = out + F.embedding(dest[:, j], h) * w_j[:, None]
    if cfg.n_shared_experts:
        out = out + mlp_layer(p["shared"], xf, act)
    return out.reshape(b, s, d), aux


def _expert_blocks(w, run):
    """How the routed experts' weights (``w_gate`` (E, D, F)) lie over the
    mesh: (blocks of experts, this process's block, experts over "data"
    too (``sharding.EXPERT_2D``), F over "model", the work split over
    "model" at all)."""
    from . import sharding as S
    dt = S.dt_api()
    on = lambda pl, d: isinstance(pl, dt.Shard) and pl.dim == d
    pl = w.placements
    tp = on(pl[1], 0) or on(pl[1], 2)
    if on(pl[0], 0):
        return run.dp * run.mp, run.di * run.mp + run.mi, True, False, tp
    if on(pl[1], 0):
        return run.mp, run.mi, False, False, tp
    return 1, 0, False, on(pl[1], 2), tp


def moe_mesh(p, h, cfg: ArchConfig, run, act="silu"):
    """:func:`moe_layer` over a mesh.  Returns (out, aux), both DTensors.

    The routing is the whole batch's, as GSPMD keeps the reference's:
    every process gathers every token (the normed stream, over both axes)
    and routes all T = B S of them (capacity from T, positions from the
    cumsum in the global token order, the aux loss's means over all
    tokens), the same bits on each.  Each process then computes its own
    experts' (C, D) slots (experts over "model", or over ("data",
    "model") with ``EXPERT_2D``; where "model" does not divide the
    experts, every expert with this process's block of F) and combines
    them: with experts over "data" too for every token, a partial sum over
    both axes; otherwise for its own batch rows only (slots of other rows'
    tokens stay zero), a partial sum over "model"; either way reduced to
    the stream's placements.  The shared experts join that sum on this
    process's rows where their hidden width splits over "model" as the
    routed work does (the reference's order of the sum: a ``(1, 1)`` mesh
    gives its bits), else go through :func:`mlp_mesh`.  Gradients: each
    process's local gradient of the
    gathered tokens and of the router is a partial sum over the axes that
    split the work (the aux loss's part on one process of each such axis),
    whole over an axis that repeats it."""
    from . import sharding as S
    dt = S.dt_api()
    n_blk, blk, e_data, f_tp, tp = _expert_blocks(p["w_gate"], run)
    part, rep = dt.Partial(), dt.Replicate()
    gd = part if (e_data or isinstance(run.bp, dt.Shard)) else rep
    gm = part if tp else rep
    xa = run.whole(h, (gd, gm))
    b, s, d = xa.shape
    t = b * s
    xf = xa.reshape(t, d)
    topw, topi, pos, keep, capacity, aux = moe_route(
        {"router": run.whole(p["router"], (gd, gm))}, xf, cfg)

    e_loc = cfg.n_experts // n_blk
    e0 = blk * e_loc
    names = ("w_gate", "w_up", "w_down")
    if e_data:
        ew = {k: p[k].to_local(grad_placements=p[k].placements)
              for k in names}
    else:
        ew = {k: run.weight(p[k], k != "w_down" or not f_tp, tp)
              for k in names}
        if f_tp:    # w_down has no "model" rule: this process's F rows
            f = ew["w_gate"].shape[2]
            ew["w_down"] = ew["w_down"][:, run.mi * f:(run.mi + 1) * f]
    # the tokens whose outputs this process adds: all, or its batch rows
    rows = slice(0, t) if e_data else slice(run.rows.start * s,
                                            run.rows.stop * s)
    own = (topi >= e0) & (topi < e0 + e_loc)
    mine = torch.zeros((t, 1), dtype=torch.bool, device=xf.device)
    mine[rows] = True
    dest = (topi - e0) * capacity + pos                            # (T, k)
    n_slots = e_loc * capacity
    slot_token = torch.full((n_slots + 1,), t, dtype=torch.int64,
                            device=xf.device)
    tokens = torch.arange(t, device=xf.device).unsqueeze(1).expand_as(dest)
    slot_token.scatter_(0, torch.where(keep & own & mine, dest,
                                       n_slots).reshape(-1),
                        tokens.reshape(-1))
    xpad = torch.cat([xf, xf.new_zeros((1, d))])
    buf = F.embedding(slot_token[:-1], xpad).view(e_loc, capacity, d)
    g = act_fn(act)(torch.bmm(buf, ew["w_gate"]))
    u = torch.bmm(buf, ew["w_up"])
    hh = torch.bmm(g * u, ew["w_down"]).view(n_slots, d)
    hpad = torch.cat([hh, hh.new_zeros((1, d))])
    out = torch.zeros((rows.stop - rows.start, d), dtype=xf.dtype,
                      device=xf.device)
    for j in range(cfg.top_k):
        dj = torch.where(own[rows, j], dest[rows, j], n_slots)
        w_j = (topw[rows, j] * keep[rows, j]).to(xf.dtype)
        out = out + F.embedding(dj, hpad) * w_j[:, None]
    # the shared experts on this process's rows where their F splits over
    # "model" as the routed work does (the reference's sum, in its order)
    shared = p.get("shared")
    fs = shared["w_gate"].shape[-1] if shared else 0
    inline = bool(shared) and not e_data and tp == (fs >= run.mp
                                                    and fs % run.mp == 0)
    if inline:
        out = out + mlp_layer({k: run.weight(w, tp, tp)
                               for k, w in shared.items()},
                              xf if rows == slice(0, t) else xf[rows], act)
    out = out.view(-1, s, d)
    if e_data:
        o = S.from_local(out, run.mesh, (part, part)).redistribute(
            run.dm, h.placements)
    else:
        o = run.out(out, tp, h.placements)
    if shared and not inline:
        o = o + mlp_mesh(shared, h, cfg, run)
    owner = ((gd == rep or run.di == 0) and (gm == rep or run.mi == 0))
    return o, S.from_local(aux if owner else aux.detach(), run.mesh,
                           (rep, rep))


# ---------------------------------------------------------------------------
# Channels split over "model" (Mamba's Di, RWKV6's heads)
# ---------------------------------------------------------------------------

class ChannelShard:
    """A mixer's channels split over "model": ``own`` this process's block
    of the ``width`` channels, ``psum`` the sum over "model" of a partial
    each process computed from its channels (``MeshRun.psum``), ``lora``
    whether RWKV6's decay LoRA is split too (its product then a partial
    sum over all ``width`` channels)."""

    def __init__(self, run, width: int, lora: bool = False):
        n = width // run.mp
        self.own = slice(run.mi * n, run.mi * n + n)
        self.width, self.psum, self.lora = width, run.psum, lora


def rms_norm_split(x, gamma, eps, tp: ChannelShard):
    """:func:`rms_norm` over a width split over "model": x and gamma this
    process's channels, the sum of squares summed over "model"."""
    x32 = x.to(torch.float32)
    var = tp.psum((x32 * x32).sum(-1, keepdim=True)) / tp.width
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * (1.0 + gamma)


# ---------------------------------------------------------------------------
# Mamba (jamba): selective SSM with a chunked scan
# ---------------------------------------------------------------------------

def softplus(x):
    """log(1 + e^x) as ``jax.nn.softplus`` forms it (logaddexp(x, 0))."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def init_mamba(generator, cfg: ArchConfig, dtype, device, lead=()) -> dict:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_d_state
    dt_rank = max(d // 16, 1)
    draw = lambda std, *shape: normal(generator, (*lead, *shape), std, dtype,
                                      device)
    full = lambda v: v.to(device).expand(*lead, *v.shape).clone()
    lin = torch.linspace(1e-3, 1e-1, di, dtype=torch.float32)
    return {
        "w_in": draw(d ** -0.5, d, 2 * di),
        "conv_w": draw(0.3, cfg.ssm_conv, di),
        "conv_b": torch.zeros((*lead, di), dtype=dtype, device=device),
        "w_bcdt": draw(di ** -0.5, di, 2 * n + dt_rank),
        "w_dt": draw(dt_rank ** -0.5, dt_rank, di),
        "dt_bias": full(torch.log(torch.exp(lin) - 1).to(dtype)),
        "A_log": full(torch.log(torch.arange(1, n + 1, dtype=torch.float32)
                                .repeat(di, 1))),
        "D": full(torch.ones((di,), dtype=torch.float32)),
        "w_out": draw(di ** -0.5, di, d),
    }


def linear_scan(a, b):
    """Inclusive scan of the maps h -> a_t h + b_t along axis 1: (A_t, B_t)
    with A_t = a_t ... a_1 and B_t = sum_s (a_t ... a_s+1) b_s, so that
    h_t = A_t h_0 + B_t.  Log-depth doubling (Hillis-Steele): at offset o,
    each step composes with the one o earlier as (a1, b1) then (a2, b2) ->
    (a1 a2, a2 b1 + b2), the reference's ``associative_scan`` combine; the
    association order differs from XLA's, so the sums agree to rounding."""
    n = a.shape[1]
    off = 1
    while off < n:
        a_new = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], 1)
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], 1)
        a = a_new
        off *= 2
    return a, b


def _mamba_scan(u, dt_, B_, C_, A, chunk: int, h0=None):
    """u/dt_ (B,S,Di), B_/C_ (B,S,N), A (Di,N).  Chunked selective scan:
    within a chunk the log-depth :func:`linear_scan`, across chunks a loop
    carrying the state.  Returns (y (B,S,Di), h_last (B,Di,N))."""
    b, s, di = u.shape
    n = B_.shape[-1]
    pad = (-s) % chunk
    if pad:
        z3 = lambda a: F.pad(a, (0, 0, 0, pad))
        u, dt_, B_, C_ = z3(u), z3(dt_), z3(B_), z3(C_)
        # padded steps are identity updates (dt = 0: decay 1, input 0), or
        # the carried final state would be decayed by them
        valid = (torch.arange(s + pad, device=u.device) < s).to(dt_.dtype)
        dt_ = dt_ * valid[None, :, None]
    h = (torch.zeros((b, di, n), dtype=torch.float32, device=u.device)
         if h0 is None else h0)
    ys = []
    for c0 in range(0, s + pad, chunk):
        uj, dtj = u[:, c0:c0 + chunk], dt_[:, c0:c0 + chunk]
        Bj, Cj = B_[:, c0:c0 + chunk], C_[:, c0:c0 + chunk]
        dA = dtj[..., None] * A[None, None]          # (B, L, Di, N) log-decay
        dBu = (dtj * uj)[..., None] * Bj[:, :, None, :]
        # a = exp(dA) <= 1: the composition stays bounded, unlike a
        # cumsum-of-ratios form
        prod_a, hs_b = linear_scan(torch.exp(dA), dBu)
        hs = prod_a * h[:, None] + hs_b               # (B, L, Di, N)
        ys.append(torch.einsum("blin,bln->bli", hs, Cj))
        h = hs[:, -1]
    return torch.cat(ys, 1)[:, :s], h


def _mamba_inputs(p, xin, cfg: ArchConfig, tp=None):
    """B, C (fp32) and dt (fp32, softplus) from the conv output xin; with
    ``tp`` (a :class:`ChannelShard`) xin and ``w_bcdt``'s rows are this
    process's channels, so B, C and dt's low rank are summed over "model"
    before use."""
    n = cfg.ssm_d_state
    bcdt = xin @ p["w_bcdt"]
    if tp is not None:
        bcdt = tp.psum(bcdt)
    B_ = bcdt[..., :n].to(torch.float32)
    C_ = bcdt[..., n:2 * n].to(torch.float32)
    dt_ = softplus(bcdt[..., 2 * n:] @ p["w_dt"] + p["dt_bias"]).to(
        torch.float32)
    return B_, C_, dt_


def mamba_layer(p, x, cfg: ArchConfig, state=None, chunk: int = 0,
                return_state: bool = False, tp=None):
    """Full-sequence mamba mixer.  ``return_state`` also yields the decode
    state {"conv" (B,K,Di) raw-input tail, "ssm" (B,Di,N)}.  With ``tp``
    (:func:`mamba_mesh`) the weights and the state are this process's
    channels and the output a partial sum over "model"."""
    if not chunk:   # adaptive: longer chunks at long sequence lengths
        chunk = 128 if x.shape[1] <= 8192 else 512
    s = x.shape[1]
    xraw, z = (x @ p["w_in"]).chunk(2, dim=-1)            # (B,S,Di) each
    k = p["conv_w"].shape[0]
    xpad = F.pad(xraw, (0, 0, k - 1, 0))                  # causal depthwise
    conv = sum(xpad[:, i:i + s] * p["conv_w"][i] for i in range(k))
    xin = F.silu(conv + p["conv_b"])
    B_, C_, dt_ = _mamba_inputs(p, xin, cfg, tp)
    A = -torch.exp(p["A_log"])
    h0 = state["ssm"] if state is not None else None
    y, h_last = _mamba_scan(xin.to(torch.float32), dt_, B_, C_, A, chunk, h0)
    y = y + p["D"] * xin.to(torch.float32)
    y = y.to(x.dtype) * F.silu(z)
    out = y @ p["w_out"]
    if return_state:
        return out, {"conv": xpad[:, -k:, :], "ssm": h_last}
    return out


def mamba_decode(p, x, cfg: ArchConfig, state, pos, tp=None):
    """One-token decode with the carried (conv window, ssm state), both
    written in place (``tp`` as in :func:`mamba_layer`)."""
    xin, z = (x @ p["w_in"]).chunk(2, dim=-1)             # (B,1,Di)
    conv_buf = torch.cat([state["conv"][:, 1:], xin], 1)  # (B,K,Di)
    conv = (conv_buf * p["conv_w"][None]).sum(1, keepdim=True)
    xin = F.silu(conv + p["conv_b"])
    B_, C_, dt_ = _mamba_inputs(p, xin, cfg, tp)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt_[..., None] * A)                    # (B,1,Di,N)
    dBu = (dt_ * xin.to(torch.float32))[..., None] * B_[:, :, None, :]
    h = dA[:, 0] * state["ssm"] + dBu[:, 0]
    y = torch.einsum("bin,bn->bi", h, C_[:, 0])[:, None, :]
    y = y + p["D"] * xin.to(torch.float32)
    y = y.to(x.dtype) * F.silu(z)
    state["conv"].copy_(conv_buf)
    state["ssm"].copy_(h)
    return y @ p["w_out"], state


def _mamba_weights(p, cfg: ArchConfig, run):
    """Mamba's weights on this process and its :class:`ChannelShard`
    (None where "model" does not split Di: the mixer replicated).  Di's
    weights come as their "model" shards, except ``w_in`` (D, 2 Di), whose
    contiguous shard would hold the x or the z half, gathered and cut to
    this process's x and z channels, and ``w_dt`` (no "model" rule),
    gathered and cut to its columns."""
    di = cfg.ssm_expand * cfg.d_model
    tp = run.mp > 1 and di % run.mp == 0
    lp = {k: run.weight(w, tp, tp) for k, w in p.items()
          if k not in ("w_in", "w_dt")}
    w_in, w_dt = (run.weight(p[k], False, tp) for k in ("w_in", "w_dt"))
    if not tp:
        return dict(lp, w_in=w_in, w_dt=w_dt), None
    sh = ChannelShard(run, di)
    own = sh.own
    lp["w_in"] = torch.cat([w_in[:, own],
                            w_in[:, di + own.start:di + own.stop]], 1)
    lp["w_dt"] = w_dt[:, own]
    return lp, sh


def mamba_mesh(p, h, cfg: ArchConfig, run, return_state: bool = False):
    """:func:`mamba_layer` over a mesh: Di over "model" (the conv, the scan
    and the state on this process's channels; B, C and dt summed over
    "model"), the output projection's partial sums reduced to ``h``'s
    placements.  ``return_state``: also this process's block of the
    decode state."""
    lp, sh = _mamba_weights(p, cfg, run)
    out = mamba_layer(lp, run.act(h, sh is not None), cfg,
                      return_state=return_state, tp=sh)
    if return_state:
        return run.out(out[0], sh is not None, h.placements), out[1]
    return run.out(out, sh is not None, h.placements)


def mamba_decode_mesh(p, h, cfg: ArchConfig, state, pos, run):
    """:func:`mamba_decode` over a mesh, ``state`` this process's block
    (its channels of ``conv`` and ``ssm``), written in place."""
    lp, sh = _mamba_weights(p, cfg, run)
    out, _ = mamba_decode(lp, run.act(h, sh is not None), cfg, state, pos,
                          tp=sh)
    return run.out(out, sh is not None, h.placements)


# ---------------------------------------------------------------------------
# RWKV6 ("Finch"): data-dependent decay linear attention, chunked
# ---------------------------------------------------------------------------

def init_rwkv(generator, cfg: ArchConfig, dtype, device, lead=()) -> dict:
    d = cfg.d_model
    lora = max(d // 16, 32)
    std = d ** -0.5
    draw = lambda std, *shape: normal(generator, (*lead, *shape), std, dtype,
                                      device)
    full = lambda v, *shape: torch.full((*lead, *shape), v, dtype=dtype,
                                        device=device)
    return {
        "mu": full(0.5, 5, d),    # token-shift mix for r, k, v, w, g
        "w_r": draw(std, d, d), "w_k": draw(std, d, d),
        "w_v": draw(std, d, d), "w_g": draw(std, d, d),
        "w_o": draw(std, d, d),
        "w0": full(-6.0, d),      # data-dependent decay exp(-exp(w0 + lora))
        "w_lora_a": draw(std, d, lora),
        "w_lora_b": draw(lora ** -0.5, lora, d),
        "u": draw(0.1, d),        # bonus
        "ln_g": full(0.0, d),
    }


def _rwkv_chunk(r, k, v, logw, u, h0, chunk: int):
    """r/k/v/logw (B,S,H,hd) with logw <= 0; u (H,hd); h0 (B,H,hd,hd).

    Chunked evaluation of o_t = r_t . (S_{t-1} + u k_t v_t^T),
    S_t = diag(w_t) S_{t-1} + k_t v_t^T (decay on the k-dimension): a loop
    over chunks carrying S, the factored form with the strict tril mask
    within a chunk.
    """
    b, s, h, hd = r.shape
    pad = (-s) % chunk
    if pad:
        z = lambda a: F.pad(a, (0, 0, 0, 0, 0, pad))
        r, k, v, logw = z(r), z(k), z(v), z(logw)
    hsplit = lambda a: a.transpose(1, 2)               # (B, H, S, hd)
    r, k, v, logw = hsplit(r), hsplit(k), hsplit(v), hsplit(logw)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32,
                                device=r.device), diagonal=-1)
    S = (torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
         if h0 is None else h0)
    os_ = []
    for c0 in range(0, s + pad, chunk):
        rj, kj = r[:, :, c0:c0 + chunk], k[:, :, c0:c0 + chunk]
        vj, wj = v[:, :, c0:c0 + chunk], logw[:, :, c0:c0 + chunk]
        cl = torch.cumsum(wj, dim=2)                  # cumulative log decay
        cl_prev = cl - wj                             # up to t - 1
        rdec = rj * torch.exp(cl_prev)
        o_inter = torch.einsum("bhld,bhde->bhle", rdec, S)
        # exp(-cl) stays bounded: the layer clamps the per-step log decay
        scores = torch.einsum("bhid,bhjd->bhij", rdec, kj * torch.exp(-cl))
        scores = scores * tri[None, None]
        diag = torch.einsum("bhid,bhid->bhi", rj * u[None, :, None, :], kj)
        os_.append(o_inter + torch.einsum("bhij,bhje->bhie", scores, vj)
                   + diag[..., None] * vj)
        last = cl[:, :, -1:, :]
        S = (torch.exp(last).transpose(2, 3) * S
             + torch.einsum("bhjd,bhje->bhde", kj * torch.exp(last - cl), vj))
    o = torch.cat(os_, 2).transpose(1, 2)[:, :s]
    return o, S


def _rwkv_mix(p, x, xs):
    """The token-shift mixes: mix(i) = x + (xs - x) * mu[i]."""
    return lambda i: x + (xs - x) * p["mu"][i]


def _rwkv_decay_logit(p, mix, tp=None):
    """w0 + tanh(mix_w A) B, clamped; with ``tp`` for this process's
    channels, the LoRA's product (a partial sum where the LoRA is split)
    summed over "model" before it is cut to them."""
    t = torch.tanh(mix(3) @ p["w_lora_a"]) @ p["w_lora_b"]
    if tp is not None:
        t = (tp.psum(t) if tp.lora else t)[..., tp.own]
    return (p["w0"] + t).to(torch.float32).clamp(-20.0, 2.0)


def _rwkv_out_norm(o, p, cfg: ArchConfig, tp=None):
    """The ``ln_g`` norm over the whole width (across heads: over "model"
    with ``tp``)."""
    if tp is None:
        return rms_norm(o, p["ln_g"], cfg.norm_eps)
    return rms_norm_split(o, p["ln_g"], cfg.norm_eps, tp)


def rwkv_layer(p, x, cfg: ArchConfig, state=None, chunk: int = 0,
               return_state: bool = False, tp=None):
    """The time mix over a sequence.  With ``tp`` (:func:`rwkv_mesh`) the
    r/k/v/g and output weights, ``u``, ``w0``, ``ln_g`` and the state are
    this process's heads and the output a partial sum over "model"."""
    b, s, d = x.shape
    if not chunk:   # adaptive; the decay clamp keeps exp(0.35*chunk) in fp32
        chunk = 32 if s <= 4096 else 128
    hd = cfg.rwkv_head_dim
    h = p["w_r"].shape[1] // hd
    xs = F.pad(x, (0, 0, 1, 0))[:, :-1]               # token shift
    mix = _rwkv_mix(p, x, xs)
    r, k, v = mix(0) @ p["w_r"], mix(1) @ p["w_k"], mix(2) @ p["w_v"]
    # per-step log decay clamped to >= -0.35, as the reference clamps it
    # here (and not in rwkv_decode)
    logw = torch.clamp_min(-torch.exp(_rwkv_decay_logit(p, mix, tp)), -0.35)
    g = F.silu(mix(4) @ p["w_g"])
    hsplit = lambda a: a.reshape(b, s, h, hd)
    h0 = state["S"] if state is not None else None
    o, S = _rwkv_chunk(hsplit(r).to(torch.float32),
                       hsplit(k).to(torch.float32),
                       hsplit(v).to(torch.float32), hsplit(logw),
                       p["u"].to(torch.float32).reshape(h, hd), h0, chunk)
    o = o.reshape(b, s, h * hd).to(x.dtype)
    o = _rwkv_out_norm(o, p, cfg, tp) * g
    out = o @ p["w_o"]
    if return_state:
        return out, {"S": S, "shift": x[:, -1:, :]}
    return out


def rwkv_decode(p, x, cfg: ArchConfig, state, pos, tp=None):
    """state = {"S": (B,H,hd,hd), "shift": (B,1,D)}, written in place.  The
    log decay is not clamped here (the reference's asymmetry).  ``tp`` as
    in :func:`rwkv_layer` (``S`` this process's heads)."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    h = p["w_r"].shape[1] // hd
    mix = _rwkv_mix(p, x, state["shift"])
    heads = lambda a: a.reshape(b, h, hd).to(torch.float32)
    r, k, v = (heads(mix(0) @ p["w_r"]), heads(mix(1) @ p["w_k"]),
               heads(mix(2) @ p["w_v"]))
    logw = -torch.exp(_rwkv_decay_logit(p, mix, tp)).reshape(b, h, hd)
    g = F.silu(mix(4) @ p["w_g"])
    u = p["u"].to(torch.float32).reshape(h, hd)
    S = state["S"]
    o = (torch.einsum("bhd,bhde->bhe", r, S)
         + (r * u * k).sum(-1, keepdim=True) * v)
    S_new = torch.exp(logw)[..., None] * S + k[..., None] * v[..., None, :]
    o = o.reshape(b, 1, h * hd).to(x.dtype)
    o = _rwkv_out_norm(o, p, cfg, tp) * g
    state["S"].copy_(S_new)
    state["shift"].copy_(x)
    return o @ p["w_o"], state


RWKV_HEAD_KEYS = ("w_r", "w_k", "w_v", "w_g", "w_o")


def _rwkv_weights(p, cfg: ArchConfig, run):
    """RWKV6's time-mix weights on this process and its
    :class:`ChannelShard` (None where "model" does not divide the heads:
    the mixer replicated): r/k/v/g column- and ``w_o`` row-parallel by
    heads, the decay LoRA by its rank where the rules split it, ``mu``
    whole, ``u``, ``w0`` and ``ln_g`` cut to this process's channels."""
    from . import sharding as S
    d = cfg.d_model
    tp = run.mp > 1 and (d // cfg.rwkv_head_dim) % run.mp == 0
    lora = tp and isinstance(p["w_lora_a"].placements[1], S.dt_api().Shard)
    lp = {k: run.weight(w, tp and (k in RWKV_HEAD_KEYS or lora and k in (
        "w_lora_a", "w_lora_b")), tp) for k, w in p.items()}
    if not tp:
        return lp, None
    sh = ChannelShard(run, d, lora)
    for k in ("w0", "u", "ln_g"):
        lp[k] = lp[k][sh.own]
    return lp, sh


def rwkv_mesh(p, h, cfg: ArchConfig, run, return_state: bool = False):
    """:func:`rwkv_layer` over a mesh: the heads over "model" (the chunked
    recurrence on this process's heads), the decay LoRA's product and the
    ``ln_g`` norm's sum of squares summed over "model", the output
    projection's partial sums reduced to ``h``'s placements.
    ``return_state``: also this process's block of the decode state (its
    heads of ``S``; the token shift whole)."""
    lp, sh = _rwkv_weights(p, cfg, run)
    out = rwkv_layer(lp, run.act(h, sh is not None), cfg,
                     return_state=return_state, tp=sh)
    if return_state:
        return run.out(out[0], sh is not None, h.placements), out[1]
    return run.out(out, sh is not None, h.placements)


def rwkv_decode_mesh(p, h, cfg: ArchConfig, state, pos, run):
    """:func:`rwkv_decode` over a mesh, ``state`` this process's block."""
    lp, sh = _rwkv_weights(p, cfg, run)
    out, _ = rwkv_decode(lp, run.act(h, sh is not None), cfg, state, pos,
                         tp=sh)
    return run.out(out, sh is not None, h.placements)


# ---------------------------------------------------------------------------
# RWKV channel mix (the "dense" mlp of the ssm family)
# ---------------------------------------------------------------------------

def init_rwkv_cmix(generator, d: int, d_ff: int, dtype, device,
                   lead=()) -> dict:
    draw = lambda std, *shape: normal(generator, (*lead, *shape), std, dtype,
                                      device)
    return {"mu": torch.full((*lead, 2, d), 0.5, dtype=dtype, device=device),
            "w_k": draw(d ** -0.5, d, d_ff),
            "w_v": draw(d_ff ** -0.5, d_ff, d),
            "w_r": draw(d ** -0.5, d, d)}


def rwkv_cmix(p, x, shift_state=None):
    xs = F.pad(x, (0, 0, 1, 0))[:, :-1] if shift_state is None else shift_state
    kx = x + (xs - x) * p["mu"][0]
    rx = x + (xs - x) * p["mu"][1]
    k = torch.square(F.relu(kx @ p["w_k"]))
    return torch.sigmoid(rx @ p["w_r"]) * (k @ p["w_v"])


def cmix_mesh(p, h, cfg: ArchConfig, run, shift_state=None):
    """:func:`rwkv_cmix` over a mesh: F over "model" (``w_k``'s columns;
    ``w_v`` (F, D), which the rules shard on D, gathered and cut to this
    process's F rows), ``w_r`` whole; the product, a partial sum over
    "model", reduced to ``h``'s placements.  ``shift_state`` this
    process's rows of the decode's ``cmix_shift``."""
    f = p["w_k"].shape[-1]
    tp = run.mp > 1 and f % run.mp == 0
    lp = {k: run.weight(p[k], tp and k == "w_k", tp)
          for k in ("mu", "w_k", "w_r")}
    w_v = run.weight(p["w_v"], False, tp)
    lp["w_v"] = w_v[ChannelShard(run, f).own] if tp else w_v
    return run.out(rwkv_cmix(lp, run.act(h, tp), shift_state), tp,
                   h.placements)
