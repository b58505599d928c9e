"""Every registry architecture of the port's LM (``repro_torch.lm``)
against the JAX ``repro.lm`` at the JAX smoke test's reduced sizes
(``tests/test_lm_archs.py``: 4 layers, d_model 48, d_ff 96, vocab 128;
batch 2, a 12-token prompt, caches of 16), fp32, the JAX weights carried
over by ``bridge.lm_params_to_torch``; whisper and the vision model with
the reference's context stub (frame or patch embeddings).  The vision
model runs 5 layers, so that its one cross-attention layer (every 5th) is
in the stack.

* per architecture: forward logits and aux loss; the prefill's last logits
  and every cache leaf; three decode steps (logits and every cache leaf);
  deepseek's ``mtp_logits``;
* per mixer: ``moe_layer`` at capacity factor 1.0 (tokens drop) with the
  routing integers (expert ids, slot positions, keeps) equal to JAX's
  exactly, also under a zero router (every score tied); ``_mamba_scan``
  and ``_rwkv_chunk`` with S off the chunk and a nonzero initial state;
  ``mla_decode``; cross-attention over a context of 600 rows (JAX pads it
  to its 512-row chunks); ``attention_ref`` with DV != D against
  ``chunked_attention``;
* one bf16 case (deepseek).

Tolerances: fp32 atol 1e-4 x max|JAX| (the frameworks sum in other
orders; the Mamba scan also associates its products in another order);
bf16 atol 6e-2 x max|JAX|, the gate of ``tests/test_torch_lm.py`` (bf16
rounding at places XLA and PyTorch choose differently).  The file takes
~95 s in one process, a third of it the JAX initialiser.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.lm import layers as JL
from repro.lm import model as JM
from repro.lm import serve_lib as JS
from repro_torch import bridge
from repro_torch.kernels import ref as tref
from repro_torch.lm import layers as TL
from repro_torch.lm import model as TM
from repro_torch.lm import serve_lib as TS

ALL = sorted(ARCHS)
B, S, ML, STEPS = 2, 12, 16, 3
TOL = {"float32": 1e-4, "bfloat16": 6e-2}
_MODELS = {}


def _f32(x):
    x = x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32)
    return np.asarray(x)


def _close(got, want, what, dtype="float32"):
    want = _f32(want)
    assert tuple(got.shape) == want.shape, what
    np.testing.assert_allclose(_f32(got), want, rtol=0,
                               atol=TOL[dtype] * np.abs(want).max(),
                               err_msg=what)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _close_caches(tc, jc, what, dtype="float32"):
    t, j = dict(_leaves(tc)), dict(_leaves(jc))
    assert t.keys() == j.keys(), (what, sorted(t), sorted(j))
    for path in j:
        assert t[path].dtype == {"float32": torch.float32,
                                 "bfloat16": torch.bfloat16}[str(j[path].dtype)]
        _close(t[path], j[path], f"{what} cache {path}", dtype)


def _models(name, dtype="float32"):
    """(jcfg, jparams, tcfg, tparams, tokens, jctx, tctx), built once."""
    if (name, dtype) not in _MODELS:
        n_layers = 5 if name == "llama-3.2-vision-90b" else 4
        jcfg = ARCHS[name].reduced(n_layers=n_layers, d_model=48, d_ff=96,
                                   vocab=128)
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
        tparams = bridge.lm_params_to_torch(jax.device_get(jparams), "cpu")
        rng = np.random.default_rng(1)
        tokens = rng.integers(0, jcfg.vocab, (B, S + STEPS))
        ctx = None
        if jcfg.enc_dec or (jcfg.cross_attn_every and jcfg.family == "vlm"):
            t = jcfg.n_audio_frames if jcfg.enc_dec else jcfg.n_image_tokens
            ctx = rng.normal(0, 1, (B, t, jcfg.d_model)).astype(np.float32)
        _MODELS[name, dtype] = (
            jcfg, jparams, bridge.arch_config_to_torch(jcfg), tparams, tokens,
            None if ctx is None else jnp.asarray(ctx),
            None if ctx is None else torch.tensor(ctx))
    return _MODELS[name, dtype]


def test_reduced_stacks_cover_every_mixer():
    specs = [spec for name in ALL for spec in _models(name)[2].layer_specs()]
    mixers, mlps = {s.mixer for s in specs}, {s.mlp for s in specs}
    assert mixers == {"attn", "attn_local", "mla", "mamba", "rwkv", "cross"}
    assert mlps == {"dense", "moe"}


@pytest.mark.parametrize("name", ALL)
def test_forward_matches_jax(name):
    jcfg, jparams, tcfg, tparams, tokens, jctx, tctx = _models(name)
    want, jaux = JM.forward(jparams, jcfg, jnp.asarray(tokens[:, :S]), jctx)
    with torch.no_grad():
        got, aux = TM.forward(tparams, tcfg, torch.tensor(tokens[:, :S]), tctx)
    _close(got, want, f"{name} forward logits")
    assert abs(float(aux) - float(jaux)) <= 1e-4 * max(abs(float(jaux)), 1e-30)
    if not jcfg.n_experts:
        assert float(aux) == 0.0


@pytest.mark.parametrize("name", ALL)
def test_prefill_and_decode_match_jax(name):
    jcfg, jparams, tcfg, tparams, tokens, jctx, tctx = _models(name)
    jpre = JS.make_prefill(jcfg, max_len=ML, remat="none")
    jl, jc = (jpre(jparams, jnp.asarray(tokens[:, :S]), jctx) if jctx is not None
              else jpre(jparams, jnp.asarray(tokens[:, :S])))
    tl, tc = TS.make_prefill(tcfg, max_len=ML)(
        tparams, torch.tensor(tokens[:, :S]), tctx)
    _close(tl, jl, f"{name} prefill last logits")
    _close_caches(tc, jc, f"{name} prefill")
    jstep = jax.jit(JS.make_serve_step(jcfg))
    tstep = TS.make_serve_step(tcfg)
    for t in range(S, S + STEPS):
        jl, jc = jstep(jparams, jc, jnp.asarray(tokens[:, t:t + 1]), t)
        tl, tc = tstep(tparams, tc, torch.tensor(tokens[:, t:t + 1]), t)
        _close(tl, jl, f"{name} decode logits at {t}")
        _close_caches(tc, jc, f"{name} decode at {t}")


def test_mtp_logits_match_jax():
    jcfg, jparams, tcfg, tparams, tokens, _, _ = _models("deepseek-v3-671b")
    _, jh, _ = JM.forward(jparams, jcfg, jnp.asarray(tokens[:, :S]),
                          return_hidden=True)
    with torch.no_grad():
        _, th, _ = TM.forward(tparams, tcfg, torch.tensor(tokens[:, :S]),
                              return_hidden=True)
        got = TM.mtp_logits(tparams, tcfg, th[:, :-1],
                            torch.tensor(tokens[:, 1:S]))
    want = JM.mtp_logits(jparams, jcfg, jh[:, :-1], jnp.asarray(tokens[:, 1:S]))
    _close(got, want, "mtp logits")


def test_bf16_deepseek_matches_jax():
    """MLA, MoE (sigmoid router), MTP's model in bf16 (the reference's bf16
    initialiser): forward, prefill and three decode steps at the bf16 gate.
    Routing is discontinuous: where two experts' scores lie closer than the
    bf16 rounding of the hidden state (the fp32 weights rounded to bf16 give
    such a tie, a gap of 0.0023), the frameworks pick different experts for
    that token and the gate does not hold there."""
    jcfg, jparams, tcfg, tparams, tokens, _, _ = _models("deepseek-v3-671b",
                                                         "bfloat16")
    want, _ = JM.forward(jparams, jcfg, jnp.asarray(tokens[:, :S]))
    with torch.no_grad():
        got, _ = TM.forward(tparams, tcfg, torch.tensor(tokens[:, :S]))
    assert got.dtype == torch.bfloat16
    _close(got, want, "bf16 forward", "bfloat16")
    jl, jc = JS.make_prefill(jcfg, max_len=ML, remat="none")(
        jparams, jnp.asarray(tokens[:, :S]))
    tl, tc = TS.make_prefill(tcfg, max_len=ML)(tparams,
                                               torch.tensor(tokens[:, :S]))
    _close(tl, jl, "bf16 prefill last logits", "bfloat16")
    _close_caches(tc, jc, "bf16 prefill", "bfloat16")
    jstep = jax.jit(JS.make_serve_step(jcfg))
    tstep = TS.make_serve_step(tcfg)
    for t in range(S, S + STEPS):
        jl, jc = jstep(jparams, jc, jnp.asarray(tokens[:, t:t + 1]), t)
        tl, tc = tstep(tparams, tc, torch.tensor(tokens[:, t:t + 1]), t)
        _close(tl, jl, f"bf16 decode logits at {t}", "bfloat16")


# ---------------------------------------------------------------------------
# per mixer
# ---------------------------------------------------------------------------

def _jax_route(p, x, cfg):
    """The routing integers of the reference's ``moe_layer``
    (``repro/lm/layers.py``, the lines from the router logits to the
    positions), run in JAX: (topi, pos, keep)."""
    t = x.shape[0] * x.shape[1]
    e, k = cfg.n_experts, cfg.top_k
    logits = x.reshape(t, -1).astype(jnp.float32) @ p["router"]
    scores = (jax.nn.sigmoid(logits) if cfg.router_scores == "sigmoid"
              else jax.nn.softmax(logits, -1))
    _, topi = jax.lax.top_k(scores, k)
    capacity = max(int(t * k / e * cfg.capacity_factor), 4)
    pos_list, keep_list = [], []
    counts = jnp.zeros((e,), jnp.int32)
    for j in range(k):
        onehot = jax.nn.one_hot(topi[:, j], e, dtype=jnp.int32)
        pos_j = counts[topi[:, j]] + (jnp.cumsum(onehot, 0) - onehot)[
            jnp.arange(t), topi[:, j]]
        counts = counts + onehot.sum(0)
        keep_list.append(pos_j < capacity)
        pos_list.append(jnp.minimum(pos_j, capacity - 1))
    return (np.asarray(topi), np.stack([np.asarray(p_) for p_ in pos_list], 1),
            np.stack([np.asarray(k_) for k_ in keep_list], 1))


@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
@pytest.mark.parametrize("zero_router", [False, True])
def test_moe_routing_and_output_match_jax(router, zero_router):
    """Capacity factor 1.0: some (token, slot) pairs drop; expert ids, slot
    positions and keeps equal JAX's exactly, the output and aux loss within
    the fp32 gate.  A zero router ties every score: ties go to the lower
    expert index, as ``jax.lax.top_k`` breaks them."""
    cfg = ARCHS["llama4-scout-17b-a16e"].reduced(
        d_model=48, d_ff=96, n_experts=4, top_k=2, capacity_factor=1.0,
        n_shared_experts=1, router_scores=router)
    jp = JL.init_moe(jax.random.PRNGKey(3), cfg, jnp.float32)
    if zero_router:
        jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    x = np.random.default_rng(4).normal(0, 1, (B, S, 48)).astype(np.float32)
    want, jaux = JL.moe_layer(jp, jnp.asarray(x), cfg, cfg.act)
    tp = bridge.lm_params_to_torch(jax.device_get(jp), "cpu")
    tcfg = bridge.arch_config_to_torch(cfg)
    xt = torch.tensor(x)
    got, aux = TL.moe_layer(tp, xt, tcfg, tcfg.act)
    _, topi, pos, keep, capacity, _ = TL.moe_route(tp, xt.reshape(B * S, 48),
                                                  tcfg)
    jtopi, jpos, jkeep = _jax_route(jp, jnp.asarray(x), cfg)
    assert capacity == max(int(B * S * 2 / 4 * 1.0), 4)
    np.testing.assert_array_equal(topi.numpy(), jtopi)
    np.testing.assert_array_equal(pos.numpy(), jpos)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    assert not jkeep.all(), "no pair dropped: the case does not test drops"
    if zero_router:
        assert (jtopi == [0, 1]).all()
    _close(got, want, "moe output")
    assert abs(float(aux) - float(jaux)) <= 1e-5 * abs(float(jaux))


def test_mamba_scan_matches_jax():
    """S = 37 over chunks of 8 (the last one padded with identity steps)
    from a nonzero state."""
    rng = np.random.default_rng(5)
    b, s, di, n = 2, 37, 24, 4
    u = rng.normal(0, 1, (b, s, di)).astype(np.float32)
    dt = rng.uniform(0.001, 0.5, (b, s, di)).astype(np.float32)
    B_, C_ = (rng.normal(0, 1, (b, s, n)).astype(np.float32) for _ in range(2))
    A = -np.tile(np.arange(1, n + 1, dtype=np.float32), (di, 1))
    h0 = rng.normal(0, 1, (b, di, n)).astype(np.float32)
    jy, jh = JL._mamba_scan(*(jnp.asarray(a) for a in (u, dt, B_, C_, A)), 8,
                            jnp.asarray(h0))
    ty, th = TL._mamba_scan(*(torch.tensor(a) for a in (u, dt, B_, C_, A)), 8,
                            torch.tensor(h0))
    _close(ty, jy, "mamba y")
    _close(th, jh, "mamba final state")


def test_rwkv_chunk_matches_jax():
    """S = 37 over chunks of 8 from a nonzero state, log decay in
    [-0.35, 0)."""
    rng = np.random.default_rng(6)
    b, s, h, hd = 2, 37, 3, 8
    r, k, v = (rng.normal(0, 1, (b, s, h, hd)).astype(np.float32)
               for _ in range(3))
    logw = -rng.uniform(1e-3, 0.35, (b, s, h, hd)).astype(np.float32)
    u = rng.normal(0, 0.1, (h, hd)).astype(np.float32)
    h0 = rng.normal(0, 1, (b, h, hd, hd)).astype(np.float32)
    jo, jS = JL._rwkv_chunk(*(jnp.asarray(a) for a in (r, k, v, logw, u, h0)),
                            8)
    to, tS = TL._rwkv_chunk(*(torch.tensor(a) for a in (r, k, v, logw, u, h0)),
                            8)
    _close(to, jo, "rwkv o")
    _close(tS, jS, "rwkv final state")


def test_mla_decode_matches_jax():
    """The absorbed decode over a filled latent cache at position 9 of 16:
    output and both cache leaves (written in place at 9)."""
    cfg = ARCHS["deepseek-v3-671b"].reduced(d_model=48, d_ff=96)
    spec = cfg.layer_specs()[0]
    jp = JL.init_mla(jax.random.PRNGKey(7), cfg, jnp.float32)
    rng = np.random.default_rng(8)
    x = rng.normal(0, 1, (B, 1, 48)).astype(np.float32)
    cache = {"ckv": rng.normal(0, 1, (B, ML, cfg.kv_lora_rank)),
             "k_rope": rng.normal(0, 1, (B, ML, cfg.qk_rope_dim))}
    cache = {k: v.astype(np.float32) for k, v in cache.items()}
    want, jc = JL.mla_decode(jp, jnp.asarray(x), cfg, spec,
                             {k: jnp.asarray(v) for k, v in cache.items()}, 9)
    tp = bridge.lm_params_to_torch(jax.device_get(jp), "cpu")
    tc = {k: torch.tensor(v) for k, v in cache.items()}
    got, tc = TL.mla_decode(tp, torch.tensor(x), bridge.arch_config_to_torch(cfg),
                            spec, tc, torch.tensor(9))
    _close(got, want, "mla decode output")
    for k in cache:
        _close(tc[k], jc[k], f"mla decode cache {k}")


def test_cross_attention_ragged_context_matches_jax():
    """600 context rows (JAX pads them to two 512-row chunks and masks the
    padding): the prefill form and the decode form over the cached k/v."""
    cfg = ARCHS["whisper-medium"].reduced(d_model=48, d_ff=96)
    jp = JL.init_cross_attention(jax.random.PRNGKey(9), cfg, jnp.float32)
    rng = np.random.default_rng(10)
    x = rng.normal(0, 1, (B, 5, 48)).astype(np.float32)
    ctx = rng.normal(0, 1, (B, 600, 48)).astype(np.float32)
    want = JL.cross_attention_layer(jp, jnp.asarray(x), jnp.asarray(ctx), cfg)
    tp = bridge.lm_params_to_torch(jax.device_get(jp), "cpu")
    tcfg = bridge.arch_config_to_torch(cfg)
    got = TL.cross_attention_layer(tp, torch.tensor(x), torch.tensor(ctx), tcfg)
    _close(got, want, "cross attention")
    ctxn = JL.rms_norm(jnp.asarray(ctx), jp["ctx_norm"], cfg.norm_eps)
    jcache = {"ck": jnp.einsum("btd,dhe->bhte", ctxn, jp["wk"]),
              "cv": jnp.einsum("btd,dhe->bhte", ctxn, jp["wv"])}
    want = JS._cross_decode(jp, jnp.asarray(x[:, :1]), cfg, jcache)
    k, v = TL.cross_kv(tp, torch.tensor(ctx), tcfg)
    got = TL.cross_attend(tp, torch.tensor(x[:, :1]), k, v)
    _close(got, want, "cross decode")


@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_with_its_own_value_width(causal):
    """MLA's shape class: D = 16 for q/k, DV = 8 for v, scale 1/sqrt(D),
    against the JAX LM's ``chunked_attention`` (KV chunks of 8)."""
    rng = np.random.default_rng(11)
    q = rng.normal(0, 1, (2, 4, 20, 16)).astype(np.float32)
    k = rng.normal(0, 1, (2, 4, 20, 16)).astype(np.float32)
    v = rng.normal(0, 1, (2, 4, 20, 8)).astype(np.float32)
    want = JL.chunked_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                causal=causal, chunk=8)
    got = tref.attention_ref(*(torch.tensor(a) for a in (q, k, v)), causal)
    assert tuple(got.shape) == (2, 4, 20, 8)
    _close(got, want, "attention_ref with DV != D")
