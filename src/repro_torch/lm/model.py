"""Model assembly from an ArchConfig (``repro/lm/model.py``).

The parameter tree keeps the JAX layout: ``embed``, ``final_norm``
(``lm_head`` when the embeddings are not tied), ``prefix`` as a list of
per-layer dicts, and ``pattern`` as a list (one entry per position of the
repeating pattern, ``ArchConfig.scan_pattern``) of dicts of tensors stacked
along a leading ``(n_steps,)`` axis; whisper's ``encoder`` (stacked along
``(n_enc_layers,)``), ``enc_norm`` and ``frame_proj``, the vision model's
``img_proj``, and deepseek's ``mtp_layer``, ``mtp_norm`` and ``mtp_proj``.
The JAX ``lax.scan`` over pattern periods is a Python loop that takes step
``s`` of every stacked tensor as a view (``forward`` unbinds each stacked
tensor once, so that its gradient is one stack of the steps' gradients).

``forward(remat="full")`` recomputes each prefix layer and each pattern
period in the backward (``torch.utils.checkpoint``, non-reentrant), as the
reference checkpoints them.

``mesh``: None, a ``MeshLayout`` of one device (run as no mesh), or a
``("data", "model")`` process mesh (``launch/mesh.py::LMMesh``) for every
registry architecture, whose parameters are then DTensors laid out by
``lm/sharding.py``'s specs (``distribute_params``): the embedding and the
LM head vocabulary-parallel, the residual stream under the reference's
``activation_constraint`` between layers, each block on local shards
(``sharding.MeshRun``; ``layers``' ``*_mesh`` functions), the context
through the encoder or the patch projection over the batch, the MoE
layers' aux loss the whole batch's, MTP over the same blocks, the logits
under ``logits_constraint``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig, LayerSpec
from ..device import resolve_device
from . import layers as L
from . import sharding as S

# the whisper encoder's layers and deepseek's MTP layer
ENC_SPEC = LayerSpec(mixer="attn", mlp="dense", use_rope=False)
MTP_SPEC = LayerSpec("attn", "dense")


def _init_mixer(generator, cfg: ArchConfig, spec: LayerSpec, dtype, device,
                lead):
    init = {"attn": L.init_attention, "attn_local": L.init_attention,
            "mla": L.init_mla, "mamba": L.init_mamba, "rwkv": L.init_rwkv,
            "cross": L.init_cross_attention}.get(spec.mixer)
    if init is None:
        raise ValueError(spec.mixer)
    return init(generator, cfg, dtype, device, lead)


def _init_mlp(generator, cfg: ArchConfig, spec: LayerSpec, dtype, device,
              lead):
    if spec.mlp == "moe":
        return L.init_moe(generator, cfg, dtype, device, lead)
    if cfg.family == "ssm":
        return L.init_rwkv_cmix(generator, cfg.d_model, cfg.d_ff, dtype,
                                device, lead)
    return L.init_mlp(generator, cfg.d_model, cfg.d_ff, dtype, device, lead)


def init_layer(generator, cfg: ArchConfig, spec: LayerSpec, dtype, device,
               lead=()) -> dict:
    zeros = torch.zeros((*lead, cfg.d_model), dtype=dtype, device=device)
    return {"norm1": zeros,
            "mixer": _init_mixer(generator, cfg, spec, dtype, device, lead),
            "norm2": zeros.clone(),
            "mlp": _init_mlp(generator, cfg, spec, dtype, device, lead)}


def apply_mixer(p, h, cfg: ArchConfig, spec: LayerSpec, positions,
                context=None, causal=True):
    """The sequence mixer of one layer on its normed input ``h``."""
    if spec.mixer in L.ATTN_MIXERS:
        return L.attention_layer(p, h, cfg, spec, positions, causal)
    if spec.mixer == "mla":
        return L.mla_layer(p, h, cfg, spec, positions)
    if spec.mixer == "mamba":
        return L.mamba_layer(p, h, cfg)
    if spec.mixer == "rwkv":
        return L.rwkv_layer(p, h, cfg)
    if spec.mixer == "cross":
        if context is None:
            raise ValueError(f"{cfg.name}'s cross-attention layers need a "
                             "context (frame or patch embeddings)")
        return L.cross_attention_layer(p, h, context, cfg)
    raise ValueError(spec.mixer)


def apply_mlp(p, h, cfg: ArchConfig, spec: LayerSpec):
    """The channel mixer of one layer on its normed input: (out, aux)."""
    if spec.mlp == "moe":
        return L.moe_layer(p, h, cfg, cfg.act)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.family == "ssm":
        return L.rwkv_cmix(p, h), aux
    return L.mlp_layer(p, h, cfg.act), aux


def apply_layer(p, x, cfg: ArchConfig, spec: LayerSpec, positions,
                context=None, causal=True):
    """Pre-norm residual block.  Returns (x, aux_loss)."""
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    x = x + apply_mixer(p["mixer"], h, cfg, spec, positions, context, causal)
    h = L.rms_norm(x, p["norm2"], cfg.norm_eps)
    o, aux = apply_mlp(p["mlp"], h, cfg, spec)
    return x + o, aux


def step_params(stacked: dict, s: int) -> dict:
    """Step ``s`` of a tree of stacked tensors, as views."""
    return {k: step_params(v, s) if isinstance(v, dict) else v[s]
            for k, v in stacked.items()}


def unstack(stacked: dict, n: int) -> list[dict]:
    """Every step of a tree of tensors stacked along ``(n,)``, as views
    from one ``unbind`` per tensor: under autograd the steps' gradients
    come back as one stack, not as n full-size scatters (DTensors are
    unbound on their blocks, ``sharding.unbind0``)."""
    def split(tree):
        return {k: split(v) if isinstance(v, dict) else S.unbind0(v)
                for k, v in tree.items()}

    def pick(tree, s):
        return {k: pick(v, s) if isinstance(v, dict) else v[s]
                for k, v in tree.items()}

    parts = split(stacked)
    return [pick(parts, s) for s in range(n)]


def layers_in_order(params, cfg: ArchConfig):
    """(layer params, spec) in execution order: the prefix layers, then the
    pattern's positions step by step."""
    prefix_n, n_steps, pattern = cfg.scan_pattern()
    specs = cfg.layer_specs()
    for i in range(prefix_n):
        yield params["prefix"][i], specs[i]
    for s in range(n_steps):
        for j, spec in enumerate(pattern):
            yield step_params(params["pattern"][j], s), spec


# ---------------------------------------------------------------------------
# Whole-model init
# ---------------------------------------------------------------------------

def init_params(cfg: ArchConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Parameters with the JAX initialiser's structure and scales (normal
    times std, zeros for norms and biases, the reference's constants for
    Mamba's and RWKV's) in ``cfg.dtype`` (the router in fp32).  The numbers
    come from ``generator``, drawn on its device; the stacked pattern
    tensors are drawn whole, one per position, or in slices when large
    (``layers.normal``)."""
    dev = resolve_device(device)
    dtype = L.dt(cfg)
    prefix_n, n_steps, pattern = cfg.scan_pattern()
    specs = cfg.layer_specs()
    d = cfg.d_model
    draw = lambda std, *shape: L.normal(generator, shape, std, dtype, dev)
    zeros = lambda: torch.zeros((d,), dtype=dtype, device=dev)
    params: dict = {"embed": draw(0.02, cfg.vocab, d), "final_norm": zeros()}
    if not cfg.tie_embeddings:
        params["lm_head"] = draw(d ** -0.5, d, cfg.vocab)
    params["prefix"] = [init_layer(generator, cfg, specs[i], dtype, dev)
                        for i in range(prefix_n)]
    params["pattern"] = [init_layer(generator, cfg, spec, dtype, dev,
                                    lead=(n_steps,)) for spec in pattern]
    if cfg.enc_dec:
        params["encoder"] = init_layer(generator, cfg, ENC_SPEC, dtype, dev,
                                       lead=(cfg.n_enc_layers,))
        params["enc_norm"] = zeros()
        # conv frontend stub: precomputed frame embeddings; one projection
        # stands in for the conv stack
        params["frame_proj"] = draw(d ** -0.5, d, d)
    if cfg.cross_attn_every:
        # modality stub: image patch embeddings arrive precomputed
        params["img_proj"] = draw(d ** -0.5, d, d)
    if cfg.mtp:
        params["mtp_layer"] = init_layer(generator, cfg, MTP_SPEC, dtype, dev)
        params["mtp_norm"] = zeros()
        params["mtp_proj"] = draw((2 * d) ** -0.5, 2 * d, d)
    return params


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def encode_context(params, cfg: ArchConfig, context):
    """Modality frontend stub: frame embeddings through ``frame_proj`` and
    the encoder stack (non-causal, rope applied as the reference's
    ``attention_qkv`` applies it), or patch embeddings through
    ``img_proj``; None stays None."""
    if context is None:
        return None
    ctx = context.to(L.dt(cfg))
    if cfg.enc_dec:
        x = ctx @ params["frame_proj"]
        pos = torch.arange(x.shape[1], device=x.device)
        for layer_p in unstack(params["encoder"], cfg.n_enc_layers):
            x, _ = apply_layer(layer_p, x, cfg, ENC_SPEC, pos, causal=False)
        return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)
    if cfg.cross_attn_every:
        return ctx @ params["img_proj"]
    return ctx


def logits_head(params, cfg: ArchConfig, x):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head


def final_softcap(cfg: ArchConfig, logits):
    """cap * tanh(logits / cap): tanh in fp32, the product in logits' dtype
    (the reference's order).  In place on fresh copies (serving's logits
    are large); the product on a copy of the tanh, which autograd keeps."""
    if cfg.final_softcap <= 0:
        return logits
    t = logits.to(torch.float32, copy=True).div_(cfg.final_softcap).tanh_()
    return t.to(logits.dtype, copy=True).mul_(cfg.final_softcap)


def embed(params, tokens):
    """The token embeddings: a gather whose backward (training) sums the
    rows of repeated tokens in a fixed order on the card as well."""
    return F.embedding(tokens, params["embed"])


# ---------------------------------------------------------------------------
# Over a process mesh (sharding.MeshRun)
# ---------------------------------------------------------------------------

def _vocab_tp(cfg: ArchConfig, run) -> bool:
    return cfg.vocab >= run.mp and cfg.vocab % run.mp == 0


def embed_mesh(params, cfg: ArchConfig, tokens, run, like):
    """The embedding over a mesh, vocabulary-parallel where "model"
    divides the vocabulary: each process looks up the tokens of its rows
    of the table (zeros for the others), and the partial sums are
    reduce-scattered to the placements ``like``.  ``tokens`` a DTensor."""
    tp = _vocab_tp(cfg, run)
    w = run.weight(params["embed"], tp, tp)
    tok = tokens.to_local()
    if not tp:
        return run.out(F.embedding(tok, w), False, like)
    idx = tok - run.mi * w.shape[0]
    ok = (idx >= 0) & (idx < w.shape[0])
    e = F.embedding(idx.clamp(0, w.shape[0] - 1), w)
    return run.out(torch.where(ok[..., None], e, e.new_zeros(())), True,
                   like)


def head_mesh(params, cfg: ArchConfig, x, run, softcap: bool = True):
    """The LM head over a mesh: the normed stream ``x`` (a DTensor)
    gathered, times this process's vocabulary columns; the logits (soft
    capped with ``softcap``) as a DTensor under the reference's
    ``logits_constraint`` (batch over "data", vocabulary over "model")."""
    dt = S.dt_api()
    tp = _vocab_tp(cfg, run)
    xl = run.act(x, tp)
    w = run.weight(params["embed"] if cfg.tie_embeddings
                   else params["lm_head"], tp, tp)
    logits = xl @ (w.T if cfg.tie_embeddings else w)
    if softcap:
        logits = final_softcap(cfg, logits)
    return S.from_local(logits, run.mesh,
                        (run.bp, dt.Shard(2) if tp else dt.Replicate()))


def _zero_aux(run):
    """A layer's aux loss without MoE over a mesh: 0, replicated."""
    dt = S.dt_api()
    return S.from_local(torch.zeros((), dtype=torch.float32,
                                    device=run.mesh.device), run.mesh,
                        (dt.Replicate(), dt.Replicate()))


def apply_mixer_mesh(p, h, cfg: ArchConfig, spec: LayerSpec, positions,
                     run, context=None, causal=True):
    """:func:`apply_mixer` over a mesh (``h`` and ``context`` DTensors)."""
    if spec.mixer in L.ATTN_MIXERS:
        return L.attention_mesh(p, h, cfg, spec, positions, run, causal)[0]
    if spec.mixer == "mla":
        return L.mla_mesh(p, h, cfg, spec, positions, run)[0]
    if spec.mixer == "mamba":
        return L.mamba_mesh(p, h, cfg, run)
    if spec.mixer == "rwkv":
        return L.rwkv_mesh(p, h, cfg, run)
    if spec.mixer == "cross":
        if context is None:
            raise ValueError(f"{cfg.name}'s cross-attention layers need a "
                             "context (frame or patch embeddings)")
        return L.cross_mesh(p, h, context, cfg, run)[0]
    raise ValueError(spec.mixer)


def apply_mlp_mesh(p, h, cfg: ArchConfig, spec: LayerSpec, run):
    """:func:`apply_mlp` over a mesh: (out, aux), DTensors."""
    if spec.mlp == "moe":
        return L.moe_mesh(p, h, cfg, run, cfg.act)
    if cfg.family == "ssm":
        return L.cmix_mesh(p, h, cfg, run), _zero_aux(run)
    return L.mlp_mesh(p, h, cfg, run), _zero_aux(run)


def apply_layer_mesh(p, x, cfg: ArchConfig, spec: LayerSpec, positions,
                     run, context=None, causal=True):
    """:func:`apply_layer` over a mesh, ``x`` the residual stream (a
    DTensor; the norms run on its blocks, row by row).  Returns (x, aux)."""
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    x = x + apply_mixer_mesh(p["mixer"], h, cfg, spec, positions, run,
                             context, causal)
    h = L.rms_norm(x, p["norm2"], cfg.norm_eps)
    o, aux = apply_mlp_mesh(p["mlp"], h, cfg, spec, run)
    return x + o, aux


def encode_context_mesh(params, cfg: ArchConfig, context, run,
                        seq_shard: bool = True):
    """:func:`encode_context` over a mesh: ``context`` (B, T, D) a DTensor
    over the batch (the reference's ``context_spec``) or the whole batch
    on every process; the projection on this process's rows, whisper's
    encoder through :func:`apply_layer_mesh` (non-causal) with its stream
    under ``activation_constraint``.  A DTensor, or None."""
    if context is None:
        return None
    dt = S.dt_api()
    ctx = run.batch(context).to(L.dt(cfg))
    if not (cfg.enc_dec or cfg.cross_attn_every):
        return ctx
    w = run.weight(params["frame_proj" if cfg.enc_dec else "img_proj"],
                   False, False)
    x = S.from_local(run.act(ctx, False) @ w, run.mesh,
                     (run.bp, dt.Replicate()))
    if not cfg.enc_dec:
        return x
    pos = torch.arange(x.shape[1], device=run.mesh.device)
    x = S.activation_constraint(x, run.mesh, seq_shard)
    for layer_p in unstack(params["encoder"], cfg.n_enc_layers):
        x, _ = apply_layer_mesh(layer_p, x, cfg, ENC_SPEC, pos, run,
                                causal=False)
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _forward_mesh(params, cfg: ArchConfig, tokens, context, remat: str,
                  mesh, seq_shard: bool):
    """(logits, hidden, aux) over ``mesh``."""
    prefix_n, n_steps, pattern = cfg.scan_pattern()
    specs = cfg.layer_specs()
    run = S.MeshRun(mesh, tokens.shape[0])
    tokens = run.batch(tokens)
    positions = torch.arange(tokens.shape[1], device=mesh.device)
    dt = S.dt_api()
    x = embed_mesh(params, cfg, tokens, run, (run.bp, dt.Replicate()))
    ctx = encode_context_mesh(params, cfg, context, run, seq_shard)
    x = S.activation_constraint(x, mesh, seq_shard)

    def run_layers(layer_ps, layer_specs, h, aux_acc):
        for layer_p, spec in zip(layer_ps, layer_specs):
            h, aux = apply_layer_mesh(layer_p, h, cfg, spec, positions, run,
                                      ctx)
            aux_acc = aux_acc + aux
        return h, aux_acc

    def block(layer_ps, layer_specs, h, aux_acc):
        if remat == "full":
            return checkpoint(run_layers, layer_ps, layer_specs, h, aux_acc,
                              use_reentrant=False, preserve_rng_state=False)
        return run_layers(layer_ps, layer_specs, h, aux_acc)

    aux = _zero_aux(run)
    for i in range(prefix_n):
        x, aux = block([params["prefix"][i]], [specs[i]], x, aux)
    steps = [unstack(p, n_steps) for p in params["pattern"]]
    for st in range(n_steps):
        x, aux = block([steps[j][st] for j in range(len(pattern))], pattern,
                       x, aux)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return head_mesh(params, cfg, x, run), x, aux


def forward(params, cfg: ArchConfig, tokens, context=None,
            return_hidden: bool = False, remat: str = "none", mesh=None,
            seq_shard: bool = True):
    """tokens (B, S) -> (logits (B, S, V), aux_loss), the MoE layers' aux
    losses summed; ``context``: frame or patch embeddings (B, T, D); with
    ``return_hidden`` also the final normed hidden states.

    ``remat="full"`` recomputes each prefix layer and each pattern period
    (one step of the stacked layers) in the backward instead of keeping
    its activations (``torch.utils.checkpoint``, non-reentrant): only the
    residual stream between them is saved, the reference's policy.  The
    recomputation repeats the forward's operations, so loss and gradients
    are the same bits as with ``remat="none"``.

    Over an ``LMMesh``: ``params`` DTensors, ``tokens`` and ``context``
    DTensors or the whole batch on every process; the logits (batch over
    "data", vocabulary over "model"), the hidden states (the residual
    stream's placements) and the aux loss (replicated) DTensors;
    ``seq_shard`` (``TrainHParams.seq_shard_activations``) shards the
    residual stream's sequence over "model" between layers."""
    mesh = S.executing_mesh(mesh, "forward")
    if remat not in ("none", "full"):
        raise ValueError(f"remat is 'none' or 'full', not {remat!r}")
    if mesh is not None:
        logits, x, aux = _forward_mesh(params, cfg, tokens, context, remat,
                                       mesh, seq_shard)
        return (logits, x, aux) if return_hidden else (logits, aux)
    prefix_n, n_steps, pattern = cfg.scan_pattern()
    specs = cfg.layer_specs()
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)
    x = embed(params, tokens)
    ctx = encode_context(params, cfg, context)

    def run_layers(layer_ps, layer_specs, h, aux_acc):
        for layer_p, spec in zip(layer_ps, layer_specs):
            h, aux = apply_layer(layer_p, h, cfg, spec, positions,
                                 context=ctx)
            aux_acc = aux_acc + aux
        return h, aux_acc

    def run(layer_ps, layer_specs, h, aux_acc):
        if remat == "full":
            # the forward draws nothing at random: no RNG state to keep
            return checkpoint(run_layers, layer_ps, layer_specs, h, aux_acc,
                              use_reentrant=False, preserve_rng_state=False)
        return run_layers(layer_ps, layer_specs, h, aux_acc)

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(prefix_n):
        x, aux_total = run([params["prefix"][i]], [specs[i]], x, aux_total)
    steps = [unstack(p, n_steps) for p in params["pattern"]]
    for st in range(n_steps):
        x, aux_total = run([steps[j][st] for j in range(len(pattern))],
                           pattern, x, aux_total)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = final_softcap(cfg, logits_head(params, cfg, x))
    if return_hidden:
        return logits, x, aux_total
    return logits, aux_total


def mtp_logits(params, cfg: ArchConfig, hidden, tokens):
    """DeepSeek MTP: one extra layer predicting token t+2 from
    [h_t ; emb(token_{t+1})] (single-depth MTP, as in the paper); the
    caller shifts ``tokens``."""
    emb_next = embed(params, tokens)
    h = torch.cat([hidden, emb_next], -1) @ params["mtp_proj"]
    h, _ = apply_layer(params["mtp_layer"], h, cfg, MTP_SPEC,
                       torch.arange(h.shape[1], device=h.device))
    h = L.rms_norm(h, params["mtp_norm"], cfg.norm_eps)
    return logits_head(params, cfg, h)


def mtp_logits_mesh(params, cfg: ArchConfig, hidden, tokens, mesh):
    """:func:`mtp_logits` over a mesh: ``hidden`` the final normed stream
    and ``tokens`` the batch's (DTensors, or the whole batch), shifted
    here (``hidden[:, :-1]``, ``tokens[:, 1:]``); the projection on this
    process's rows, the MTP layer through :func:`apply_layer_mesh`, the
    logits (not soft-capped) a DTensor as :func:`head_mesh` makes them."""
    dt = S.dt_api()
    run = S.MeshRun(mesh, hidden.shape[0])
    rows = (run.bp, dt.Replicate())
    tok = S.from_local(run.batch(tokens).to_local()[:, 1:], mesh, rows)
    emb = run.act(embed_mesh(params, cfg, tok, run, rows), False)
    h = torch.cat([run.act(hidden, False)[:, :-1], emb], -1)
    h = S.from_local(h @ run.weight(params["mtp_proj"], False, False), mesh,
                     rows)
    h, _ = apply_layer_mesh(params["mtp_layer"], h, cfg, MTP_SPEC,
                            torch.arange(h.shape[1], device=mesh.device),
                            run)
    h = L.rms_norm(h, params["mtp_norm"], cfg.norm_eps)
    return head_mesh(params, cfg, h, run, softcap=False)
