"""Model assembly from an ArchConfig (``repro/lm/model.py``).

The parameter tree keeps the JAX layout: ``embed``, ``final_norm``
(``lm_head`` when the embeddings are not tied), ``prefix`` as a list of
per-layer dicts, and ``pattern`` as a list (one entry per position of the
repeating pattern, ``ArchConfig.scan_pattern``) of dicts of tensors stacked
along a leading ``(n_steps,)`` axis.  The JAX ``lax.scan`` over pattern
periods is a Python loop that takes step ``s`` of every stacked tensor as a
view.

Not ported: ``remat``, ``mesh`` and ``context`` (``forward`` raises if asked
for them), the encoder and modality stubs and ``mtp_logits``; nor the
mixers and MLPs other than attention and the dense MLP (ROADMAP Queue 1
item 13).
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig, LayerSpec
from ..device import resolve_device
from . import layers as L


def _check_supported(cfg: ArchConfig, spec: LayerSpec) -> None:
    if spec.mixer not in L.ATTN_MIXERS:
        raise L.unported(f"the {spec.mixer!r} mixer")
    if spec.mlp != "dense" or cfg.family == "ssm":
        raise L.unported(f"the {spec.mlp!r} channel mixer of {cfg.name}")


def init_layer(generator, cfg: ArchConfig, spec: LayerSpec, dtype, device,
               lead=()) -> dict:
    _check_supported(cfg, spec)
    zeros = torch.zeros((*lead, cfg.d_model), dtype=dtype, device=device)
    return {
        "norm1": zeros,
        "mixer": L.init_attention(generator, cfg, dtype, device, lead),
        "norm2": zeros.clone(),
        "mlp": L.init_mlp(generator, cfg.d_model, cfg.d_ff, dtype, device,
                          lead),
    }


def apply_layer(p, x, cfg: ArchConfig, spec: LayerSpec, positions,
                causal=True):
    """Pre-norm residual block.  Returns (x, aux_loss)."""
    _check_supported(cfg, spec)
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    x = x + L.attention_layer(p["mixer"], h, cfg, spec, positions, causal)
    h = L.rms_norm(x, p["norm2"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + L.mlp_layer(p["mlp"], h, cfg.act), aux


def step_params(stacked: dict, s: int) -> dict:
    """Step ``s`` of a tree of stacked tensors, as views."""
    return {k: step_params(v, s) if isinstance(v, dict) else v[s]
            for k, v in stacked.items()}


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
    times std, zeros for norms and biases) in ``cfg.dtype``.  The numbers
    come from ``generator``, drawn on its device; the stacked pattern
    tensors are drawn whole, one per position."""
    dev = resolve_device(device)
    if cfg.enc_dec or cfg.cross_attn_every or cfg.mtp:
        raise L.unported(f"the encoder/modality/MTP parts of {cfg.name}")
    dtype = L.dt(cfg)
    prefix_n, n_steps, pattern = cfg.scan_pattern()
    specs = cfg.layer_specs()
    for spec in specs:
        _check_supported(cfg, spec)
    params: dict = {
        "embed": L.normal(generator, (cfg.vocab, cfg.d_model), 0.02, dtype,
                          dev),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.normal(generator, (cfg.d_model, cfg.vocab),
                                     cfg.d_model ** -0.5, dtype, dev)
    params["prefix"] = [init_layer(generator, cfg, specs[i], dtype, dev)
                        for i in range(prefix_n)]
    params["pattern"] = [init_layer(generator, cfg, spec, dtype, dev,
                                    lead=(n_steps,)) for spec in pattern]
    return params


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------

def logits_head(params, cfg: ArchConfig, x):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head


def final_softcap(cfg: ArchConfig, logits):
    """cap * tanh(logits / cap): tanh in fp32, the product in logits' dtype
    (the reference's order)."""
    if cfg.final_softcap <= 0:
        return logits
    t = logits.to(torch.float32, copy=True).div_(cfg.final_softcap).tanh_()
    return t.to(logits.dtype).mul_(cfg.final_softcap)


def forward(params, cfg: ArchConfig, tokens, context=None,
            return_hidden: bool = False, remat: str = "none", mesh=None):
    """tokens (B, S) -> (logits (B, S, V), aux_loss); with
    ``return_hidden`` also the final normed hidden states."""
    if context is not None or remat != "none" or mesh is not None:
        raise L.unported("forward with context, remat or mesh")
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)
    x = params["embed"][tokens]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer_p, spec in layers_in_order(params, cfg):
        x, aux = apply_layer(layer_p, x, cfg, spec, positions)
        aux_total = aux_total + aux
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = final_softcap(cfg, logits_head(params, cfg, x))
    if return_hidden:
        return logits, x, aux_total
    return logits, aux_total
