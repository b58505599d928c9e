"""LM training step (``repro/lm/train_lib.py``): loss, remat, gradient
clipping, optimizer.

``make_train_step`` builds the step the launcher (``launch/train.py``)
runs: the loss through ``model.forward`` (with ``TrainHParams.remat``), the
gradient by ``torch.autograd.grad`` over the parameter leaves, then the
port's ``optim``: ``clip_by_global_norm``, the optimizer's update and
``apply_updates``.  The attention's gradient comes from
``kernels.ops.FlashAttention`` (the flash kernel's forward with its row
log-sum-exp on the card, a plain chunked backward).  Nothing in a step
reads a value back to the host.

One card: no mesh.  The reference's sharding helpers
(``abstract_train_state``, ``opt_state_shardings``, ``batch_specs``,
``context_spec``) decide nothing a single-card step reads and wait for the
multi-card work (ROADMAP Queue 1 item 13, ``lm/sharding.py``);
``abstract_params`` is kept (the parameter tree on the ``meta`` device).
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ArchConfig
from ..optim import adam, adam8bit, adamw, apply_updates, clip_by_global_norm
from ..optim.adam import tree_leaves, tree_map
from . import layers as L
from . import model as M


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    """The reference's fields and defaults.  ``seq_shard_activations``
    constrains the residual stream's sharding over a mesh in the
    reference; on one card it has no effect."""
    lr: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    aux_loss_coef: float = 0.01      # MoE load balance
    mtp_coef: float = 0.3            # deepseek MTP
    z_loss: float = 1e-4
    optimizer: str = "adam"          # adam | adamw | adam8bit
    remat: str = "full"              # full | none
    seq_shard_activations: bool = True


def make_optimizer(hp: TrainHParams):
    if hp.optimizer == "adam8bit":
        return adam8bit(hp.lr, weight_decay=hp.weight_decay)
    if hp.optimizer == "adamw":
        return adamw(hp.lr, weight_decay=hp.weight_decay)
    return adam(hp.lr)


def cross_entropy(logits, labels, z_loss: float = 0.0):
    """Token CE with an fp32 logsumexp; ignores labels < 0."""
    logits32 = logits.to(torch.float32)
    lse = torch.logsumexp(logits32, dim=-1)
    gold = logits32.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    ce = lse - gold
    if z_loss:
        ce = ce + z_loss * lse ** 2
    valid = (labels >= 0).to(torch.float32)
    return (ce * valid).sum() / valid.sum().clamp_min(1.0)


def make_loss_fn(cfg: ArchConfig, hp: TrainHParams):
    """loss_fn(params, batch) -> (loss, metrics): the CE (with z-loss), plus
    ``aux_loss_coef`` x the MoE aux loss when ``cfg.n_experts``, plus
    ``mtp_coef`` x the MTP head's CE (predicting t + 2 from ``hidden[:, :-1]``
    and ``tokens[:, 1:]``, no z-loss) when ``cfg.mtp``."""
    def loss_fn(params, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        out = M.forward(params, cfg, tokens, batch.get("context"),
                        return_hidden=bool(cfg.mtp), remat=hp.remat)
        logits, aux = out[0], out[-1]
        loss = cross_entropy(logits, labels, hp.z_loss)
        metrics = {"ce": loss}
        if cfg.n_experts:
            loss = loss + hp.aux_loss_coef * aux
            metrics["aux"] = aux
        if cfg.mtp:
            hidden = out[1]
            mtp_logits = M.mtp_logits(params, cfg, hidden[:, :-1],
                                      tokens[:, 1:])
            mtp_loss = cross_entropy(mtp_logits, labels[:, 1:])
            loss = loss + hp.mtp_coef * mtp_loss
            metrics["mtp"] = mtp_loss
        return loss, metrics

    return loss_fn


def make_train_step(cfg: ArchConfig, hp: TrainHParams, mesh=None):
    """Returns (train_step, opt): train_step(params, opt_state, batch) ->
    (params, opt_state, metrics), metrics holding ``ce`` (and ``aux``,
    ``mtp`` where the architecture has them), ``loss`` and ``grad_norm``
    (before clipping), all 0-d tensors on the parameters' device."""
    if mesh is not None:
        raise L.unported("a training mesh")
    opt = make_optimizer(hp)
    loss_fn = make_loss_fn(cfg, hp)

    def train_step(params, opt_state, batch):
        with torch.enable_grad():
            leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
            loss, metrics = loss_fn(leaves, batch)
            flat = tree_leaves(leaves)
            # a leaf the loss does not reach (whisper's unused pieces) gets
            # zeros, as jax.grad gives it
            grads_flat = torch.autograd.grad(loss, flat, allow_unused=True,
                                             materialize_grads=True)
        by_leaf = {id(p): g for p, g in zip(flat, grads_flat)}
        grads = tree_map(lambda p: by_leaf[id(p)], leaves)
        grads, gnorm = clip_by_global_norm(grads, hp.grad_clip)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(loss=loss.detach(), grad_norm=gnorm)
        return params, opt_state, metrics

    return train_step, opt


def abstract_params(cfg: ArchConfig) -> dict:
    """The full parameter tree on the ``meta`` device: shapes and dtypes,
    no storage (the reference's ``jax.eval_shape`` of ``init_params``)."""
    return M.init_params(cfg, torch.Generator(), device="meta")
