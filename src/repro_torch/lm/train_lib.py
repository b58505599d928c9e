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

``mesh``: None or a layout of one device runs the step on one card; a
``("data", "model")`` process mesh (``launch/mesh.py::LMMesh``) runs it
over DTensors laid out by ``lm/sharding.py``'s specs (parameters,
optimizer state and batch: ``distribute_params``,
``distribute_opt_state``, ``distribute_batch``) for every registry
architecture with ``adam`` or ``adamw`` (``adam8bit`` over one process
only), the MoE aux loss and the MTP term included: each gradient is
brought to its parameter's placements (the ZeRO reduce-scatter over
"data") before the global norm, which sums over the shards, and the
update.  The reference's sharding helpers
(``abstract_params``, ``abstract_train_state``, ``opt_state_shardings``,
``batch_specs``, ``context_spec``) give the training state and batch on the
``meta`` device with their spec trees for any layout: the dry run's
accounting (``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ArchConfig
from ..optim import adam, adam8bit, adamw, apply_updates, clip_by_global_norm
from ..optim.adam import tree_leaves, tree_map
from . import layers as L
from . import model as M
from . import sharding as S


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    """The reference's fields and defaults.  ``seq_shard_activations``:
    over a process mesh the residual stream's sequence is sharded over
    "model" between layers (the reference's ``activation_constraint``);
    without a mesh it has no effect."""
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


def _ce_sums(logits, labels, z_loss: float):
    """(sum of the valid tokens' CE, their count), fp32 0-d."""
    logits32 = logits.to(torch.float32)
    lse = torch.logsumexp(logits32, dim=-1)
    gold = logits32.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    ce = lse - gold
    if z_loss:
        ce = ce + z_loss * lse ** 2
    valid = (labels >= 0).to(torch.float32)
    return (ce * valid).sum(), valid.sum()


def cross_entropy(logits, labels, z_loss: float = 0.0):
    """Token CE with an fp32 logsumexp; ignores labels < 0.  Logits that
    are a DTensor (over a process mesh) are gathered along the vocabulary
    on each process's batch rows; the sums are reduced over "data", so the
    loss is a replicated 0-d DTensor."""
    if not S.is_dtensor(logits):
        total, n = _ce_sums(logits, labels, z_loss)
        return total / n.clamp_min(1.0)
    dt = S.dt_api()
    dm, bp = logits.device_mesh, logits.placements[0]
    local = logits.redistribute(dm, (bp, dt.Replicate())).to_local(
        grad_placements=(bp, dt.Replicate()))
    lab = labels.to_local() if S.is_dtensor(labels) else labels
    part = dt.Partial() if isinstance(bp, dt.Shard) else dt.Replicate()
    total, n = (dt.DTensor.from_local(t, dm, (part, dt.Replicate()),
                                      run_check=False).redistribute(
        dm, (dt.Replicate(), dt.Replicate()))
        for t in _ce_sums(local, lab, z_loss))
    return total / n.clamp_min(1.0)


def make_loss_fn(cfg: ArchConfig, hp: TrainHParams, mesh=None):
    """loss_fn(params, batch) -> (loss, metrics): the CE (with z-loss), plus
    ``aux_loss_coef`` x the MoE aux loss when ``cfg.n_experts``, plus
    ``mtp_coef`` x the MTP head's CE (predicting t + 2 from ``hidden[:, :-1]``
    and ``tokens[:, 1:]``, no z-loss) when ``cfg.mtp``.  Over an ``LMMesh``
    the batch is distributed first where it is not yet."""
    mesh = S.executing_mesh(mesh, "training")

    def loss_fn(params, batch):
        if mesh is not None:
            batch = S.distribute_batch(batch, mesh)
        tokens, labels = batch["tokens"], batch["labels"]
        out = M.forward(params, cfg, tokens, batch.get("context"),
                        return_hidden=bool(cfg.mtp), remat=hp.remat,
                        mesh=mesh, seq_shard=hp.seq_shard_activations)
        logits, aux = out[0], out[-1]
        loss = cross_entropy(logits, labels, hp.z_loss)
        metrics = {"ce": loss}
        if cfg.n_experts:
            loss = loss + hp.aux_loss_coef * aux
            metrics["aux"] = aux
        if cfg.mtp:
            hidden = out[1]
            if mesh is None:
                mtp_logits = M.mtp_logits(params, cfg, hidden[:, :-1],
                                          tokens[:, 1:])
            else:
                mtp_logits = M.mtp_logits_mesh(params, cfg, hidden, tokens,
                                               mesh)
                labels = labels.to_local()
            mtp_loss = cross_entropy(mtp_logits, labels[:, 1:])
            loss = loss + hp.mtp_coef * mtp_loss
            metrics["mtp"] = mtp_loss
        return loss, metrics

    return loss_fn


def make_train_step(cfg: ArchConfig, hp: TrainHParams, mesh=None):
    """Returns (train_step, opt): train_step(params, opt_state, batch) ->
    (params, opt_state, metrics), metrics holding ``ce`` (and ``aux``,
    ``mtp`` where the architecture has them), ``loss`` and ``grad_norm``
    (before clipping), all 0-d tensors on the parameters' device.
    ``mesh``: None or a layout of one device, run as no mesh; an
    ``LMMesh``: ``params``, ``opt_state`` and the returned ones are
    DTensors laid out by the specs, the metrics replicated 0-d DTensors
    (the same bits on every process)."""
    mesh = S.executing_mesh(mesh, "training")
    opt = make_optimizer(hp)
    loss_fn = make_loss_fn(cfg, hp, mesh)

    def train_step(params, opt_state, batch):
        with torch.enable_grad():
            leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
            loss, metrics = loss_fn(leaves, batch)
            flat = tree_leaves(leaves)
            # a leaf the loss does not reach (whisper's unused pieces) gets
            # zeros, as jax.grad gives it
            grads_flat = torch.autograd.grad(loss, flat, allow_unused=True,
                                             materialize_grads=True)
        if mesh is not None:
            # each gradient in its parameter's placements: the partial sums
            # over "data" reduce-scattered (ZeRO), whatever layout the
            # backward left them in
            grads_flat = [g.redistribute(p.device_mesh, p.placements)
                          for g, p in zip(grads_flat, flat)]
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


def abstract_train_state(cfg: ArchConfig, hp: TrainHParams, mesh):
    """((params, opt_state), (param_specs, opt_specs)): the training state
    on the ``meta`` device and its spec trees over ``mesh``."""
    params = abstract_params(cfg)
    opt_state = make_optimizer(hp).init(params)
    p_specs = S.params_shardings(params, mesh)
    return (params, opt_state), (p_specs,
                                 opt_state_shardings(opt_state, p_specs, mesh))


def opt_state_shardings(opt_state, param_specs, mesh):
    """The optimizer state's spec tree: a slot whose path ends in a
    parameter's path takes that parameter's spec (Adam's m and v, and
    adam8bit's bf16 ``v16``); adam8bit's int8 blocks ``q`` and their scales
    ``s`` put their leading (block) dim over the fsdp axis where it
    divides; everything else (``count``, small fp32 slots) is
    replicated."""
    p_by_path = {tuple(path.split("/")): spec
                 for path, spec in S.leaves_with_paths(param_specs)}

    def assign(path, leaf):
        key = tuple(path.split("/"))
        for start in range(len(key)):
            if key[start:] in p_by_path:
                return p_by_path[key[start:]]
        if key[-1] == "v16":
            for start in range(len(key)):
                if key[start:-1] in p_by_path:
                    return p_by_path[key[start:-1]]
        if key[-1] in ("q", "s"):
            for start in range(len(key)):
                if key[start:-1] in p_by_path:
                    n = mesh.shape.get(S.FSDP, 0)
                    ax = S.FSDP if (n and leaf.shape[0] >= n
                                    and leaf.shape[0] % n == 0) else None
                    return S.P(ax, *([None] * (leaf.dim() - 1)))
        return S.P()

    return S.map_with_paths(assign, opt_state)


def batch_specs(cfg: ArchConfig, seq: int, global_batch: int, mesh,
                with_context: bool = True):
    """(batch, specs): a training batch on the ``meta`` device (int32
    ``tokens`` and ``labels`` (B, S), as ``launch/train.py`` makes them, and
    the context stub's input where the architecture has one) and its specs
    (the batch dim over the data-parallel axes)."""
    dp = S.batch_spec(mesh)
    tok = torch.empty((global_batch, seq), dtype=torch.int32, device="meta")
    batch = {"tokens": tok, "labels": tok}
    specs = {"tokens": dp, "labels": dp}
    ctx = context_spec(cfg, global_batch, mesh)
    if ctx is not None and with_context:
        batch["context"], specs["context"] = ctx
    return batch, specs


def context_spec(cfg: ArchConfig, global_batch: int, mesh):
    """The modality stub's input, precomputed frame or patch embeddings
    (B, T, D) in ``cfg.dtype`` on the ``meta`` device, with its spec; None
    for an architecture without one."""
    if not (cfg.enc_dec or cfg.cross_attn_every):
        return None
    dp = S.batch_spec(mesh)
    t = cfg.n_audio_frames if cfg.enc_dec else cfg.n_image_tokens
    ctx = torch.empty((global_batch, t, cfg.d_model), dtype=L.dt(cfg),
                      device="meta")
    return ctx, S.P(dp[0] if dp else None, None, None)
