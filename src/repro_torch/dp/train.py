"""Deep Potential training: DeePMD-style energy+force loss, Adam, RMSE logs.

Port of ``repro/dp/train.py``: the paper's training pipeline (Sec. IV-B /
Fig. 7), with force RMSE tracked against train and validation sets,
exponential learning-rate decay, and the prefactor schedule that shifts the
loss's weight from forces to energies as training proceeds.

Force matching differentiates F = -dE/dr to the parameters, a second
derivative, so the loss runs the model's training route
(``second_order=True``: the reference's jnp descriptor under autograd; the
neighbour gather and its force scatter serve both orders).  The
evaluation, :func:`force_rmse`, is a first-order force call on the kernel
route.  The reference's per-frame ``vmap`` becomes one flattened buffer of
B*N atoms with offset neighbour indices
(``DPModel.energy_and_forces_batched``).  Batches, checkpoints and the
history follow the reference step for step: the batch order is numpy's
permutation seeded by (seed, epoch), a checkpoint holds ``{"params",
"opt"}`` under JAX's key strings, and a run restored from one continues
with the batches the uninterrupted run would have taken.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..ckpt import AsyncCheckpointer
from ..data.synthetic import Dataset, frame_neighbor_lists
from ..device import resolve_device
from ..optim import adam, apply_updates, deepmd_prefactors, exponential_decay
from ..optim.adam import tree_leaves, tree_map
from .common import EnvStats, compute_env_stats, env_matrix
from .model import DPConfig, DPModel

EVAL_CHUNK = 16   # frames per force call in force_rmse


@dataclasses.dataclass
class TrainConfig:
    lr0: float = 1e-3
    decay_steps: int = 500
    decay_rate: float = 0.95
    batch_size: int = 8
    n_steps: int = 2000
    eval_every: int = 100
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 500
    seed: int = 0


def _flat_lists(idx: torch.Tensor, mask: torch.Tensor):
    """(F, N, K) per-frame lists -> one (F*N, K) list over the frames laid
    end to end (indices offset by N per frame, -1 kept)."""
    f, n, k = idx.shape
    off = (torch.arange(f, device=idx.device, dtype=idx.dtype) * n)[:, None, None]
    return (torch.where(idx >= 0, idx + off, idx).reshape(f * n, k),
            mask.reshape(f * n, k))


def fit_env_stats(model_cfg: DPConfig, data: Dataset, n_sample: int = 32,
                  device="cuda") -> EnvStats:
    """Per-type env-matrix statistics over the first ``n_sample`` frames."""
    dev = resolve_device(device)
    d = model_cfg.descriptor
    coords = torch.as_tensor(data.coords[:n_sample], device=dev)
    types = torch.as_tensor(data.types[:n_sample], device=dev)
    idx, mask = frame_neighbor_lists(coords, d.rcut, d.sel)
    f, n, k = idx.shape
    R, *_ = env_matrix(coords.reshape(f * n, 3), None,
                       *_flat_lists(idx, mask), d.rcut_smth, d.rcut)
    return compute_env_stats(R.reshape(f, n, k, 4), types, mask, d.ntypes)


def fit_energy_bias(data: Dataset, ntypes: int) -> np.ndarray:
    """Least-squares per-species energy bias (DeePMD ``bias_atom_e``)."""
    counts = np.stack([(data.types == t).sum(1) for t in range(ntypes)], -1)
    bias, *_ = np.linalg.lstsq(counts.astype(np.float64),
                               data.energies.astype(np.float64), rcond=None)
    return bias.astype(np.float32)


def make_loss_fn(model: DPModel):
    """loss(params, batch, pref_e, pref_f) -> (loss, (l_e, l_f)): the mean
    over frames of ((E - E_ref)/N)^2 and of the per-frame mean squared
    force error, weighted by the prefactors; differentiable to the
    parameters through the forces (the training route)."""

    def loss_fn(params, batch, pref_e, pref_f):
        coords = batch["coords"]
        b, n = coords.shape[:2]
        local = torch.ones((b, n), dtype=coords.dtype, device=coords.device)
        e, f = model.energy_and_forces_batched(
            params, coords, batch["types"], batch["nbr_idx"],
            batch["nbr_mask"], local, box=None, second_order=True)
        de2 = ((e - batch["energies"]) / n) ** 2
        df2 = ((f - batch["forces"]) ** 2).mean((1, 2))
        l_e = de2.mean()
        l_f = df2.mean()
        return pref_e * l_e + pref_f * l_f, (l_e, l_f)

    return loss_fn


def prepare_batches(data: Dataset, rcut: float, sel: int, device="cuda"):
    """The dataset as tensors on ``device`` with each frame's neighbour list
    built once (the oracle's jitter is small enough that a rebuild per
    epoch is unnecessary)."""
    dev = resolve_device(device)
    coords = torch.as_tensor(data.coords, device=dev)
    idx, mask = frame_neighbor_lists(coords, rcut, sel)
    return {"coords": coords, "types": torch.as_tensor(data.types, device=dev),
            "nbr_idx": idx, "nbr_mask": mask,
            "energies": torch.as_tensor(data.energies, device=dev),
            "forces": torch.as_tensor(data.forces, device=dev)}


def force_rmse(model: DPModel, params, arrays, max_frames: int = 64) -> float:
    """Force RMSE over the first ``max_frames`` frames of ``arrays``
    (:func:`prepare_batches`), in force calls of ``EVAL_CHUNK`` frames on
    the kernel route (first order)."""
    n = min(max_frames, len(arrays["energies"]))
    f_err = 0.0
    count = 0
    for k in range(0, n, EVAL_CHUNK):
        sl = slice(k, min(k + EVAL_CHUNK, n))
        c = arrays["coords"][sl]
        _, f = model.energy_and_forces_batched(
            params, c, arrays["types"][sl], arrays["nbr_idx"][sl],
            arrays["nbr_mask"][sl], torch.ones(c.shape[:2], dtype=c.dtype,
                                               device=c.device))
        f_err += float(((f - arrays["forces"][sl]) ** 2).sum())
        count += f.numel()
    return float(np.sqrt(f_err / count))


def batch_indices(cfg: TrainConfig, n_frames: int, step: int) -> np.ndarray:
    """The frames of step ``step``: a permutation seeded by (seed, epoch),
    so a restored run takes the uninterrupted run's batches."""
    epoch = (step * cfg.batch_size) // n_frames
    perm = np.random.default_rng((cfg.seed, epoch)).permutation(n_frames)
    lo = (step * cfg.batch_size) % max(n_frames - cfg.batch_size + 1, 1)
    sel_idx = perm[lo: lo + cfg.batch_size]
    if len(sel_idx) < cfg.batch_size:
        sel_idx = perm[: cfg.batch_size]
    return sel_idx


def select_batch(arrays, cfg: TrainConfig, step: int) -> dict:
    """Step ``step``'s batch of ``arrays`` (:func:`prepare_batches`), taken
    on their device."""
    sel = torch.as_tensor(batch_indices(cfg, len(arrays["energies"]), step),
                          device=arrays["energies"].device)
    return {k: v[sel] for k, v in arrays.items()}


def make_train_step(model: DPModel, cfg: TrainConfig, lr_fn, opt):
    """step(params, opt_state, batch, step) -> (params, opt_state, loss,
    l_e, l_f, grads): one Adam step on the loss at the prefactors of the
    step's learning-rate ratio.  ``step`` is an int32 0-d tensor on the
    parameters' device; nothing is read back to the host."""
    pref_fn = deepmd_prefactors()
    loss_fn = make_loss_fn(model)

    def train_step(params, opt_state, batch, step):
        lr_ratio = lr_fn(step) / cfg.lr0
        pref_e, pref_f = pref_fn(lr_ratio)
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves = tree_leaves(live)
        loss, (l_e, l_f) = loss_fn(live, batch, pref_e, pref_f)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
        by_leaf = {id(p): torch.zeros_like(p) if g is None else g
                   for p, g in zip(leaves, got)}
        grads = tree_map(lambda p: by_leaf[id(p)], live)
        with torch.no_grad():
            updates, opt_state = opt.update(grads, opt_state, params)
            params = apply_updates(params, updates)
        return params, opt_state, loss.detach(), l_e.detach(), l_f.detach(), grads

    return train_step


def train(model: DPModel, train_data: Dataset, valid_data: Dataset,
          cfg: TrainConfig, log: Optional[Callable[[dict], None]] = None):
    """Returns (params, history).  Restores from ``cfg.checkpoint_dir`` if
    it holds a checkpoint.  Runs on the model's device; the parameters
    start from ``model.init_params`` seeded ``cfg.seed``, with the energy
    bias fitted to the training set's composition."""
    d = model.cfg.descriptor
    dev = model.device
    arrays_tr = prepare_batches(train_data, d.rcut, d.sel, dev)
    arrays_va = prepare_batches(valid_data, d.rcut, d.sel, dev)

    params = model.init_params(torch.Generator().manual_seed(cfg.seed))
    params["bias"] = torch.as_tensor(
        fit_energy_bias(train_data, model.cfg.ntypes), device=dev)

    lr_fn = exponential_decay(cfg.lr0, cfg.decay_steps, cfg.decay_rate)
    opt = adam(lr_fn)
    opt_state = opt.init(params)
    train_step = make_train_step(model, cfg, lr_fn, opt)

    ckpt = AsyncCheckpointer(cfg.checkpoint_dir) if cfg.checkpoint_dir else None
    start_step = 0
    if ckpt is not None:
        restored, step = ckpt.restore_latest({"params": params, "opt": opt_state})
        if restored is not None:
            params, opt_state = restored["params"], restored["opt"]
            start_step = step + 1

    history = []
    t0 = time.time()
    for step in range(start_step, cfg.n_steps):
        params, opt_state, loss, l_e, l_f, _ = train_step(
            params, opt_state, select_batch(arrays_tr, cfg, step),
            torch.tensor(step, dtype=torch.int32, device=dev))

        if step % cfg.eval_every == 0 or step == cfg.n_steps - 1:
            rec = {
                "step": step,
                "loss": float(loss),
                "rmse_e_per_atom": float(torch.sqrt(l_e)),
                "rmse_f_train": force_rmse(model, params, arrays_tr, 32),
                "rmse_f_valid": force_rmse(model, params, arrays_va, 32),
                "lr": float(lr_fn(step)),
                "wall_s": time.time() - t0,
            }
            history.append(rec)
            if log:
                log(rec)
        if ckpt is not None and step and step % cfg.checkpoint_every == 0:
            ckpt.save({"params": params, "opt": opt_state}, step)
    if ckpt is not None:
        ckpt.save({"params": params, "opt": opt_state}, cfg.n_steps - 1)
        ckpt.wait()
    return params, history
