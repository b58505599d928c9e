"""Single-domain DP inference (port of the single-device part of
``repro/core/ddinfer.py``; the virtual domain decomposition comes later).

The reference path: one domain, PBC minimum image, the brute-force full
neighbour list, forces by autograd.  With a skin the work splits into an
assembly (a skin-widened list) and evaluations that re-filter that list to
the exact cutoff at the current positions.
"""
from __future__ import annotations

import torch

from ..dp.model import DPModel
from ..md.neighbors import (NeighborList, brute_force_neighbor_list,
                            dense_scan, minimum_image)


def masked_neighbor_list(coords: torch.Tensor, box: torch.Tensor,
                         rcut: float, k: int, valid: torch.Tensor):
    """Validity-masked brute-force full list (PBC minimum image): the
    brute-force construction, except atoms with ``valid == 0`` are neither
    centres nor candidates.  Returns (idx (N, K) int32, mask (N, K) {0, 1},
    overflow () bool)."""
    idx, take, overflow = dense_scan(coords, box, rcut ** 2, k, valid=valid)
    return idx, take.to(coords.dtype), overflow


def make_padded_batch_fn(model: DPModel, n_max: int, nbr_capacity: int):
    """Bucket evaluator for force serving: f(params, coords (B, n_max, 3),
    types (B, n_max), mask (B, n_max), box (B, 3)) -> (energy (B,),
    forces (B, n_max, 3), overflow (B,) bool).  Each row is one independent
    request padded to ``n_max``; padding atoms take part in nothing."""
    rcut = model.cfg.descriptor.rcut

    def fn(params, coords, types, mask, box):
        if coords.shape[-2] != n_max:
            raise ValueError(f"rows hold {coords.shape[-2]} atoms, bucket "
                             f"is {n_max}")
        es, fs, overs = [], [], []
        for c, t, m, b in zip(coords, types, mask, box):
            idx, nmask, over = masked_neighbor_list(c, b, rcut, nbr_capacity, m)
            e, f = model.energy_and_forces(params, c, t, idx, nmask,
                                           local_mask=m, box=b)
            es.append(e)
            fs.append(f * m[:, None])
            overs.append(over)
        return torch.stack(es), torch.stack(fs), torch.stack(overs)

    return fn


def single_domain_forces_batched(model: DPModel, params, coords, types, box,
                                 nbr_capacity: int):
    """Replica-batched single-domain reference: coords (R, N, 3) ->
    (energy (R,), forces (R, N, 3)) through one batched model call."""
    box = torch.as_tensor(box, dtype=coords.dtype, device=coords.device)
    rcut = model.cfg.descriptor.rcut
    lists = [brute_force_neighbor_list(c, box, rcut, nbr_capacity)
             for c in coords]
    idx = torch.stack([nl.idx for nl in lists])
    mask = torch.stack([nl.mask for nl in lists])
    local = torch.ones(coords.shape[:2], dtype=coords.dtype,
                       device=coords.device)
    return model.energy_and_forces_batched(params, coords, types, idx, mask,
                                           local, box=box)


def single_domain_forces(model: DPModel, params, coords, types, box,
                         nbr_capacity: int):
    """Reference path: one domain, PBC minimum image (stock-NNPot analogue)."""
    box = torch.as_tensor(box, dtype=coords.dtype, device=coords.device)
    nl = brute_force_neighbor_list(coords, box, model.cfg.descriptor.rcut,
                                   nbr_capacity)
    local = torch.ones_like(coords[:, 0])
    return model.energy_and_forces(params, coords, types, nl.idx, nl.mask,
                                   local, box=box)


def single_domain_state(model: DPModel, coords, box, nbr_capacity: int,
                        skin: float) -> NeighborList:
    """Assembly phase: a full skin-widened list (its ``ref_positions`` are
    the reuse reference)."""
    box = torch.as_tensor(box, dtype=coords.dtype, device=coords.device)
    return brute_force_neighbor_list(coords, box,
                                     model.cfg.descriptor.rcut + skin,
                                     nbr_capacity)


def single_domain_forces_nlist(model: DPModel, params, coords, types, box,
                               nlist: NeighborList):
    """Evaluation phase: reuse a (possibly stale) skin-widened list,
    re-filtered to the exact cutoff at the current positions."""
    box = torch.as_tensor(box, dtype=coords.dtype, device=coords.device)
    rcut = model.cfg.descriptor.rcut
    safe = torch.where(nlist.idx >= 0, nlist.idx, torch.zeros_like(nlist.idx))
    dr = minimum_image(coords[safe] - coords[:, None, :], box)
    mask = nlist.mask * ((dr * dr).sum(-1) < rcut ** 2)
    local = torch.ones_like(coords[:, 0])
    return model.energy_and_forces(params, coords, types, nlist.idx, mask,
                                   local, box=box)
