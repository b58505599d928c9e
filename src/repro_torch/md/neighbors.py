"""Neighbour lists: brute-force reference, cell-list construction, Verlet skin.

Port of ``repro/md/neighbors.py``.  Lists are capacity-padded: ``idx == -1``
and ``mask == 0`` mark padding, and the ordering is the JAX one (ascending
neighbour index), so ``idx``, ``mask`` and ``overflow`` equal JAX's exactly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.ref import sq_dist
from . import cells

# rows per pass of the O(N^2) scan: bounds the (rows, N, 3) displacement
# block to a few hundred MB at N ~ 16k without changing the result
ROW_CHUNK = 2048


@dataclasses.dataclass(frozen=True)
class NeighborList:
    idx: torch.Tensor            # (N, K) int32 neighbour indices, -1 padded
    mask: torch.Tensor           # (N, K) float {0, 1}
    ref_positions: torch.Tensor  # positions at build time (skin check)
    overflow: torch.Tensor       # () bool — capacity exceeded, list invalid

    @property
    def capacity(self) -> int:
        return self.idx.shape[1]


def minimum_image(dr: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Orthorhombic minimum-image displacement (``torch.round`` rounds half
    to even, as ``jnp.round`` does)."""
    return dr - box * torch.round(dr / box)


def pair_displacements(pos: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    return minimum_image(pos[None, :, :] - pos[:, None, :], box)


def _f32_square(x: float, like: torch.Tensor) -> torch.Tensor:
    """x*x formed in fp32, as a traced JAX scalar argument squares."""
    t = torch.tensor(x, dtype=torch.float32, device=like.device)
    return t * t


def _topk_list(within: torch.Tensor, capacity: int, cand=None,
               fill: int = -1):
    """Index-ordered top-k of a (rows, M) candidate flag matrix: the first
    ``capacity`` candidates by ascending index (the column index, or the
    value of ``cand`` (rows, M) when given), ``fill`` padded.  Returns
    (idx int32, take bool, counts)."""
    rows, n = within.shape
    if cand is None:
        key = torch.arange(n, device=within.device,
                           dtype=torch.float32)[None, :]
    else:
        key = cand.to(torch.float32)
    score = torch.where(within, -key, torch.full_like(key, float("-inf")))
    kk = min(capacity, n)
    _, order = torch.topk(score, kk, dim=1, sorted=True)
    take = torch.gather(within, 1, order)
    val = order if cand is None else torch.gather(cand, 1, order)
    idx = torch.where(take, val, torch.full_like(val, fill)).to(torch.int32)
    if kk < capacity:
        pad = torch.full((rows, capacity - kk), fill, dtype=torch.int32,
                         device=within.device)
        idx = torch.cat([idx, pad], 1)
        take = torch.cat([take, torch.zeros_like(pad, dtype=torch.bool)], 1)
    return idx, take, within.sum(1)


def dense_scan(pos, box, cut2, capacity, valid=None, half=False):
    """Row-chunked O(N^2) list construction shared by the brute-force and
    the validity-masked lists: (idx, take, overflow) for pairs with
    d^2 < ``cut2`` (and, with ``valid``, both atoms valid)."""
    n = pos.shape[0]
    idxs, takes, over = [], [], torch.zeros((), dtype=torch.bool,
                                            device=pos.device)
    for r0 in range(0, n, ROW_CHUNK):
        rows = torch.arange(r0, min(n, r0 + ROW_CHUNK), device=pos.device)
        dr = minimum_image(pos[None, :, :] - pos[rows, None, :], box)
        within = sq_dist(dr[..., 0], dr[..., 1], dr[..., 2]) < cut2
        cols = torch.arange(n, device=pos.device)
        within &= cols[None, :] != rows[:, None]
        if half:
            within &= cols[None, :] > rows[:, None]
        if valid is not None:
            within &= (valid[rows, None] > 0) & (valid[None, :] > 0)
        idx, take, counts = _topk_list(within, capacity)
        idxs.append(idx)
        takes.append(take)
        over = over | (counts > capacity).any()
    return torch.cat(idxs), torch.cat(takes), over


def brute_force_neighbor_list(pos: torch.Tensor, box: torch.Tensor,
                              cutoff: float, capacity: int,
                              half: bool = False) -> NeighborList:
    """O(N^2) reference list.  ``half=True`` keeps only j > i."""
    idx, take, overflow = dense_scan(pos, box, _f32_square(cutoff, pos),
                                     capacity, half=half)
    return NeighborList(idx=idx, mask=take.to(pos.dtype), ref_positions=pos,
                        overflow=overflow)


def _cell_grid(box, cutoff: float) -> tuple[int, int, int]:
    return cells.grid_dims(box, cutoff)


def cell_list_neighbor_list(pos: torch.Tensor, box: torch.Tensor,
                            cutoff: float, capacity: int,
                            grid: tuple[int, int, int], cell_capacity: int,
                            half: bool = False) -> NeighborList:
    """Cell-list construction: O(N * 27 * cell_capacity).

    ``grid`` is the static cell grid (:func:`_cell_grid`), each cell edge
    >= cutoff so the 27 neighbouring cells cover the interaction sphere.
    Same ``idx``/``mask``/``overflow`` as the brute-force list whenever no
    cell overflows.
    """
    n = pos.shape[0]
    grid_t = torch.tensor(grid, device=pos.device)
    cell_size = box / grid_t.to(pos.dtype)
    frac = torch.minimum(torch.floor(pos / cell_size).to(torch.int32)
                         .clamp_min(0), (grid_t - 1).to(torch.int32))
    table = cells.build_cell_table(cells.cell_ids_from_coords(frac, grid),
                                   grid, cell_capacity)
    cand = cells.neighborhood_candidates(table, frac, periodic=True)
    safe = cand.clamp_min(0).long()
    dr = minimum_image(pos[safe] - pos[:, None, :], box)
    d2 = sq_dist(dr[..., 0], dr[..., 1], dr[..., 2])
    rows = torch.arange(n, device=pos.device)[:, None]
    within = (d2 < _f32_square(cutoff, pos)) & (cand >= 0) & (cand != rows)
    if half:
        within &= cand > rows
    idx, take, counts = _topk_list(within, capacity, cand=cand)
    overflow = (counts > capacity).any() | table.overflow
    return NeighborList(idx=idx, mask=take.to(pos.dtype), ref_positions=pos,
                        overflow=overflow)


def build_neighbor_list(pos: torch.Tensor, box, cutoff: float, capacity: int,
                        half: bool = False, skin: float = 0.0,
                        cell_cap_scale: float = 1.0) -> NeighborList:
    """Front door: the cell list when the box admits >= 3 cells per axis,
    the brute-force list otherwise.  ``cell_cap_scale`` scales the
    density-derived per-cell capacity (grown with ``capacity`` when cells
    overflow)."""
    box = torch.as_tensor(box, dtype=pos.dtype, device=pos.device)
    r = cutoff + skin
    box_h = box.cpu().numpy()
    grid = _cell_grid(box_h, r)
    if min(grid) >= 3:
        density = pos.shape[0] / float(np.prod(box_h))
        cell_cap = int(cell_cap_scale * max(8, 2.5 * density * r ** 3 + 8))
        return cell_list_neighbor_list(pos, box, r, capacity, grid, cell_cap,
                                       half)
    return brute_force_neighbor_list(pos, box, r, capacity, half)


def max_displacement2(pos: torch.Tensor, ref: torch.Tensor,
                      box: torch.Tensor) -> torch.Tensor:
    """Max squared minimum-image displacement since ``ref``, per trajectory
    (positions (..., N, 3) -> (...); a max is exact in any order)."""
    dr = minimum_image(pos - ref, box)
    return (dr * dr).sum(-1).amax(-1)


def needs_rebuild(nlist: NeighborList, pos: torch.Tensor, box: torch.Tensor,
                  skin: float) -> torch.Tensor:
    """True when an atom moved > skin/2 since the list was built (per
    trajectory of a batched list)."""
    disp2 = max_displacement2(pos, nlist.ref_positions, box)
    half = torch.tensor(skin, dtype=torch.float32, device=pos.device) * 0.5
    return (disp2 > half * half) | nlist.overflow


def stack_neighbor_lists(lists) -> NeighborList:
    """Per-replica lists (same capacity) as one batched list: every field
    gains a leading replica axis (``overflow`` (R,))."""
    return NeighborList(idx=torch.stack([nl.idx for nl in lists]),
                        mask=torch.stack([nl.mask for nl in lists]),
                        ref_positions=torch.stack([nl.ref_positions
                                                   for nl in lists]),
                        overflow=torch.stack([nl.overflow for nl in lists]))

