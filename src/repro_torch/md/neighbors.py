"""Neighbour lists: brute-force reference and the Verlet-skin check.

Port of the single-device part of ``repro/md/neighbors.py`` (the cell-list
front door comes with ``md/cells.py`` in a later slice).  Lists are
capacity-padded: ``idx == -1`` and ``mask == 0`` mark padding, and the
ordering is the JAX one (ascending neighbour index), so ``idx``, ``mask``
and ``overflow`` equal JAX's exactly.
"""
from __future__ import annotations

import dataclasses

import torch

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


def _topk_list(within: torch.Tensor, capacity: int):
    """Index-ordered top-k of a (rows, N) candidate flag matrix: the first
    ``capacity`` candidates by ascending index, -1 padded.  Returns
    (idx int32, take bool, counts)."""
    rows, n = within.shape
    ar = torch.arange(n, device=within.device, dtype=torch.float32)
    score = torch.where(within, -ar[None, :],
                        torch.full_like(ar, float("-inf"))[None, :])
    kk = min(capacity, n)
    _, order = torch.topk(score, kk, dim=1, sorted=True)
    take = torch.gather(within, 1, order)
    idx = torch.where(take, order, torch.full_like(order, -1)).to(torch.int32)
    if kk < capacity:
        pad = torch.full((rows, capacity - kk), -1, dtype=torch.int32,
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
        within = (dr * dr).sum(-1) < cut2
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


def max_displacement2(pos: torch.Tensor, ref: torch.Tensor,
                      box: torch.Tensor) -> torch.Tensor:
    """Max squared minimum-image displacement since ``ref``."""
    dr = minimum_image(pos - ref, box)
    return (dr * dr).sum(-1).max()


def needs_rebuild(nlist: NeighborList, pos: torch.Tensor, box: torch.Tensor,
                  skin: float) -> torch.Tensor:
    """True when an atom moved > skin/2 since the list was built."""
    disp2 = max_displacement2(pos, nlist.ref_positions, box)
    half = torch.tensor(skin, dtype=torch.float32, device=pos.device) * 0.5
    return (disp2 > half * half) | nlist.overflow
