"""Virtual domain decomposition (the paper's core mechanism, Sec. IV-A).

Port of ``repro/core/domain.py``.  A temporary, virtual Cartesian
decomposition of the NN-atom set: the box is cut into a uniform (or
load-balanced rectilinear) grid of P subdomains, one per rank; each rank
takes its local atoms by comparing coordinates with its bounds, and the
atoms (with explicit periodic image shifts) inside its subdomain expanded
by the halo as ghosts.  Everything is capacity-padded, and selection is
scored by atom index, so index sets, shifts, counts and overflow flags
equal the JAX package's exactly; the arithmetic is the reference's, in
float32, op for op.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..md import cells as cellmod

F32 = torch.float32


def _f32(x, device) -> torch.Tensor:
    """A Python float as a float32 scalar (JAX's weak-typed constant)."""
    return torch.tensor(x, dtype=F32, device=device)


def factor_grid(p: int, box) -> tuple[int, int, int]:
    """Split P ranks into a 3-D grid roughly matching the box aspect ratio."""
    box = np.asarray(box, np.float64)
    best, best_cost = (p, 1, 1), np.inf
    for gx in range(1, p + 1):
        if p % gx:
            continue
        rem = p // gx
        for gy in range(1, rem + 1):
            if rem % gy:
                continue
            gz = rem // gy
            side = box / np.array([gx, gy, gz])
            cost = side.max() / side.min()
            if cost < best_cost:
                best, best_cost = (gx, gy, gz), cost
    return best


@dataclasses.dataclass(frozen=True)
class VirtualGrid:
    """Rectilinear decomposition: per-axis plane positions (G+1 each)."""

    planes_x: torch.Tensor  # (gx+1,)
    planes_y: torch.Tensor  # (gy+1,)
    planes_z: torch.Tensor  # (gz+1,)
    dims: tuple[int, int, int]

    @property
    def n_ranks(self) -> int:
        gx, gy, gz = self.dims
        return gx * gy * gz

    def rank_coords(self, rank: int):
        gx, gy, gz = self.dims
        return rank // (gy * gz), (rank // gz) % gy, rank % gz

    def bounds(self, rank: int):
        """(lo (3,), hi (3,)) of a rank's subdomain."""
        rx, ry, rz = self.rank_coords(int(rank))
        lo = torch.stack([self.planes_x[rx], self.planes_y[ry],
                          self.planes_z[rz]])
        hi = torch.stack([self.planes_x[rx + 1], self.planes_y[ry + 1],
                          self.planes_z[rz + 1]])
        return lo, hi

    def rank_of(self, coords: torch.Tensor) -> torch.Tensor:
        """(N,) owning rank per atom (coords assumed wrapped into the box)."""
        gx, gy, gz = self.dims

        def axis(planes, x, g):
            i = torch.searchsorted(planes.contiguous(), x.contiguous(),
                                   right=True) - 1
            return i.clamp(0, g - 1)

        ix = axis(self.planes_x, coords[:, 0], gx)
        iy = axis(self.planes_y, coords[:, 1], gy)
        iz = axis(self.planes_z, coords[:, 2], gz)
        return (ix * gy + iy) * gz + iz


def _linspace(stop: torch.Tensor, g: int) -> torch.Tensor:
    """``jnp.linspace(0.0, stop, g + 1)`` in float32: stop * (i / g), then
    the exact endpoint."""
    step = torch.arange(g, dtype=F32, device=stop.device) / _f32(g, stop.device)
    return torch.cat([stop * step, stop[None]])


def uniform_grid(box, dims: tuple[int, int, int]) -> VirtualGrid:
    box = torch.as_tensor(box, dtype=F32)
    return VirtualGrid(planes_x=_linspace(box[0], dims[0]),
                       planes_y=_linspace(box[1], dims[1]),
                       planes_z=_linspace(box[2], dims[2]), dims=tuple(dims))


def _quantile(x: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """``jnp.quantile(x, qs)`` (linear interpolation), op for op in float32."""
    xs = torch.sort(x).values
    n = _f32(x.shape[0], x.device)
    q = qs * (n - 1)
    low, high = torch.floor(q), torch.ceil(q)
    hw = q - low
    lw = 1 - hw
    low = torch.minimum(low.clamp_min(0), n - 1).long()
    high = torch.minimum(high.clamp_min(0), n - 1).long()
    return xs[low] * lw + xs[high] * hw


def _weighted_quantiles(x: torch.Tensor, w: torch.Tensor,
                        qs: torch.Tensor) -> torch.Tensor:
    """Values where the cumulative weight fraction crosses each q in ``qs``."""
    order = torch.sort(x, stable=True).indices
    xs = x[order]
    cw = torch.cumsum(w[order].to(F32), 0)
    cw = cw / torch.clamp_min(cw[-1], 1e-12)
    sel = torch.searchsorted(cw, qs.contiguous())
    return xs[sel.clamp(0, x.shape[0] - 1)]


def balanced_planes(coords: torch.Tensor, box, dims: tuple[int, int, int],
                    weights=None) -> VirtualGrid:
    """Load-balanced rectilinear grid from per-axis quantiles (beyond paper):
    each axis's planes equalize the per-slab atom population (or, with
    ``weights``, the per-atom cost), kept monotone and at least 25% of the
    uniform slab width apart from the box faces."""
    box = torch.as_tensor(box, dtype=F32, device=coords.device)
    dev = coords.device

    def axis_planes(x, g, length):
        if g == 1:
            return torch.stack([length * 0.0, length * 1.0])
        q = _linspace(_f32(1.0, dev), g)[1:-1]
        qs = (_quantile(x, q) if weights is None
              else _weighted_quantiles(x, weights, q))
        planes = torch.cat([torch.zeros(1, dtype=F32, device=dev), qs,
                            length[None]])
        min_w = _f32(0.25, dev) * length / _f32(g, dev)
        planes = torch.cummax(planes, 0).values
        ar = torch.arange(g + 1, dtype=F32, device=dev)
        planes = torch.maximum(planes, ar * min_w)
        planes = torch.minimum(planes, length - (g - ar) * min_w)
        return planes

    return VirtualGrid(
        planes_x=axis_planes(coords[:, 0], dims[0], box[0]),
        planes_y=axis_planes(coords[:, 1], dims[1], box[1]),
        planes_z=axis_planes(coords[:, 2], dims[2], box[2]),
        dims=tuple(dims))


# 27 periodic image shifts
IMAGE_SHIFTS = np.array([(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                         for k in (-1, 0, 1)], np.int32)
_ZERO_SHIFT = 13  # index of (0,0,0)


def _select(score: torch.Tensor, member: torch.Tensor, capacity: int):
    """Top-``capacity`` entries of a flat score (members first, ascending
    key): (positions, mask), zero padded to ``capacity``."""
    k = min(capacity, score.shape[0])
    sel = torch.topk(score, k, sorted=True).indices
    mask = member[sel]
    if k < capacity:
        pad = capacity - k
        sel = torch.cat([sel, torch.zeros(pad, dtype=sel.dtype,
                                          device=sel.device)])
        mask = torch.cat([mask, torch.zeros(pad, dtype=torch.bool,
                                            device=mask.device)])
    return sel, mask


def _neg_inf_where(member, key):
    return torch.where(member, -key.to(F32),
                       torch.full_like(key, float("-inf"), dtype=F32))


def select_local(coords: torch.Tensor, grid: VirtualGrid, rank: int,
                 capacity: int, valid=None):
    """Static-capacity selection of a rank's local atoms.  ``valid`` (N,)
    bool excludes atoms (padding) from residence.  Returns
    (idx (C,) int32 zero padded, mask (C,) bool, count ())."""
    n = coords.shape[0]
    member = grid.rank_of(coords) == rank
    if valid is not None:
        member &= valid
    score = _neg_inf_where(member, torch.arange(n, device=coords.device))
    sel, mask = _select(score, member, capacity)
    idx = torch.where(mask, sel, torch.zeros_like(sel)).to(torch.int32)
    return idx, mask, member.sum()


def _shifts(box: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(IMAGE_SHIFTS, device=box.device).to(F32) * box[None, :]


def _inside(pos, lo, hi, halo: float):
    h = _f32(halo, pos.device)
    return ((pos >= lo - h) & (pos < hi + h)).all(-1)


def select_ghosts(coords: torch.Tensor, box, grid: VirtualGrid, rank: int,
                  halo: float, capacity: int):
    """Static-capacity ghost selection with explicit periodic images: an
    (atom, shift) pair is a ghost when the shifted position lies inside the
    subdomain expanded by ``halo`` and is not the atom's own (unshifted)
    residence.  Returns (idx (C,), shift_vec (C, 3), mask (C,), count ())."""
    n = coords.shape[0]
    box = torch.as_tensor(box, dtype=F32, device=coords.device)
    lo, hi = grid.bounds(rank)
    shifts = _shifts(box)                                         # (27, 3)
    pos = coords[None, :, :] + shifts[:, None, :]                 # (27, N, 3)
    inside_exp = _inside(pos, lo, hi, halo)                       # (27, N)
    local_unshifted = grid.rank_of(coords) == rank
    is_zero = torch.arange(27, device=coords.device) == _ZERO_SHIFT
    ghost = inside_exp & ~(is_zero[:, None] & local_unshifted[None, :])
    flat = ghost.reshape(-1)
    score = _neg_inf_where(flat, torch.arange(27 * n, device=coords.device))
    sel, mask = _select(score, flat, capacity)
    shift_vec = shifts[sel // n] * mask[:, None]
    idx = torch.where(mask, sel % n, torch.zeros_like(sel)).to(torch.int32)
    return idx, shift_vec, mask, ghost.sum()


# ---------------------------------------------------------------------------
# Cell-based selection: enumerate only the O(halo surface) cells of the
# expanded subdomain instead of scanning all 27*N (atom, image) pairs.
# ---------------------------------------------------------------------------

def bin_atoms(coords: torch.Tensor, box, dims: tuple[int, int, int],
              capacity: int, valid=None) -> cellmod.CellTable:
    """Bin the replicated coordinate buffer into a global periodic cell
    grid; ``valid`` (N,) bool routes excluded atoms to the spill row."""
    box = torch.as_tensor(box, dtype=F32, device=coords.device)
    dims_t = torch.tensor(dims, device=coords.device)
    cw = box / dims_t.to(F32)
    frac = torch.minimum(torch.floor(coords / cw).to(torch.int32).clamp_min(0),
                         (dims_t - 1).to(torch.int32))
    ids = cellmod.cell_ids_from_coords(frac, dims)
    if valid is not None:
        ids = cellmod.route_invalid(ids, valid, int(np.prod(dims)))
    return cellmod.build_cell_table(ids, dims, capacity)


def _region_cells(lo, hi, box, dims: tuple[int, int, int],
                  region: tuple[int, int, int]):
    """The static-capacity block of cells covering [lo, hi): (ids (R,),
    shift (R, 3) int, valid (R,), overflow ()) with R = prod(region).
    Out-of-box cells wrap periodically and carry their integer image shift;
    ``overflow`` is set when the true extent exceeds ``region``."""
    dev = lo.device
    box = torch.as_tensor(box, dtype=F32, device=dev)
    dims_arr = torch.tensor(dims, dtype=torch.int32, device=dev)
    cw = box / dims_arr.to(F32)
    c0 = torch.floor(lo / cw).to(torch.int32)
    c1 = torch.floor(hi / cw).to(torch.int32)
    region_t = torch.tensor(region, dtype=torch.int32, device=dev)
    overflow = ((c1 - c0 + 1) > region_t).any()
    ax = [c0[a] + torch.arange(region[a], dtype=torch.int32, device=dev)
          for a in range(3)]
    valid_ax = [ax[a] <= c1[a] for a in range(3)]
    cc = torch.stack(torch.meshgrid(*ax, indexing="ij"), -1).reshape(-1, 3)
    valid = (valid_ax[0][:, None, None] & valid_ax[1][None, :, None]
             & valid_ax[2][None, None, :]).reshape(-1)
    shift = torch.div(cc, dims_arr, rounding_mode="floor")
    wrapped = cc - shift * dims_arr
    ids = cellmod.cell_ids_from_coords(wrapped, dims)
    key = ids * 27 + ((shift[:, 0] + 1) * 9 + (shift[:, 1] + 1) * 3
                      + (shift[:, 2] + 1))
    neg = -1 - torch.arange(key.shape[0], dtype=key.dtype, device=dev)
    valid &= cellmod.dedupe_mask(torch.where(valid, key, neg))
    n_cells = int(np.prod(dims))
    ids = torch.where(valid, ids, torch.full_like(ids, n_cells))
    return ids, shift, valid, overflow


def select_local_cells(coords: torch.Tensor, grid: VirtualGrid, rank: int,
                       capacity: int, table: cellmod.CellTable,
                       region: tuple[int, int, int], box, valid=None):
    """Cell-based :func:`select_local`: candidates from the cells
    overlapping the subdomain.  Same returns and ordering, plus a
    region-overflow flag."""
    lo, hi = grid.bounds(rank)
    ids, _, _, region_overflow = _region_cells(lo, hi, box, table.dims, region)
    n_cells = int(np.prod(table.dims))
    ids = torch.where(cellmod.dedupe_mask(ids), ids,
                      torch.full_like(ids, n_cells))
    cand = table.table[ids.long()].reshape(-1)
    member = grid.rank_of(coords) == rank
    if valid is not None:
        member &= valid
    is_member = (cand >= 0) & member[cand.clamp_min(0).long()]
    score = _neg_inf_where(is_member, cand)
    sel, mask = _select(score, is_member, capacity)
    idx = torch.where(mask, cand[sel], torch.zeros_like(cand[sel]))
    return (idx.to(torch.int32), mask, member.sum(),
            region_overflow | table.overflow)


def select_ghosts_cells(coords: torch.Tensor, box, grid: VirtualGrid,
                        rank: int, halo: float, capacity: int,
                        table: cellmod.CellTable,
                        region: tuple[int, int, int]):
    """Cell-based :func:`select_ghosts`: candidates only from the cells
    covering the halo-expanded subdomain, then the dense path's exact test,
    scored by its flat (shift, atom) key, so both paths give identical ghost
    buffers.  Returns (idx, shift_vec, mask, count, overflow)."""
    n = coords.shape[0]
    box = torch.as_tensor(box, dtype=F32, device=coords.device)
    lo, hi = grid.bounds(rank)
    h = _f32(halo, coords.device)
    ids, cshift, _, region_overflow = _region_cells(
        lo - h, hi + h, box, table.dims, region)
    cap = table.capacity
    cand = table.table[ids.long()].reshape(-1)
    shift = torch.repeat_interleave(cshift, cap, dim=0)
    valid = cand >= 0
    safe = cand.clamp_min(0).long()
    pos = coords[safe] + shift.to(F32) * box[None, :]
    inside_exp = _inside(pos, lo, hi, halo)
    member = grid.rank_of(coords) == rank
    zero_shift = (shift == 0).all(-1)
    ghost = valid & inside_exp & ~(zero_shift & member[safe])
    shift_idx = ((shift[:, 0] + 1) * 9 + (shift[:, 1] + 1) * 3
                 + (shift[:, 2] + 1))
    key = shift_idx.to(F32) * _f32(n, coords.device) + safe.to(F32)
    score = torch.where(ghost, -key, torch.full_like(key, float("-inf")))
    sel, mask = _select(score, ghost, capacity)
    idx = torch.where(mask, cand[sel], torch.zeros_like(cand[sel]))
    shift_vec = shift[sel].to(F32) * box[None, :] * mask[:, None]
    return (idx.to(torch.int32), shift_vec, mask, ghost.sum(),
            region_overflow | table.overflow)


def atom_costs(coords: torch.Tensor, box, grid: VirtualGrid,
               halo: float) -> torch.Tensor:
    """(N,) per-atom buffer multiplicity under ``grid``: how many rank
    buffers (local residence + every periodic ghost image) each atom lands
    in — the Eq.-8 cost model attributed back to atoms."""
    box = torch.as_tensor(box, dtype=F32, device=coords.device)
    pos = coords[None, :, :] + _shifts(box)[:, None, :]
    total = torch.zeros(coords.shape[0], dtype=torch.int64,
                        device=coords.device)
    for rank in range(grid.n_ranks):
        lo, hi = grid.bounds(rank)
        total += _inside(pos, lo, hi, halo).sum(0)
    return total.to(torch.int32)


def interior_fraction_estimate(box, dims, margin: float) -> float:
    """Uniform-density estimate of the fraction of atoms deeper than
    ``margin`` from every subdomain face (the comms-overlap interior)."""
    box = np.asarray(box, np.float64)
    sides = box / np.asarray(dims, np.float64)
    core = np.clip(sides - 2.0 * margin, 0.0, None)
    return float(np.prod(core / sides))


def partition_costs(coords: torch.Tensor, box, grid: VirtualGrid,
                    halo: float) -> torch.Tensor:
    """(P,) per-rank local+ghost atom counts — the paper's Eq. 8 cost model."""
    box = torch.as_tensor(box, dtype=F32, device=coords.device)
    pos = coords[None, :, :] + _shifts(box)[:, None, :]
    ranks = grid.rank_of(coords)
    is_zero = torch.arange(27, device=coords.device) == _ZERO_SHIFT
    out = []
    for rank in range(grid.n_ranks):
        lo, hi = grid.bounds(rank)
        local = ranks == rank
        ghost = _inside(pos, lo, hi, halo) & ~(is_zero[:, None]
                                                & local[None, :])
        out.append(local.sum() + ghost.sum())
    return torch.stack(out).to(torch.int32)
