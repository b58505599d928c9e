"""Shared cell-list (spatial binning) infrastructure.

Port of ``repro/md/cells.py``: the binning core used by the cell-list
neighbour list (:mod:`repro_torch.md.neighbors`), the virtual-DD ghost/local
selection (:mod:`repro_torch.core.domain`) and the subdomain neighbour
assembly (:mod:`repro_torch.core.ddinfer`).  Atoms go into a static
``(n_cells + 1, capacity)`` table; the extra *spill row* at index
``n_cells`` absorbs invalid/masked atoms.  Slot order equals the JAX
table's exactly: atoms of a cell in ascending index (a stable sort), and on
overflow the cell's last atom in the last slot.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# 27 cell offsets covering the 3x3x3 neighbourhood, lexicographic over
# (-1, 0, 1)^3 — index 13 is (0, 0, 0).  Shared with domain.IMAGE_SHIFTS.
NEIGHBOR_OFFSETS = np.array([(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                             for k in (-1, 0, 1)], np.int32)


@dataclasses.dataclass(frozen=True)
class CellTable:
    """Bucketed atom indices: ``table[c]`` lists atoms in cell ``c`` (-1 pad).

    Row ``n_cells`` (the last) is the spill row for atoms assigned the
    invalid cell id; it is never a candidate source (its entries are -1).
    """

    table: torch.Tensor     # (n_cells + 1, capacity) int32, -1 padded
    counts: torch.Tensor    # (n_cells + 1,) int32
    overflow: torch.Tensor  # () bool — some *real* cell exceeded capacity
    dims: tuple[int, int, int]

    @property
    def n_cells(self) -> int:
        gx, gy, gz = self.dims
        return gx * gy * gz

    @property
    def capacity(self) -> int:
        return self.table.shape[1]


def grid_dims(box, edge: float) -> tuple[int, int, int]:
    """Static per-axis cell counts with each cell edge >= ``edge``."""
    dims = np.maximum(1, np.floor(np.asarray(box, np.float64) / edge).astype(int))
    return tuple(int(d) for d in dims)


def suggest_cell_capacity(density: float, cell_volume: float,
                          slack: float = 2.5, floor: int = 8) -> int:
    """Capacity heuristic for one cell from mean density (+ overflow flags
    downstream catching underestimates)."""
    return int(max(floor, slack * density * cell_volume + floor))


def cell_ids_from_coords(frac: torch.Tensor,
                         dims: tuple[int, int, int]) -> torch.Tensor:
    """Flatten integer cell coordinates (..., 3) to flat ids (...,)."""
    gx, gy, gz = dims
    return (frac[..., 0] * gy + frac[..., 1]) * gz + frac[..., 2]


def build_cell_table(cell_ids: torch.Tensor, dims: tuple[int, int, int],
                     capacity: int) -> CellTable:
    """Scatter atoms into per-cell buckets.

    ``cell_ids`` (N,) must lie in ``[0, n_cells]``; id ``n_cells`` routes an
    atom to the spill row.  A stable sort orders each cell's atoms by index
    and a prefix count gives each its slot; every (cell, slot) is written
    at most once (an overflowing cell's last slot takes the -1 its last
    surplus atom writes in the JAX scatter), so the table does not depend
    on the device's scatter order.  ``overflow`` marks it invalid.
    """
    dev = cell_ids.device
    n = cell_ids.shape[0]
    n_cells = int(np.prod(dims))
    ids = cell_ids.long()
    order = torch.sort(ids, stable=True).indices
    sorted_cells = ids[order]
    counts = torch.bincount(ids, minlength=n_cells + 1)
    first = torch.cumsum(counts, 0) - counts
    slot = torch.arange(n, device=dev) - first[sorted_cells]
    last = slot == counts[sorted_cells] - 1
    write = (slot < capacity - 1) | ((slot >= capacity - 1) & last)
    table = torch.full((n_cells + 1, capacity), -1, dtype=torch.int32,
                       device=dev)
    vals = torch.where((slot < capacity) & (sorted_cells < n_cells), order,
                       torch.full_like(order, -1)).to(torch.int32)
    rows, cols = sorted_cells[write], slot[write].clamp(max=capacity - 1)
    table[rows, cols] = vals[write]
    overflow = (counts[:n_cells] > capacity).any()
    return CellTable(table=table, counts=counts.to(torch.int32),
                     overflow=overflow, dims=tuple(dims))


def route_invalid(ids: torch.Tensor, valid: torch.Tensor,
                  n_cells: int) -> torch.Tensor:
    """Send entries with ``valid == False`` to the spill row ``n_cells``."""
    return torch.where(valid, ids, torch.full_like(ids, n_cells))


def dedupe_mask(ids: torch.Tensor) -> torch.Tensor:
    """Mask marking the first occurrence of each value along the last axis
    of a small array."""
    m = ids[..., :, None] == ids[..., None, :]
    first = m.to(torch.int8).argmax(-1)      # index of the first equal one
    return first == torch.arange(ids.shape[-1], device=ids.device)


def neighborhood_candidates(cells: CellTable, frac: torch.Tensor,
                            periodic: bool) -> torch.Tensor:
    """Candidate atoms from each query's 27-cell neighbourhood.

    ``frac`` (Q, 3) holds in-range integer cell coordinates.  ``periodic``
    wraps neighbour cells around the grid (deduped, so grids with dim < 3
    do not yield an atom twice); otherwise out-of-range cells go to the
    empty spill row.  Returns (Q, 27 * capacity) int32, -1 padded.
    """
    dev = frac.device
    dims_arr = torch.tensor(cells.dims, dtype=torch.int32, device=dev)
    offsets = torch.as_tensor(NEIGHBOR_OFFSETS, device=dev)
    nb = frac[:, None, :].to(torch.int32) + offsets[None]      # (Q, 27, 3)
    n_cells = cells.n_cells
    spill = torch.full(nb.shape[:2], n_cells, dtype=torch.int32, device=dev)
    if periodic:
        nb_id = cell_ids_from_coords(torch.remainder(nb, dims_arr),
                                     cells.dims)
        nb_id = torch.where(dedupe_mask(nb_id), nb_id, spill)
    else:
        valid = ((nb >= 0) & (nb < dims_arr)).all(-1)
        inside = torch.minimum(torch.clamp_min(nb, 0), dims_arr - 1)
        nb_id = torch.where(valid, cell_ids_from_coords(inside, cells.dims),
                            spill)
    return cells.table[nb_id.long()].reshape(frac.shape[0], -1)
