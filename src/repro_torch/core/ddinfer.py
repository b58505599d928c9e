"""Distributed Deep-Potential inference over the decomposition's ranks,
and the single-domain reference path.

Port of ``repro/core/ddinfer.py``.  The domain decomposition
(:class:`DDConfig`, :func:`suggest_config`, the per-rank assembly
:func:`_assemble_rank`) stacks the per-rank index sets and lists of the
ranks one device holds (all G of them, or a process mesh's share) along a
leading rank axis, and :mod:`repro_torch.core.pipeline` evaluates those
ranks' buffers in one model call.  Selection, shifts, counts and overflow
flags equal the JAX package's per rank exactly.

The single-domain path: one domain, PBC minimum image, the brute-force full
neighbour list, forces by autograd.  With a skin the work splits into an
assembly (a skin-widened list) and evaluations that re-filter that list to
the exact cutoff at the current positions.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ..dp.model import DPModel
from ..kernels.cell_filter import cell_filter
from ..kernels.nbr_attn import MAX_K, k_limit_message
from ..kernels.ref import cutoff2, sq_dist
from ..md import cells as cellmod
from ..md.neighbors import (NeighborList, ROW_CHUNK, _topk_list,
                            brute_force_neighbor_list, dense_scan,
                            minimum_image, stack_neighbor_lists)
from .domain import (IMAGE_SHIFTS, VirtualGrid, atom_costs, balanced_planes,
                     bin_atoms, factor_grid, select_ghosts,
                     select_ghosts_cells, select_local, select_local_cells,
                     uniform_grid)

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class DDConfig:
    """Static configuration of the virtual decomposition (field for field
    the JAX ``DDConfig``, without ``use_pallas``: the tensors' device picks
    kernel or plain version, and the port's K limit holds on every device).
    """

    grid_dims: tuple[int, int, int]
    local_capacity: int
    ghost_capacity: int
    nbr_capacity: int            # K for the DP neighbour lists
    halo: float                  # 2*r_c (owner_full) or r_c (ghost_reduce)
    balanced: bool = False       # quantile load balancing (beyond paper)
    rebalance: bool = False      # planes from measured per-atom Eq.-8 costs
    reduce_mode: str = "all_reduce"  # "all_reduce" (paper) | "reduce_scatter"
    force_mode: str = "owner_full"   # "owner_full" (2 r_c halo, paper) |
    #   "ghost_reduce" (1 r_c halo, Eq. 7 masking + ghost-force reduction)
    axis: str = "dd"
    nbr_method: str = "dense"    # "dense" (O(C^2) oracle) | "cells"
    cell_dims: tuple[int, int, int] = (0, 0, 0)
    cell_capacity: int = 0
    local_region: tuple[int, int, int] = (0, 0, 0)
    ghost_region: tuple[int, int, int] = (0, 0, 0)
    subcell_dims: tuple[int, int, int] = (0, 0, 0)
    subcell_capacity: int = 0
    skin: float = 0.0            # Verlet buffer; 0 = rebuild every step
    nbr_capacity_eval: int = 0   # K after exact-cutoff compaction (0 = K)
    overlap: bool = False        # interior pass + boundary pass (pipeline.py)
    overlap_capacity: int = 0    # boundary-pass sub-buffer rows (0 = full C)
    overlap_min_interior: float = 0.25  # advisory: below this interior
    #   fraction the split cannot hide the gather

    def __post_init__(self):
        if len(self.grid_dims) != 3 or min(self.grid_dims) < 1:
            raise ValueError(
                f"grid_dims {self.grid_dims} must be three positive factors "
                "(use factor_grid/suggest_config)")
        if min(self.local_capacity, self.ghost_capacity,
               self.nbr_capacity) < 1:
            raise ValueError(
                f"capacities must be positive: local_capacity="
                f"{self.local_capacity}, ghost_capacity="
                f"{self.ghost_capacity}, nbr_capacity={self.nbr_capacity}")
        if self.skin < 0:
            raise ValueError(f"skin must be >= 0, got {self.skin}")
        if self.nbr_capacity_eval > self.nbr_capacity:
            raise ValueError(
                f"nbr_capacity_eval {self.nbr_capacity_eval} > nbr_capacity "
                f"{self.nbr_capacity}: evaluation compacts the skin-widened "
                "build list down to k_eval entries; it cannot widen it")
        if self.k_eval > MAX_K:
            raise ValueError(
                f"k_eval {self.k_eval}: " + k_limit_message(self.k_eval)
                + "; cap nbr_capacity_eval at 128")
        if self.overlap and self.force_mode != "owner_full":
            raise ValueError(
                "overlap=True requires force_mode='owner_full': the interior "
                "pass reproduces a row's force only where the 2 r_c halo "
                "makes every ghost descriptor exact")
        if self.overlap_capacity < 0 or not (
                0.0 <= self.overlap_min_interior <= 1.0):
            raise ValueError(
                f"overlap_capacity {self.overlap_capacity} must be >= 0 and "
                f"overlap_min_interior {self.overlap_min_interior} in [0, 1]")

    @property
    def n_ranks(self) -> int:
        gx, gy, gz = self.grid_dims
        return gx * gy * gz

    @property
    def k_eval(self) -> int:
        """Model-facing neighbour capacity after exact-cutoff compaction."""
        return self.nbr_capacity_eval or self.nbr_capacity

    @property
    def halo_hops(self) -> int:
        return 2 if self.force_mode == "owner_full" else 1

    @property
    def halo_eff(self) -> float:
        """Selection halo including the skin margin (k hops, k * skin)."""
        return self.halo + self.halo_hops * self.skin

    def padded_atoms(self, n_atoms: int) -> int:
        """Atom-axis size padded up to a rank multiple."""
        return -(-n_atoms // self.n_ranks) * self.n_ranks

    def validate(self, box) -> None:
        box = np.asarray(box)
        widths = box / np.asarray(self.grid_dims)
        if (widths < 1e-6).any():
            raise ValueError("degenerate subdomain")
        if (self.halo_eff > box / 2).any():
            raise ValueError(
                f"halo+skin {self.halo_eff} exceeds half box {box/2}: periodic "
                "ghost images would alias; use fewer ranks, a smaller skin, "
                "or a bigger box")
        if self.skin < 0:
            raise ValueError("skin must be >= 0")
        if self.nbr_method not in ("dense", "cells"):
            raise ValueError(f"unknown nbr_method {self.nbr_method!r}")
        if self.nbr_method == "cells":
            if (min(self.cell_dims) < 1 or self.cell_capacity < 1
                    or min(self.subcell_dims) < 1 or self.subcell_capacity < 1
                    or min(self.local_region) < 1 or min(self.ghost_region) < 1):
                raise ValueError(
                    "nbr_method='cells' needs cell_dims/cell_capacity/"
                    "subcell_dims/subcell_capacity/local_region/ghost_region "
                    "sized > 0 (use suggest_config)")


@dataclasses.dataclass(frozen=True)
class DDState:
    """Persistent assembly state, reused across evaluation steps.  Per-rank
    leaves are stacked along the rank axis (leading ``n_ranks * capacity``),
    as the JAX state is; over a process mesh each process holds its own
    ranks' rows (a shard of the JAX state's sharded leaves).  ``l_slot``
    (every rank's local ids), the scalars and ``ref`` (the padded reference
    positions the state was built at) are whole-mesh values.  Replica-
    batched, every leaf gains a leading replica axis; over a 2-D
    ``(replica x dd)`` mesh the per-rank leaves, ``l_slot`` and ``ref``
    hold the resident replicas' rows only, and the scalars every replica's
    (R,)."""

    l_idx: torch.Tensor       # (P*Cl,) int32 local atom indices (0-padded)
    l_mask: torch.Tensor      # (P*Cl,) bool
    l_slot: torch.Tensor      # (P*Cl,) int32 every rank's l_idx, rank order
    g_idx: torch.Tensor       # (P*Cg,) int32 ghost atom indices
    g_shift: torch.Tensor     # (P*Cg, 3) int32 integer periodic image shifts
    g_mask: torch.Tensor      # (P*Cg,) bool
    buf_types: torch.Tensor   # (P*C,) subdomain buffer types
    buf_mask: torch.Tensor    # (P*C,) float {0, 1} buffer validity
    nbr_idx: torch.Tensor     # (P*C, K) int32 list at cutoff r_c + skin
    nbr_mask: torch.Tensor    # (P*C, K) float {0, 1}
    local_count: torch.Tensor  # () summed over ranks
    ghost_count: torch.Tensor  # () summed over ranks
    cost_max: torch.Tensor    # () max per-rank local+ghost count
    overflow: torch.Tensor    # () int32 summed over ranks; != 0 => invalid
    ref: torch.Tensor         # (n_pad, 3) reference positions at build time


def _build_grid(coords, box, dims: tuple[int, int, int], halo_eff: float,
                balanced: bool, rebalance: bool) -> VirtualGrid:
    """The decomposition planes for a configuration (shared by the runtime
    and by :func:`suggest_config`'s capacity sizing)."""
    if rebalance:
        base = (balanced_planes(coords, box, dims) if balanced
                else uniform_grid(box, dims))
        w = atom_costs(coords, box, base, halo_eff)
        return balanced_planes(coords, box, dims, weights=w)
    if balanced:
        return balanced_planes(coords, box, dims)
    return uniform_grid(torch.as_tensor(box, device=coords.device), dims)


def _max_rank_counts(coords, box, vgrid: VirtualGrid, halo: float,
                     dims: tuple[int, int, int]) -> tuple[int, int]:
    """Exact (max local, max ghost) per-rank counts — host side, config
    time only (O(27 * N * P))."""
    coords_t = torch.as_tensor(np.asarray(coords, np.float32))
    ranks = vgrid.rank_of(coords_t).numpy()
    p = int(np.prod(dims))
    loc_max = int(np.bincount(ranks, minlength=p).max())
    pos = (np.asarray(coords, np.float64)[None, :, :]
           + (IMAGE_SHIFTS * np.asarray(box, np.float64))[:, None, :])
    zero = (IMAGE_SHIFTS == 0).all(1)
    gho_max = 0
    for r in range(p):
        lo, hi = vgrid.bounds(r)
        lo = lo.numpy().astype(np.float64) - halo
        hi = hi.numpy().astype(np.float64) + halo
        inside = ((pos >= lo) & (pos < hi)).all(-1)          # (27, N)
        ghost = inside & ~(zero[:, None] & (ranks == r)[None, :])
        gho_max = max(gho_max, int(ghost.sum()))
    return loc_max, gho_max


def _cell_counts(coords, box, dims: tuple[int, int, int]) -> np.ndarray:
    """Host-side per-cell atom counts for a periodic grid over the box."""
    coords = np.asarray(coords, np.float64)
    box = np.asarray(box, np.float64)
    dims_arr = np.asarray(dims)
    frac = np.clip((coords / (box / dims_arr)).astype(int), 0, dims_arr - 1)
    ids = (frac[:, 0] * dims[1] + frac[:, 1]) * dims[2] + frac[:, 2]
    return np.bincount(ids, minlength=int(np.prod(dims))).reshape(dims)


def _max_cell_occupancy(coords, box, dims: tuple[int, int, int]) -> int:
    return int(_cell_counts(coords, box, dims).max())


def _max_shifted_cell_occupancy(coords, box, edge: float) -> int:
    """Upper bound on atoms inside an ``edge``-sized cube at any origin:
    the max wrapped 2x2x2 block sum of the box-anchored grid."""
    counts = _cell_counts(coords, box, cellmod.grid_dims(box, edge))
    pooled = sum(np.roll(counts, (-dx, -dy, -dz), axis=(0, 1, 2))
                 for dx in (0, 1) for dy in (0, 1) for dz in (0, 1))
    return int(pooled.max())


def suggest_config(n_atoms: int, box, n_ranks: int, rcut: float,
                   nbr_capacity: int = 64, slack: float = 1.6,
                   balanced: bool = False, rebalance: bool = False,
                   force_mode: str = "owner_full",
                   nbr_method: str = "cells",
                   coords=None, skin: float = 0.0) -> DDConfig:
    """Capacity heuristics from density; overflow flags catch underestimates.

    With ``coords`` (host array, (N, 3)) the local/ghost and cell
    capacities come from the configuration's actual maxima (with a 1.25
    margin for drift), counted under the planes the runtime will build.
    ``skin`` widens every halo, cell grid and the list cutoff, and scales
    ``nbr_capacity`` by the cutoff-sphere volume ratio (the model-facing
    ``k_eval`` stays ``nbr_capacity``).  Same numbers as the JAX function.
    """
    box = np.asarray(box, np.float64)
    dims = factor_grid(n_ranks, box)
    hops = 2 if force_mode == "owner_full" else 1
    halo = hops * rcut
    halo_eff = halo + hops * skin
    r_list = rcut + skin
    nbr_capacity_eval = nbr_capacity
    if skin > 0:
        nbr_capacity = int(np.ceil(nbr_capacity * (r_list / rcut) ** 3))
    density = n_atoms / box.prod()
    sub = box / np.asarray(dims)
    local_cap = int(slack * n_atoms / n_ranks) + 8
    exp_vol = np.minimum(sub + 2 * halo_eff, box).prod()
    ghost_cap = int(slack * density * (exp_vol - sub.prod())) + 16
    ghost_cap = min(ghost_cap, 27 * n_atoms)
    if coords is not None:
        vgrid = _build_grid(torch.as_tensor(np.asarray(coords, np.float32)),
                            torch.as_tensor(box.astype(np.float32)), dims,
                            halo_eff, balanced, rebalance)
        loc_max, gho_max = _max_rank_counts(coords, box, vgrid, halo_eff,
                                            dims)
        local_cap = max(local_cap, int(np.ceil(1.25 * loc_max)) + 8)
        ghost_cap = max(ghost_cap, min(int(np.ceil(1.25 * gho_max)) + 16,
                                       27 * n_atoms))

    # worst-case slab width per axis (moving planes are clamped to >= 25%
    # of the uniform width)
    g = np.asarray(dims, np.float64)
    moving_planes = balanced or rebalance
    max_sub = sub if not moving_planes else box - (g - 1) * 0.25 * box / g

    # global grid: cell edge >= halo_eff, coarse enough for ~4 atoms/cell
    target_edge = max(halo_eff, (4.0 / max(density, 1e-12)) ** (1.0 / 3.0))
    cell_dims = cellmod.grid_dims(box, target_edge)
    cw = box / np.asarray(cell_dims)
    cell_cap = cellmod.suggest_cell_capacity(density, cw.prod(),
                                             slack=max(slack, 2.0))
    if coords is not None:
        cell_cap = max(cell_cap, int(np.ceil(
            max(slack, 1.25) * _max_cell_occupancy(coords, box, cell_dims))))
    local_region = tuple(int(np.ceil(max_sub[a] / cw[a])) + 1 for a in range(3))
    ghost_region = tuple(int(np.ceil((max_sub[a] + 2 * halo_eff) / cw[a])) + 1
                         for a in range(3))

    # subdomain buffer grid: edge r_c + skin anchored at lo - halo_eff
    subcell_dims = tuple(
        int(np.ceil((max_sub[a] + 2 * halo_eff) / r_list)) + 1
        for a in range(3))
    subcell_cap = cellmod.suggest_cell_capacity(density, r_list ** 3,
                                                slack=max(slack, 2.0))
    if coords is not None:
        subcell_cap = max(subcell_cap, int(np.ceil(
            1.25 * _max_shifted_cell_occupancy(coords, box, r_list))))
    return DDConfig(grid_dims=dims, local_capacity=local_cap,
                    ghost_capacity=ghost_cap, nbr_capacity=nbr_capacity,
                    halo=halo, balanced=balanced, rebalance=rebalance,
                    force_mode=force_mode,
                    nbr_method=nbr_method, cell_dims=cell_dims,
                    cell_capacity=cell_cap, local_region=local_region,
                    ghost_region=ghost_region, subcell_dims=subcell_dims,
                    subcell_capacity=subcell_cap,
                    skin=skin, nbr_capacity_eval=nbr_capacity_eval)


# ---------------------------------------------------------------------------
# Subdomain assembly: selection per rank, neighbour lists for all ranks at
# once (a leading rank axis; the cell filter launches once for all ranks)
# ---------------------------------------------------------------------------

def _subdomain_nbr_list(buf_coords: torch.Tensor, buf_mask: torch.Tensor,
                        rcut: float, k: int):
    """Full neighbour lists inside subdomain buffers (open boundaries):
    buf_coords (G, C, 3), buf_mask (G, C) -> (idx (G, C, K) int32 zero
    padded, take (G, C, K) bool, overflow (G,) bool).  Rows in chunks."""
    g, c, _ = buf_coords.shape
    dev = buf_coords.device
    cut2 = cutoff2(rcut, dev)
    cols = torch.arange(c, device=dev)
    idxs, takes, overs = [], [], []
    for r in range(g):
        x, m = buf_coords[r], buf_mask[r] > 0
        ri, rt, ro = [], [], torch.zeros((), dtype=torch.bool, device=dev)
        for r0 in range(0, c, ROW_CHUNK):
            rows = cols[r0:r0 + ROW_CHUNK]
            dr = x[None, :, :] - x[rows, None, :]
            within = sq_dist(dr[..., 0], dr[..., 1], dr[..., 2]) < cut2
            within &= cols[None, :] != rows[:, None]
            within &= m[rows, None] & m[None, :]
            idx, take, counts = _topk_list(within, k, fill=0)
            ri.append(idx)
            rt.append(take)
            ro = ro | (counts > k).any()
        idxs.append(torch.cat(ri))
        takes.append(torch.cat(rt))
        overs.append(ro)
    return torch.stack(idxs), torch.stack(takes), torch.stack(overs)


def _subdomain_nbr_list_cells(buf_coords: torch.Tensor, buf_mask: torch.Tensor,
                              rcut: float, k: int, origin: torch.Tensor,
                              dims: tuple[int, int, int], cell_capacity: int):
    """Cell-list neighbour assembly inside subdomain buffers: buf_coords
    (G, C, 3), buf_mask (G, C), origin (G, 3) -> as
    :func:`_subdomain_nbr_list`, and equal to it (same candidate scoring by
    buffer index).  Each rank bins its buffer into an open-boundary grid of
    edge ``rcut`` anchored at ``origin``; the 27-cell candidates of all
    ranks go through one ``cell_filter`` launch (the gather is fused)."""
    g, c, _ = buf_coords.shape
    dev = buf_coords.device
    dims_arr = torch.tensor(dims, dtype=torch.int32, device=dev)
    n_cells = int(np.prod(dims))
    rc = torch.tensor(rcut, dtype=F32, device=dev)
    cands, ovfs = [], []
    for r in range(g):
        x, m = buf_coords[r], buf_mask[r] > 0
        frac = torch.floor((x - origin[r]) / rc).to(torch.int32)
        in_range = ((frac >= 0) & (frac < dims_arr)).all(-1) & m
        range_overflow = (~in_range & m).any()
        frac = torch.minimum(frac.clamp_min(0), dims_arr - 1)
        ids = cellmod.route_invalid(cellmod.cell_ids_from_coords(frac, dims),
                                    in_range, n_cells)
        table = cellmod.build_cell_table(ids, dims, cell_capacity)
        cands.append(cellmod.neighborhood_candidates(table, frac,
                                                     periodic=False))
        ovfs.append(table.overflow | range_overflow)
    cand = torch.stack(cands)                                 # (G, C, M)
    off = (torch.arange(g, device=dev, dtype=torch.int32) * c)[:, None, None]
    flat = torch.where(cand >= 0, cand + off, cand).reshape(g * c, -1)
    within = cell_filter(buf_coords.reshape(g * c, 3), flat,
                         buf_mask.reshape(g * c), rcut)
    idx, take, counts = _topk_list(within, k, cand=cand.reshape(g * c, -1),
                                   fill=0)
    overflow = (counts.reshape(g, c) > k).any(1) | torch.stack(ovfs)
    return idx.reshape(g, c, k), take.reshape(g, c, k), overflow


def _park(buf_coords: torch.Tensor, buf_mask: torch.Tensor, box) -> torch.Tensor:
    """Park padded buffer entries far away, each at a distinct position, so
    they can never enter a cutoff sphere (works on (..., C, 3))."""
    box = torch.as_tensor(box, dtype=F32, device=buf_coords.device)
    c = buf_coords.shape[-2]
    park = box.max() * 10.0 * (
        1.0 + torch.arange(c, dtype=F32, device=box.device))[:, None]
    return torch.where(buf_mask[..., None] > 0, buf_coords, park + box * 3.0)


def _select_rank(coords_all, box, grid: VirtualGrid, cfg: DDConfig, rank: int,
                 valid, table):
    """Local and ghost selection for one rank (dense or cells)."""
    if cfg.nbr_method == "cells":
        l_idx, l_mask, l_count, l_ovf = select_local_cells(
            coords_all, grid, rank, cfg.local_capacity, table,
            cfg.local_region, box, valid=valid)
        g_idx, g_shift_vec, g_mask, g_count, g_ovf = select_ghosts_cells(
            coords_all, box, grid, rank, cfg.halo_eff, cfg.ghost_capacity,
            table, cfg.ghost_region)
        sel_overflow = l_ovf | g_ovf
    else:
        l_idx, l_mask, l_count = select_local(coords_all, grid, rank,
                                              cfg.local_capacity, valid=valid)
        g_idx, g_shift_vec, g_mask, g_count = select_ghosts(
            coords_all, box, grid, rank, cfg.halo_eff, cfg.ghost_capacity)
        sel_overflow = torch.zeros((), dtype=torch.bool,
                                   device=coords_all.device)
    return (l_idx, l_mask, l_count, g_idx, g_shift_vec, g_mask, g_count,
            sel_overflow)


def _assemble_ranks(coords_all, types_all, box, grid: VirtualGrid,
                    cfg: DDConfig, rcut: float, ranks, n_real: int) -> dict:
    """Assembly phase for the given ranks, stacked along a leading rank
    axis: selection + subdomain buffer + subdomain neighbour list.  Runs on
    the replicated coordinate buffer, which may be padded to a rank
    multiple (``n_real`` marks the real atoms).  Halos and the list cutoff
    are widened by ``cfg.skin``."""
    st = _select_ranks(coords_all, types_all, box, grid, cfg, ranks, n_real)
    return _rank_lists(st, cfg, rcut)


def _select_ranks(coords_all, types_all, box, grid: VirtualGrid,
                  cfg: DDConfig, ranks, n_real: int) -> dict:
    """The selection half of :func:`_assemble_ranks`: index sets, shifts,
    masks, counts and the parked subdomain buffers, stacked along a leading
    rank axis (no neighbour list yet)."""
    n = coords_all.shape[0]
    dev = coords_all.device
    box = torch.as_tensor(box, dtype=F32, device=dev)
    valid = (torch.arange(n, device=dev) < n_real) if n_real != n else None
    table = (bin_atoms(coords_all, box, cfg.cell_dims, cfg.cell_capacity,
                       valid=valid) if cfg.nbr_method == "cells" else None)
    cols = {k: [] for k in ("l_idx", "l_mask", "local_count", "g_idx",
                            "g_shift", "g_mask", "ghost_count", "sel_ovf",
                            "buf_coords", "buf_types", "buf_mask", "origin")}
    for rank in ranks:
        (l_idx, l_mask, l_count, g_idx, g_shift_vec, g_mask, g_count,
         sel_ovf) = _select_rank(coords_all, box, grid, cfg, rank, valid,
                                 table)
        # integer image shifts: exact multiples of the box
        g_shift = torch.round(g_shift_vec / box).to(torch.int32)
        li, gi = l_idx.long(), g_idx.long()
        buf_mask = torch.cat([l_mask, g_mask]).to(coords_all.dtype)
        buf = torch.cat([coords_all[li], coords_all[gi] + g_shift_vec])
        lo, _ = grid.bounds(rank)
        for key, val in (("l_idx", l_idx), ("l_mask", l_mask),
                         ("local_count", l_count), ("g_idx", g_idx),
                         ("g_shift", g_shift), ("g_mask", g_mask),
                         ("ghost_count", g_count), ("sel_ovf", sel_ovf),
                         ("buf_coords", _park(buf, buf_mask, box)),
                         ("buf_types", torch.cat([types_all[li],
                                                  types_all[gi]])),
                         ("buf_mask", buf_mask),
                         ("origin", lo - torch.tensor(cfg.halo_eff, dtype=F32,
                                                      device=dev))):
            cols[key].append(val)
    return {k: torch.stack(v) for k, v in cols.items()}


def _rank_lists(st: dict, cfg: DDConfig, rcut: float) -> dict:
    """The list half of :func:`_assemble_ranks`: the subdomain neighbour
    lists of every stacked buffer in ``st`` (one ``cell_filter`` launch for
    all of them, whichever replicas and ranks they belong to) and the
    overflow flags."""
    r_list = rcut + cfg.skin
    if cfg.nbr_method == "cells":
        nbr_idx, nbr_take, nbr_overflow = _subdomain_nbr_list_cells(
            st["buf_coords"], st["buf_mask"], r_list, cfg.nbr_capacity,
            origin=st["origin"], dims=cfg.subcell_dims,
            cell_capacity=cfg.subcell_capacity)
    else:
        nbr_idx, nbr_take, nbr_overflow = _subdomain_nbr_list(
            st["buf_coords"], st["buf_mask"], r_list, cfg.nbr_capacity)
    overflow = (nbr_overflow | st.pop("sel_ovf")
                | (st["local_count"] > cfg.local_capacity)
                | (st["ghost_count"] > cfg.ghost_capacity))
    del st["origin"]
    st.update(nbr_idx=nbr_idx, nbr_mask=nbr_take.to(st["buf_coords"].dtype),
              overflow=overflow)
    return st


def _assemble_rank(coords_all, types_all, box, grid: VirtualGrid,
                   cfg: DDConfig, rcut: float, rank: int, n_real: int) -> dict:
    """Assembly phase for one rank (the JAX function's outputs: index sets,
    shifts, masks, buffer, neighbour list, counts, overflow)."""
    st = _assemble_ranks(coords_all, types_all, box, grid, cfg, rcut,
                         [int(rank)], n_real)
    st.pop("buf_coords")
    return {k: v[0] for k, v in st.items()}


def _pad_types(types: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Pad the type array to the rank-multiple atom count (type 0)."""
    n = types.shape[0]
    if n == n_pad:
        return types
    return torch.cat([types, torch.zeros(n_pad - n, dtype=types.dtype,
                                         device=types.device)])


def _pad_atoms(coords: torch.Tensor, n_pad: int, box, types=None):
    """Pad the atom axis to a rank multiple; padding is parked far below the
    box at distinct, deterministic positions."""
    n = coords.shape[0]
    if n == n_pad:
        return (coords, types) if types is not None else coords
    box = torch.as_tensor(box, dtype=coords.dtype, device=coords.device)
    park = -(box.max() * (2.0 + torch.arange(n_pad - n, dtype=coords.dtype,
                                             device=coords.device)))
    out = torch.cat([coords, park[:, None].expand(n_pad - n, 3)])
    if types is None:
        return out
    return out, _pad_types(types, n_pad)


def _make_grid(coords_all, box, cfg: DDConfig, n_real: int) -> VirtualGrid:
    """Planes from the real atoms only (padding would skew quantiles)."""
    return _build_grid(coords_all[:n_real], box, cfg.grid_dims, cfg.halo_eff,
                       cfg.balanced, cfg.rebalance)


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
    request padded to ``n_max`` (its own types and box); padding atoms take
    part in nothing.  The lists are built row by row; the B rows then go
    through the model as one (B*n_max)-atom batch (offset neighbour ids,
    each row's box on its atoms), so each model kernel launches once per
    dispatch whatever B."""
    rcut = model.cfg.descriptor.rcut

    def fn(params, coords, types, mask, box):
        b, n = coords.shape[:2]
        if n != n_max:
            raise ValueError(f"rows hold {n} atoms, bucket is {n_max}")
        lists = [masked_neighbor_list(c, bx, rcut, nbr_capacity, m)
                 for c, bx, m in zip(coords, box, mask)]
        idx = torch.stack([nl[0] for nl in lists])
        nmask = torch.stack([nl[1] for nl in lists])
        box_rows = box[:, None, None, :].expand(b, n, 1, 3).reshape(
            b * n, 1, 3)
        e, f = model.energy_and_forces_batched(params, coords, types, idx,
                                               nmask, mask, box=box_rows)
        return e, f * mask[..., None], torch.stack([nl[2] for nl in lists])

    return fn


def _with_replicas(coords):
    """(``coords`` with a leading replica axis, whether one was added)."""
    return (coords[None], True) if coords.dim() == 2 else (coords, False)


def _single_domain_call(model: DPModel, params, xs, types, box, idx, mask,
                        one: bool):
    """One batched model call over the replicas of ``xs`` (R, N, 3) with
    their lists (R, N, K): each replica's atoms all local.  ``one`` drops
    the replica axis again (R = 1 is the unbatched call's layout and bits)."""
    local = torch.ones(xs.shape[:2], dtype=xs.dtype, device=xs.device)
    e, f = model.energy_and_forces_batched(params, xs, types, idx, mask,
                                           local, box=box)
    return (e[0], f[0]) if one else (e, f)


def single_domain_forces(model: DPModel, params, coords, types, box,
                         nbr_capacity: int):
    """Reference path: one domain, PBC minimum image (stock-NNPot analogue).
    ``coords`` is (N, 3), or (R, N, 3) for R replicas -> (energy (R,),
    forces (R, N, 3)) through one model call (lists built per replica)."""
    box = torch.as_tensor(box, dtype=coords.dtype, device=coords.device)
    xs, one = _with_replicas(coords)
    lists = [brute_force_neighbor_list(c, box, model.cfg.descriptor.rcut,
                                       nbr_capacity) for c in xs]
    return _single_domain_call(model, params, xs, types, box,
                               torch.stack([nl.idx for nl in lists]),
                               torch.stack([nl.mask for nl in lists]), one)


single_domain_forces_batched = single_domain_forces  # the (R, N, 3) name


def single_domain_state(model: DPModel, coords, box, nbr_capacity: int,
                        skin: float) -> NeighborList:
    """Assembly phase: a full skin-widened list (its ``ref_positions`` are
    the reuse reference); for (R, N, 3) ``coords`` the replicas' lists
    stacked (every field with a leading replica axis)."""
    box = torch.as_tensor(box, dtype=coords.dtype, device=coords.device)
    xs, one = _with_replicas(coords)
    lists = [brute_force_neighbor_list(c, box,
                                       model.cfg.descriptor.rcut + skin,
                                       nbr_capacity) for c in xs]
    return lists[0] if one else stack_neighbor_lists(lists)


def refilter_mask(coords, box, rcut: float, idx, mask):
    """``mask`` kept only at the slots within ``rcut`` at ``coords``:
    (R, N, 3) positions, (R, N, K) list."""
    safe = torch.where(idx >= 0, idx, torch.zeros_like(idx)).long()
    nbr = torch.gather(coords, 1, safe.reshape(len(coords), -1, 1)
                       .expand(-1, -1, 3)).reshape(*safe.shape, 3)
    dr = minimum_image(nbr - coords[:, :, None, :], box)
    return mask * ((dr * dr).sum(-1) < rcut ** 2)


def single_domain_forces_nlist(model: DPModel, params, coords, types, box,
                               nlist: NeighborList):
    """Evaluation phase: reuse a (possibly stale) skin-widened list,
    re-filtered to the exact cutoff at the current positions.  ``coords``
    (N, 3) with its list, or (R, N, 3) with a stacked one."""
    box = torch.as_tensor(box, dtype=coords.dtype, device=coords.device)
    xs, one = _with_replicas(coords)
    idx, mask = ((nlist.idx[None], nlist.mask[None]) if one
                 else (nlist.idx, nlist.mask))
    mask = refilter_mask(xs, box, model.cfg.descriptor.rcut, idx, mask)
    return _single_domain_call(model, params, xs, types, box, idx, mask, one)


# ---------------------------------------------------------------------------
# Replica-batched functions: warn-once shims over the pipeline's replica
# transform (``ForcePipeline(..., n_replicas=R)``), as in the reference.
# ``mesh`` is passed through: None (replicas and ranks are virtual axes of
# one device), or the 2-D ``launch.mesh.EnsembleMesh`` of
# ``ensemble.make_ensemble_mesh`` (replicas sharded over its leading axis,
# ranks over its trailing one); a 1-D ``launch.mesh.DDMesh`` runs one
# trajectory and refuses replicas.
# ---------------------------------------------------------------------------

_DEPRECATION_WARNED: set = set()


def _warn_shim(old: str, new: str) -> None:
    if old in _DEPRECATION_WARNED:
        return
    _DEPRECATION_WARNED.add(old)
    warnings.warn(
        f"repro_torch.core.ddinfer.{old} is a deprecation shim over "
        f"repro_torch.core.pipeline.ForcePipeline.{new}(); build a "
        "ForcePipeline(..., n_replicas=R) instead", DeprecationWarning,
        stacklevel=3)


def _pipeline(model, cfg: DDConfig, mesh, box, n_atoms: int,
              n_replicas: int):
    from .pipeline import ForcePipeline     # pipeline imports this module
    return ForcePipeline(model, cfg, box, n_atoms, n_replicas=n_replicas,
                         mesh=mesh)


def make_batched_assembly_fn(model: DPModel, cfg: DDConfig, mesh, box,
                             n_atoms: int, n_replicas: int):
    """Deprecation shim: replica-batched ``build_assembly_fn()``:
    f(coords (R, N, 3), types (N,)) -> DDState whose every leaf carries a
    leading replica axis."""
    _warn_shim("make_batched_assembly_fn", "build_assembly_fn")
    return _pipeline(model, cfg, mesh, box, n_atoms,
                     n_replicas).build_assembly_fn()


def make_batched_evaluation_fn(model: DPModel, cfg: DDConfig, mesh, box,
                               n_atoms: int, n_replicas: int):
    """Deprecation shim: replica-batched ``build_evaluation_fn()``:
    f(params, coords (R, N, 3), state) -> (energy (R,), forces (R, N, 3),
    diag of (R,) leaves)."""
    _warn_shim("make_batched_evaluation_fn", "build_evaluation_fn")
    return _pipeline(model, cfg, mesh, box, n_atoms,
                     n_replicas).build_evaluation_fn()


def make_batched_check_fn(cfg: DDConfig, mesh, box, n_atoms: int,
                          n_replicas: int):
    """Deprecation shim: replica-batched ``build_check_fn()``:
    f(coords (R, N, 3), state) -> (R,) bool per-replica rebuild flags."""
    _warn_shim("make_batched_check_fn", "build_check_fn")
    return _pipeline(None, cfg, mesh, box, n_atoms,
                     n_replicas).build_check_fn()


def make_batched_force_fn(model: DPModel, cfg: DDConfig, mesh, box,
                          n_atoms: int, n_replicas: int):
    """Deprecation shim: replica-batched ``build_force_fn()`` (fused
    per-step assembly + evaluation): f(params, coords (R, N, 3),
    types (N,)) -> (energy (R,), forces (R, N, 3), diag of (R,) leaves)."""
    _warn_shim("make_batched_force_fn", "build_force_fn")
    return _pipeline(model, cfg, mesh, box, n_atoms,
                     n_replicas).build_force_fn()
