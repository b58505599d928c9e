"""Classical force field: bonded terms, LJ, Coulomb (reaction field / PME).

Port of ``repro/md/forcefield.py``.  This is the empirical-force-field
baseline the paper compares the Deep Potential against (Eq. 1): E =
E_bonded + E_sr + E_lr.  Energies are pure functions of positions, so
forces come from ``torch.autograd.grad``, the same conservative-forces
contract the DP model uses (Eq. 2).

Every position gather goes through
:func:`repro_torch.kernels.force_scatter.neighbor_gather` (the neighbour
list's ``pos[idx]`` with the list's mask, the bonded ``pos[bonds]``,
``pos[angles]`` and ``pos[dihedrals]`` with the topology's masks), so the
gathers' backward is the force scatter: ascending slot order, the same bits
on the card and the CPU, on every repeat and at any list capacity, and no
pile-up of the padded slots on atom 0.  The scatter skips the masked slots;
the double-``where`` guards below make their cotangent exactly 0, so the
sums are those of the full scatter.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..kernels.force_scatter import neighbor_gather
from .neighbors import NeighborList, minimum_image
from .system import COULOMB, System


@dataclasses.dataclass(frozen=True)
class ForceFieldConfig:
    cutoff: float = 1.2             # nm (paper Tab. II: r_c = 1.2 EM/NVT/NPT)
    use_reaction_field: bool = True  # RF correction for cutoff Coulomb
    eps_rf: float = 78.5            # solvent dielectric for RF
    use_pme: bool = False           # long-range via smooth PME (md/pme.py)
    pme_grid: tuple = (32, 32, 32)
    pme_order: int = 4
    ewald_beta: float = 3.12        # 1/nm; erfc(beta*rc) ~ 1e-5 at rc=1.2


# ---------------------------------------------------------------------------
# Bonded terms
# ---------------------------------------------------------------------------

def _gather_terms(pos, table, mask):
    """``pos[table]`` (T, W, 3) for an index table (T, W), each term's mask
    on all its slots: masked terms add nothing to the forces."""
    return neighbor_gather(pos, table, mask[:, None].expand(table.shape))


def bond_energy(pos, box, bonds, params, mask):
    p = _gather_terms(pos, bonds, mask)
    dr = minimum_image(p[:, 1] - p[:, 0], box)
    # double-where: masked (padded) entries see a safe r so the backward pass
    # never differentiates sqrt at 0 (NaN * 0 == NaN in the cotangent).
    r2 = torch.where(mask > 0, (dr ** 2).sum(-1), 1.0)
    r = torch.sqrt(r2)
    r0, k = params[:, 0], params[:, 1]
    return (0.5 * k * (r - r0) ** 2 * mask).sum()


def angle_energy(pos, box, angles, params, mask):
    p = _gather_terms(pos, angles, mask)
    v1 = minimum_image(p[:, 0] - p[:, 1], box)
    v2 = minimum_image(p[:, 2] - p[:, 1], box)
    nn = (v1 ** 2).sum(-1) * (v2 ** 2).sum(-1)
    cos = (v1 * v2).sum(-1) / torch.sqrt(torch.where(mask > 0, nn, 1.0))
    theta = torch.arccos(torch.clamp(cos, -1 + 1e-7, 1 - 1e-7))
    t0, k = params[:, 0], params[:, 1]
    return (0.5 * k * (theta - t0) ** 2 * mask).sum()


def dihedral_energy(pos, box, dihedrals, params, mask):
    """Periodic proper dihedral: k (1 + cos(mult*phi - phi0))."""
    p = _gather_terms(pos, dihedrals, mask)
    b1 = minimum_image(p[:, 1] - p[:, 0], box)
    b2 = minimum_image(p[:, 2] - p[:, 1], box)
    b3 = minimum_image(p[:, 3] - p[:, 2], box)
    n1 = torch.linalg.cross(b1, b2)
    n2 = torch.linalg.cross(b2, b3)
    nb2 = torch.sqrt(torch.where(mask > 0, (b2 ** 2).sum(-1), 1.0))[:, None]
    m1 = torch.linalg.cross(n1, b2 / nb2)
    x = torch.where(mask > 0, (n1 * n2).sum(-1), 1.0)
    y = torch.where(mask > 0, (m1 * n2).sum(-1), 0.0)
    phi = torch.atan2(y, x)
    phi0, k, mult = params[:, 0], params[:, 1], params[:, 2]
    return (k * (1 + torch.cos(mult * phi - phi0)) * mask).sum()


def bonded_energy(pos, box, topology) -> torch.Tensor:
    t = topology
    return (bond_energy(pos, box, t.bonds, t.bond_params, t.bond_mask)
            + angle_energy(pos, box, t.angles, t.angle_params, t.angle_mask)
            + dihedral_energy(pos, box, t.dihedrals, t.dihedral_params,
                              t.dihedral_mask))


# ---------------------------------------------------------------------------
# Non-bonded short range (neighbor-list driven)
# ---------------------------------------------------------------------------

def _safe(idx):
    return torch.where(idx >= 0, idx, 0)


def _pair_mask(system: System, nlist: NeighborList) -> torch.Tensor:
    """Neighbor-list mask minus exclusions minus NN-NN pairs (NNPot contract)."""
    idx = nlist.idx
    excl = system.topology.exclusions                      # (N, E)
    excluded = (idx[:, :, None] == excl[:, None, :]).any(-1)
    nn_nn = (system.nn_mask[:, None] * system.nn_mask[_safe(idx)]) > 0.5
    return nlist.mask * (~excluded) * (~nn_nn)


def _pair_dr(pos, system: System, nlist: NeighborList):
    """Minimum-image displacements to each listed neighbour, (N, K, 3),
    ``pos[safe] - pos[:, None, :]``.  Both ends are gathered through one
    (N, 2K) table of (i, j) per slot, so the force scatter sums the
    cotangents of both in ascending slot order: the forces' bits do not
    depend on the list's capacity (padded slots add nothing, and the valid
    ones keep their order), where the broadcast's backward, a sum over K,
    groups its terms by K on the card (``chip_smoke.py``'s md phase holds
    both forms at capacities 96 to 512)."""
    n, k = nlist.idx.shape
    own = torch.arange(n, dtype=nlist.idx.dtype,
                       device=pos.device)[:, None].expand(n, k)
    table = torch.stack([own, nlist.idx], -1).reshape(n, 2 * k)
    ends = neighbor_gather(pos, table, nlist.mask.repeat_interleave(2, 1))
    ends = ends.reshape(n, k, 2, 3)
    return minimum_image(ends[:, :, 1] - ends[:, :, 0], system.box)


def _pairs(pos, system: System, nlist: NeighborList, cutoff: float):
    """(safe, r2, mask) of the listed pairs: the neighbour indices read
    safely, the squared minimum-image distances and the pair mask within
    ``cutoff``.  :func:`classical_energy` computes them once for both pair
    terms."""
    dr = _pair_dr(pos, system, nlist)
    r2 = (dr ** 2).sum(-1)
    mask = _pair_mask(system, nlist) * (r2 < cutoff ** 2)
    return _safe(nlist.idx), r2, mask


def _lj(system: System, safe, r2, mask, cutoff: float, half: bool):
    r2 = torch.where(mask > 0, r2, 1.0)

    # Lorentz-Berthelot combining rules from per-type tables.
    si = system.lj_sigma[system.types][:, None]
    sj = system.lj_sigma[system.types[safe]]
    ei = system.lj_epsilon[system.types][:, None]
    ej = system.lj_epsilon[system.types[safe]]
    sig = 0.5 * (si + sj)
    eps = torch.sqrt(ei * ej)

    sr2 = sig ** 2 / r2
    sr6 = sr2 ** 3
    e = 4.0 * eps * (sr6 ** 2 - sr6)
    # shift so E(r_c) = 0 (GROMACS potential-shift modifier)
    src6 = (sig ** 2 / cutoff ** 2) ** 3
    e = e - 4.0 * eps * (src6 ** 2 - src6)
    total = (e * mask).sum()
    return total if half else 0.5 * total


def lj_energy(pos: torch.Tensor, system: System, nlist: NeighborList,
              cutoff: float, half: bool) -> torch.Tensor:
    return _lj(system, *_pairs(pos, system, nlist, cutoff), cutoff, half)


def _coulomb(system: System, safe, r2, mask, cfg: ForceFieldConfig,
             half: bool):
    rc = cfg.cutoff
    r = torch.sqrt(torch.where(mask > 0, r2, 1.0))
    qq = system.charges[:, None] * system.charges[safe]

    if cfg.use_pme:
        # real-space Ewald term; reciprocal handled in md/pme.py
        e = COULOMB * qq * torch.special.erfc(cfg.ewald_beta * r) / r
    else:
        # reaction field: E = qq (1/r + k_rf r^2 - c_rf)
        eps = cfg.eps_rf
        k_rf = (eps - 1.0) / (2 * eps + 1.0) / rc ** 3
        c_rf = 1.0 / rc + k_rf * rc ** 2
        e = COULOMB * qq * (1.0 / r + k_rf * r2 - c_rf)
    total = (e * mask).sum()
    return total if half else 0.5 * total


def coulomb_energy(pos: torch.Tensor, system: System, nlist: NeighborList,
                   cfg: ForceFieldConfig, half: bool) -> torch.Tensor:
    """Cutoff Coulomb with reaction-field, or Ewald real-space when PME is on."""
    return _coulomb(system, *_pairs(pos, system, nlist, cfg.cutoff), cfg,
                    half)


# ---------------------------------------------------------------------------
# Total classical energy / forces
# ---------------------------------------------------------------------------

def classical_energy(pos: torch.Tensor, system: System, nlist: NeighborList,
                     cfg: ForceFieldConfig, half: bool = True) -> torch.Tensor:
    e = bonded_energy(pos, system.box, system.topology)
    pairs = _pairs(pos, system, nlist, cfg.cutoff)
    e = e + _lj(system, *pairs, cfg.cutoff, half)
    e = e + _coulomb(system, *pairs, cfg, half)
    if cfg.use_pme:
        from .pme import pme_reciprocal_energy
        e = e + pme_reciprocal_energy(pos, system.charges, system.box,
                                      cfg.pme_grid, cfg.pme_order,
                                      cfg.ewald_beta)
        # Ewald self-energy
        e = e - (COULOMB * cfg.ewald_beta / math.sqrt(math.pi)
                 * (system.charges ** 2).sum())
    return e


def classical_forces(pos, system, nlist, cfg, half: bool = True):
    """(E, F = -dE/dr), both detached: no graph outlives the call."""
    with torch.enable_grad():
        p = pos.detach().requires_grad_(True)
        e = classical_energy(p, system, nlist, cfg, half)
        (g,) = torch.autograd.grad(e, p)
    return e.detach(), -g
