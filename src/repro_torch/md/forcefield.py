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

Replica batching (:func:`replicate_system`, :func:`classical_forces_batched`)
lays R replicas out as one (R*N)-atom system whose atom ids are offset by
r*N, as JAX's ``vmap`` effectively does: each gather, and so each force
scatter, launches once per call for all replicas, and each atom's force
still sums its own replica's slots in the same ascending order.  The
energies reduce per replica (``rep``), each replica's terms as one run's,
and the dihedral angle's ``atan2`` runs per replica (PyTorch's CPU
``atan2`` rounds an element by its position in the vector loop; every
other elementwise op here gives the same bits at any position).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..kernels.force_scatter import neighbor_gather
from .neighbors import NeighborList, minimum_image
from .system import COULOMB, System, Topology


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


def _rsum(x, rep=None):
    """``x.sum()``, or with ``rep`` replicas laid out along the leading
    axis, the (rep,) sums of each replica's block (each block summed as an
    unbatched run sums its whole array)."""
    if rep is None:
        return x.sum()
    return torch.stack([b.sum() for b in x.reshape(rep, -1, *x.shape[1:])])


def bond_energy(pos, box, bonds, params, mask, rep=None):
    p = _gather_terms(pos, bonds, mask)
    dr = minimum_image(p[:, 1] - p[:, 0], box)
    # double-where: masked (padded) entries see a safe r so the backward pass
    # never differentiates sqrt at 0 (NaN * 0 == NaN in the cotangent).
    r2 = torch.where(mask > 0, (dr ** 2).sum(-1), 1.0)
    r = torch.sqrt(r2)
    r0, k = params[:, 0], params[:, 1]
    return _rsum(0.5 * k * (r - r0) ** 2 * mask, rep)


def angle_energy(pos, box, angles, params, mask, rep=None):
    p = _gather_terms(pos, angles, mask)
    v1 = minimum_image(p[:, 0] - p[:, 1], box)
    v2 = minimum_image(p[:, 2] - p[:, 1], box)
    nn = (v1 ** 2).sum(-1) * (v2 ** 2).sum(-1)
    cos = (v1 * v2).sum(-1) / torch.sqrt(torch.where(mask > 0, nn, 1.0))
    theta = torch.arccos(torch.clamp(cos, -1 + 1e-7, 1 - 1e-7))
    t0, k = params[:, 0], params[:, 1]
    return _rsum(0.5 * k * (theta - t0) ** 2 * mask, rep)


def dihedral_energy(pos, box, dihedrals, params, mask, rep=None):
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
    if rep is None:
        phi = torch.atan2(y, x)
    else:
        phi = torch.cat([torch.atan2(a, b) for a, b in
                         zip(y.reshape(rep, -1), x.reshape(rep, -1))])
    phi0, k, mult = params[:, 0], params[:, 1], params[:, 2]
    return _rsum(k * (1 + torch.cos(mult * phi - phi0)) * mask, rep)


def bonded_energy(pos, box, topology, rep=None) -> torch.Tensor:
    t = topology
    return (bond_energy(pos, box, t.bonds, t.bond_params, t.bond_mask, rep)
            + angle_energy(pos, box, t.angles, t.angle_params, t.angle_mask,
                           rep)
            + dihedral_energy(pos, box, t.dihedrals, t.dihedral_params,
                              t.dihedral_mask, rep))


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


def _lj(system: System, safe, r2, mask, cutoff: float, half: bool,
        rep=None):
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
    total = _rsum(e * mask, rep)
    return total if half else 0.5 * total


def lj_energy(pos: torch.Tensor, system: System, nlist: NeighborList,
              cutoff: float, half: bool) -> torch.Tensor:
    return _lj(system, *_pairs(pos, system, nlist, cutoff), cutoff, half)


def _coulomb(system: System, safe, r2, mask, cfg: ForceFieldConfig,
             half: bool, rep=None):
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
    total = _rsum(e * mask, rep)
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
                     cfg: ForceFieldConfig, half: bool = True,
                     rep=None) -> torch.Tensor:
    """E (), or with ``rep`` (a :func:`replicate_system` layout of ``rep``
    replicas) the per-replica energies (rep,)."""
    e = bonded_energy(pos, system.box, system.topology, rep)
    pairs = _pairs(pos, system, nlist, cfg.cutoff)
    e = e + _lj(system, *pairs, cfg.cutoff, half, rep)
    e = e + _coulomb(system, *pairs, cfg, half, rep)
    if cfg.use_pme:
        from .pme import pme_reciprocal_energy
        n = pos.shape[0] // (rep or 1)
        recip = [pme_reciprocal_energy(p, q, system.box, cfg.pme_grid,
                                       cfg.pme_order, cfg.ewald_beta)
                 for p, q in zip(pos.reshape(-1, n, 3),
                                 system.charges.reshape(-1, n))]
        e = e + (recip[0] if rep is None else torch.stack(recip))
        # Ewald self-energy
        e = e - (COULOMB * cfg.ewald_beta / math.sqrt(math.pi)
                 * _rsum(system.charges ** 2, rep))
    return e


def classical_forces(pos, system, nlist, cfg, half: bool = True):
    """(E, F = -dE/dr), both detached: no graph outlives the call."""
    with torch.enable_grad():
        p = pos.detach().requires_grad_(True)
        e = classical_energy(p, system, nlist, cfg, half)
        (g,) = torch.autograd.grad(e, p)
    return e.detach(), -g


def replicate_system(system: System, n_rep: int) -> System:
    """R replicas of ``system`` as one (R*N)-atom system: per-atom arrays
    tiled, every topology table and the exclusions offset by r*N (their -1
    padding kept)."""
    n = system.n_atoms
    dev = system.box.device

    def tile(t):
        return t.repeat(n_rep, *([1] * (t.dim() - 1)))

    def offset(t):
        off = (torch.arange(n_rep, device=dev, dtype=t.dtype) * n).reshape(
            n_rep, *([1] * t.dim()))
        big = t[None].expand(n_rep, *t.shape)
        return torch.where(big >= 0, big + off, big).reshape(-1,
                                                              *t.shape[1:])

    t = system.topology
    topo = Topology(bonds=offset(t.bonds), bond_params=tile(t.bond_params),
                    bond_mask=tile(t.bond_mask), angles=offset(t.angles),
                    angle_params=tile(t.angle_params),
                    angle_mask=tile(t.angle_mask),
                    dihedrals=offset(t.dihedrals),
                    dihedral_params=tile(t.dihedral_params),
                    dihedral_mask=tile(t.dihedral_mask),
                    exclusions=offset(t.exclusions))
    return dataclasses.replace(system, types=tile(system.types),
                               masses=tile(system.masses),
                               charges=tile(system.charges),
                               nn_mask=tile(system.nn_mask), topology=topo)


def flatten_nlist(nlist: NeighborList) -> NeighborList:
    """A batched list (R, N, K) as one list over the (R*N)-atom layout of
    :func:`replicate_system` (neighbour ids offset by r*N)."""
    r, n, k = nlist.idx.shape
    off = (torch.arange(r, device=nlist.idx.device,
                        dtype=nlist.idx.dtype) * n)[:, None, None]
    idx = torch.where(nlist.idx >= 0, nlist.idx + off, nlist.idx)
    return NeighborList(idx=idx.reshape(r * n, k),
                        mask=nlist.mask.reshape(r * n, k),
                        ref_positions=nlist.ref_positions.reshape(r * n, 3),
                        overflow=nlist.overflow.any())


def classical_forces_batched(pos, rep_system: System, nlist: NeighborList,
                             cfg, half: bool = True):
    """R trajectories at once: ``pos`` (R, N, 3), ``rep_system`` from
    :func:`replicate_system`, ``nlist`` batched (R, N, K).  Returns
    (E (R,), F (R, N, 3)), both detached; each gather and force scatter
    launches once for all replicas."""
    r, n, _ = pos.shape
    flat = flatten_nlist(nlist)
    with torch.enable_grad():
        p = pos.detach().reshape(r * n, 3).requires_grad_(True)
        e = classical_energy(p, rep_system, flat, cfg, half, rep=r)
        (g,) = torch.autograd.grad(e.sum(), p)
    return e.detach(), -g.reshape(r, n, 3)
