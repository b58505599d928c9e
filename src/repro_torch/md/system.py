"""Molecular system description: atoms, topology, box.

Port of ``repro/md/system.py``: a ``System`` carries everything the
classical force field and the NNPot special-force hook need, as
fixed-shape tensors on one device (the engine runs on the device of its
``System``).  The ``build_*`` functions draw from
``np.random.default_rng(seed)`` on the host, so their arrays equal the JAX
package's bit for bit.

Units (GROMACS convention):
  length nm, time ps, energy kJ/mol, mass amu, charge e.
  kB = 0.00831446261815324 kJ/(mol K).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device

KB = 0.00831446261815324  # kJ/(mol K)
COULOMB = 138.935458  # kJ mol^-1 nm e^-2  (1/(4 pi eps0))

# water points per pass of the carve-out in build_solvated_protein: bounds
# its (points, protein sites) float64 blocks to ~32 MB each at 3,917
# residues, where the one-block form would take 4.4 GB
CARVE_CHUNK = 1024


@dataclasses.dataclass(frozen=True)
class Topology:
    """Bonded topology with fixed-capacity index tensors.

    ``bonds``  (B, 2) int32 atom indices, ``bond_params`` (B, 2) = (r0, k)
    ``angles`` (A, 3) int32,  ``angle_params`` (A, 2) = (theta0, k)
    ``dihedrals`` (D, 4) int32, ``dihedral_params`` (D, 3) = (phi0, k, mult)
    ``exclusions`` (N, EMAX) int32 padded with -1: short-range-excluded
    partners per atom (bonded 1-2/1-3 pairs plus the NNPot group).
    Masks are float {0,1} so removed entries contribute nothing.
    """

    bonds: torch.Tensor
    bond_params: torch.Tensor
    bond_mask: torch.Tensor
    angles: torch.Tensor
    angle_params: torch.Tensor
    angle_mask: torch.Tensor
    dihedrals: torch.Tensor
    dihedral_params: torch.Tensor
    dihedral_mask: torch.Tensor
    exclusions: torch.Tensor  # (N, EMAX) int32, -1 padded

    @property
    def n_bonds(self) -> int:
        return self.bonds.shape[0]


@dataclasses.dataclass(frozen=True)
class System:
    """Complete simulation system (static description, not dynamic state)."""

    box: torch.Tensor         # (3,) orthorhombic box lengths [nm]
    types: torch.Tensor       # (N,) int32 species index
    masses: torch.Tensor      # (N,) float
    charges: torch.Tensor     # (N,) float [e]
    lj_sigma: torch.Tensor    # (T,) per-type sigma [nm]
    lj_epsilon: torch.Tensor  # (T,) per-type epsilon [kJ/mol]
    topology: Topology
    nn_mask: torch.Tensor     # (N,) float {0,1}: 1 = NNPot ("DP group") atom

    @property
    def n_atoms(self) -> int:
        return self.types.shape[0]

    @property
    def n_types(self) -> int:
        return self.lj_sigma.shape[0]

    @property
    def device(self) -> torch.device:
        return self.box.device


def _t(a, dev) -> torch.Tensor:
    """A numpy array as a tensor on ``dev``, dtype kept."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _pad_rows(rows: list[list[int]], width: int, n: int) -> np.ndarray:
    out = np.full((n, width), -1, dtype=np.int32)
    for i, r in enumerate(rows):
        r = sorted(set(r))[:width]
        out[i, : len(r)] = r
    return out


def build_exclusions(n_atoms: int, bonds: np.ndarray, angles: np.ndarray,
                     extra_pairs: Optional[np.ndarray] = None,
                     width: int = 16) -> np.ndarray:
    """1-2 and 1-3 exclusions (GROMACS default nrexcl-ish) + extra pairs."""
    rows: list[list[int]] = [[] for _ in range(n_atoms)]

    def add(i, j):
        if i != j:
            rows[int(i)].append(int(j))
            rows[int(j)].append(int(i))

    for i, j in bonds:
        add(i, j)
    for i, j, k in angles:
        add(i, j), add(j, k), add(i, k)
    if extra_pairs is not None:
        for i, j in extra_pairs:
            add(i, j)
    return _pad_rows(rows, width, n_atoms)


def mark_nn_group(system: System, nn_indices: np.ndarray,
                  exclude_within_group: bool = True) -> System:
    """NNPot preprocessing (paper Sec. IV-A).

    Marked ("NN") atoms lose their bonded interactions, and pairs *within*
    the group are added to the exclusion lists so no short-range classical
    interaction is double counted against the Deep Potential.  Long-range
    Coulomb is left untouched.  The result lies on the system's device.
    """
    dev = system.device
    nn_indices = np.asarray(nn_indices, dtype=np.int32)
    nn_mask = np.zeros(system.n_atoms, dtype=np.float32)
    nn_mask[nn_indices] = 1.0
    in_group = lambda idx: nn_mask[np.asarray(idx)].all(axis=-1)

    top = system.topology
    bond_mask = _np(top.bond_mask) * (1.0 - in_group(_np(top.bonds)))
    angle_mask = _np(top.angle_mask) * (1.0 - in_group(_np(top.angles)))
    dih_mask = _np(top.dihedral_mask) * (1.0 - in_group(_np(top.dihedrals)))

    exclusions = _np(top.exclusions)
    if exclude_within_group and len(nn_indices) > 1:
        # the table holds the full NN-NN clique only for small groups; for
        # big ones the force field masks on nn_mask[i]*nn_mask[j] (always on)
        width = max(exclusions.shape[1], min(len(nn_indices) - 1 + 8, 64))
        if len(nn_indices) <= width:
            rows = [[int(x) for x in row if x >= 0] for row in exclusions]
            for i in nn_indices:
                rows[int(i)].extend(int(j) for j in nn_indices if j != i)
            exclusions = _pad_rows(rows, width, system.n_atoms)

    return dataclasses.replace(
        system,
        nn_mask=_t(nn_mask, dev),
        topology=dataclasses.replace(
            top,
            bond_mask=_t(bond_mask.astype(np.float32), dev),
            angle_mask=_t(angle_mask.astype(np.float32), dev),
            dihedral_mask=_t(dih_mask.astype(np.float32), dev),
            exclusions=_t(exclusions, dev),
        ),
    )


# ---------------------------------------------------------------------------
# Systems: water box and model "protein" chains (1YRF / 1HCI stand-ins).
# ---------------------------------------------------------------------------

def build_water_box(n_side: int, spacing: float = 0.31, device="cuda"):
    """Cubic lattice of single-site "water" (OPC-like LJ, no charge).
    Returns (System, positions (N, 3) float32)."""
    dev = resolve_device(device)
    n = n_side ** 3
    box = np.array([n_side * spacing] * 3, dtype=np.float32)
    grid = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"), -1)
    pos = ((grid.reshape(-1, 3) + 0.5) * spacing).astype(np.float32)
    sys_ = System(
        box=_t(box, dev), types=_t(np.zeros(n, np.int32), dev),
        masses=_t(np.full(n, 18.015, np.float32), dev),
        charges=_t(np.zeros(n, np.float32), dev),
        lj_sigma=_t(np.array([0.3166], np.float32), dev),
        lj_epsilon=_t(np.array([0.6502], np.float32), dev),
        topology=empty_topology(n, device=dev),
        nn_mask=torch.zeros(n, dtype=torch.float32, device=dev),
    )
    return sys_, _t(pos, dev)


def empty_topology(n_atoms: int, width: int = 16, device="cuda") -> Topology:
    dev = resolve_device(device)
    z2 = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    zi = lambda *s: torch.zeros(s, dtype=torch.int32, device=dev)
    return Topology(
        bonds=zi(1, 2), bond_params=z2(1, 2), bond_mask=z2(1),
        angles=zi(1, 3), angle_params=z2(1, 2), angle_mask=z2(1),
        dihedrals=zi(1, 4), dihedral_params=z2(1, 3), dihedral_mask=z2(1),
        exclusions=torch.full((n_atoms, width), -1, dtype=torch.int32,
                              device=dev),
    )


def build_protein_chain(n_residues: int, seed: int = 0,
                        atoms_per_residue: int = 4) -> dict:
    """Self-avoiding helical backbone chain used as the protein stand-in.

    Returns numpy arrays (positions, types, masses, charges, bonds, angles)
    for splicing into a solvated system.  ~4 atoms/residue; 1YRF (582 atoms)
    ~ 146 residues, 1HCI (15,668 atoms) ~ 3,917 residues.
    """
    rng = np.random.default_rng(seed)
    n = n_residues * atoms_per_residue
    t = np.arange(n) * 0.6
    radius = 0.25
    pos = np.stack([
        radius * np.cos(t),
        radius * np.sin(t),
        0.05 * np.arange(n),
    ], -1) + rng.normal(0, 0.01, (n, 3))
    pos = pos.astype(np.float32)
    types = (np.arange(n) % 3 + 1).astype(np.int32)  # species 1..3 (0 = water)
    masses = np.array([12.011, 14.007, 15.999])[types - 1].astype(np.float32)
    charges = (rng.uniform(-0.3, 0.3, n)).astype(np.float32)
    charges -= charges.mean()  # neutral group
    bonds = np.stack([np.arange(n - 1), np.arange(1, n)], -1).astype(np.int32)
    angles = np.stack([np.arange(n - 2), np.arange(1, n - 1),
                       np.arange(2, n)], -1).astype(np.int32)
    return dict(positions=pos, types=types, masses=masses, charges=charges,
                bonds=bonds, angles=angles)


def _carve_keep(wpos: np.ndarray, sites: np.ndarray) -> np.ndarray:
    """Water points farther than 0.25 nm from every protein site: the JAX
    package's ``((w[:, None] - s[None]) ** 2).sum(-1).min(1) > 0.25 ** 2``
    over chunks of CARVE_CHUNK points, the three squares added as numpy's
    sum over that axis adds them, ``(x^2 + y^2) + z^2`` in float64.  Each
    point's row is the one-block computation's, and a minimum is exact in
    any order, so the mask is the one-block mask bit for bit."""
    d2 = []
    for i in range(0, len(wpos), CARVE_CHUNK):
        d = [wpos[i:i + CARVE_CHUNK, None, a] - sites[None, :, a]
             for a in range(3)]
        d2.append(((d[0] ** 2 + d[1] ** 2) + d[2] ** 2).min(1))
    return np.concatenate(d2) > 0.25 ** 2


def build_solvated_protein(n_residues: int, water_per_protein_atom: float = 3.0,
                           seed: int = 0, spacing: float = 0.31,
                           device="cuda"):
    """Protein chain + surrounding water lattice, the paper's test scenario.

    Returns (System, positions, nn_indices).  The protein occupies species
    1..3; water is species 0.  NN group (DP group) = the protein, as in the
    paper (Tab. II, "DP Group: Protein").
    """
    dev = resolve_device(device)
    prot = build_protein_chain(n_residues, seed)
    n_prot = len(prot["positions"])
    n_wat_target = int(n_prot * water_per_protein_atom)
    n_side = max(4, int(round(n_wat_target ** (1 / 3))))

    extent = prot["positions"].max(0) - prot["positions"].min(0)
    box = np.maximum(extent + 2.0, n_side * spacing).astype(np.float32)

    grid = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"), -1)
    wpos = (grid.reshape(-1, 3) + 0.5) * (box / n_side)
    center = box / 2
    ppos = prot["positions"] - prot["positions"].mean(0) + center
    wpos = wpos[_carve_keep(wpos, ppos[::4])]
    n_wat = len(wpos)

    positions = np.concatenate([ppos, wpos]).astype(np.float32)
    n = len(positions)
    types = np.concatenate([prot["types"], np.zeros(n_wat, np.int32)])
    masses = np.concatenate([prot["masses"], np.full(n_wat, 18.015, np.float32)])
    charges = np.concatenate([prot["charges"], np.zeros(n_wat, np.float32)])
    bonds, angles = prot["bonds"], prot["angles"]
    excl = build_exclusions(n, bonds, angles)

    topo = Topology(
        bonds=_t(bonds, dev),
        bond_params=_t(np.tile([0.15, 25000.0], (len(bonds), 1))
                       .astype(np.float32), dev),
        bond_mask=torch.ones(len(bonds), dtype=torch.float32, device=dev),
        angles=_t(angles, dev),
        angle_params=_t(np.tile([1.91, 300.0], (len(angles), 1))
                        .astype(np.float32), dev),
        angle_mask=torch.ones(len(angles), dtype=torch.float32, device=dev),
        dihedrals=torch.zeros((1, 4), dtype=torch.int32, device=dev),
        dihedral_params=torch.zeros((1, 3), dtype=torch.float32, device=dev),
        dihedral_mask=torch.zeros(1, dtype=torch.float32, device=dev),
        exclusions=_t(excl, dev),
    )
    system = System(
        box=_t(box, dev),
        types=_t(types, dev), masses=_t(masses, dev), charges=_t(charges, dev),
        lj_sigma=_t(np.array([0.3166, 0.34, 0.325, 0.296], np.float32), dev),
        lj_epsilon=_t(np.array([0.6502, 0.36, 0.71, 0.88], np.float32), dev),
        topology=topo,
        nn_mask=torch.zeros(n, dtype=torch.float32, device=dev),
    )
    nn_indices = np.arange(n_prot, dtype=np.int32)
    return system, _t(positions, dev), nn_indices
