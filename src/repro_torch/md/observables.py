"""Observables: temperature, kinetic/potential energy, gyration radii.

Port of ``repro/md/observables.py``.  The gyration radii about the
Cartesian axes are the paper's validation observable (Fig. 8, ``gmx
gyrate`` semantics): stable radii == no unphysical unfolding == the DD +
model coupling is correct.
"""
from __future__ import annotations

import torch

from .system import KB


def kinetic_energy(velocities, masses) -> torch.Tensor:
    return 0.5 * (masses[:, None] * velocities ** 2).sum()


def temperature(velocities, masses) -> torch.Tensor:
    ndof = velocities.numel() - 3
    return 2 * kinetic_energy(velocities, masses) / (ndof * KB)


def radius_of_gyration(pos, masses, selection=None) -> torch.Tensor:
    """Scalar Rg over a selection mask (defaults to all atoms)."""
    w = masses if selection is None else masses * selection
    com = (w[:, None] * pos).sum(0) / w.sum()
    d2 = ((pos - com) ** 2).sum(-1)
    return torch.sqrt((w * d2).sum() / w.sum())


def gyration_radii_axes(pos, masses, selection=None) -> torch.Tensor:
    """(3,) radii about x, y, z — gmx gyrate convention.

    Rg_x uses distances *perpendicular* to x (i.e. y,z components), etc.
    """
    w = masses if selection is None else masses * selection
    com = (w[:, None] * pos).sum(0) / w.sum()
    d2 = (pos - com) ** 2
    perp = torch.stack([d2[:, 1] + d2[:, 2],
                        d2[:, 0] + d2[:, 2],
                        d2[:, 0] + d2[:, 1]], dim=-1)  # (N, 3)
    return torch.sqrt((w[:, None] * perp).sum(0) / w.sum())


def com_drift(velocities, masses) -> torch.Tensor:
    return torch.linalg.norm((masses[:, None] * velocities).sum(0)
                             / masses.sum())
