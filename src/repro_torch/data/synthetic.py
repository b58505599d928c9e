"""Synthetic "solvated protein fragment" dataset with an analytic QM stand-in.

Port of ``repro/data/synthetic.py``.  The paper trains its DPA-1 on
solvated-protein-fragment DFT data, which is not fetched here: the
training system runs against an analytic many-body oracle (per-species
Morse pairs and a Stillinger-Weber-style 3-body angular term), many-body
so that the descriptor has to learn angular structure.

The geometry sampler (:func:`_fragment_positions`) is the reference's numpy
code as it is, so a seed gives the same starting frames; the oracle, its
forces (autograd) and the relaxation run in PyTorch on the caller's
device.  A :class:`Dataset` holds numpy arrays, as the reference's does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..md.neighbors import brute_force_neighbor_list


# ---------------------------------------------------------------------------
# Oracle ("DFT") potential
# ---------------------------------------------------------------------------

# species: 0 = O(water), 1 = C, 2 = N, 3 = O(protein)
_DE = np.array([[0.65, 0.45, 0.50, 0.55],
                [0.45, 0.90, 0.75, 0.70],
                [0.50, 0.75, 0.80, 0.65],
                [0.55, 0.70, 0.65, 0.85]], np.float32)        # well depth
_R0 = np.array([[0.31, 0.30, 0.29, 0.28],
                [0.30, 0.15, 0.14, 0.14],
                [0.29, 0.14, 0.14, 0.13],
                [0.28, 0.14, 0.13, 0.13]], np.float32) + 0.12  # eq. distance
_A = 9.0           # Morse steepness [1/nm]: soft enough for stable labels
_K3 = 2.0          # 3-body strength
_COS0 = -1.0 / 3.0  # tetrahedral-ish preferred angle
_RC3 = 0.35        # 3-body cutoff [nm]
_LABEL_CHUNK = 16  # frames per batched label call (N^3 3-body terms each)


def _smooth_cut(r, rc):
    x = (r / rc).clamp(0.0, 1.0)
    return (1 - x ** 2) ** 2


def oracle_energy(coords: torch.Tensor, types: torch.Tensor,
                  rc: float = 0.6) -> torch.Tensor:
    """Open-boundary analytic energy of frames (..., N, 3) with types
    (..., N): shape (...).  O(N^3) per frame (the 3-body term)."""
    n = coords.shape[-2]
    dev = coords.device
    dr = coords[..., None, :, :] - coords[..., :, None, :]
    d2 = (dr ** 2).sum(-1)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    d2s = torch.where(eye, torch.ones((), device=dev), d2)
    r = torch.sqrt(d2s)
    de = torch.as_tensor(_DE, device=dev)[types[..., :, None], types[..., None, :]]
    r0 = torch.as_tensor(_R0, device=dev)[types[..., :, None], types[..., None, :]]
    morse = de * (torch.exp(-2 * _A * (r - r0)) - 2 * torch.exp(-_A * (r - r0)))
    pair_mask = (~eye) & (d2s < rc ** 2)
    zero = torch.zeros((), device=dev)
    e2 = 0.5 * torch.where(pair_mask, morse * _smooth_cut(r, rc),
                           zero).sum((-2, -1))

    # 3-body: sum over centres i and neighbour pairs (j, k)
    inv_r = torch.where(eye, zero, 1.0 / r)
    rhat = dr * inv_r[..., None]
    w3 = torch.where((~eye) & (d2s < _RC3 ** 2), _smooth_cut(r, _RC3), zero)
    cos_jk = torch.einsum("...ijd,...ikd->...ijk", rhat, rhat)
    wjk = w3[..., :, :, None] * w3[..., :, None, :]
    e3 = 0.5 * _K3 * torch.where(eye, zero,
                                 wjk * (cos_jk - _COS0) ** 2).sum((-3, -2, -1))
    return e2 + e3


def oracle_energy_and_forces(coords: torch.Tensor, types: torch.Tensor):
    """(energy, forces = -dE/dr) of frames (..., N, 3), by autograd."""
    with torch.enable_grad():
        c = coords.detach().requires_grad_(True)
        e = oracle_energy(c, types)
        (g,) = torch.autograd.grad(e.sum(), c)
    return e.detach(), -g


# ---------------------------------------------------------------------------
# Frame generation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Dataset:
    coords: np.ndarray    # (F, N, 3)
    types: np.ndarray     # (F, N)
    energies: np.ndarray  # (F,)
    forces: np.ndarray    # (F, N, 3)

    @property
    def n_frames(self) -> int:
        return len(self.energies)

    @property
    def n_atoms(self) -> int:
        return self.coords.shape[1]

    def split(self, valid_fraction: float = 0.1):
        n_valid = max(1, int(self.n_frames * valid_fraction))
        tr = Dataset(self.coords[:-n_valid], self.types[:-n_valid],
                     self.energies[:-n_valid], self.forces[:-n_valid])
        va = Dataset(self.coords[-n_valid:], self.types[-n_valid:],
                     self.energies[-n_valid:], self.forces[-n_valid:])
        return tr, va


def _fragment_positions(rng: np.random.Generator, n_atoms: int) -> np.ndarray:
    """Chain fragment + scattered solvent with min-distance rejection."""
    n_chain = n_atoms // 2
    t = np.arange(n_chain) * 0.5
    chain = np.stack([0.2 * np.cos(t), 0.2 * np.sin(t), 0.14 * np.arange(n_chain)], -1)
    chain += rng.normal(0, 0.02, chain.shape)
    span = max(chain[:, 2].max() + 0.6, 1.2)
    sol = []
    tries = 0
    while len(sol) < n_atoms - n_chain and tries < 20000:
        p = rng.uniform(-span / 2, span / 2, 3) + np.array([0, 0, span / 2 - 0.3])
        pts = np.concatenate([chain] + ([np.array(sol)] if sol else []))
        if (np.linalg.norm(pts - p, axis=-1) > 0.26).all():
            sol.append(p)
        tries += 1
    while len(sol) < n_atoms - n_chain:  # fallback fill
        sol.append(rng.uniform(-span, span, 3))
    return np.concatenate([chain, np.array(sol)]).astype(np.float32)


def relax_geometry(coords, types, n_steps: int = 80, lr: float = 2e-4,
                   device="cuda") -> np.ndarray:
    """Steepest descent on the oracle, so frames sit near a minimum of the
    energy surface (the analogue of sampling DFT data from equilibrated
    AIMD: near-equilibrium frames, moderate forces, learnable labels).
    ``coords`` (N, 3) or a batch (G, N, 3) relaxed together; each step's
    force is capped at 50 per atom.  The loop runs on ``device`` without
    reading back until its end."""
    dev = resolve_device(device)
    c = torch.as_tensor(np.asarray(coords), device=dev)
    t = torch.as_tensor(np.asarray(types), device=dev).long()
    for _ in range(n_steps):
        _, f = oracle_energy_and_forces(c, t)
        fmag = torch.linalg.vector_norm(f, dim=-1, keepdim=True)
        f = f / (fmag / 50.0).clamp_min(1.0)  # cap the step on steep walls
        c = c + lr * f
    return c.cpu().numpy()


def make_dataset(n_frames: int, n_atoms: int = 48, seed: int = 0,
                 jitter: float = 0.01, device="cuda") -> Dataset:
    """Frames = jittered conformations of relaxed fragment geometries;
    labels from the oracle, in batches of frames on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_geo = max(1, n_frames // 16)
    types_tmp = np.concatenate([(np.arange(n_atoms // 2) % 3 + 1),
                                np.zeros(n_atoms - n_atoms // 2)]).astype(np.int32)
    starts = np.stack([_fragment_positions(rng, n_atoms) for _ in range(n_geo)])
    geos = relax_geometry(starts, types_tmp, device=dev)
    n_chain = n_atoms // 2
    types_chain = (np.arange(n_chain) % 3 + 1).astype(np.int32)
    coords, types = [], []
    for f in range(n_frames):
        g = geos[f % n_geo]
        coords.append(g + rng.normal(0, jitter, g.shape).astype(np.float32))
        types.append(np.concatenate([types_chain,
                                     np.zeros(n_atoms - n_chain, np.int32)]))
    coords = np.stack(coords)
    types = np.stack(types)

    es, fs = [], []
    for i in range(0, n_frames, _LABEL_CHUNK):
        e, f = oracle_energy_and_forces(
            torch.as_tensor(coords[i:i + _LABEL_CHUNK], device=dev),
            torch.as_tensor(types[i:i + _LABEL_CHUNK], device=dev).long())
        es.append(e.cpu().numpy())
        fs.append(f.cpu().numpy())
    return Dataset(coords=coords, types=types,
                   energies=np.concatenate(es).astype(np.float32),
                   forces=np.concatenate(fs).astype(np.float32))


def frame_neighbor_lists(coords: torch.Tensor, rcut: float, sel: int):
    """Full neighbour lists (idx int32, mask) of a batch of open-boundary
    frames (F, N, 3), on their device."""
    big_box = torch.full((3,), 1e3, dtype=coords.dtype, device=coords.device)
    lists = [brute_force_neighbor_list(c, big_box, rcut, sel, half=False)
             for c in coords]
    return (torch.stack([nl.idx for nl in lists]),
            torch.stack([nl.mask for nl in lists]))
