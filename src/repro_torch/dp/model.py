"""Deep Potential model: descriptor + fitting net, autograd forces, Eq. 7 masking.

Port of ``repro/dp/model.py``.  E = sum_i m_i e_i over local atoms and
F = -dE/dr by reverse-mode autograd (``torch.autograd.grad``), so forces on
ghost atoms come out of the same gradient.

``second_order=True`` (``energy_and_forces``, ``energy_and_forces_batched``)
is the training route: the descriptor in plain PyTorch
(the reference's jnp path, which its training takes: ``use_pallas`` is
False there) and forces that keep their graph (``create_graph=True``), so
a loss on them differentiates to the parameters.  The default is the
kernel route, first order, for every MD, DD, serving and evaluation
caller; no path switches route on its own.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import precision
from .common import EnvStats, type_rows
from .descriptors import DescriptorConfig, apply_descriptor, init_descriptor
from .networks import count_params, mlp_apply, mlp_init
from ..device import resolve_device
from ..kernels.force_scatter import neighbor_gather


@dataclasses.dataclass(frozen=True)
class DPConfig:
    descriptor: DescriptorConfig = dataclasses.field(default_factory=DescriptorConfig)
    fitting_neuron: tuple = (256, 256, 256)  # paper: 3 x 256
    dtype: str = "float32"                   # "float32" | "bfloat16"

    @property
    def ntypes(self) -> int:
        return self.descriptor.ntypes


def paper_dpa1_config(ntypes: int = 4, rcut: float = 0.6, sel: int = 64,
                      dtype: str = "float32") -> DPConfig:
    """The paper's in-house DPA-1: emb (32,64,128), 3 attn x 256, fit 3 x 256."""
    return DPConfig(descriptor=DescriptorConfig(
        kind="dpa1", rcut=rcut, rcut_smth=max(rcut - 0.3, 0.15), sel=sel,
        ntypes=ntypes, neuron=(32, 64, 128), axis_neuron=16,
        attn_layers=3, attn_hidden=256), dtype=dtype)


class DPModel:
    """Stateless apply-style model; parameters live in an external dict.

    ``device`` (default ``"cuda"``, raising when there is none) is where the
    model's normalisation stats and freshly initialised parameters live.
    """

    def __init__(self, cfg: DPConfig, stats: Optional[EnvStats] = None,
                 device="cuda"):
        precision.validate_dtype(cfg.dtype)
        cfg.descriptor.validate()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.stats = (stats.to(self.device) if stats is not None
                      else EnvStats.identity(cfg.ntypes, self.device))

    # -- params -------------------------------------------------------------

    def init_params(self, generator: torch.Generator) -> dict:
        """Parameters with the JAX initialiser's structure and scales; the
        numbers come from ``generator`` (drawn on the CPU, so a seed gives
        the same weights on every device)."""
        d = self.cfg.descriptor
        fit_sizes = (d.out_dim,) + tuple(self.cfg.fitting_neuron) + (1,)
        return {
            "descriptor": init_descriptor(generator, d, device=self.device),
            "fitting": mlp_init(generator, fit_sizes, device=self.device),
            "bias": torch.zeros((d.ntypes,), device=self.device),
        }

    def n_params(self, params) -> int:
        return count_params(params)

    # -- core forward ---------------------------------------------------------

    def atomic_energies(self, params, coords_center, coords_nbr, types_center,
                        types_nbr, nbr_mask, atom_mask,
                        second_order: bool = False) -> torch.Tensor:
        """e_i for every centre atom (padded atoms -> 0)."""
        desc = apply_descriptor(params["descriptor"], self.cfg.descriptor,
                                self.stats, coords_center, coords_nbr,
                                types_center, types_nbr, nbr_mask,
                                dtype=self.cfg.dtype,
                                second_order=second_order)
        e = mlp_apply(params["fitting"], desc,
                      compute_dtype=precision.compute_dtype(self.cfg.dtype)
                      )[..., 0]
        e = e + (type_rows(params["bias"], types_center) if second_order
                 else params["bias"][types_center.clamp_min(0)])
        return e * atom_mask

    def _atomic_e(self, params, coords, types, nbr_idx, nbr_mask, box=None,
                  second_order: bool = False):
        """(C,) per-atom energies over a buffer; padded-neighbour safe.  The
        neighbour gather's gradient is the force scatter
        (:func:`~repro_torch.kernels.force_scatter.neighbor_gather`): a sum
        over the valid slots in a fixed order, the CUDA kernel on the card."""
        safe = torch.where(nbr_idx >= 0, nbr_idx, torch.zeros_like(nbr_idx))
        coords_nbr = neighbor_gather(coords, nbr_idx, nbr_mask)
        if box is not None:
            dr = coords_nbr - coords[:, None, :]
            dr = dr - box * torch.round(dr / box)
            coords_nbr = coords[:, None, :] + dr
        return self.atomic_energies(params, coords, coords_nbr, types,
                                    types[safe], nbr_mask,
                                    torch.ones_like(coords[:, 0]),
                                    second_order)

    def total_energy(self, params, coords, types, nbr_idx, nbr_mask,
                     local_mask, box=None) -> torch.Tensor:
        """E = sum_i m_i e_i (Eq. 7: m_i = 1 local, 0 ghost/pad).  nbr_idx
        indexes into coords; ``box`` turns on the minimum image."""
        e = self._atomic_e(params, coords, types, nbr_idx, nbr_mask, box)
        return (e * local_mask).sum()

    @staticmethod
    def _grad(out, coords, create_graph: bool = False):
        (g,) = torch.autograd.grad(out, coords, create_graph=create_graph)
        return g

    def energy_and_forces(self, params, coords, types, nbr_idx, nbr_mask,
                          local_mask, box=None, second_order: bool = False):
        """(E, forces on every buffer atom, ghosts included).  With
        ``second_order`` both keep their graph to the parameters."""
        with torch.enable_grad():
            c = coords.detach().requires_grad_(True)
            e = (self._atomic_e(params, c, types, nbr_idx, nbr_mask, box,
                                second_order) * local_mask).sum()
            g = self._grad(e, c, create_graph=second_order)
        return (e if second_order else e.detach()), -g

    def energy_and_forces_dual(self, params, coords, types, nbr_idx, nbr_mask,
                               force_mask, report_mask, box=None):
        """Owner-computes-full-local-forces mode: forces differentiate
        sum(e * force_mask); the reported energy is sum(e * report_mask)."""
        with torch.enable_grad():
            c = coords.detach().requires_grad_(True)
            e = self._atomic_e(params, c, types, nbr_idx, nbr_mask, box)
            g = self._grad((e * force_mask).sum(), c)
        return (e.detach() * report_mask).sum(), -g

    def energy_and_forces_batched(self, params, coords, types, nbr_idx,
                                  nbr_mask, local_mask, box=None,
                                  second_order: bool = False):
        """Replica-batched :meth:`energy_and_forces`: coords (R, C, 3),
        nbr_idx/nbr_mask (R, C, K), local_mask (R, C); ``types`` shared (C,)
        or per replica (R, C).  The replicas are laid out as one (R*C)-atom
        buffer with offset neighbour indices, so each kernel launches once
        for all of them.  Returns (energy (R,), forces (R, C, 3)); with
        ``second_order`` both keep their graph to the parameters."""
        r, c = coords.shape[:2]
        off = (torch.arange(r, device=nbr_idx.device) * c)[:, None, None]
        flat_idx = torch.where(nbr_idx >= 0, nbr_idx + off, nbr_idx)
        flat_types = types.expand(r, c).reshape(r * c)
        with torch.enable_grad():
            x = coords.detach().reshape(r * c, 3).requires_grad_(True)
            e = self._atomic_e(params, x, flat_types, flat_idx.reshape(r * c, -1),
                               nbr_mask.reshape(r * c, -1), box, second_order)
            energy = (e * local_mask.reshape(r * c)).reshape(r, c).sum(1)
            g = self._grad(energy.sum(), x, create_graph=second_order)
        return ((energy if second_order else energy.detach()),
                -g.reshape(r, c, 3))

    def energy_forces_virial(self, params, coords, types, nbr_idx, nbr_mask,
                             local_mask, box=None):
        e, f = self.energy_and_forces(params, coords, types, nbr_idx,
                                      nbr_mask, local_mask, box)
        virial = -(coords[:, :, None] * f[:, None, :]).sum(0)
        return e, f, virial
