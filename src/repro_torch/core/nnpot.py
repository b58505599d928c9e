"""NNPot-style special-force provider with a DeePMD backend (paper Sec. IV-A).

Port of ``repro/core/nnpot.py`` for one domain (``dd_config=None``).
``DeepmdForceProvider`` owns the model handle, extracts the NN atoms from the
full position array, converts units, runs inference and scatters forces
back into engine layout.  With a positive ``skin`` it exposes the amortized
two-phase API (``assemble`` / ``evaluate`` / ``needs_rebuild`` / ``grow``)
the GROMACS ``nstlist`` analogue drives, and :meth:`compute` reuses its
state across calls.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..backend import ForceRequest, ForceResult
from ..device import resolve_device
from ..dp.model import DPModel
from ..md.neighbors import needs_rebuild as _nlist_needs_rebuild
from .ddinfer import (single_domain_forces, single_domain_forces_nlist,
                      single_domain_state)


@dataclasses.dataclass(frozen=True)
class UnitConversion:
    """GROMACS (nm, kJ/mol) <-> model native units (DeePMD: Angstrom, eV).
    Identity by default (the in-house model is trained in GROMACS units)."""

    length_to_model: float = 1.0   # nm -> model length
    energy_to_engine: float = 1.0  # model energy -> kJ/mol

    @staticmethod
    def deepmd_ev_angstrom() -> "UnitConversion":
        return UnitConversion(length_to_model=10.0,
                              energy_to_engine=96.48533212)

    @property
    def force_to_engine(self) -> float:
        return self.energy_to_engine * self.length_to_model


def _floor_mod(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``jnp.mod``: fmod (exact) shifted into the divisor's sign."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


class DeepmdForceProvider:
    """Single-domain DP force provider behind the ``ForceBackend`` protocol.

    ``params`` must lie on ``device`` (default ``"cuda"``; raises without a
    card unless ``device="cpu"``).  ``skin`` (model length units) enables
    state reuse: ``assemble`` builds a skin-widened neighbour list,
    ``evaluate`` reuses it until ``needs_rebuild`` reports an atom moved
    more than skin/2, and ``grow`` doubles the list capacity after an
    overflow.

    Extension hooks (model units, NN group): ``backend_assemble``,
    ``backend_needs_rebuild``, ``backend_evaluate``, ``backend_forces``.
    """

    batched = False
    host_side = False

    def __init__(self, model: DPModel, params, nn_indices: np.ndarray,
                 types, box, n_atoms: int, dd_config=None, mesh=None,
                 units: UnitConversion = UnitConversion(),
                 nbr_capacity: int = 64, skin: float = 0.0, device="cuda"):
        if dd_config is not None or mesh is not None:
            raise NotImplementedError(
                "the distributed provider (virtual DD) is not ported yet: "
                "ROADMAP.md Queue 1 item 4-5 (virtual DD assembly, "
                "ForcePipeline)")
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.nn_indices = torch.as_tensor(np.asarray(nn_indices, np.int64),
                                          device=self.device)
        self.n_atoms = n_atoms
        self.units = units
        self.nbr_capacity = nbr_capacity
        self.nn_types = torch.as_tensor(types,
                                        device=self.device)[self.nn_indices]
        self.box_model = (torch.as_tensor(box, dtype=torch.float32,
                                          device=self.device)
                          * units.length_to_model)
        self.skin = skin
        if skin > 0:
            # widen the list capacity with the skin volume
            rcut = model.cfg.descriptor.rcut
            self.nbr_capacity = int(np.ceil(
                nbr_capacity * ((rcut + skin) / rcut) ** 3))
        self._state = None
        self.growths = 0
        self.last_diag: Optional[dict] = None

    # -- amortized two-phase API ----------------------------------------------

    @property
    def stateful(self) -> bool:
        return self.skin > 0

    def _to_model(self, positions: torch.Tensor) -> torch.Tensor:
        nn_pos = (positions[..., self.nn_indices, :]
                  * self.units.length_to_model)
        return _floor_mod(nn_pos, self.box_model)

    def assemble(self, positions: torch.Tensor):
        """Assembly phase at the current positions -> reusable state."""
        return self.backend_assemble(self._to_model(positions))

    def backend_assemble(self, nn_pos: torch.Tensor):
        """Hook: single-domain assembly (model units, NN group)."""
        return single_domain_state(self.model, nn_pos, self.box_model,
                                   self.nbr_capacity, self.skin)

    def state_overflow(self, state) -> torch.Tensor:
        return state.overflow

    def needs_rebuild(self, positions: torch.Tensor, state) -> torch.Tensor:
        """() bool — some atom moved more than skin/2 since assembly."""
        return self.backend_needs_rebuild(self._to_model(positions), state)

    def backend_needs_rebuild(self, nn_pos: torch.Tensor, state):
        """Hook: single-domain skin displacement check."""
        return _nlist_needs_rebuild(state, nn_pos, self.box_model, self.skin)

    def evaluate(self, positions: torch.Tensor, state):
        """(energy, forces (N, 3) engine units, flags) reusing ``state``;
        ``flags["needs_rebuild"]`` is the skin check at these positions."""
        e, f_nn, flags = self.backend_evaluate(self._to_model(positions),
                                               state)
        e, forces = self._to_engine(e, f_nn, positions)
        return e, forces, flags

    def backend_evaluate(self, nn_pos: torch.Tensor, state):
        """Hook: single-domain evaluation reusing ``state``."""
        e, f_nn = single_domain_forces_nlist(
            self.model, self.params, nn_pos, self.nn_types, self.box_model,
            state)
        flags = {"overflow": state.overflow,
                 "needs_rebuild": self.backend_needs_rebuild(nn_pos, state)}
        return e, f_nn, flags

    def grow(self) -> None:
        """Double the list capacity after an overflow."""
        self.growths += 1
        self.nbr_capacity *= 2
        self._state = None

    # -- ForceBackend entry point -----------------------------------------------

    def _to_engine(self, e, f_nn, positions):
        e = e * self.units.energy_to_engine
        f_nn = f_nn * self.units.force_to_engine
        forces = torch.zeros(positions.shape[:-2] + (self.n_atoms, 3),
                             dtype=positions.dtype, device=positions.device)
        forces[..., self.nn_indices, :] = f_nn.to(positions.dtype)
        return e.to(positions.dtype), forces

    def compute(self, request: ForceRequest) -> ForceResult:
        """(energy kJ/mol, forces (N, 3) kJ/mol/nm, zeros off the NN group)
        for the engine-layout ``request.positions``.  With a positive skin
        the cached state is reused across calls, rebuilt when the
        displacement check trips and grown (up to 8 doublings) while the
        list overflows."""
        positions = torch.as_tensor(request.positions, dtype=torch.float32,
                                    device=self.device)
        if not self.stateful:
            e, f_nn = self.backend_forces(self._to_model(positions))
            e, forces = self._to_engine(e, f_nn, positions)
            return ForceResult(energy=e, forces=forces,
                               tenant=request.tenant, req_id=request.req_id)
        if self._state is None:
            self._state = self.assemble(positions)
        e, forces, flags = self.evaluate(positions, self._state)
        if bool(flags["needs_rebuild"]):
            self._state = self.assemble(positions)
            e, forces, flags = self.evaluate(positions, self._state)
        for _ in range(8):
            if not bool(flags["overflow"]):
                break
            self.grow()
            self._state = self.assemble(positions)
            e, forces, flags = self.evaluate(positions, self._state)
        else:
            raise RuntimeError("special-force capacity still exceeded after "
                               "8 doublings")
        self.last_diag = {k: bool(v) for k, v in flags.items()}
        return ForceResult(energy=e, forces=forces,
                           diagnostics=dict(self.last_diag),
                           tenant=request.tenant, req_id=request.req_id)

    def backend_forces(self, nn_pos: torch.Tensor):
        """Hook: single-domain per-step forces (model units)."""
        return single_domain_forces(self.model, self.params, nn_pos,
                                    self.nn_types, self.box_model,
                                    self.nbr_capacity)
