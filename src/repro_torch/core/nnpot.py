"""NNPot-style special-force provider with a DeePMD backend (paper Sec. IV-A).

Port of ``repro/core/nnpot.py``.  ``DeepmdForceProvider`` owns the model
handle, extracts the NN atoms from the full position array, converts units,
runs inference and scatters forces back into engine layout: on one domain
(``dd_config=None``), or distributed over the ranks of a
:class:`~repro_torch.core.ddinfer.DDConfig` through one
:class:`~repro_torch.core.pipeline.ForcePipeline`: virtual ranks of the
device, or (``mesh``) the processes of a
:class:`~repro_torch.launch.mesh.DDMesh` (a replica-batched subclass also
takes the 2-D :class:`~repro_torch.launch.mesh.EnsembleMesh`).  With a
positive skin (``skin``, or ``dd_config.skin``) it exposes the amortized
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
from ..kernels.nbr_attn import MAX_K, k_limit_message
from ..launch.mesh import DDMesh, EnsembleMesh
from ..md.integrators import wrap
from ..md.neighbors import needs_rebuild as _nlist_needs_rebuild
from .ddinfer import (DDConfig, single_domain_forces,
                      single_domain_forces_nlist, single_domain_state)
from .pipeline import ForcePipeline

# DD diag entries surfaced as per-step observability counters (see
# repro_torch.obs.trace): everything the Fig. 12 / imbalance reports read
_COUNTER_KEYS = ("local_count", "ghost_count", "cost_max", "cost_ratio",
                 "rank_cost", "nbr_occupancy", "rank_occupancy", "max_disp2",
                 "interior_frac", "rank_nonfinite")


def _any(flag) -> bool:
    """A flag of any trajectory (a replica-batched provider's are (R,))."""
    return bool(torch.as_tensor(flag).any())


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


class DeepmdForceProvider:
    """DP force provider behind the ``ForceBackend`` protocol.

    ``params`` must lie on ``device`` (default ``"cuda"``; raises without a
    card unless ``device="cpu"``).

    * ``dd_config=None``: one domain.  ``skin`` (model length units) enables
      state reuse: ``assemble`` builds a skin-widened neighbour list,
      ``evaluate`` reuses it until ``needs_rebuild`` reports an atom moved
      more than skin/2, and ``grow`` doubles the list capacity after an
      overflow (past K = 128 it raises: the port's attention limit).
    * ``dd_config`` (e.g. ``suggest_config(..., skin=...)``): the domain
      decomposition, ``prod(dd_config.grid_dims)`` ranks: virtual ranks of
      this one device (``mesh=None``), or ``mesh.ranks_per_process`` of
      them on each process of a ``launch.mesh.make_dd_mesh`` mesh, on
      ``mesh.device`` (every process passes the same positions and gets
      the same energy, forces and flags), or, replica-batched
      (:class:`repro_torch.ensemble.BatchedDeepmdProvider`), over the 2-D
      mesh of ``ensemble.make_ensemble_mesh``.  The state is a
      :class:`~repro_torch.core.ddinfer.DDState`; ``grow`` doubles every
      capacity and saturates the model-facing ``k_eval`` at 128.  Without a
      skin every call runs the fused per-step pipeline.

    ``fault_hook`` (``health.FaultPlan.pipeline_hook()``) is threaded into
    every :class:`ForcePipeline` the provider builds: the rank-targeted
    fault seam; without it the computation is unchanged.

    Extension hooks (model units, NN group): ``backend_build_fns`` (the
    distributed functions), and for one domain ``backend_assemble``,
    ``backend_needs_rebuild``, ``backend_evaluate``, ``backend_forces``.
    """

    batched = False
    host_side = False

    def __init__(self, model: DPModel, params, nn_indices: np.ndarray,
                 types, box, n_atoms: int, dd_config=None, mesh=None,
                 units: UnitConversion = UnitConversion(),
                 nbr_capacity: int = 64, skin: float = 0.0, device="cuda",
                 fault_hook=None):
        if dd_config is not None and not isinstance(dd_config, DDConfig):
            raise TypeError(f"dd_config must be a repro_torch DDConfig, got "
                            f"{type(dd_config).__name__}")
        self.device = resolve_device(device)
        if mesh is not None:
            if not isinstance(mesh, (DDMesh, EnsembleMesh)):
                raise ValueError(
                    "mesh must be a repro_torch DDMesh (launch.mesh."
                    "make_dd_mesh), an EnsembleMesh (ensemble."
                    "make_ensemble_mesh, replica-batched providers) or None "
                    "(the ranks as virtual axes of one device), got "
                    f"{type(mesh).__name__}")
            if isinstance(mesh, EnsembleMesh) and not self.batched:
                raise ValueError(
                    f"mesh axes {tuple(mesh.shape)} shard replicas: a 2-D "
                    "(replica x dd) mesh needs a replica-batched provider "
                    "(ensemble.BatchedDeepmdProvider); one trajectory runs "
                    "on launch.mesh.make_dd_mesh")
            if dd_config is None:
                raise ValueError("a mesh runs the domain decomposition: "
                                 "pass dd_config too")
            if mesh.device.type != self.device.type:
                raise ValueError(f"the mesh runs on {mesh.device}, the "
                                 f"provider was asked for {self.device}")
            self.device = mesh.device
        self.mesh = mesh
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
        self.n_nn = len(nn_indices)
        self.dd_config = dd_config
        self.fault_hook = fault_hook
        if dd_config is not None:
            self.skin = dd_config.skin
        else:
            self.skin = skin
            if skin > 0:
                # widen the list capacity with the skin volume
                rcut = model.cfg.descriptor.rcut
                self.nbr_capacity = int(np.ceil(
                    nbr_capacity * ((rcut + skin) / rcut) ** 3))
        self.backend_build_fns()
        self._state = None
        self.growths = 0
        self.last_diag: Optional[dict] = None

    def backend_build_fns(self) -> None:
        """Hook: (re)build the distributed functions from ONE
        :class:`ForcePipeline` (at init and after every ``grow``); exposed
        as ``self.pipeline``."""
        if self.dd_config is None:
            self.pipeline = None
            return
        self.pipeline = ForcePipeline(self.model, self.dd_config,
                                      self.box_model, self.n_nn,
                                      fault_hook=self.fault_hook,
                                      mesh=self.mesh)
        self._dist_fn = self.pipeline.build_force_fn()
        self._asm_fn = self.pipeline.build_assembly_fn()
        self._eval_fn = self.pipeline.build_evaluation_fn()
        self._check_fn = self.pipeline.build_check_fn()

    # -- amortized two-phase API ----------------------------------------------

    @property
    def stateful(self) -> bool:
        return self.skin > 0

    def _to_model(self, positions: torch.Tensor) -> torch.Tensor:
        nn_pos = (positions[..., self.nn_indices, :]
                  * self.units.length_to_model)
        return wrap(nn_pos, self.box_model)

    def assemble(self, positions: torch.Tensor):
        """Assembly phase at the current positions -> reusable state."""
        nn_pos = self._to_model(positions)
        if self.dd_config is not None:
            return self._asm_fn(nn_pos, self.nn_types)
        return self.backend_assemble(nn_pos)

    def backend_assemble(self, nn_pos: torch.Tensor):
        """Hook: single-domain assembly (model units, NN group)."""
        return single_domain_state(self.model, nn_pos, self.box_model,
                                   self.nbr_capacity, self.skin)

    def state_overflow(self, state) -> torch.Tensor:
        """() bool — static capacities were exceeded; state invalid."""
        if self.dd_config is not None:
            return state.overflow > 0
        return state.overflow

    def needs_rebuild(self, positions: torch.Tensor, state) -> torch.Tensor:
        """() bool — some atom moved more than skin/2 since assembly."""
        nn_pos = self._to_model(positions)
        if self.dd_config is not None:
            return self._check_fn(nn_pos, state)
        return self.backend_needs_rebuild(nn_pos, state)

    def backend_needs_rebuild(self, nn_pos: torch.Tensor, state):
        """Hook: single-domain skin displacement check."""
        return _nlist_needs_rebuild(state, nn_pos, self.box_model, self.skin)

    def evaluate(self, positions: torch.Tensor, state):
        """(energy, forces (N, 3) engine units, flags) reusing ``state``;
        ``flags["needs_rebuild"]`` is the skin check at these positions
        (a distributed evaluation also carries its ``counters``)."""
        nn_pos = self._to_model(positions)
        if self.dd_config is not None:
            e, f_nn, diag = self._eval_fn(self.params, nn_pos, state)
            flags = {"overflow": diag["overflow"] > 0,
                     "needs_rebuild": diag["needs_rebuild"],
                     "counters": {k: diag[k] for k in _COUNTER_KEYS
                                  if k in diag}}
        else:
            e, f_nn, flags = self.backend_evaluate(nn_pos, state)
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
        """Double the static capacities after an overflow.  Distributed:
        every capacity doubles, the model-facing ``k_eval`` saturates at the
        port's limit of 128 (the build list keeps doubling).  One domain:
        the list capacity doubles, and past 128 this raises."""
        if self.dd_config is not None:
            c = self.dd_config
            self.dd_config = dataclasses.replace(
                c, nbr_capacity=2 * c.nbr_capacity,
                nbr_capacity_eval=min(2 * c.k_eval, MAX_K),
                local_capacity=2 * c.local_capacity,
                ghost_capacity=min(2 * c.ghost_capacity, 27 * self.n_nn),
                cell_capacity=2 * c.cell_capacity,
                subcell_capacity=2 * c.subcell_capacity)
            self.backend_build_fns()
        else:
            if 2 * self.nbr_capacity > MAX_K:
                raise ValueError(k_limit_message(2 * self.nbr_capacity))
            self.nbr_capacity *= 2
        self.growths += 1
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
            nn_pos = self._to_model(positions)
            diag = {}
            if self.dd_config is not None:
                e, f_nn, diag = self._dist_fn(self.params, nn_pos,
                                              self.nn_types)
                self.last_diag = diag
            else:
                e, f_nn = self.backend_forces(nn_pos)
            e, forces = self._to_engine(e, f_nn, positions)
            return ForceResult(energy=e, forces=forces,
                               diagnostics=dict(diag),
                               tenant=request.tenant, req_id=request.req_id)
        if self._state is None:
            self._state = self.assemble(positions)
        e, forces, flags = self.evaluate(positions, self._state)
        if _any(flags["needs_rebuild"]):
            self._state = self.assemble(positions)
            e, forces, flags = self.evaluate(positions, self._state)
        for _ in range(8):
            if not _any(flags["overflow"]):
                break
            self.grow()
            self._state = self.assemble(positions)
            e, forces, flags = self.evaluate(positions, self._state)
        else:
            raise RuntimeError("special-force capacity still exceeded after "
                               "8 doublings")
        self.last_diag = {k: _any(v) for k, v in flags.items()
                          if k != "counters"}
        return ForceResult(energy=e, forces=forces,
                           diagnostics=dict(self.last_diag),
                           tenant=request.tenant, req_id=request.req_id)

    def backend_forces(self, nn_pos: torch.Tensor):
        """Hook: single-domain per-step forces (model units)."""
        return single_domain_forces(self.model, self.params, nn_pos,
                                    self.nn_types, self.box_model,
                                    self.nbr_capacity)
