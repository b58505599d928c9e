"""Replica-batched Deep-Potential force provider.

Port of ``repro/ensemble/provider.py``.  :class:`BatchedDeepmdProvider` is
:class:`repro_torch.core.DeepmdForceProvider` lifted over a leading replica
axis: positions arrive as (R, N, 3) and energies/forces return as (R,) /
(R, N, 3).  The unit conversions, the stateful assemble/evaluate/grow
protocol and the capacity growth are inherited; the subclass overrides
only ``backend_build_fns``:

* distributed (``dd_config`` given): one replica-batched
  :class:`~repro_torch.core.pipeline.ForcePipeline` (``n_replicas=R``) on
  the virtual (replica x rank) layout of this device, so every model kernel
  and force-scatter site launches once per call for all replicas; or, with
  ``mesh=make_ensemble_mesh(Rs, G, ...)``, over a 2-D process layout: each
  process evaluates its R / Rs resident replicas' share of the ranks (one
  model call for them) and every process gets all R replicas' results;
* single domain: the inherited hooks, whose single-domain helpers
  (:mod:`repro_torch.core.ddinfer`) take a leading replica axis: one
  ``DPModel.energy_and_forces_batched`` call over the R replicas (their
  lists built per replica, laid out with offset ids); the unbatched
  provider is the same call at R = 1.

Per-replica semantics are kept: ``evaluate`` flags (``needs_rebuild`` /
``overflow``) come back shaped (R,), so the ensemble engine tracks each
trajectory's skin budget apart.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.ddinfer import DDConfig
from ..core.nnpot import DeepmdForceProvider, UnitConversion
from ..core.pipeline import ForcePipeline
from ..dp.model import DPModel


class BatchedDeepmdProvider(DeepmdForceProvider):
    """Plugs into ``EnsembleEngine(special_force=...)``; replicas and ranks
    are virtual axes of ``device`` (``mesh=None``), or run over the
    processes of ``mesh``, an ``ensemble.make_ensemble_mesh`` layout whose
    device the provider takes (a 1-D ``make_dd_mesh`` mesh raises in the
    pipeline: it runs one trajectory)."""

    batched = True  # ForceBackend capability flag: leading replica axis

    def __init__(self, model: DPModel, params, nn_indices: np.ndarray,
                 types, box, n_atoms: int, n_replicas: int,
                 dd_config: Optional[DDConfig] = None, mesh=None,
                 units: UnitConversion = UnitConversion(),
                 nbr_capacity: int = 64, skin: float = 0.0, device="cuda",
                 fault_hook=None):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self.n_replicas = n_replicas
        super().__init__(model, params, nn_indices, types, box, n_atoms,
                         dd_config=dd_config, mesh=mesh, units=units,
                         nbr_capacity=nbr_capacity, skin=skin, device=device,
                         fault_hook=fault_hook)

    def backend_build_fns(self) -> None:
        # the replica-batched functions are the SAME pipeline with the
        # batching transform applied, not a separate family
        if self.dd_config is None:
            self.pipeline = None
            return
        self.pipeline = ForcePipeline(self.model, self.dd_config,
                                      self.box_model, self.n_nn,
                                      fault_hook=self.fault_hook,
                                      n_replicas=self.n_replicas,
                                      mesh=self.mesh)
        self._dist_fn = self.pipeline.build_force_fn()
        self._asm_fn = self.pipeline.build_assembly_fn()
        self._eval_fn = self.pipeline.build_evaluation_fn()
        self._check_fn = self.pipeline.build_check_fn()
