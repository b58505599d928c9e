"""RemoteForceProvider: the client stub for :class:`repro_torch.serve.ForceServer`.

Port of ``repro/serve/client.py``.  A drop-in ``MDEngine(special_force=...)``
provider implementing the :class:`repro_torch.backend.ForceBackend`
protocol whose evaluator lives in a shared force server instead of this
simulation.  It mirrors the data-layout duties of ``DeepmdForceProvider``
— extract the marked NN group, convert engine units to model units, wrap
into the model box, scatter the returned forces back into engine layout —
but ships the converted group as a :class:`~repro_torch.backend.ForceRequest`
of host tensors rather than calling the model itself.

The provider advertises ``host_side = True``: the engine calls it in its
per-step host loop.  The reference's other route, ``jax.pure_callback``
from inside a traced (jitted) caller, has no counterpart: the port runs
eagerly, so every caller is already on the host and ``compute`` is the one
entry point.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..backend import ForceRequest, ForceResult
from ..core.nnpot import UnitConversion
from ..md.integrators import wrap
from .server import ForceServer, ServerOverloaded


class RemoteForceProvider:
    """ForceBackend whose evaluator is a (shared, multi-tenant) server.

    Stateless: neighbour state lives server-side per request (the padded
    bucket evaluator rebuilds it each call), so the engine drives the simple
    per-step path.
    """

    stateful = False   # no client-side reusable state
    batched = False    # one simulation per provider; batching is the server's
    host_side = True   # the engine calls it from its per-step host loop

    def __init__(self, server: ForceServer, nn_indices: np.ndarray,
                 types, box, n_atoms: int,
                 units: UnitConversion = UnitConversion(),
                 tenant: str = "default",
                 timeout_s: Optional[float] = None):
        self.server = server
        self.nn_indices = torch.as_tensor(np.asarray(nn_indices, np.int64))
        self.n_nn = len(self.nn_indices)
        self.n_atoms = n_atoms
        self.units = units
        self.tenant = tenant
        self.timeout_s = timeout_s
        self.nn_types = torch.as_tensor(
            np.asarray(torch.as_tensor(types).cpu(), np.int32))[self.nn_indices]
        self.box_model = (torch.as_tensor(box, dtype=torch.float32).cpu()
                          * units.length_to_model)
        self.last_diag: Optional[dict] = None

    def compute(self, request: ForceRequest) -> ForceResult:
        """(energy, forces (N, 3), zeros off the NN group) for the
        engine-layout ``request.positions``, in engine units, on the
        positions' device.  A failed or overloaded request raises."""
        positions = torch.as_tensor(request.positions)
        dev, dtype = positions.device, positions.dtype
        nn_pos = (positions.detach().cpu()[self.nn_indices].to(torch.float32)
                  * self.units.length_to_model)
        nn_pos = wrap(nn_pos, self.box_model)
        try:
            res: ForceResult = self.server.compute(
                ForceRequest(positions=nn_pos, box=self.box_model,
                             types=self.nn_types, tenant=self.tenant),
                timeout=self.timeout_s)
        except ServerOverloaded as e:
            # compute() already retried per ServeConfig.max_retries; what
            # reaches here is exhausted backpressure
            raise RuntimeError(
                f"force server overloaded for tenant {self.tenant!r} "
                f"after {self.server.config.max_retries} retries: "
                f"{e}") from e
        self.last_diag = dict(res.diagnostics)
        if not res.ok:
            raise RuntimeError(
                f"force server failed request for tenant "
                f"{self.tenant!r}: {res.error}")
        energy = (torch.as_tensor(res.energy, dtype=torch.float64)
                  * self.units.energy_to_engine).to(dtype)
        f_nn = torch.as_tensor(res.forces) * self.units.force_to_engine
        forces = torch.zeros(self.n_atoms, 3, dtype=dtype)
        forces[self.nn_indices] = f_nn.to(dtype)
        return ForceResult(energy=energy.reshape(()).to(dev),
                           forces=forces.to(dev),
                           diagnostics=dict(self.last_diag),
                           tenant=request.tenant, req_id=request.req_id)
