"""ForceBackend: the typed contract every force evaluator implements.

Port of ``repro/backend.py``: :class:`ForceRequest` / :class:`ForceResult`
are the request/response pair, :class:`ForceBackend` the universal surface
(``compute(request) -> result`` plus capability flags) and
:class:`StatefulForceBackend` the amortized assemble/evaluate extension (the
GROMACS ``nstlist`` analogue).  Array fields hold torch tensors; the module
imports nothing of the rest of the package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Protocol, runtime_checkable


@dataclasses.dataclass
class ForceRequest:
    """One force evaluation: positions + box, plus serving metadata.

    ``positions``/``box`` are in the caller's frame (engine units, full-system
    layout when the request comes from an MD engine).  ``types`` is only
    populated on the serving wire.  ``deadline`` is a ``time.monotonic``
    cutoff after which a server may drop the request.
    """

    positions: Any                 # (..., N, 3) tensor
    box: Any = None                # (3,) tensor
    types: Any = None              # (N,) int — wire requests only
    tenant: str = "default"
    req_id: int = 0
    deadline: Optional[float] = None

    @property
    def n_atoms(self) -> int:
        return int(self.positions.shape[-2])


@dataclasses.dataclass
class ForceResult:
    """Energy/forces in the request's frame + diagnostics.

    ``ok=False`` marks a degraded outcome (zeros in ``energy``/``forces``,
    ``error`` says why).
    """

    energy: Any                    # (...,) scalar per trajectory
    forces: Any                    # (..., N, 3)
    diagnostics: dict = dataclasses.field(default_factory=dict)
    tenant: str = "default"
    req_id: int = 0
    ok: bool = True
    error: str = ""


@runtime_checkable
class ForceBackend(Protocol):
    """Capability flags + one typed entry point."""

    stateful: bool   # supports the amortized assemble/evaluate split below
    batched: bool    # positions carry a leading replica axis
    host_side: bool  # must be called eagerly

    def compute(self, request: ForceRequest) -> ForceResult:
        """Forces for one request."""
        ...


@runtime_checkable
class StatefulForceBackend(ForceBackend, Protocol):
    """Amortized two-phase extension (drive only when ``stateful`` is true):
    ``assemble`` at positions P is valid for ``evaluate`` at any P' with
    per-atom displacement < skin/2 (``needs_rebuild``); ``state_overflow``
    flags exceeded capacities and ``grow`` doubles them."""

    def assemble(self, positions) -> Any:
        """Assembly phase at the current positions -> reusable state."""
        ...

    def evaluate(self, positions, state) -> tuple:
        """(energy, forces, flags) reusing ``state``; ``flags`` carries at
        least ``needs_rebuild`` and ``overflow``."""
        ...

    def needs_rebuild(self, positions, state):
        """Per-trajectory bool: some atom moved > skin/2 since assembly."""
        ...

    def state_overflow(self, state):
        """Per-trajectory bool: static capacities exceeded."""
        ...

    def grow(self) -> None:
        """Double the static capacities."""
        ...
