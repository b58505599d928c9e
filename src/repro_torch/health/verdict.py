"""Window verdicts and the recovery-policy table.

Port of ``repro/health/verdict.py`` (host-side, numpy only).  Every window
(and every per-step segment) ends with a host-side :class:`WindowVerdict`
summarizing its device flags; the engine dispatches on
:data:`RECOVERY_POLICY` instead of hand-rolled overflow branches:

=====================  ==================  ===================================
verdict kind           policy              meaning / action
=====================  ==================  ===================================
``ok``                 ``commit``          accept window results
``capacity_overflow``  ``grow_replay``     double the overflowed capacity,
                                           replay the window from its saved
                                           start
``guard_trip``         ``rollback_replay`` roll back to the window start (or
                                           the last verified checkpoint if
                                           the start is tainted) and replay:
                                           first at the original dt, then
                                           with dt shrunk by
                                           ``GuardConfig.dt_shrink``
``unrecoverable``      ``emergency_dump``  write an emergency checkpoint and
                                           diagnostics bundle, then raise
=====================  ==================  ===================================

``trip_mask`` is shaped like the engine's ``_batch_shape`` so a batched
engine can mask recovery per replica.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

VERDICT_KINDS = ("ok", "capacity_overflow", "guard_trip", "unrecoverable")

RECOVERY_POLICY: dict[str, str] = {
    "ok": "commit",
    "capacity_overflow": "grow_replay",
    "guard_trip": "rollback_replay",
    "unrecoverable": "emergency_dump",
}


@dataclasses.dataclass
class WindowVerdict:
    """Host-side summary of one window's device flags."""

    kind: str                                 # one of VERDICT_KINDS
    trip_mask: Optional[np.ndarray] = None    # guard trips, _batch_shape
    detail: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in VERDICT_KINDS:
            raise ValueError(f"unknown verdict kind {self.kind!r}; "
                             f"expected one of {VERDICT_KINDS}")

    @property
    def policy(self) -> str:
        return RECOVERY_POLICY[self.kind]
