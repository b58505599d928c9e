"""Guarded execution: health monitors, unified rollback-and-replay
recovery, and deterministic fault injection.

Port of ``repro/health``.  The layer spans the engine's windows
(``GuardConfig`` checks inside each step, the trip flag accumulated on the
device and read with the window's overflow flags), the engine
(``WindowVerdict`` -> ``RECOVERY_POLICY`` dispatch with rollback-and-replay),
checkpointing (emergency dumps, CRC-verified restore fallback) and the
force pipeline's ``fault_hook``.  ``FaultPlan`` drives every recovery path
deterministically in tests and ``chip_smoke.py``.
"""
from .faults import FAULT_KINDS, FaultPlan, FaultSpec, InjectedFault
from .guards import GuardConfig, step_guard_trip
from .recovery import GuardTripError, dump_emergency
from .verdict import RECOVERY_POLICY, VERDICT_KINDS, WindowVerdict

__all__ = [
    "FAULT_KINDS", "FaultPlan", "FaultSpec", "InjectedFault",
    "GuardConfig", "step_guard_trip",
    "GuardTripError", "dump_emergency",
    "RECOVERY_POLICY", "VERDICT_KINDS", "WindowVerdict",
]
