"""Guarded execution, the part the MD engine needs: the window verdict and
its recovery-policy table (grow-and-replay on capacity overflow runs with
guards off), and the guard checks.  Rollback, fault injection and
emergency dumps come with checkpoints (ROADMAP item 8)."""
from .guards import GuardConfig, step_guard_trip
from .verdict import RECOVERY_POLICY, VERDICT_KINDS, WindowVerdict

__all__ = ["GuardConfig", "step_guard_trip",
           "RECOVERY_POLICY", "VERDICT_KINDS", "WindowVerdict"]
