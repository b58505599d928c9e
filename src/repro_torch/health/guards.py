"""Health monitors: cheap device-side invariant checks.

Port of ``repro/health/guards.py``.  ``GuardConfig`` is off by default;
with ``enabled=False`` the engine runs no check and carries no flag.  With
``enabled=True`` the per-step check :func:`step_guard_trip` runs inside
every step of the engine's windows (and of the per-step loop): its result
is a per-trajectory boolean flag OR-reduced on the device across the
window and read with the window's ``nlist_overflow`` / ``sp_overflow``
flags, in the same host read.

The checks are *outputs only*: nothing they compute feeds back into the
physics, so an enabled-but-quiet run is bitwise-identical to an unguarded
one.  Recovery from a tripped flag is the engine's job (the verdict ->
policy table in :mod:`repro_torch.health.verdict`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Guarded-execution knobs.

    Thresholds are in engine units (nm, K, kJ/mol).  ``None`` disables the
    individual check; ``enabled=False`` disables the whole guard layer.
    """

    enabled: bool = False
    check_nonfinite: bool = True       # NaN/Inf in positions/velocities/forces
    max_disp: Optional[float] = None   # per-step displacement bound (nm)
    temp_ceiling: Optional[float] = None   # instantaneous temperature cap (K)
    energy_jump: Optional[float] = None    # |E(t) - E(t-1)| bound (kJ/mol)
    max_rollbacks: int = 3             # replays per window before escalating
    dt_shrink: float = 0.5             # dt factor applied from the 2nd replay

    def __post_init__(self):
        if self.max_rollbacks < 1:
            raise ValueError("max_rollbacks must be >= 1")
        if not (0.0 < self.dt_shrink <= 1.0):
            raise ValueError("dt_shrink must be in (0, 1]")


def step_guard_trip(cfg: GuardConfig, prev_positions: torch.Tensor, state,
                    masses: torch.Tensor, box: torch.Tensor,
                    e_total: torch.Tensor, e_prev: torch.Tensor
                    ) -> torch.Tensor:
    """Per-trajectory guard-trip flag for one integrated step.

    ``state`` is the post-integration MD state, ``prev_positions`` the
    pre-step positions (for the displacement bound, minimum-image so box
    wrapping never looks like a jump), ``e_prev`` the previous step's total
    potential energy (NaN on the window's first step: the energy-jump
    comparison is then False, i.e. skipped).  Returns a bool tensor shaped
    like the engine's ``_batch_shape``.  Every threshold comparison with a
    NaN is False (IEEE), so a non-finite state only trips through
    ``check_nonfinite``.
    """
    trip = torch.zeros(state.positions.shape[:-2], dtype=torch.bool,
                       device=state.positions.device)
    if cfg.check_nonfinite:
        finite = (torch.isfinite(state.positions).all(-1).all(-1)
                  & torch.isfinite(state.velocities).all(-1).all(-1)
                  & torch.isfinite(state.forces).all(-1).all(-1))
        trip = trip | ~finite
    if cfg.max_disp is not None:
        d = state.positions - prev_positions
        d = d - torch.round(d / box) * box       # minimum image
        trip = trip | ((d ** 2).sum(-1).amax(-1) > cfg.max_disp ** 2)
    if cfg.temp_ceiling is not None:
        from ..md.system import KB  # lazy: repro_torch.md imports this package
        ke = 0.5 * (masses[:, None] * state.velocities ** 2).sum((-1, -2))
        ndof = state.positions.shape[-2] * 3 - 3
        t_now = 2.0 * ke / (ndof * KB)
        trip = trip | (t_now > cfg.temp_ceiling)
    if cfg.energy_jump is not None:
        trip = trip | ((e_total - e_prev).abs() > cfg.energy_jump)
    return trip
