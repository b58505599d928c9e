"""Replica-batched MD state: R trajectories as one state.

Port of ``repro/ensemble/state.py``.  :class:`ReplicaState` is
:class:`repro_torch.md.integrators.MDState` with every field gaining a
leading replica axis, plus the replica-exchange bookkeeping: ``ladder``
maps each replica slot to its current rung in the (static) temperature
table, and ``rng`` holds one generator state per replica, stacked (R, S)
(``torch.Generator.get_state`` of each replica's stream, advanced by every
exchange attempt), so trajectories are reproducible replica by replica.

The integrators act on it unchanged: ``dataclasses.replace`` inside
``leapfrog_step`` keeps the extra field, and the per-atom arithmetic
broadcasts over the replica axis.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..md.integrators import MDState


@dataclasses.dataclass(frozen=True)
class ReplicaState:
    positions: torch.Tensor   # (R, N, 3)
    velocities: torch.Tensor  # (R, N, 3)
    forces: torch.Tensor      # (R, N, 3)
    step: torch.Tensor        # (R,) int32 (kept in lockstep by the engine)
    rng: torch.Tensor         # (R, S) uint8 generator states (host)
    ladder: torch.Tensor      # (R,) int32 rung index into the temperature table

    @property
    def n_replicas(self) -> int:
        return self.positions.shape[0]


def stack_states(states: Sequence[MDState], ladder=None) -> ReplicaState:
    """Stack R single-trajectory states into one batched state (``ladder``
    defaults to replica r on rung r)."""
    dev = states[0].positions.device
    if ladder is None:
        ladder = torch.arange(len(states), dtype=torch.int32, device=dev)
    return ReplicaState(
        positions=torch.stack([s.positions for s in states]),
        velocities=torch.stack([s.velocities for s in states]),
        forces=torch.stack([s.forces for s in states]),
        step=torch.stack([s.step for s in states]),
        rng=torch.stack([s.rng for s in states]),
        ladder=torch.as_tensor(ladder, dtype=torch.int32, device=dev))


def replica_state(state: ReplicaState, r: int) -> MDState:
    """Replica ``r`` as a plain single-trajectory :class:`MDState`."""
    return MDState(positions=state.positions[r],
                   velocities=state.velocities[r],
                   forces=state.forces[r], step=state.step[r],
                   rng=state.rng[r].clone())   # a generator state of its own
