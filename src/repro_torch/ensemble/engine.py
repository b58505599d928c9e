"""Replica-ensemble MD engine: R trajectories as one program.

Port of ``repro/ensemble/engine.py``.  The paper's strong-scaling ceiling
(40% efficiency at 32 devices, Sec. VI) means that past ~16 ranks extra
hardware buys more from *more trajectories* than from more ranks per
trajectory.  ``EnsembleEngine`` makes replica count that first-class
scaling dimension: a :class:`ReplicaState` batches R independent replicas
of one system over a leading axis, the classical force path runs all
replicas at once (:func:`repro_torch.md.forcefield.classical_forces_batched`:
atom ids offset by r*N, one launch per gather and force-scatter site for
all replicas), the integrator acts on (R, N, 3), the Deep-Potential
special force runs through
:class:`repro_torch.ensemble.BatchedDeepmdProvider` (one batched model call
on one domain, or the replica-batched pipeline over virtual ranks), and an
optional temperature-ladder replica-exchange move
(:mod:`repro_torch.ensemble.exchange`) turns the ensemble into REMD.  The
classical neighbour lists are built per replica and stacked.

The host-side window machinery — windows, displacement-triggered rebuilds,
capacity grow-and-replay, guard rollback-and-replay, observe/checkpoint
cadence — is *inherited* from :class:`repro_torch.md.MDEngine`, not forked:
per-trajectory flags are shaped (R,) (``_batch_shape``), the shared code
reduces them with any()/sum() for host decisions, and a rebuild fires for
all replicas when *any* replica trips.  That is exact, not approximate:
both the classical force field (cutoff re-filter at evaluation) and the DP
evaluation (canonical within-cutoff compaction) are independent of list
staleness inside the skin bound, so a batched run with exchange disabled
reproduces R independent ``MDEngine`` runs trajectory for trajectory (same
per-replica seeds and temperatures; bit for bit where measured, see
``tests/test_torch_ensemble.py``).  A guard trip rolls the window back and
replays it, and only the tripped replicas take the replay
(``_merge_rollback``).

Replica exchange happens at window boundaries (``exchange_interval`` is an
extra host-boundary cadence): the Metropolis criterion uses the potential
energies from the window's final force evaluation, i.e. the energies at
the positions *entering* the last step.

Over a 2-D ``(replica x dd)`` process layout (a provider built with
``mesh=ensemble.make_ensemble_mesh(...)``) every process runs this engine
on the whole, replicated :class:`ReplicaState`: all R replicas' positions,
classical forces, lists and integration.  The provider evaluates only the
process's own replicas and ranks and returns every replica's energies,
forces and flags, the same bits on every process, so the rebuild, growth,
guard and exchange branches (whose uniforms come from the replicated
``ReplicaState.rng``) are the same everywhere.  Each process pays the
classical work of all R replicas.  Each process needs a checkpoint path of
its own.  After a masked guard recovery over such a layout, the provider
state's resident-replica leaves (their leading axis is R / Rs, not R) are
the replay's, consistent among themselves.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..md import observables
from ..md.engine import EngineConfig, MDEngine
from ..md.forcefield import classical_forces_batched, replicate_system
from ..md.integrators import berendsen_rescale, leapfrog_step
from ..md.neighbors import needs_rebuild, stack_neighbor_lists
from ..md.system import System
from .exchange import make_exchange_fn
from .state import ReplicaState, stack_states


@dataclasses.dataclass
class EnsembleConfig:
    """Replica-ensemble knobs, orthogonal to :class:`EngineConfig`."""

    n_replicas: int
    temps: Optional[tuple] = None      # temperature ladder (len R, ascending);
    #   None = every replica at EngineConfig.thermostat_t
    exchange_interval: int = 0         # steps between exchange attempts; 0=off
    seeds: Optional[tuple] = None      # per-replica velocity seeds (default
    #   0..R-1); they also seed the exchange streams


class EnsembleEngine(MDEngine):
    """R-replica batched MD with optional replica exchange.

    Usage mirrors ``MDEngine``::

        ens = EnsembleConfig(n_replicas=4, temps=(300, 330, 365, 400),
                             exchange_interval=20)
        eng = EnsembleEngine(system, EngineConfig(...), ens,
                             special_force=BatchedDeepmdProvider(...))
        state = eng.run(eng.init_state(positions), n_steps)

    Exchange statistics land in ``diagnostics`` (``exchange_attempts`` /
    ``exchange_accepts`` plus the per-rung-pair ``pair_*`` vectors), guard
    trips per replica in ``replica_guard_trips``.
    """

    _state_type = ReplicaState

    def __init__(self, system: System, config: EngineConfig,
                 ens: EnsembleConfig, special_force=None, obs=None,
                 guard=None, faults=None, checkpointer=None):
        r = ens.n_replicas
        if r < 1:
            raise ValueError("n_replicas must be >= 1")
        if ens.temps is not None and len(ens.temps) != r:
            raise ValueError(f"temps has {len(ens.temps)} entries for "
                             f"{r} replicas")
        if ens.temps is None and ens.exchange_interval:
            if config.thermostat_t is None:
                raise ValueError("replica exchange needs a temperature "
                                 "ladder (EnsembleConfig.temps) or a "
                                 "thermostat target")
        if special_force is not None and not getattr(special_force,
                                                     "batched", False):
            raise ValueError(
                "the ensemble's special force must take a leading replica "
                "axis (batched = True, e.g. BatchedDeepmdProvider)")
        self.ens = ens
        self._thermostat = (ens.temps is not None
                            or config.thermostat_t is not None)
        base_t = (config.thermostat_t if config.thermostat_t is not None
                  else 300.0)
        # the ladder in float32, as the reference holds it
        self._temp_table = torch.tensor(
            ens.temps if ens.temps is not None else (base_t,) * r,
            dtype=torch.float32)
        self._batch_shape = (r,)
        self._extra_boundary_every = ens.exchange_interval
        super().__init__(system, config, special_force, obs=obs,
                         guard=guard, faults=faults, checkpointer=checkpointer)
        self._exchange_fn = make_exchange_fn(self._temp_table)

    def _init_diagnostics(self) -> dict:
        # called from MDEngine.__init__ and reset(); self.ens is set first
        r = self.ens.n_replicas
        d = super()._init_diagnostics()
        d.update({
            "exchange_attempts": 0, "exchange_accepts": 0,
            "pair_attempts": np.zeros(max(r - 1, 0), np.int64),
            "pair_accepts": np.zeros(max(r - 1, 0), np.int64),
            # per-replica guard-trip attribution (recovery is masked per
            # replica: untripped replicas keep the committed window)
            "replica_guard_trips": np.zeros(r, np.int64),
        })
        return d

    # -- batched construction ------------------------------------------------

    def _build_fns(self):
        self._rep_system = replicate_system(self.system, self.ens.n_replicas)
        self._targets = self._temp_table.to(self.device)
        self._classical_fn = self._classical_batched
        self._integrate_fn = self._integrate_batched

    def _classical_batched(self, pos, nlist):
        return classical_forces_batched(pos, self._rep_system, nlist,
                                        self.config.ff, True)

    def _integrate_batched(self, state: ReplicaState, f):
        """Leapfrog on (R, N, 3) (elementwise: each replica's bits are an
        unbatched step's), then each replica's Berendsen rescale toward its
        current rung (a per-replica kinetic-energy reduction)."""
        cfg = self.config
        new = leapfrog_step(state, f, self.system.masses, self.system.box,
                            cfg.dt)
        if not self._thermostat:
            return new
        target = self._targets[state.ladder.long()]
        v = torch.stack([
            berendsen_rescale(new.velocities[k], self.system.masses,
                              target[k], cfg.dt, cfg.thermostat_tau)
            for k in range(self.ens.n_replicas)])
        return dataclasses.replace(new, velocities=v)

    def build_nlist(self, positions):
        return stack_neighbor_lists([MDEngine.build_nlist(self, p)
                                     for p in positions])

    def _check_rebuild(self, nlist, positions):
        return needs_rebuild(nlist, positions, self.system.box,
                             self.config.skin)

    # -- lifecycle -----------------------------------------------------------

    def init_state(self, positions, seeds: Optional[Sequence[int]] = None
                   ) -> ReplicaState:
        """Batched init: per-replica Maxwell-Boltzmann draws at the ladder
        temperatures, from per-replica seeds — replica r's state is exactly
        ``MDEngine.init_state(positions[r], temps[r], seed=seeds[r])``."""
        r = self.ens.n_replicas
        if seeds is None:
            seeds = self.ens.seeds if self.ens.seeds is not None else range(r)
        if not isinstance(seeds, (list, tuple, range, np.ndarray)):
            raise TypeError(
                "EnsembleEngine.init_state takes per-replica `seeds` (a "
                "sequence), not MDEngine's scalar temperature/seed — "
                "replica temperatures come from EnsembleConfig.temps")
        seeds = list(seeds)
        if len(seeds) != r:
            raise ValueError(f"{len(seeds)} seeds for {r} replicas")
        if positions.dim() == 2:
            positions = positions.expand((r,) + tuple(positions.shape))
        states = [MDEngine.init_state(self, positions[k],
                                      float(self._temp_table[k]),
                                      seed=int(seeds[k]))
                  for k in range(r)]
        return stack_states(states)

    # -- batched-engine hooks ------------------------------------------------

    def _abs_step(self, state) -> int:
        return int(state.step[0])

    def _post_segment(self, state, e_cl, e_sp, i: int):
        ex = self.ens.exchange_interval
        if not ex or i % ex != 0 or self.ens.n_replicas < 2:
            return state
        energies = e_cl + e_sp
        # parity from the absolute step: part of the checkpointed state, so
        # a restored run continues the same alternating rung-pair schedule
        # whenever checkpoints land on exchange boundaries
        parity = (self._abs_step(state) // ex) % 2
        state, stats = self._exchange_fn(state, energies, parity)
        d = self.diagnostics
        d["exchange_attempts"] += stats["attempted"]
        d["exchange_accepts"] += stats["accepted"]
        d["pair_attempts"] = d["pair_attempts"] + stats[
            "pair_attempts"].numpy().astype(np.int64)
        d["pair_accepts"] = d["pair_accepts"] + stats[
            "pair_accepts"].numpy().astype(np.int64)
        return state

    def _observation(self, state: ReplicaState, e_cl, e_sp) -> dict:
        temps = torch.stack([observables.temperature(v, self.system.masses)
                             for v in state.velocities])
        ladder = state.ladder.cpu().numpy()
        return {
            "step": self._abs_step(state),
            "e_classical": e_cl.cpu().numpy(),
            "e_special": torch.as_tensor(e_sp).cpu().numpy(),
            "temperature": temps.cpu().numpy(),
            "ladder": ladder,
            "target_t": self._temp_table.numpy()[ladder],
        }

    # -- fault tolerance -----------------------------------------------------

    def _note_guard_trips(self, mask) -> None:
        self.diagnostics["replica_guard_trips"] += np.asarray(mask, np.int64)
