"""MD engine: the GROMACS main-loop analogue (paper Fig. 5).

Port of ``repro/md/engine.py``.  Conceptual step order: (1) init, (2)
domain decomposition / load balance, (3) position exchange, (4)
neighbor-list construction, (5) interaction evaluation, (6) special force
(NNPot), (7) force reduction + update, (8) output.  Stages (2), (3) and the
NN part of (6) live in ``repro_torch.core``; this module owns the host
loop and the classical interactions.  It runs on the device of its
``System``; the special force must live there too.

Two host-loop modes (``EngineConfig.loop_mode``), over the reference's
window boundaries (``_segment_len``: rebuild cadence, observation, end of
run):

``"scan"`` (default)
    Each window runs its steps back to back with no per-stage
    synchronisation.  Where JAX folds the displacement-triggered rebuilds
    into ``lax.cond`` branches, the port branches on the host: one host
    read per step fetches both rebuild flags (the classical list's and the
    special force's state's).  A list that overflows inside a window flags
    the window, which is replayed from its saved start after the capacity
    grows (the ``WindowVerdict`` -> ``RECOVERY_POLICY`` dispatch).

``"step"``
    One host round trip per stage, the neighbor / classical / special /
    integrate stages timed apart (synchronised), growth inline: the
    paper-Fig.-9 overhead decomposition.

No graph outlives a step: the run is under ``torch.no_grad`` and the force
calls differentiate inside their own ``enable_grad``.  Not ported yet, and
refused when asked for: observability (``obs``, ROADMAP Queue 1 item 9),
guards, fault injection, checkpoints and emergency dumps (item 8).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from ..backend import ForceBackend, ForceRequest
from ..health import GuardConfig, WindowVerdict
from . import observables
from .forcefield import ForceFieldConfig, classical_forces
from .integrators import (MDState, berendsen_rescale, init_velocities,
                          leapfrog_step)
from .neighbors import NeighborList, build_neighbor_list, needs_rebuild
from .system import System

_ITEM_8 = "ROADMAP Queue 1 item 8 (ckpt/ and health/)"
_ITEM_9 = "ROADMAP Queue 1 item 9 (obs/)"


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet ({item})")


@dataclasses.dataclass
class EngineConfig:
    dt: float = 0.002                  # ps (paper Tab. II)
    cutoff: float = 1.2                # classical cutoff
    skin: float = 0.1                  # Verlet buffer
    neighbor_capacity: int = 96
    rebuild_every: int = 10            # also displacement-triggered
    thermostat_t: Optional[float] = None
    thermostat_tau: float = 0.5
    checkpoint_every: int = 0          # steps; 0 = off (item 8)
    checkpoint_path: Optional[str] = None
    loop_mode: str = "scan"            # "scan" (windows) | "step"
    max_capacity_growths: int = 6      # doublings before giving up
    emergency_path: Optional[str] = None  # unrecoverable-verdict dumps (item 8)
    ff: ForceFieldConfig = dataclasses.field(default_factory=ForceFieldConfig)


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (a.index if a.index is not None else cur) == (
        b.index if b.index is not None else cur)


class MDEngine:
    """Host-side loop of the MD engine.

    The window machinery (segments between host boundaries, displacement
    rebuilds inside them, grow-and-replay on overflow, observe cadence) is
    meant to be shared with a replica-batched engine: per-trajectory flags
    are shaped ``_batch_shape`` (``()`` here), host decisions reduce with
    any()/sum(), and the rebuild check / integrator / observation packaging
    are overridable hooks.
    """

    _batch_shape: tuple = ()        # leading shape of per-trajectory flags
    _extra_boundary_every: int = 0  # extra host boundary (replica exchange)

    def __init__(self, system: System, config: EngineConfig,
                 special_force: Optional[ForceBackend] = None,
                 obs=None, guard: Optional[GuardConfig] = None,
                 faults=None, checkpointer=None):
        if obs is not None:
            raise _not_ported("observability (obs)", _ITEM_9)
        if guard is not None and guard.enabled:
            raise _not_ported("guarded execution (guard.enabled)", _ITEM_8)
        if faults is not None:
            raise _not_ported("fault injection (faults)", _ITEM_8)
        if checkpointer is not None:
            raise _not_ported("asynchronous checkpoints (checkpointer)",
                              _ITEM_8)
        if config.checkpoint_every or config.checkpoint_path:
            raise _not_ported("checkpoints (checkpoint_every, "
                              "checkpoint_path)", _ITEM_8)
        if config.emergency_path:
            raise _not_ported("emergency dumps (emergency_path)", _ITEM_8)
        self.system = system
        self.device = system.device
        sp_dev = getattr(special_force, "device", None)
        if sp_dev is not None and not _same_device(torch.device(sp_dev),
                                                   self.device):
            raise ValueError(
                f"the special force lives on {sp_dev}, the system on "
                f"{self.device}: the engine runs on its system's device "
                "and moves no force between devices")
        self.config = config
        self.special_force = special_force
        self._stateful = bool(getattr(special_force, "stateful", False))
        # host-side backends block on host round trips: per-step loop
        self._host_special = bool(getattr(special_force, "host_side", False))
        self._cell_cap_scale = 1.0
        self._build_fns()
        self.timings: dict[str, float] = self._init_timings()
        self.diagnostics: dict = self._init_diagnostics()

    def _init_timings(self) -> dict:
        return {"classical": 0.0, "special": 0.0, "integrate": 0.0,
                "neighbor": 0.0, "scan": 0.0}

    def _init_diagnostics(self) -> dict:
        return {"capacity_growths": [],
                "special_growths": 0,
                "displacement_rebuilds": 0,
                "special_rebuilds": 0,
                "cadence_rebuilds": 0,
                "window_reruns": 0,
                "emergency_dumps": []}

    def reset(self) -> None:
        """Zero ``timings`` and ``diagnostics``.  ``run`` resets ``timings``
        on entry (they are per-run); ``diagnostics`` are cumulative across
        runs (capacity growths outlive the run that triggered them)."""
        self.timings = self._init_timings()
        self.diagnostics = self._init_diagnostics()

    def _sync(self) -> None:
        """Wait for the device (``jax.block_until_ready`` in the reference)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- construction ------------------------------------------------------

    def _eval_special_stateless(self, positions, box):
        """Per-step special force through the ForceBackend protocol
        (``compute`` with a typed request)."""
        res = self.special_force.compute(ForceRequest(positions=positions,
                                                      box=box))
        return res.energy, res.forces

    def _classical_one(self, pos, nlist):
        """Single-trajectory classical (energy, forces)."""
        return classical_forces(pos, self.system, nlist, self.config.ff, True)

    def _integrate_one(self, state: MDState, f, thermostat_t):
        """Single-trajectory leapfrog + optional Berendsen rescale toward
        ``thermostat_t`` (None disables)."""
        cfg = self.config
        new = leapfrog_step(state, f, self.system.masses, self.system.box,
                            cfg.dt)
        if thermostat_t is not None:
            v = berendsen_rescale(new.velocities, self.system.masses,
                                  thermostat_t, cfg.dt, cfg.thermostat_tau)
            new = dataclasses.replace(new, velocities=v)
        return new

    def _build_fns(self):
        cfg = self.config
        self._classical_fn = self._classical_one
        self._integrate_fn = (
            lambda state, f: self._integrate_one(state, f, cfg.thermostat_t))

    def _step_parts(self, state: MDState, nlist: NeighborList, sp_state):
        """One step from already-valid lists: the scan windows' core.

        Returns (new_state, nlist_out, sp_state_out, e_cl, e_sp, rb, sp_rb,
        sp_ovf): ``rb`` and ``sp_rb`` are host bools, fetched together in
        the step's one host read; ``sp_ovf`` stays on the device.  The
        special force is evaluated before the classical list is rebuilt
        (the two are independent), so both flags are known at once.
        """
        special = self.special_force
        rb = self._check_rebuild(nlist, state.positions).any()
        e_sp = torch.zeros(self._batch_shape, device=self.device)
        sp_ovf = torch.zeros(self._batch_shape, dtype=torch.bool,
                             device=self.device)
        f_sp, sp_rb = None, False
        if special is not None and self._stateful:
            # evaluate first: the displacement check comes out of the
            # evaluation's own flags; when it fires, the stale result is
            # discarded: rebuild and re-evaluate
            e_sp, f_sp, fl = special.evaluate(state.positions, sp_state)
            rb, sp_rb = torch.stack([
                rb, torch.as_tensor(fl["needs_rebuild"],
                                    device=self.device).any()]).tolist()
        else:
            rb = bool(rb)
        if rb:
            nlist = self.build_nlist(state.positions)
        e_cl, f = self._classical_fn(state.positions, nlist)
        if special is not None:
            if self._stateful:
                if sp_rb:
                    sp_state = special.assemble(state.positions)
                    e_sp, f_sp, fl = special.evaluate(state.positions,
                                                      sp_state)
                sp_ovf = torch.as_tensor(fl["overflow"], device=self.device)
            else:
                e_sp, f_sp = self._eval_special_stateless(state.positions,
                                                          self.system.box)
            f = f + f_sp
        new = self._integrate_fn(state, f)
        return new, nlist, sp_state, e_cl, e_sp, rb, sp_rb, sp_ovf

    def _check_rebuild(self, nlist: NeighborList, positions) -> torch.Tensor:
        """Displacement-triggered rebuild flag(s), shaped ``_batch_shape``."""
        return needs_rebuild(nlist, positions, self.system.box,
                             self.config.skin)

    def _run_window(self, k: int, state, nlist, sp_state):
        """``k`` steps back to back (JAX's ``lax.scan`` window): returns the
        carry and the window's flags (rebuild counts on the host, overflow
        flags on the device)."""
        flags = {"rebuilds": 0, "sp_rebuilds": 0,
                 "nlist_overflow": torch.zeros(self._batch_shape,
                                               dtype=torch.bool,
                                               device=self.device)}
        flags["sp_overflow"] = flags["nlist_overflow"]
        e_cl = e_sp = None
        for _ in range(k):
            (state, nlist, sp_state, e_cl, e_sp, rb, sp_rb,
             sp_ovf) = self._step_parts(state, nlist, sp_state)
            flags["rebuilds"] += int(rb)
            flags["sp_rebuilds"] += int(sp_rb)
            flags["nlist_overflow"] = flags["nlist_overflow"] | nlist.overflow
            flags["sp_overflow"] = flags["sp_overflow"] | sp_ovf
        return state, nlist, sp_state, flags, e_cl, e_sp

    # -- lifecycle ---------------------------------------------------------

    def init_state(self, positions: torch.Tensor, temperature: float = 300.0,
                   seed: int = 0) -> MDState:
        """Maxwell-Boltzmann velocities from a generator seeded ``seed`` on
        the engine's device; ``rng`` holds its state after the draw."""
        if not _same_device(positions.device, self.device):
            raise ValueError(f"positions on {positions.device}, the system "
                             f"on {self.device}")
        gen = torch.Generator(device=self.device).manual_seed(seed)
        v = init_velocities(gen, self.system.masses, temperature)
        return MDState(positions=positions, velocities=v,
                       forces=torch.zeros_like(positions),
                       step=torch.zeros((), dtype=torch.int32,
                                        device=self.device),
                       rng=gen.get_state())

    def build_nlist(self, positions) -> NeighborList:
        cfg = self.config
        return build_neighbor_list(positions, self.system.box, cfg.cutoff,
                                   cfg.neighbor_capacity, half=True,
                                   skin=cfg.skin,
                                   cell_cap_scale=self._cell_cap_scale)

    # -- capacity growth (mid-run overflow does not kill the run) ----------

    def _grow_neighbor_capacity(self) -> None:
        cfg = self.config
        if len(self.diagnostics["capacity_growths"]) >= cfg.max_capacity_growths:
            self._emergency("neighbor capacity still exceeded after "
                            f"{cfg.max_capacity_growths} doublings")
        cfg.neighbor_capacity *= 2
        self._cell_cap_scale *= 2.0  # cell occupancy can be the overflow too
        self.diagnostics["capacity_growths"].append(cfg.neighbor_capacity)

    def _build_nlist_grown(self, positions) -> NeighborList:
        """Build the classical list, doubling capacity until it fits."""
        while True:
            nlist = self.build_nlist(positions)
            if not bool(nlist.overflow.any()):
                return nlist
            self._grow_neighbor_capacity()

    def _assemble_special_grown(self, positions):
        """Assemble the special-force state, growing its capacities on
        overflow (surfaced in diagnostics)."""
        special = self.special_force
        for _ in range(self.config.max_capacity_growths + 1):
            sp_state = special.assemble(positions)
            if not bool(torch.as_tensor(
                    special.state_overflow(sp_state)).any()):
                return sp_state
            special.grow()
            self.diagnostics["special_growths"] += 1
        self._emergency("special-force capacity still exceeded after "
                        f"{self.config.max_capacity_growths} doublings")

    # -- main loop ---------------------------------------------------------

    def _segment_len(self, i: int, n_steps: int, observing: bool,
                     observe_every: int) -> int:
        """Steps until the next host boundary (rebuild cadence, observe, or
        end of run), counting from relative step ``i``."""
        cfg = self.config
        ends = [n_steps]
        re = cfg.rebuild_every
        ends.append((i // re + 1) * re)
        if self._extra_boundary_every:
            ee = self._extra_boundary_every
            ends.append((i // ee + 1) * ee)
        if observing:
            # observation happens after relative steps 1, 1+obs, 1+2*obs, ...
            ends.append(i + 1 if i % observe_every == 0
                        else ((i - 1) // observe_every + 1) * observe_every + 1)
        return max(1, min(e for e in ends if e > i) - i)

    def _window_verdict(self, flags) -> WindowVerdict:
        """Host-side verdict for one finished window's device flags (one
        host read).  Guards are refused, so no guard trip arises."""
        nlist_ovf, sp_ovf = torch.stack([flags["nlist_overflow"].any(),
                                         flags["sp_overflow"].any()]).tolist()
        if nlist_ovf or sp_ovf:
            return WindowVerdict("capacity_overflow",
                                 detail={"nlist": nlist_ovf,
                                         "special": sp_ovf})
        return WindowVerdict("ok")

    def _run_segment_scan(self, state, nlist, sp_state, k: int):
        """One window, dispatched through the ``WindowVerdict`` ->
        ``RECOVERY_POLICY`` table: commit, or grow and replay from the
        window's saved start on capacity overflow."""
        start = (state, nlist, sp_state)
        while True:
            t0 = time.perf_counter()
            (state, nlist, sp_state, flags, e_cl,
             e_sp) = self._run_window(k, *start)
            self._sync()
            self.timings["scan"] += time.perf_counter() - t0
            verdict = self._window_verdict(flags)
            if verdict.policy == "commit":
                self.diagnostics["displacement_rebuilds"] += flags["rebuilds"]
                self.diagnostics["special_rebuilds"] += flags["sp_rebuilds"]
                return state, nlist, sp_state, e_cl, e_sp
            self.diagnostics["window_reruns"] += 1
            state0, nlist0, sp_state0 = start
            # grow whichever capacity overflowed: correctness over
            # throughput on the rare growth event
            if verdict.detail["nlist"]:
                self._grow_neighbor_capacity()
                nlist0 = self._build_nlist_grown(state0.positions)
            if self._stateful and verdict.detail["special"]:
                self.special_force.grow()
                self.diagnostics["special_growths"] += 1
                sp_state0 = self._assemble_special_grown(state0.positions)
            start = (state0, nlist0, sp_state0)

    def _run_segment_step(self, state, nlist, sp_state, k: int):
        """The per-step host loop over one segment (capacity overflow is
        handled inline per step; guard rollback is item 8's)."""
        return self._attempt_segment_step(state, nlist, sp_state, k)

    def _attempt_segment_step(self, state, nlist, sp_state, k: int):
        """One per-step segment: the Fig.-9 stage timers, each stage
        synchronised."""
        cfg = self.config
        special = self.special_force
        e_cl = e_sp = torch.zeros(self._batch_shape, device=self.device)
        for _ in range(k):
            t0 = time.perf_counter()
            if bool(self._check_rebuild(nlist, state.positions).any()):
                nlist = self._build_nlist_grown(state.positions)
                self.diagnostics["displacement_rebuilds"] += 1
            self._sync()
            self.timings["neighbor"] += time.perf_counter() - t0

            t0 = time.perf_counter()
            e_cl, f = self._classical_fn(state.positions, nlist)
            self._sync()
            self.timings["classical"] += time.perf_counter() - t0

            if special is not None:
                t0 = time.perf_counter()
                if self._stateful:
                    e_sp, f_sp, fl = special.evaluate(state.positions,
                                                      sp_state)
                    if bool(torch.as_tensor(fl["needs_rebuild"]).any()):
                        sp_state = self._assemble_special_grown(
                            state.positions)
                        self.diagnostics["special_rebuilds"] += 1
                        e_sp, f_sp, fl = special.evaluate(state.positions,
                                                          sp_state)
                    while bool(torch.as_tensor(fl["overflow"]).any()):
                        # evaluation-side overflow (e.g. k_eval trim): grow
                        # and recompute, as the scan replay does
                        special.grow()
                        self.diagnostics["special_growths"] += 1
                        if self.diagnostics["special_growths"] > (
                                cfg.max_capacity_growths):
                            self._emergency(
                                "special-force capacity still exceeded "
                                f"after {cfg.max_capacity_growths} doublings")
                        sp_state = self._assemble_special_grown(
                            state.positions)
                        e_sp, f_sp, fl = special.evaluate(state.positions,
                                                          sp_state)
                else:
                    e_sp, f_sp = self._eval_special_stateless(
                        state.positions, self.system.box)
                f = f + f_sp
                self._sync()
                self.timings["special"] += time.perf_counter() - t0

            t0 = time.perf_counter()
            state = self._integrate_fn(state, f)
            self._sync()
            self.timings["integrate"] += time.perf_counter() - t0
        return state, nlist, sp_state, e_cl, e_sp

    def _emergency(self, reason: str):
        """Unrecoverable verdict: record it and raise (the emergency
        checkpoint and diagnostics bundle are item 8's)."""
        self.diagnostics["emergency_dumps"].append(reason)
        raise RuntimeError(reason)

    @torch.no_grad()
    def run(self, state: MDState, n_steps: int,
            observe: Optional[Callable[[MDState, dict], None]] = None,
            observe_every: int = 10) -> MDState:
        cfg = self.config
        if not _same_device(state.positions.device, self.device):
            raise ValueError(f"state on {state.positions.device}, the "
                             f"system on {self.device}")
        # timings are per-run; diagnostics stay cumulative (see reset())
        self.timings = self._init_timings()
        scan_mode = cfg.loop_mode != "step" and not self._host_special
        t0 = time.perf_counter()
        nlist = self._build_nlist_grown(state.positions)
        sp_state = None
        if self._stateful:
            sp_state = self._assemble_special_grown(state.positions)
        self.timings["neighbor"] += time.perf_counter() - t0

        i = 0
        while i < n_steps:
            if i > 0 and i % cfg.rebuild_every == 0:
                # cadence rebuild on the host (the redundant step-0 rebuild
                # right after the pre-loop build is skipped)
                t0 = time.perf_counter()
                nlist = self._build_nlist_grown(state.positions)
                if self._stateful:
                    sp_state = self._assemble_special_grown(state.positions)
                self.diagnostics["cadence_rebuilds"] += 1
                self.timings["neighbor"] += time.perf_counter() - t0

            k = self._segment_len(i, n_steps, observe is not None,
                                  observe_every)
            if scan_mode:
                state, nlist, sp_state, e_cl, e_sp = self._run_segment_scan(
                    state, nlist, sp_state, k)
            else:
                state, nlist, sp_state, e_cl, e_sp = self._run_segment_step(
                    state, nlist, sp_state, k)
            i += k
            state = self._post_segment(state, e_cl, e_sp, i)

            if observe is not None and (i - 1) % observe_every == 0:
                observe(state, self._observation(state, e_cl, e_sp))
        return state

    # -- batched-engine hooks ----------------------------------------------

    def _abs_step(self, state) -> int:
        return int(state.step)

    def _post_segment(self, state, e_cl, e_sp, i: int):
        """Host boundary between windows (replica exchange hook)."""
        return state

    def _observation(self, state, e_cl, e_sp) -> dict:
        return {
            "step": self._abs_step(state),
            "e_classical": float(e_cl),
            "e_special": float(e_sp),
            "temperature": float(observables.temperature(
                state.velocities, self.system.masses)),
        }

    # -- fault tolerance ----------------------------------------------------

    def checkpoint(self, state: MDState, path: str) -> None:
        raise _not_ported("MDEngine.checkpoint", _ITEM_8)

    @staticmethod
    def restore(path: str) -> MDState:
        raise _not_ported("MDEngine.restore", _ITEM_8)
