"""Deterministic fault injection: one plan, four seams.

Port of ``repro/health/faults.py``.  Where JAX reads the plan at trace
time, the port reads it at call time: a fired spec contributes nothing to
the next call, so a consumed plan computes the unfaulted step.

A :class:`FaultPlan` is an explicit, ordered list of :class:`FaultSpec`
entries threaded through the subsystems under test:

``nan_force``
    Poison the total force with NaN.  With ``rank=None`` the injection is
    *engine-level*: a device-side ``torch.where(step == s, nan, f)`` inside
    ``MDEngine._step_parts`` (no host read), in both loop modes and (via
    ``replica=``) per replica of a batched engine.  With ``rank=r`` it goes
    through the :class:`~repro_torch.core.pipeline.ForcePipeline`
    ``fault_hook`` seam instead, poisoning rank *r*'s slice of the leading
    virtual-rank axis before the force reduction, so the failure propagates
    through the reduction the way a real blown rank would; the engine arms
    it only for the window containing ``step`` (the pipeline functions have
    no step operand, so rank faults have window granularity).
``overflow_flag``
    Force the special-force overflow window flag at ``step`` without a real
    capacity miss — exercises grow-and-replay's verdict path; the engine
    detects the injection and replays *without* growing (scan mode only).
``serve_fail`` / ``serve_delay``
    Raise / sleep ``delay_s`` before the ``nth``-th dispatched serve batch
    (:meth:`FaultPlan.before_bucket_eval`, called by
    ``repro_torch.serve.ForceServer`` before each bucket evaluation).
``truncate_ckpt``
    After the ``nth``-th (or step-matching) ``AsyncCheckpointer`` save,
    truncate the written shard file — exercises CRC verification and
    ``restore_latest``'s fall-back-to-newest-verified.

Every fault is **one-shot**: once fired it is never re-injected.  The
engine disarms fired faults before replaying, so the replayed window runs
*without* the injection: it computes what a never-faulted run computes,
which is what makes the recovery reproducible bit for bit (the contract
``tests/test_torch_health.py`` enforces).
The plan itself is deterministic by construction: no randomness, faults
fire at exact steps/batches, and two runs with the same plan inject
identically.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Sequence

import torch

FAULT_KINDS = ("nan_force", "overflow_flag", "serve_fail", "serve_delay",
               "truncate_ckpt")

_ENGINE_KINDS = ("nan_force", "overflow_flag")


class InjectedFault(RuntimeError):
    """Raised by a ``serve_fail`` injection inside the serve executor."""


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault.  Which fields apply depends on ``kind`` (see
    the module docstring); ``fired``/``armed`` are runtime bookkeeping."""

    kind: str
    step: Optional[int] = None      # absolute MD step (nan/overflow/ckpt)
    rank: Optional[int] = None      # dd rank (nan_force via pipeline seam)
    replica: Optional[int] = None   # ensemble replica (None = all)
    nth: Optional[int] = None       # k-th serve batch / k-th checkpoint save
    delay_s: float = 0.0            # serve_delay sleep
    fired: bool = False
    armed: bool = True              # rank faults are window-armed by engine

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected "
                             f"one of {FAULT_KINDS}")
        if self.kind in _ENGINE_KINDS and self.step is None:
            raise ValueError(f"{self.kind} needs an absolute `step`")
        if self.kind in ("serve_fail", "serve_delay") and self.nth is None:
            raise ValueError(f"{self.kind} needs `nth` (1-based batch index)")
        if self.kind == "truncate_ckpt" and (self.nth is None
                                             and self.step is None):
            raise ValueError("truncate_ckpt needs `nth` or `step`")


class FaultPlan:
    """Deterministic fault schedule shared by all seams.

    Construct one plan, hand it to every subsystem under test::

        plan = FaultPlan([FaultSpec("nan_force", step=5)])
        eng = MDEngine(system, cfg, special_force=provider, guard=guard,
                       faults=plan)
        # rank-targeted pipeline faults additionally need the hook:
        provider = DeepmdForceProvider(..., fault_hook=plan.pipeline_hook())
        ckpt = AsyncCheckpointer(root, fault_plan=plan)

    The seams consult the plan's *armed/unfired* specs at every call: a
    plan with every fault fired injects nothing and computes what
    ``faults=None`` computes.
    """

    def __init__(self, faults: Sequence[FaultSpec]):
        self.faults = list(faults)
        for s in self.faults:
            if not isinstance(s, FaultSpec):
                raise TypeError(f"expected FaultSpec, got {type(s).__name__}")
            # rank-targeted faults start disarmed: the engine arms them for
            # the window containing their step (sync_window)
            if s.kind in _ENGINE_KINDS and s.rank is not None:
                s.armed = False
        self._ckpt_saves = 0
        self._serve_batches = 0

    # -- bookkeeping ---------------------------------------------------------

    def pending(self) -> list[FaultSpec]:
        return [s for s in self.faults if not s.fired]

    def summary(self) -> dict:
        return {"total": len(self.faults),
                "fired": sum(s.fired for s in self.faults),
                "pending": [dataclasses.asdict(s) for s in self.pending()]}

    # -- engine seam (device-side, exact step) -------------------------------

    def apply_engine(self, step, f, sp_ovf):
        """Device-side injection inside ``MDEngine._step_parts``.

        ``step`` is the pre-integration step counter (a tensor on the
        engine's device) shaped like the engine's ``_batch_shape``; ``f``
        the total force (..., N, 3); ``sp_ovf`` the special-overflow flag.
        The step comparison stays on the device: no host read.
        Fired/rank-targeted specs contribute nothing, so a consumed plan
        returns its inputs.
        """
        for s in self.faults:
            if (s.fired or s.rank is not None
                    or s.kind not in _ENGINE_KINDS):
                continue
            trig = torch.as_tensor(step, device=f.device) == s.step
            if s.replica is not None and trig.ndim == 1:
                trig = trig & (torch.arange(trig.shape[0], device=f.device)
                               == s.replica)
            if s.kind == "nan_force":
                mask = trig.reshape(trig.shape + (1,) * (f.ndim - trig.ndim))
                f = torch.where(mask, torch.full_like(f, float("nan")), f)
            else:  # overflow_flag
                sp_ovf = sp_ovf | trig
        return f, sp_ovf

    def sync_window(self, step0: int, k: int) -> bool:
        """Arm rank-targeted faults whose step falls in [step0, step0+k),
        disarm the rest.  Returns True when any armed state changed (the
        reference engine then re-traces; the port reads the hook's state at
        every call)."""
        changed = False
        for s in self.faults:
            if s.fired or s.rank is None or s.kind not in _ENGINE_KINDS:
                continue
            want = step0 <= s.step < step0 + k
            if s.armed != want:
                s.armed = want
                changed = True
        return changed

    def consume_in_window(self, step0: int, end: int,
                          kinds: Optional[tuple] = None) -> list[FaultSpec]:
        """Mark MD-path faults with step in [step0, end) as fired (one-shot
        disarm before a replay).  Returns the newly fired specs."""
        fired = []
        for s in self.faults:
            if s.fired or s.kind not in _ENGINE_KINDS:
                continue
            if kinds is not None and s.kind not in kinds:
                continue
            if not (step0 <= s.step < end):
                continue
            s.fired = True
            s.armed = False
            fired.append(s)
        return fired

    # -- pipeline seam (rank-targeted, window-armed) -------------------------

    def pipeline_hook(self):
        """Build the ``ForcePipeline(fault_hook=...)`` callable.

        Called once per evaluation, before the force reduction, as
        ``hook(rank, rep0, e_local, f_global)``: ``rank`` is the virtual
        rank of each row of the per-rank axis ((G,), or (R, G) from a
        replica-batched pipeline), ``rep0`` the global index of the first
        resident replica (0 unless a 2-D ``make_ensemble_mesh`` layout
        shards the replicas: shard ``rs`` holds them from ``rs * Rl``),
        and ``f_global`` the per-rank pre-reduce forces ((G, n, 3), or
        (R, G, n, 3) batched, over the resident replicas and the ranks
        held here).  Armed specs poison rank ``r``'s slice, and with
        ``replica`` set (batched) only that replica's: the other replicas
        compute what an unfaulted call computes.  The armed/unfired set
        is read at each call, so once the engine fires a
        spec the hook returns its inputs.
        """
        plan = self

        def hook(rank, rep0, e_local, f_global):
            for s in plan.faults:
                if (s.kind != "nan_force" or s.rank is None
                        or s.fired or not s.armed):
                    continue
                rank_t = torch.as_tensor(rank, device=f_global.device)
                bad = rank_t == s.rank
                if s.replica is not None and f_global.ndim == 4:
                    resident = rep0 + torch.arange(f_global.shape[0],
                                                   device=f_global.device)
                    bad = bad & (resident == s.replica)[:, None]
                bad = bad.reshape(bad.shape + (1,) * (f_global.ndim
                                                      - bad.ndim))
                f_global = torch.where(
                    bad, torch.full_like(f_global, float("nan")), f_global)
            return e_local, f_global

        return hook

    # -- serve seam ----------------------------------------------------------

    def before_bucket_eval(self) -> None:
        """Called by a force server before each dispatch; fires matching
        ``serve_fail``/``serve_delay`` specs (1-based batch count across
        the server's lifetime)."""
        self._serve_batches += 1
        k = self._serve_batches
        for s in self.faults:
            if s.fired or s.kind not in ("serve_fail", "serve_delay"):
                continue
            if s.nth != k:
                continue
            s.fired = True
            if s.kind == "serve_delay":
                time.sleep(s.delay_s)
            else:
                raise InjectedFault(
                    f"injected serve executor failure on batch {k}")

    # -- checkpoint seam -----------------------------------------------------

    def after_checkpoint_save(self, path: str, step: Optional[int]) -> None:
        """Called by ``AsyncCheckpointer`` after each completed save;
        truncates the shard of a matching ``truncate_ckpt`` spec (matched
        by 1-based save ordinal ``nth`` or by ``step``)."""
        self._ckpt_saves += 1
        k = self._ckpt_saves
        for s in self.faults:
            if s.fired or s.kind != "truncate_ckpt":
                continue
            if s.nth is not None and s.nth != k:
                continue
            if s.nth is None and s.step is not None and s.step != step:
                continue
            s.fired = True
            shard = os.path.join(path, "shard_host0.npz")
            if os.path.exists(shard):
                size = os.path.getsize(shard)
                with open(shard, "r+b") as f:
                    f.truncate(max(size // 2, 1))
