"""ForceServer: a resident DP evaluator behind a batching queue.

Port of ``repro/serve/server.py``.  One process-wide evaluator serves force
calls from many independent client simulations (threads in-process; the
wire format is :class:`repro_torch.backend.ForceRequest` with host
tensors, so a transport can be bolted on without touching the batching
core):

  submit -> bounded queue -> batching worker -> shape bucket -> pad ->
  one batched dispatch on the device -> per-request results (host)

Scheduling ("continuous batching"): the worker takes whatever is queued the
moment it frees up — it waits at most ``batch_window_s`` for stragglers —
pads the group to the nearest (batch x atoms) bucket and dispatches.
Clients blocked on their own previous step re-synchronise on the next
batch, so N concurrent simulations ride one dispatch instead of N.

Degradation is per request, never global: a request past its deadline is
answered ``ok=False`` without consuming compute, a full queue rejects at
submit time (:class:`ServerOverloaded` backpressure), an evaluator failure
or a neighbour-capacity overflow errors only the affected rows, and every
outcome lands in the per-tenant metrics.

The worker thread runs its device work on the model's device and on a
stream of its own; before a result is handed back that stream is
synchronised and the result copied to the host, so a client on another
thread (and stream) never reads a force the device has not finished.

Over a process mesh (``pipeline_executor_factory(..., mesh_for=...)``, a
``(replica x dd)`` :class:`~repro_torch.launch.mesh.EnsembleMesh` per
batch bucket) process 0 runs this server and every other process runs
:func:`follow_dispatches`.  Each dispatch on process 0 (the worker's,
``evaluate_direct``'s, ``warmup``'s) broadcasts its op, bucket and padded
rows on a group of every process under one lock, then evaluates; the
followers receive and evaluate the same bucket, so every process joins
every collective in the same order.  While the server is idle, process 0
broadcasts a header of no work every :data:`KEEPALIVE_S` (at most), so no
follower waits into the group's timeout.  What degrades a request (an expired
deadline, a full queue, an injected ``serve_fail`` or ``serve_delay``)
happens on process 0 before the broadcast; a failure after it
(:class:`ServeGroupBroken`) answers every pending request ``ok=False``,
stops the server and is raised from ``stop()``; ``stop()`` otherwise
broadcasts the stop op, and the followers return.
"""
from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..backend import ForceRequest, ForceResult
from ..core.ddinfer import make_padded_batch_fn
from ..dp.model import DPModel
from ..obs import Tracer
from .batching import BucketingConfig, choose_bucket, pad_group
from .metrics import MetricsRegistry


class ServerOverloaded(RuntimeError):
    """Backpressure: the bounded request queue is full — retry later."""


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving knobs."""

    atom_buckets: tuple[int, ...] = (64, 128, 256)   # dispatch atom shapes
    batch_buckets: tuple[int, ...] = (1, 2, 4, 8)    # dispatch batch shapes
    queue_bound: int = 64          # max queued requests before rejection
    batch_window_s: float = 0.002  # max straggler wait (0 = drain, no wait)
    default_timeout_s: float = 30.0    # deadline when the request has none
    nbr_capacity: int = 64         # neighbour capacity per atom bucket
    metrics_window_s: float = 5.0  # trailing rps window
    max_retries: int = 0           # compute() retries on ServerOverloaded
    retry_backoff_s: float = 0.01  # first retry delay (doubles per attempt)
    retry_backoff_max_s: float = 0.5   # backoff ceiling

    @property
    def bucketing(self) -> BucketingConfig:
        return BucketingConfig(self.atom_buckets, self.batch_buckets)


class ForceFuture:
    """Client handle for one in-flight request."""

    def __init__(self, request: ForceRequest):
        self.request = request
        self.t_submit = time.monotonic()
        self._event = threading.Event()
        self._result: Optional[ForceResult] = None

    def _deliver(self, result: ForceResult) -> None:
        self._result = result
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> ForceResult:
        """Block until the server answers; raises ``TimeoutError`` when the
        wait budget runs out first (the server still settles the request as
        a deadline drop, so the metrics stay consistent)."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"force request {self.request.req_id} "
                f"(tenant {self.request.tenant!r}) not answered "
                f"within {timeout}s")
        return self._result


def _zeros_result(req: ForceRequest, error: str, **diag) -> ForceResult:
    return ForceResult(
        energy=torch.zeros(()), forces=torch.zeros(req.n_atoms, 3),
        diagnostics=diag, tenant=req.tenant, req_id=req.req_id,
        ok=False, error=error)


class ServeGroupBroken(RuntimeError):
    """A served dispatch over a process mesh failed after its broadcast
    (a collective or an executor error on some process), or a keep-alive
    broadcast failed: the group can no longer be trusted, so the server
    answers every pending request ``ok=False``, stops, and raises this
    from :meth:`ForceServer.stop`, ``submit`` and the call that hit it."""


# the ops process 0 broadcasts to the followers of a served mesh
OP_STOP, OP_EVALUATE, OP_WARMUP, OP_KEEPALIVE = 0, 1, 2, 3
# seconds idle before process 0 sends a keep-alive header (at most; an
# eighth of the followers' header timeout where that is given)
KEEPALIVE_S = 5.0


class _Broadcast:
    """The one broadcast point of a served pipeline over processes: the
    header ``(op, n_bucket, batch_bucket)`` and the padded coordinates
    with their mask, ``(B, nb, 4)`` fp32, from process 0 on a group of
    every process (its timeout ``follow_timeout``: how long a follower
    waits for the next header), on the mesh's device (through the host
    where the mesh's backend is gloo on CUDA tensors).

    Every send holds :attr:`lock`.  On process 0 a keep-alive thread sends
    a header of no work whenever :attr:`keepalive_s` has passed with no
    dispatch (:data:`KEEPALIVE_S`, or an eighth of ``follow_timeout``),
    so the followers of an idle server never wait into the group's
    timeout."""

    def __init__(self, mesh, follow_timeout=None):
        import torch.distributed as dist
        self.dist = dist
        self.device = mesh.device
        self.wire = torch.device("cpu") if mesh.dd.host_copy else mesh.device
        self.rank = dist.get_rank()
        self.group = dist.new_group(
            **({} if follow_timeout is None else {"timeout": follow_timeout}))
        self.lock = threading.Lock()
        self.stopped = False
        self.failure: Optional[BaseException] = None
        self.last = time.monotonic()     # the end of the last send or dispatch
        self._quit = threading.Event()
        self.keepalive_s = KEEPALIVE_S if follow_timeout is None else min(
            KEEPALIVE_S, follow_timeout.total_seconds() / 8)
        if self.rank == 0:
            threading.Thread(target=self._keep_alive, name="serve-keepalive",
                             daemon=True).start()

    def _bcast(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(self.wire)
        self.dist.broadcast(t, 0, group=self.group)
        return t.to(self.device)

    def send(self, op: int, n_bucket: int = 0, batch_bucket: int = 0,
             coords=None, mask=None) -> None:
        self._bcast(torch.tensor([op, n_bucket, batch_bucket]))
        if op in (OP_EVALUATE, OP_WARMUP):
            self._bcast(torch.cat([coords, mask[..., None].to(coords.dtype)],
                                  -1).contiguous())
        self.last = time.monotonic()

    def receive(self):
        op, nb, b = (int(v) for v in
                     self._bcast(torch.zeros(3, dtype=torch.int64)).cpu())
        if op not in (OP_EVALUATE, OP_WARMUP):
            return op, nb, b, None, None
        packed = self._bcast(torch.zeros(b, nb, 4))
        return op, nb, b, packed[..., :3].contiguous(), packed[..., 3]

    def broken(self, exc: ServeGroupBroken) -> ServeGroupBroken:
        """Record a failure after a broadcast (held under :attr:`lock`):
        no header is sent again.  Returns ``exc``."""
        self.stopped, self.failure = True, exc
        self._quit.set()
        return exc

    def stop(self) -> None:
        """Broadcast the stop op once (the followers return); raises
        :class:`ServeGroupBroken` where a broadcast or dispatch failed."""
        self._quit.set()
        with self.lock:
            if self.failure is not None:
                raise ServeGroupBroken(
                    f"the served mesh failed: {self.failure}"
                ) from self.failure
            if not self.stopped:
                self.stopped = True
                self.send(OP_STOP)

    def _keep_alive(self) -> None:
        while not self._quit.wait(self.keepalive_s / 2):
            with self.lock:
                if self.stopped:
                    return
                if time.monotonic() - self.last < self.keepalive_s:
                    continue
                try:
                    self.send(OP_KEEPALIVE)
                except Exception as exc:  # noqa: BLE001 — the next call raises
                    self.broken(ServeGroupBroken(
                        f"a keep-alive broadcast failed: {exc}"))
                    return


class _PipelineExecutors:
    """What :func:`pipeline_executor_factory` returns: called as
    ``factory(n_bucket, batch_bucket)`` it gives the server's executor of
    that bucket; over a process mesh it also builds the meshes
    (:meth:`prepare`), holds the one broadcast point, and stops the
    followers (:meth:`stop`).  ``kept`` (None, or a list) collects each
    dispatch's ``(op, n_bucket, batch_bucket, energy, forces, overflow)``
    on process 0, as :func:`follow_dispatches` does on the others."""

    def __init__(self, model: DPModel, box, types, cfg_for, ranks_for,
                 mesh_for, follow_timeout):
        if mesh_for is not None and ranks_for is not None:
            raise ValueError("ranks_for and mesh_for both given: over a "
                             "mesh each request's dd ranks are the mesh's")
        self.model, self.box, self.cfg_for = model, box, cfg_for
        self.ranks_for = ranks_for or (lambda b: max(8 // b, 1))
        self.mesh_for = mesh_for
        self.over_processes = mesh_for is not None
        self.follow_timeout = follow_timeout
        self.types = torch.as_tensor(np.asarray(types), device=model.device)
        self.meshes: dict = {}
        self.kept: Optional[list] = None
        self.bc: Optional[_Broadcast] = None
        self._runs: dict = {}

    @property
    def rank(self) -> int:
        return self.bc.rank

    def prepare(self, batch_buckets) -> None:
        """Build the meshes of ``batch_buckets`` (collective: every process
        in the same order) and, with the first, the broadcast point."""
        for b in batch_buckets:
            if b in self.meshes:
                continue
            mesh = self.mesh_for(b)
            rs = mesh.n_replica_shards
            if b % rs:
                raise ValueError(
                    f"the mesh for batch bucket {b} has {rs} replica "
                    f"shards, which do not divide the batch bucket {b}: "
                    "every shard holds the same number of requests")
            self.meshes[b] = mesh
            if self.bc is None:
                self.bc = _Broadcast(mesh, self.follow_timeout)

    def pipeline_fn(self, n_bucket: int, batch_bucket: int):
        """``run(params, coords, mask) -> (energy, forces, overflow)``: the
        bucket's pipeline, built once, with no broadcast."""
        key = (n_bucket, batch_bucket)
        if key in self._runs:
            return self._runs[key]
        from ..core.pipeline import ForcePipeline
        if self.mesh_for is None:
            mesh, ranks = None, self.ranks_for(batch_bucket)
        else:
            if batch_bucket not in self.meshes:
                raise ValueError(
                    f"no mesh was prepared for batch bucket {batch_bucket}:"
                    " factory.prepare(batch_buckets) builds them on every "
                    "process before the first request")
            mesh = self.meshes[batch_bucket]
            ranks = mesh.dd.n_ranks
        pipe = ForcePipeline(self.model, self.cfg_for(n_bucket, ranks),
                             self.box, n_bucket, n_replicas=batch_bucket,
                             mesh=mesh)
        bf = pipe.build_force_fn()
        types = self.types

        def run(params, coords, mask):
            live = mask.sum(1) > 0
            coords = torch.where(live[:, None, None], coords, coords[:1])
            e, f, diag = bf(params, coords, types)
            return e, f, diag["overflow"] > 0

        run.pipeline = pipe
        self._runs[key] = run
        return run

    def __call__(self, n_bucket: int, batch_bucket: int):
        run = self.pipeline_fn(n_bucket, batch_bucket)
        if not self.over_processes:
            def fn(params, coords, _types, mask, _box):
                return run(params, coords, mask)
        else:
            def fn(params, coords, _types, mask, _box, op=OP_EVALUATE):
                return self._dispatch(run, op, n_bucket, batch_bucket,
                                      params, coords, mask)
        fn.pipeline = run.pipeline
        return fn

    def _dispatch(self, run, op, n_bucket, batch_bucket, params, coords,
                  mask):
        bc = self.bc
        with bc.lock:
            if bc.failure is not None:
                raise ServeGroupBroken(
                    f"the served mesh failed: {bc.failure}") from bc.failure
            if bc.stopped:
                raise RuntimeError("the served mesh is stopped")
            try:
                bc.send(op, n_bucket, batch_bucket, coords, mask)
                e, f, ovf = run(params, coords, mask)
                if self.kept is not None:
                    self.kept.append((op, n_bucket, batch_bucket, e.cpu(),
                                      f.cpu(), ovf.cpu()))
            except Exception as exc:  # noqa: BLE001 — re-raised
                raise bc.broken(ServeGroupBroken(
                    f"a served dispatch over the process mesh failed "
                    f"after its broadcast (bucket {n_bucket} x "
                    f"{batch_bucket}): {exc}")) from exc
            bc.last = time.monotonic()
            return e, f, ovf

    def stop(self) -> None:
        """Broadcast the stop op (once): the followers return.  Raises
        :class:`ServeGroupBroken` where a dispatch or a keep-alive over
        the mesh failed (it waits for a dispatch in flight)."""
        if self.bc is not None:
            self.bc.stop()


def pipeline_executor_factory(model: DPModel, box, types, cfg_for,
                              ranks_for=None, mesh_for=None,
                              follow_timeout=None):
    """An ``executor_factory`` whose buckets are replica-batched
    :class:`~repro_torch.core.pipeline.ForcePipeline` dispatches.

    ``factory(n_bucket, batch_bucket)`` builds ONE pipeline per bucket —
    the coalesced requests are its replicas — and adapts its fused force
    function to the server's executor signature, so a batch costs one
    dispatch whose model kernels launch once.  All tenants must share this
    ``box``/``types`` and hold ``n_bucket`` atoms (the ensemble-farm
    scenario); the per-request boxes are ignored, and padding rows (a
    mask row of zeros) repeat the first request.  ``cfg_for(n_bucket,
    dd_ranks)`` supplies the :class:`DDConfig`.

    ``mesh_for=None``: the batch and dd axes are virtual axes of the
    model's device, each request decomposed over ``ranks_for(batch_bucket)``
    virtual ranks (default: 8 // batch, at least 1, the reference's split
    of an 8-device host).  ``mesh_for(batch_bucket) -> EnsembleMesh``
    (``launch.mesh.make_ensemble_mesh``): each bucket's pipeline runs over
    that ``(replica x dd)`` process mesh, its requests sharded over the
    replica axis and each decomposed over the mesh's dd ranks, and every
    process joins every dispatch.  ``factory.prepare(batch_buckets)``
    builds the meshes on every process in the same order (``ForceServer``
    calls it before its worker starts, a follower before its first
    receive; ``torch.distributed.new_group`` is collective) and refuses a
    mesh whose replica shards do not divide its bucket.  On process 0
    each executor call broadcasts its op, bucket and padded rows under one
    lock before it evaluates, and a header of no work goes out after
    :data:`KEEPALIVE_S` idle (or an eighth of ``follow_timeout``); the
    other processes run :func:`follow_dispatches`, which waits at most
    ``follow_timeout`` (a ``timedelta``; None: the default group's) for
    each header.  An error after a broadcast is :class:`ServeGroupBroken`.
    """
    return _PipelineExecutors(model, box, types, cfg_for, ranks_for,
                              mesh_for, follow_timeout)


def follow_dispatches(factory, params, batch_buckets, keep: bool = False):
    """The loop of every process but 0 of a server whose
    ``pipeline_executor_factory`` runs over a process mesh: builds the
    meshes of ``batch_buckets`` (in the server's order), then receives each
    dispatch process 0 broadcasts (its op, bucket and padded rows) and
    runs the same executor on it, until the stop op (a keep-alive header
    carries no work).  Returns the kept ``(op, n_bucket, batch_bucket,
    energy, forces, overflow)`` of every dispatch with ``keep`` (the same
    values on every process), else [].  An error (a collective's, the
    executor's, a header not received within ``follow_timeout``)
    propagates: the group is then unusable."""
    if not getattr(factory, "over_processes", False):
        raise ValueError("follow_dispatches takes a pipeline_executor_"
                         "factory built with mesh_for")
    factory.prepare(batch_buckets)
    if factory.rank == 0:
        raise ValueError("process 0 runs the ForceServer; the other "
                         "processes follow")
    kept = []
    while True:
        op, nb, b, coords, mask = factory.bc.receive()
        if op == OP_STOP:
            return kept
        if op == OP_KEEPALIVE:
            continue
        with torch.no_grad():
            e, f, ovf = factory.pipeline_fn(nb, b)(params, coords, mask)
        if keep:
            kept.append((op, nb, b, e.cpu(), f.cpu(), ovf.cpu()))


class ForceServer:
    """Multi-tenant batched force-inference server (in-process).

    ``model``/``params`` define the resident evaluator (on the model's
    device); every request is in *model* units and NN-group layout (the
    client stub owns unit conversion and the engine-layout scatter, as
    ``DeepmdForceProvider`` does).

    ``executor_factory`` swaps the execution engine per bucket: called as
    ``factory(n_bucket, batch_bucket)`` it must return ``fn(params,
    coords (B, nb, 3), types (B, nb), mask (B, nb), box (B, 3)) ->
    (energy (B,), forces (B, nb, 3), overflow (B,))`` on device tensors.
    The default wraps :func:`repro_torch.core.make_padded_batch_fn` (one
    batched model call per dispatch); :func:`pipeline_executor_factory`
    runs each bucket through a replica-batched ``ForcePipeline``; built
    with ``mesh_for`` it runs over a process mesh, this server on process
    0 and :func:`follow_dispatches` on the others (its meshes are built
    here, before the worker starts).
    """

    def __init__(self, model: DPModel, params, config: ServeConfig = None,
                 executor_factory=None, obs=None, fault_plan=None):
        self.model = model
        self.params = params
        self.device = model.device
        # health.FaultPlan seam: fails/stalls the executor on a chosen batch
        self.fault_plan = fault_plan
        self.config = config or ServeConfig()
        self.config.bucketing  # validate bucket lists early
        self.tracer = Tracer.ensure(obs)
        self.metrics = MetricsRegistry(self.config.metrics_window_s,
                                       obs_registry=self.tracer.registry)
        self._queue: queue.Queue = queue.Queue(self.config.queue_bound)
        self._executor_factory = executor_factory
        self._over_processes = getattr(executor_factory, "over_processes",
                                       False)
        if self._over_processes:
            executor_factory.prepare(self.config.batch_buckets)
            if executor_factory.rank != 0:
                raise ValueError("a ForceServer over a process mesh runs "
                                 "on process 0; the others run "
                                 "follow_dispatches")
        self._failure: Optional[BaseException] = None
        self._fns: dict = {}          # (atom, batch) bucket -> executor
        self._default_fns: dict = {}  # atom bucket -> shared evaluator
        self._req_ids = itertools.count()
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._serve_loop,
                                        name="force-server", daemon=True)
        self._worker.start()

    # -- client surface -----------------------------------------------------

    def submit(self, request: ForceRequest,
               timeout: Optional[float] = None) -> ForceFuture:
        """Enqueue one request; returns a :class:`ForceFuture`.

        Raises :class:`ServerOverloaded` when the bounded queue is full —
        the client should back off, not the server.  ``timeout`` (or the
        config default) becomes the request deadline when it has none.
        """
        if self._failure is not None:
            raise ServeGroupBroken(
                f"the server stopped: {self._failure}") from self._failure
        if self._stop.is_set():
            raise RuntimeError("server is stopped")
        if request.req_id == 0:
            request.req_id = next(self._req_ids) + 1
        if request.deadline is None:
            budget = (timeout if timeout is not None
                      else self.config.default_timeout_s)
            request.deadline = time.monotonic() + budget
        fut = ForceFuture(request)
        try:
            self._queue.put_nowait(fut)
        except queue.Full:
            self.metrics.update(request.tenant, "reject")
            raise ServerOverloaded(
                f"queue full ({self.config.queue_bound} requests); "
                f"tenant {request.tenant!r} must back off") from None
        self.metrics.update(request.tenant, "submit")
        return fut

    def compute(self, request: ForceRequest,
                timeout: Optional[float] = None) -> ForceResult:
        """Synchronous submit + wait (the client stub's hot path).

        ``ServerOverloaded`` is retried with bounded exponential backoff and
        deterministic jitter, up to ``ServeConfig.max_retries`` times and
        never past the original deadline; exhausted retries re-raise.
        Retries land in the ``serve.retries`` counter."""
        cfg = self.config
        budget = timeout if timeout is not None else cfg.default_timeout_s
        deadline = time.monotonic() + budget
        attempt = 0
        while True:
            try:
                fut = self.submit(request, timeout=budget)
            except ServerOverloaded:
                remaining = deadline - time.monotonic()
                if attempt >= cfg.max_retries or remaining <= 0:
                    raise
                delay = min(cfg.retry_backoff_s * (2.0 ** attempt),
                            cfg.retry_backoff_max_s)
                # jitter keyed on the request id: decorrelates a retry herd
                # without nondeterminism in tests
                delay *= 0.5 + 0.5 * (((request.req_id + 31 * attempt)
                                       % 16) / 15.0)
                time.sleep(min(delay, remaining))
                attempt += 1
                self.tracer.registry.counter("serve.retries").inc()
                continue
            return fut.result(budget + 1.0)

    def evaluate_direct(self, request: ForceRequest) -> ForceResult:
        """Bypass the queue: evaluate one request alone (the B=1 bucket) on
        the calling thread.  The looped baseline continuous batching is
        compared against; also the offline parity check."""
        out = self._run_bucket([request],
                               choose_bucket(request.n_atoms,
                                             self.config.atom_buckets))
        return out[0]

    def warmup(self, n_atoms: Optional[int] = None,
               batch_sizes: Optional[tuple] = None) -> None:
        """Run every (atom bucket x batch bucket) executor once on
        all-masked rows (kernel builds, library handles, allocator pools),
        so live traffic never pays a cold start; ``n_atoms`` warms only its
        atom bucket."""
        cfg = self.config
        buckets = (cfg.atom_buckets if n_atoms is None
                   else (choose_bucket(n_atoms, cfg.atom_buckets),))
        dev = self.device
        kw = {"op": OP_WARMUP} if self._over_processes else {}
        for nb in buckets:
            for b in (batch_sizes or cfg.batch_buckets):
                try:
                    self._bucket_fn(nb, b)(
                        self.params,
                        torch.zeros(b, nb, 3, device=dev),
                        torch.zeros(b, nb, dtype=torch.int32, device=dev),
                        torch.zeros(b, nb, device=dev),
                        torch.ones(b, 3, device=dev), **kw)
                except ServeGroupBroken as e:
                    self._fail(e)
                    raise
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def start_capture(self, trace_dir: Optional[str] = None) -> bool:
        """Start a profile capture of the serving dispatches (see
        :meth:`repro_torch.obs.Tracer.start_capture`)."""
        return self.tracer.start_capture(trace_dir)

    def stop_capture(self) -> bool:
        return self.tracer.stop_capture()

    def stop(self, drain_timeout_s: float = 5.0) -> None:
        """Stop the worker; queued-but-unserved requests error out.  Over
        a process mesh the followers are then released (the stop op), or,
        after a failed dispatch, :class:`ServeGroupBroken` is raised."""
        self.tracer.stop_capture()
        self._stop.set()
        self._worker.join(drain_timeout_s)
        self._drain("server stopped")
        if self._over_processes and self._failure is None:
            try:
                # waits for a dispatch still in flight on the worker
                self._executor_factory.stop()
            except ServeGroupBroken as exc:
                self._fail(exc)
        if self._failure is not None:
            raise ServeGroupBroken(
                f"the server stopped: {self._failure}") from self._failure

    def _drain(self, why: str) -> None:
        while True:
            try:
                fut = self._queue.get_nowait()
            except queue.Empty:
                break
            self._settle(fut, _zeros_result(fut.request, why), "error")

    def _fail(self, exc: BaseException) -> None:
        """A dispatch over the process mesh failed after its broadcast:
        answer every queued request ok=False and stop serving."""
        if self._failure is None:
            self._failure = exc
        self._stop.set()
        self._drain(f"server stopped: {exc}")

    # -- serving loop -------------------------------------------------------

    def _serve_loop(self) -> None:
        cfg = self.config
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            window_end = time.monotonic() + cfg.batch_window_s
            while len(batch) < cfg.bucketing.max_batch:
                # window 0 = pure continuous batching: take whatever is
                # already queued, never wait for stragglers
                if cfg.batch_window_s <= 0:
                    try:
                        batch.append(self._queue.get_nowait())
                    except queue.Empty:
                        break
                    continue
                remaining = window_end - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            self._dispatch(batch)

    def _dispatch(self, batch: list[ForceFuture]) -> None:
        now = time.monotonic()
        groups: dict[int, list[ForceFuture]] = {}
        for fut in batch:
            req = fut.request
            # a stalled tenant's expired request degrades to ok=False here,
            # before any padding/compute — it cannot wedge the batch
            if req.deadline is not None and now > req.deadline:
                self._settle(fut, _zeros_result(req, "deadline exceeded"),
                             "timeout")
                continue
            try:
                nb = choose_bucket(req.n_atoms, self.config.atom_buckets)
            except ValueError as e:
                self._settle(fut, _zeros_result(req, str(e)), "error")
                continue
            groups.setdefault(nb, []).append(fut)
        for nb, futs in groups.items():
            if self._failure is not None:
                results = None
            else:
                try:
                    results = self._run_bucket([f.request for f in futs], nb)
                except ServeGroupBroken:
                    results = None
                except Exception as e:  # noqa: BLE001 — degrade, keep serving
                    for fut in futs:
                        self._settle(fut, _zeros_result(
                            fut.request, f"evaluator failed: {e}"), "error")
                    continue
            if results is None:
                # after a broadcast the group is unusable: no degradation
                for fut in futs:
                    self._settle(fut, _zeros_result(
                        fut.request, f"server stopped: {self._failure}"),
                        "error")
                continue
            for fut, res in zip(futs, results):
                self._settle(fut, res, "complete" if res.ok else "error")

    def _settle(self, fut: ForceFuture, result: ForceResult,
                event: str) -> None:
        latency = time.monotonic() - fut.t_submit
        result.diagnostics.setdefault("latency_s", latency)
        self.metrics.update(fut.request.tenant, event, latency)
        fut._deliver(result)

    # -- bucket execution ---------------------------------------------------

    def _bucket_fn(self, n_bucket: int, batch_bucket: int):
        key = (n_bucket, batch_bucket)
        if key not in self._fns:
            if self._executor_factory is not None:
                self._fns[key] = self._executor_factory(n_bucket,
                                                        batch_bucket)
            else:
                # the default evaluator takes any batch: one per atom bucket
                if n_bucket not in self._default_fns:
                    self._default_fns[n_bucket] = make_padded_batch_fn(
                        self.model, n_bucket, self.config.nbr_capacity)
                self._fns[key] = self._default_fns[n_bucket]
        return self._fns[key]

    def _evaluate(self, n_bucket: int, coords, types, mask, box):
        """One dispatch on the model's device (on the server's stream when
        there is one); the results come back on the host after that stream
        is synchronised."""
        dev = self.device
        args = [torch.as_tensor(a, device=dev)
                for a in (coords, types, mask, box)]
        fn = self._bucket_fn(n_bucket, coords.shape[0])
        if self._stream is None:
            with torch.no_grad():
                e, f, ovf = fn(self.params, *args)
            return e.cpu(), f.cpu(), ovf.cpu()
        with torch.cuda.device(dev), torch.cuda.stream(self._stream):
            self._stream.wait_stream(torch.cuda.default_stream(dev))
            with torch.no_grad():
                e, f, ovf = fn(self.params, *args)
            out = [t.to("cpu", non_blocking=True) for t in (e, f, ovf)]
        self._stream.synchronize()
        return out

    def _run_bucket(self, requests: list[ForceRequest],
                    n_bucket: int) -> list[ForceResult]:
        """Pad one same-bucket group to its dispatch shape and evaluate."""
        if self.fault_plan is not None:
            # may sleep (serve_delay) or raise InjectedFault (serve_fail);
            # _dispatch degrades the affected group per request
            self.fault_plan.before_bucket_eval()
        coords, types, mask, box = pad_group(
            requests, n_bucket, self.config.batch_buckets)
        with self.tracer.span("serve.bucket", phase="serve",
                              n_bucket=n_bucket,
                              batch_bucket=int(coords.shape[0]),
                              batch_size=len(requests)):
            try:
                e, f, ovf = self._evaluate(n_bucket, coords, types, mask,
                                           box)
            except ServeGroupBroken as exc:
                self._fail(exc)
                raise
        out = []
        for i, req in enumerate(requests):
            n = req.n_atoms
            diag = {"n_bucket": n_bucket, "batch_bucket": coords.shape[0],
                    "batch_size": len(requests),
                    "overflow": bool(ovf[i])}
            if ovf[i]:
                out.append(_zeros_result(
                    req, f"neighbor capacity {self.config.nbr_capacity} "
                    "overflowed (forces would be truncated)", **diag))
            else:
                out.append(ForceResult(
                    energy=e[i], forces=f[i, :n], diagnostics=diag,
                    tenant=req.tenant, req_id=req.req_id))
        return out
