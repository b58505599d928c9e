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


def pipeline_executor_factory(model: DPModel, box, types, cfg_for,
                              ranks_for=None, mesh_for=None):
    """An ``executor_factory`` whose buckets are replica-batched
    :class:`~repro_torch.core.pipeline.ForcePipeline` dispatches.

    ``factory(n_bucket, batch_bucket)`` builds ONE pipeline over a virtual
    (batch x dd) layout of the model's device — the coalesced requests are
    its replicas, each decomposed over ``ranks_for(batch_bucket)`` virtual
    ranks (default: 8 // batch, at least 1, the reference's split of an
    8-device host) — and adapts its fused force function to the server's
    executor signature, so a batch costs one dispatch whose model kernels
    launch once.  All tenants must share this ``box``/``types`` and hold
    ``n_bucket`` atoms (the ensemble-farm scenario); the per-request boxes
    and masks are ignored, and padding rows repeat the first request.
    ``cfg_for(n_bucket, dd_ranks)`` supplies the :class:`DDConfig`.  The
    batch and dd axes are virtual axes of the server's device: ``mesh_for``
    must stay None (serving over a process mesh needs every process to
    join each dispatch of the worker thread, ROADMAP item 14(b')).
    """
    from ..core.pipeline import ForcePipeline
    if mesh_for is not None:
        raise ValueError("the served pipeline takes no mesh: its batch and "
                         "dd axes are virtual axes of one device (mesh_for "
                         "must be None; serving over processes is ROADMAP "
                         "item 14(b'))")
    if ranks_for is None:
        def ranks_for(b):
            return max(8 // b, 1)
    dev = model.device
    types_t = torch.as_tensor(np.asarray(types), device=dev)

    def factory(n_bucket: int, batch_bucket: int):
        cfg = cfg_for(n_bucket, ranks_for(batch_bucket))
        pipe = ForcePipeline(model, cfg, box, n_bucket,
                             n_replicas=batch_bucket)
        bf = pipe.build_force_fn()

        def fn(params, coords, _types, mask, _box):
            live = mask.sum(1) > 0
            coords = torch.where(live[:, None, None], coords, coords[:1])
            e, f, diag = bf(params, coords, types_t)
            return e, f, diag["overflow"] > 0

        fn.pipeline = pipe
        return fn

    return factory


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
    runs each bucket through a replica-batched ``ForcePipeline``.
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
        for nb in buckets:
            for b in (batch_sizes or cfg.batch_buckets):
                self._bucket_fn(nb, b)(
                    self.params,
                    torch.zeros(b, nb, 3, device=dev),
                    torch.zeros(b, nb, dtype=torch.int32, device=dev),
                    torch.zeros(b, nb, device=dev),
                    torch.ones(b, 3, device=dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def start_capture(self, trace_dir: Optional[str] = None) -> bool:
        """Start a profile capture of the serving dispatches (see
        :meth:`repro_torch.obs.Tracer.start_capture`)."""
        return self.tracer.start_capture(trace_dir)

    def stop_capture(self) -> bool:
        return self.tracer.stop_capture()

    def stop(self, drain_timeout_s: float = 5.0) -> None:
        """Stop the worker; queued-but-unserved requests error out."""
        self.tracer.stop_capture()
        self._stop.set()
        self._worker.join(drain_timeout_s)
        while True:
            try:
                fut = self._queue.get_nowait()
            except queue.Empty:
                break
            self._settle(fut, _zeros_result(fut.request, "server stopped"),
                         "error")

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
            try:
                results = self._run_bucket([f.request for f in futs], nb)
            except Exception as e:  # noqa: BLE001 — degrade, keep serving
                for fut in futs:
                    self._settle(fut, _zeros_result(
                        fut.request, f"evaluator failed: {e}"), "error")
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
            e, f, ovf = self._evaluate(n_bucket, coords, types, mask, box)
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
