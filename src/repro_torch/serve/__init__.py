"""Force inference as a service: multi-tenant batched DP force serving.

Port of ``repro/serve``.  The paper's profiling puts >90% of MD wall time
in DeePMD inference, so the force evaluator — not the simulation — is the
unit to scale: a resident evaluator behind a request queue that
*continuously batches* force calls from many independent simulations.

* :class:`ForceServer` — bounded request queue, a batching worker that
  groups requests into a few (batch x atoms) shape buckets, per-tenant
  metrics, per-request deadlines, graceful degradation;
* :class:`RemoteForceProvider` — the client stub, a drop-in
  ``MDEngine(special_force=...)`` provider behind the
  :class:`repro_torch.backend.ForceBackend` protocol;
* :mod:`repro_torch.serve.batching` — bucket choice and padding;
* :mod:`repro_torch.serve.metrics` — per-tenant queue depth / latency / rps;
* :func:`pipeline_executor_factory` with ``mesh_for`` and
  :func:`follow_dispatches` — serving over a ``(replica x dd)`` process
  mesh, the server on process 0 and a follower on every other.
"""
from ..backend import (ForceBackend, ForceRequest, ForceResult,  # noqa: F401
                       StatefulForceBackend)
from .batching import BucketingConfig, choose_bucket, pad_group  # noqa: F401
from .client import RemoteForceProvider  # noqa: F401
from .metrics import MetricsRegistry, TenantMetrics  # noqa: F401
from .server import (ForceFuture, ForceServer, ServeConfig,  # noqa: F401
                     ServeGroupBroken, ServerOverloaded, follow_dispatches,
                     pipeline_executor_factory)
