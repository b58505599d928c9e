"""Ensemble subsystem: batched multi-replica MD with replica exchange.

Port of ``repro/ensemble``.  Replica count is a first-class scaling
dimension beside the rank count: R replicas of one system run as one
program, with a temperature-ladder exchange move opening REMD-style
enhanced sampling.  The replicas and the DD ranks are virtual axes of one
device, or run over a 2-D ``(replica x dd)`` layout of processes
(:func:`make_ensemble_mesh`): replicas shard over its leading axis, and
the decomposition runs over its trailing ``dd`` axis within each replica
shard.  Every process runs the engine on the whole, replicated ensemble
state and evaluates the DP forces of its own cell of the work; the
per-replica results are gathered over the replica axis, so every process
takes the same host branches.
"""
from ..launch.mesh import make_ensemble_mesh  # noqa: F401
from .engine import EnsembleConfig, EnsembleEngine  # noqa: F401
from .exchange import (geometric_ladder, make_exchange_fn,  # noqa: F401
                       velocity_scale)
from .provider import BatchedDeepmdProvider  # noqa: F401
from .state import ReplicaState, replica_state, stack_states  # noqa: F401
