"""Ensemble subsystem: batched multi-replica MD with replica exchange.

Port of ``repro/ensemble``.  Replica count is a first-class scaling
dimension beside the rank count: R replicas of one system run as one
program on one device (replicas and ranks are virtual axes of it), with a
temperature-ladder exchange move opening REMD-style enhanced sampling.
The reference's ``make_ensemble_mesh`` has no counterpart yet (ROADMAP
item 14(b)): the port's process mesh (``launch.mesh.make_dd_mesh``) runs
one trajectory's ranks, and a replica layout is ``n_replicas`` plus
``dd_config.grid_dims`` on one device.
"""
from .engine import EnsembleConfig, EnsembleEngine  # noqa: F401
from .exchange import geometric_ladder, make_exchange_fn  # noqa: F401
from .provider import BatchedDeepmdProvider  # noqa: F401
from .state import ReplicaState, replica_state, stack_states  # noqa: F401
