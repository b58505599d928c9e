"""Mesh layouts (``repro/launch/mesh.py``): the axis names and sizes the
sharding rules read, and the process mesh the DD force path runs on.

The reference builds a JAX ``Mesh`` over real (or forced host) devices.
The port's sharding rules (``lm/sharding.py``) and the dry run
(``launch/dryrun.py``) read only a mesh's axis names and sizes, so a
``MeshLayout`` is exactly that: no devices behind it.

:func:`make_lm_mesh` is the counterpart of the LM's ``("data", "model")``
JAX mesh: an :class:`LMMesh` over an initialised process group, one
process per device, built with ``torch.distributed.device_mesh``; the LM's
entry points (``lm/model.py``, ``lm/train_lib.py``, ``lm/serve_lib.py``)
run over it with the sharding rules' specs as DTensor placements.  A
``MeshLayout`` stays the accounting's: passed to an entry point, one
device runs as no mesh and more raise.

:func:`make_dd_mesh` is the counterpart of the reference's 1-D ``"dd"``
mesh: a :class:`DDMesh` over an initialised ``torch.distributed`` process
group, one process per device (NCCL on cards, gloo on the CPU), each
process holding ``n_ranks / world`` of the decomposition's ranks.
:class:`~repro_torch.core.pipeline.ForcePipeline` runs its collectives
over it.  :func:`make_ensemble_mesh` is the counterpart of the
reference's 2-D ``(replica x dd)`` mesh: an :class:`EnsembleMesh` whose
rows are replica shards and whose columns are dd positions, one
:class:`DDMesh` subgroup a row and one replica subgroup a column.  The
caller starts the group (``env://`` under ``torchrun``, ``file://`` or
``tcp://localhost:<port>`` otherwise); nothing here starts one.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """Named mesh axes and their sizes, devices laid out row-major (the
    last axis varies fastest), as ``jax.make_mesh`` orders them."""
    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.axis_sizes)} sizes for "
                             f"{len(self.axis_names)} axis names")
        if any(n < 1 for n in self.axis_sizes):
            raise ValueError(f"axis sizes must be >= 1: {self.axis_sizes}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size (a JAX mesh's ``.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """The number of devices."""
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshLayout:
    """16x16 = 256 devices; 2 pods = 512 with a leading "pod" axis (only
    the data-parallel gradient reduction crosses it)."""
    if multi_pod:
        return MeshLayout((2, 16, 16), ("pod", "data", "model"))
    return MeshLayout((16, 16), ("data", "model"))


def make_card_mesh() -> MeshLayout:
    """The (1, 1) ``("data", "model")`` layout: the program that runs on one
    card."""
    return MeshLayout((1, 1), ("data", "model"))


class DDMesh:
    """The 1-D ``"dd"`` mesh of the DD force path over a process group.

    ``world`` processes (``index`` is this one's) each hold
    ``ranks_per_process`` consecutive ranks of the ``n_ranks``-rank
    decomposition on ``device``; ``shape`` is ``{"dd": n_ranks}``, as a
    JAX mesh's.  ``backend`` is the group's: ``"nccl"`` on cards,
    ``"gloo"`` on the CPU, or ``"gloo"`` on CUDA tensors when the caller
    names it (several processes sharing one card, which NCCL refuses):
    then every collective copies its tensors to the host and back, on
    purpose (``host_copy``).

    With ``record`` set to a list, every collective the pipeline runs
    appends ``(tag, start, end)`` marks (CUDA events on a card, host
    clock readings on the CPU); :meth:`collective_ms` sums them by tag.
    """

    axis = "dd"

    def __init__(self, group, world: int, index: int, device: torch.device,
                 n_ranks: int, backend: str):
        self.group = group
        self.world = world
        self.index = index
        self.device = device
        self.n_ranks = n_ranks
        self.backend = backend
        self.record: Optional[list] = None

    @property
    def ranks_per_process(self) -> int:
        return self.n_ranks // self.world

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis: self.n_ranks}

    @property
    def host_copy(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    def mark(self):
        """A time mark on this mesh's device (a recorded CUDA event on a
        card, the host clock on the CPU)."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def collective_ms(self) -> dict[str, float]:
        """The recorded collectives' milliseconds summed by tag (waits
        for the device); empties ``record``."""
        out: dict[str, float] = {}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        for tag, t0, t1 in self.record or ():
            ms = (t0.elapsed_time(t1) if isinstance(t0, torch.cuda.Event)
                  else (t1 - t0) * 1e3)
            out[tag] = out.get(tag, 0.0) + ms
        if self.record is not None:
            self.record.clear()
        return out


def _default_group(what: str):
    """The initialised default group, its world size and this process's
    index; raises without one."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"{what} needs an initialised torch.distributed process "
            "group: call torch.distributed.init_process_group first "
            "(env:// under torchrun, file:// or tcp://localhost:<port> "
            "otherwise)")
    group = dist.group.WORLD
    return group, dist.get_world_size(group), dist.get_rank(group)


def _mesh_device(device, backend: Optional[str], world: int, index: int):
    """(device, backend) of a mesh over the default group: the backend
    follows the device unless named, NCCL takes one card a process, a
    ``"cuda"`` device without an index is ``cuda:$LOCAL_RANK`` under NCCL
    and the current device under gloo (it becomes the current device), and
    the group's backend must be the one named."""
    dev = torch.device(device)
    want = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if want not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {want!r}: nccl or gloo")
    if want == "nccl":
        if dev.type != "cuda":
            raise ValueError("NCCL runs on CUDA tensors: pass a cuda "
                             "device, or backend='gloo' on the CPU")
        n_cards = torch.cuda.device_count()
        if world > n_cards:
            raise ValueError(
                f"NCCL takes one card a process: world size {world} > "
                f"{n_cards} CUDA devices (backend='gloo' lets processes "
                "share a card, through host copies)")
    dev = resolve_device(dev)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device(
                "cuda", int(os.environ.get("LOCAL_RANK", index))
                if want == "nccl" else torch.cuda.current_device())
        torch.cuda.set_device(dev)
    have = str(dist.get_backend(dist.group.WORLD))
    if want not in have:
        raise ValueError(f"the process group's backend is {have!r}, not "
                         f"{want!r}: initialise the group with the "
                         "backend the mesh names")
    return dev, want


def make_dd_mesh(n_ranks: int, device="cuda",
                 backend: Optional[str] = None) -> DDMesh:
    """The ``"dd"`` mesh of ``n_ranks`` decomposition ranks over the
    initialised default process group, ``n_ranks / world`` of them on this
    process.

    ``backend`` defaults to the device's (``"nccl"`` for CUDA, ``"gloo"``
    for the CPU) and must be the group's; ``"gloo"`` on CUDA is taken only
    when named.  A ``"cuda"`` device without an index is
    ``cuda:$LOCAL_RANK`` under NCCL (``torchrun``'s one card a process)
    and the current device under gloo; it becomes this process's current
    device.  Raises without an initialised group, when ``n_ranks`` is not a
    multiple of the world size, when NCCL is asked for more processes than
    there are cards, and (``repro_torch.device``'s rule) for CUDA without a
    card."""
    group, world, index = _default_group("make_dd_mesh")
    if n_ranks < 1 or n_ranks % world:
        raise ValueError(f"n_ranks {n_ranks} is not a positive multiple of "
                         f"the world size {world}: every process holds "
                         "the same number of ranks")
    dev, want = _mesh_device(device, backend, world, index)
    return DDMesh(group, world, index, dev, n_ranks, want)


class EnsembleMesh:
    """The 2-D ``(replica x dd)`` mesh over a process group: the
    counterpart of the reference's ``make_ensemble_mesh`` JAX mesh.

    ``world = n_replica_shards * Wd`` processes in a row-major layout (the
    last axis fastest, as ``jax.make_mesh`` orders devices): process ``p``
    sits at ``(replica_index, dd.index) = (p // Wd, p % Wd)``.  The R
    replicas shard over the leading axis, ``R / n_replica_shards``
    consecutive replicas a shard; the ``n_dd`` decomposition ranks of each
    replica run over the trailing axis, ``n_dd / Wd`` a process.

    ``dd`` is the :class:`DDMesh` of this process's replica shard (its
    ``Wd`` processes), over which the pipeline runs the decomposition's
    collectives; ``replica_group`` holds the ``n_replica_shards`` processes
    at this process's dd position, over which the per-replica results are
    gathered.  The device, the backend and the timing record are the
    ``dd`` mesh's: every collective of either axis appends its marks to
    ``dd.record``."""

    def __init__(self, dd: DDMesh, replica_group, n_replica_shards: int,
                 replica_index: int, index: int,
                 replica_axis: str = "replica"):
        self.dd = dd
        self.replica_group = replica_group
        self.n_replica_shards = n_replica_shards
        self.replica_index = replica_index
        self.index = index
        self.replica_axis = replica_axis

    @property
    def world(self) -> int:
        return self.n_replica_shards * self.dd.world

    @property
    def shape(self) -> dict[str, int]:
        return {self.replica_axis: self.n_replica_shards,
                DDMesh.axis: self.dd.n_ranks}

    @property
    def device(self) -> torch.device:
        return self.dd.device

    @property
    def backend(self) -> str:
        return self.dd.backend

    @property
    def record(self) -> Optional[list]:
        return self.dd.record

    @record.setter
    def record(self, value: Optional[list]) -> None:
        self.dd.record = value

    def collective_ms(self) -> dict[str, float]:
        """Both axes' recorded collectives, ms summed by tag."""
        return self.dd.collective_ms()


def make_ensemble_mesh(n_replica_shards: int, n_dd: int, device="cuda",
                       backend: Optional[str] = None,
                       replica_axis: str = "replica",
                       timeout: Optional[datetime.timedelta] = None
                       ) -> EnsembleMesh:
    """The 2-D ``(replica x dd)`` mesh of the initialised default group:
    ``n_replica_shards`` rows of ``Wd = world / n_replica_shards``
    processes, each row running the ``n_dd``-rank decomposition of its
    replicas (``n_dd / Wd`` ranks a process).  ``(1, n_dd)`` keeps every
    replica on every row; ``(world, n_dd)`` gives each process whole
    replicas.

    Every process creates every subgroup, in the same order (one dd group
    per replica shard, then one replica group per dd position), as
    ``torch.distributed.new_group`` requires; ``timeout`` is theirs.  The
    device and backend follow :func:`make_dd_mesh`'s rules.  Raises
    without an initialised group, when the world size is not a multiple of
    ``n_replica_shards``, when ``n_dd`` is not a multiple of ``Wd``, when
    NCCL is asked for more processes than there are cards, and for CUDA
    without a card."""
    group, world, index = _default_group("make_ensemble_mesh")
    rs = n_replica_shards
    if rs < 1 or world % rs:
        raise ValueError(f"the world size {world} is not a multiple of "
                         f"n_replica_shards {rs}: every replica shard "
                         "holds the same number of processes")
    wd = world // rs
    if n_dd < 1 or n_dd % wd:
        raise ValueError(f"n_dd {n_dd} is not a positive multiple of the "
                         f"{wd} processes on the dd axis (world {world} / "
                         f"{rs} replica shards): every process holds the "
                         "same number of ranks")
    dev, want = _mesh_device(device, backend, world, index)
    kw = {} if timeout is None else {"timeout": timeout}
    dd_groups = [dist.new_group([s * wd + j for j in range(wd)], **kw)
                 for s in range(rs)]
    rep_groups = [dist.new_group([s * wd + j for s in range(rs)], **kw)
                  for j in range(wd)]
    row, col = divmod(index, wd)
    dd = DDMesh(dd_groups[row], wd, col, dev, n_dd, want)
    return EnsembleMesh(dd, rep_groups[col], rs, row, index, replica_axis)


class LMMesh:
    """The LM's ``("data", "model")`` mesh over a process group: the
    counterpart of the reference's ``jax.make_mesh((data, model), ("data",
    "model"))``.

    ``world = data * model`` processes laid out row-major (the last axis
    fastest, as ``jax.make_mesh`` orders devices): process ``p`` sits at
    ``coords = (p // model, p % model)``.  ``device_mesh`` is the
    ``torch.distributed`` ``DeviceMesh`` (``mesh_dim_names == ("data",
    "model")``) the DTensors live on; ``axis_names``, ``shape`` and
    ``size`` are what ``lm/sharding.py``'s rules read, as from a
    ``MeshLayout``.  ``backend`` is the group's (NCCL one card a process,
    gloo on the CPU, gloo on CUDA tensors only when named)."""

    def __init__(self, device_mesh, device: torch.device, backend: str):
        self.device_mesh = device_mesh
        self.device = device
        self.backend = backend
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.axis_sizes = tuple(int(n) for n in device_mesh.mesh.shape)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def coords(self) -> tuple[int, ...]:
        """This process's coordinate along each axis."""
        return tuple(self.index(a) for a in self.axis_names)

    def index(self, axis: str) -> int:
        """This process's coordinate along ``axis``."""
        return self.device_mesh.get_local_rank(axis)


def make_lm_mesh(data: int, model: int, device="cuda",
                 backend: Optional[str] = None,
                 timeout_s: Optional[float] = None) -> LMMesh:
    """The ``(data, model)`` LM mesh over the initialised default group,
    whose world size must be ``data * model`` (``init_device_mesh``: one
    subgroup per row and per column, ``timeout_s`` their timeout in
    seconds; ``torch.distributed``'s default otherwise).  The device and backend follow
    :func:`make_dd_mesh`'s rules: the backend follows the device unless
    named (``"gloo"`` on CUDA is taken only when named), NCCL takes one
    card a process, and CUDA without a card raises unless ``device="cpu"``.
    A ``(1, 1)`` mesh is a mesh too: its tensors are DTensors over one
    process.  Raises without an initialised group and when the world size
    is not ``data * model``."""
    from torch.distributed.device_mesh import init_device_mesh

    group, world, index = _default_group("make_lm_mesh")
    resolve_device(device)      # CUDA without a card raises here
    if data < 1 or model < 1 or data * model != world:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"processes; the group has {world}")
    dev, want = _mesh_device(device, backend, world, index)
    kw = {}
    if timeout_s is not None:
        opts = (dist.ProcessGroupNCCL.Options() if want == "nccl"
                else dist.ProcessGroupGloo._Options())
        opts._timeout = datetime.timedelta(seconds=timeout_s)
        kw["backend_override"] = {"data": (want, opts),
                                  "model": (want, opts)}
    mesh = init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=("data", "model"), **kw)
    return LMMesh(mesh, dev, want)
