"""Mesh layouts (``repro/launch/mesh.py``): the axis names and sizes the
sharding rules read, and the process mesh the DD force path runs on.

The reference builds a JAX ``Mesh`` over real (or forced host) devices.
The port's sharding rules (``lm/sharding.py``) and the dry run
(``launch/dryrun.py``) read only a mesh's axis names and sizes, so a
``MeshLayout`` is exactly that: no devices behind it, and a layout of more
than one device is accounting only for the LM.

:func:`make_dd_mesh` is the counterpart of the reference's 1-D ``"dd"``
mesh: a :class:`DDMesh` over an initialised ``torch.distributed`` process
group, one process per device (NCCL on cards, gloo on the CPU), each
process holding ``n_ranks / world`` of the decomposition's ranks.
:class:`~repro_torch.core.pipeline.ForcePipeline` runs its collectives
over it.  The caller starts the group (``env://`` under ``torchrun``,
``file://`` or ``tcp://localhost:<port>`` otherwise); nothing here starts
one.
"""
from __future__ import annotations

import dataclasses
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
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_dd_mesh needs an initialised torch.distributed process "
            "group: call torch.distributed.init_process_group first "
            "(env:// under torchrun, file:// or tcp://localhost:<port> "
            "otherwise)")
    group = dist.group.WORLD
    world, index = dist.get_world_size(group), dist.get_rank(group)
    if n_ranks < 1 or n_ranks % world:
        raise ValueError(f"n_ranks {n_ranks} is not a positive multiple of "
                         f"the world size {world}: every process holds "
                         "the same number of ranks")
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
    have = str(dist.get_backend(group))
    if want not in have:
        raise ValueError(f"the process group's backend is {have!r}, not "
                         f"{want!r}: initialise the group with the "
                         "backend the mesh names")
    return DDMesh(group, world, index, dev, n_ranks, want)
