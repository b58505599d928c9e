"""Mesh layouts (``repro/launch/mesh.py``): the axis names and sizes the
sharding rules read, with no devices behind them.

The reference builds a JAX ``Mesh`` over real (or forced host) devices; the
port's sharding rules (``lm/sharding.py``) and the dry run
(``launch/dryrun.py``) read only a mesh's axis names and sizes, so a
``MeshLayout`` is exactly that.  No device mesh and no process group are
built: the port executes on one card, and a layout of more than one device
is accounting only (multi-card execution is not ported).
"""
from __future__ import annotations

import dataclasses
import math


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

