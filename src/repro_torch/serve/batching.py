"""Shape-bucketed padding: many tenant shapes -> a few dispatch shapes.

Port of ``repro/serve/batching.py``.  Requests are padded up along both
axes to a small static grid, so the server keeps one executor per
(batch, atoms) bucket and every dispatch of a bucket has the same shapes:

* the **atom bucket** — the smallest ``atom_buckets`` entry >= the
  request's atom count; tail atoms ride with ``mask = 0`` and are excluded
  from every neighbour list and energy term by
  ``repro_torch.core.make_padded_batch_fn``;
* the **batch bucket** — the smallest ``batch_buckets`` entry >= the
  number of requests sharing an atom bucket this cycle; missing rows are
  all-mask-zero padding rows that contribute nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..backend import ForceRequest


@dataclasses.dataclass(frozen=True)
class BucketingConfig:
    """The dispatch-shape grid (see module docstring)."""

    atom_buckets: tuple[int, ...] = (64, 128, 256)
    batch_buckets: tuple[int, ...] = (1, 2, 4, 8)

    def __post_init__(self):
        if (tuple(sorted(self.atom_buckets)) != tuple(self.atom_buckets)
                or tuple(sorted(self.batch_buckets)) != tuple(self.batch_buckets)):
            raise ValueError("bucket lists must be ascending")
        if not self.atom_buckets or not self.batch_buckets:
            raise ValueError("bucket lists must be non-empty")

    @property
    def max_batch(self) -> int:
        return self.batch_buckets[-1]


def choose_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (raises when the request exceeds every bucket —
    the caller rejects rather than silently truncating)."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"size {n} exceeds the largest bucket {buckets[-1]}")


def _host(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def pad_group(requests: Sequence[ForceRequest], n_bucket: int,
              batch_buckets: Sequence[int], dtype=np.float32):
    """Pad a same-atom-bucket request group to one dispatch shape.

    Returns host arrays (coords (B, n_bucket, 3), types (B, n_bucket)
    int32, mask (B, n_bucket) {0,1}, box (B, 3)) with B the batch bucket for
    ``len(requests)``.  Padding rows reuse the first request's box (any
    positive box is valid for an all-masked row — it only feeds the
    minimum-image wrap of excluded pairs).
    """
    b = choose_bucket(len(requests), batch_buckets)
    coords = np.zeros((b, n_bucket, 3), dtype)
    types = np.zeros((b, n_bucket), np.int32)
    mask = np.zeros((b, n_bucket), dtype)
    box = np.tile(_host(requests[0].box, dtype), (b, 1))
    for i, req in enumerate(requests):
        n = req.n_atoms
        if n > n_bucket:
            raise ValueError(f"request {req.req_id} has {n} atoms "
                             f"> bucket {n_bucket}")
        coords[i, :n] = _host(req.positions, dtype)
        if req.types is not None:
            types[i, :n] = _host(req.types, np.int32)
        mask[i, :n] = 1.0
        box[i] = _host(req.box, dtype)
    return coords, types, mask, box
