"""Sharding-aware batch loader with deterministic resume.

Port of ``repro/data/loader.py``.  The loader is a pure function of (epoch
seed, step index), so a restarted job resumes the exact data order from a
checkpointed step: no batch duplicated or skipped after a restart.  The
permutations are numpy's, as in the reference, so both packages give the
same batches; the batches come out as tensors on the loader's device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass
class LoaderConfig:
    batch_size: int
    seed: int = 0
    drop_remainder: bool = True


class DeterministicLoader:
    """Permutation-per-epoch loader over a dict of equal-length arrays."""

    def __init__(self, arrays: dict, cfg: LoaderConfig,
                 shard_index: int = 0, shard_count: int = 1, device="cuda"):
        self.arrays = arrays
        self.cfg = cfg
        self.device = resolve_device(device)
        n = len(next(iter(arrays.values())))
        for k, v in arrays.items():
            if len(v) != n:
                raise ValueError(f"ragged dataset field {k}")
        self.n = n
        self.shard_index = shard_index
        self.shard_count = shard_count
        per_shard = self.n // shard_count
        self.steps_per_epoch = per_shard // cfg.batch_size

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.cfg.seed, epoch))
        return rng.permutation(self.n)

    def batch_at(self, global_step: int) -> dict:
        """The batch for an absolute step index: resume == recompute."""
        epoch = global_step // self.steps_per_epoch
        within = global_step % self.steps_per_epoch
        perm = self._epoch_perm(epoch)
        shard = perm[self.shard_index::self.shard_count]
        lo = within * self.cfg.batch_size
        idx = shard[lo: lo + self.cfg.batch_size]
        return {k: torch.as_tensor(np.asarray(v)[idx], device=self.device)
                for k, v in self.arrays.items()}

    def iterate(self, start_step: int = 0) -> Iterator[tuple[int, dict]]:
        step = start_step
        while True:
            yield step, self.batch_at(step)
            step += 1


def synthetic_token_batch(rng: np.random.Generator, batch: int, seq: int,
                          vocab: int, device="cuda") -> dict:
    """LM token batches for the training examples (no external corpora)."""
    dev = resolve_device(device)
    tok = rng.integers(0, vocab, (batch, seq + 1), dtype=np.int32)
    return {"tokens": torch.as_tensor(tok[:, :-1], device=dev),
            "labels": torch.as_tensor(tok[:, 1:], device=dev)}
