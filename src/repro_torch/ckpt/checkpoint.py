"""Checkpointing: pytree save/restore, asynchronous writes, CRC-verified
restore.

Port of ``repro/ckpt/checkpoint.py``, with the same on-disk format, so a
checkpoint written by either package loads in the other:

  * A checkpoint is a directory: ``manifest.json`` (``keys``, ``step``,
    ``treedef``, ``time``, ``format`` 2, per-leaf ``crc32``) and one
    ``shard_host0.npz`` holding leaf ``i`` as ``a{i}``.
  * Leaves are ordered and named as JAX's ``tree_flatten_with_path`` does:
    dict keys sorted, a dict key's path entry ``['name']``, a list or tuple
    index ``[i]``, entries joined by ``/``; ``None`` holds no leaf.
    ``treedef`` is informational (loading ignores it).
  * A tensor leaf is saved as ``.detach().cpu().numpy()``.  The port's
    ``MDState.rng`` (a ``torch.Generator`` state) is a uint8 leaf.
  * Writes go to ``<dir>.tmp`` and are renamed atomically, so a crash
    mid-write never leaves a partial checkpoint under the final name.
  * ``load_pytree`` verifies every leaf's CRC32 and raises
    :class:`CheckpointCorrupt` on a mismatch, a truncated or unreadable
    shard or a missing manifest; format-1 checkpoints (no CRCs) still load.
  * ``AsyncCheckpointer`` copies the tree to the host on the caller's
    thread (synchronously: the engine goes on to overwrite its tensors)
    and writes on a background thread; ``restore_latest`` walks the step
    directories newest first and falls back past corrupt ones.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import warnings
import zlib
from typing import Any, Optional

import numpy as np
import torch


class CheckpointCorrupt(RuntimeError):
    """A checkpoint failed integrity verification (bad CRC, truncated or
    unreadable shard, missing manifest, leaf-count mismatch)."""


def _flatten_with_paths(tree, prefix=()):
    """(key strings, leaves) in JAX's flattening order."""
    if tree is None:
        return [], []
    if isinstance(tree, dict):
        entries = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        entries = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return ["/".join(prefix)], [tree]
    keys, vals = [], []
    for name, sub in entries:
        k, v = _flatten_with_paths(sub, prefix + (name,))
        keys += k
        vals += v
    return keys, vals


def _treedef_str(tree) -> str:
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef_str(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef_str(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        inner = ", ".join(_treedef_str(v) for v in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    return "*"


def _unflatten(like, leaves):
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def _map_leaves(fn, tree):
    keys, vals = _flatten_with_paths(tree)
    return _unflatten(tree, [fn(v) for v in vals])


def to_host(x) -> np.ndarray:
    """A leaf as a host array that owns its memory (a tensor is copied off
    its device synchronously)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


def save_pytree(path: str, tree: Any, step: Optional[int] = None) -> None:
    """Atomic synchronous save of a pytree of tensors, arrays and scalars."""
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    keys, vals = _flatten_with_paths(tree)
    arrays = {}
    crcs = []
    for i, v in enumerate(vals):
        a = v if isinstance(v, np.ndarray) else to_host(v)
        arrays[f"a{i}"] = a
        crcs.append(zlib.crc32(np.ascontiguousarray(a).tobytes()))
    meta = {"keys": keys, "step": step,
            "treedef": f"PyTreeDef({_treedef_str(tree)})",
            "time": time.time(), "format": 2, "crc32": crcs}
    np.savez(os.path.join(tmp, "shard_host0.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(meta, f)
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def _restore_leaf(tgt, v: np.ndarray):
    if isinstance(tgt, torch.Tensor):
        return torch.as_tensor(v, dtype=tgt.dtype, device=tgt.device)
    if isinstance(tgt, np.ndarray):
        return np.asarray(v, dtype=tgt.dtype)
    return torch.as_tensor(v)


def load_pytree(path: str, like: Any = None) -> Any:
    """Load a checkpoint.  Without ``like``: a nested dict of numpy arrays
    rebuilt from the recorded key paths.  With ``like``: its structure,
    each leaf on ``like``'s leaf's device and in its dtype."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            meta = json.load(f)
        data = np.load(os.path.join(path, "shard_host0.npz"))
        # npz members are CRC-checked by zipfile on extraction, so a
        # truncated shard raises here rather than yielding garbage
        vals = [data[f"a{i}"] for i in range(len(meta["keys"]))]
    except CheckpointCorrupt:
        raise
    except Exception as e:
        raise CheckpointCorrupt(f"unreadable checkpoint {path}: {e}") from e
    crcs = meta.get("crc32")
    if crcs is not None:                     # format >= 2
        if len(crcs) != len(vals):
            raise CheckpointCorrupt(
                f"{path}: manifest lists {len(crcs)} CRCs for "
                f"{len(vals)} leaves")
        for i, (v, want) in enumerate(zip(vals, crcs)):
            got = zlib.crc32(np.ascontiguousarray(v).tobytes())
            if got != want:
                raise CheckpointCorrupt(
                    f"{path}: CRC mismatch on leaf {meta['keys'][i]!r} "
                    f"(stored {want:#010x}, computed {got:#010x})")
    if like is None:
        # reconstruct a nested dict from the recorded key paths
        out: dict = {}
        for key, v in zip(meta["keys"], vals):
            parts = [p.strip("[]'.") for p in key.replace("].", "]/").split("/")]
            parts = [p for p in parts if p]
            d = out
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = v
        return out
    _, leaves = _flatten_with_paths(like)
    if len(leaves) != len(vals):
        raise ValueError(f"checkpoint has {len(vals)} leaves, target has "
                         f"{len(leaves)}")
    return _unflatten(like, [_restore_leaf(t, v)
                             for t, v in zip(leaves, vals)])


def _complete_step_dirs(root: str) -> list[str]:
    """Finished checkpoints only: a crash mid-write leaves ``step_N.tmp``
    behind, which is never restored from (or counted by GC)."""
    return [d for d in os.listdir(root)
            if d.startswith("step_") and not d.endswith(".tmp")]


def latest_step_dir(root: str) -> Optional[str]:
    if not os.path.isdir(root):
        return None
    steps = _complete_step_dirs(root)
    if not steps:
        return None
    best = max(steps, key=lambda d: int(d.split("_")[1]))
    return os.path.join(root, best)


class AsyncCheckpointer:
    """Background-thread writer: copy to the host on the caller's thread,
    serialize and write off the critical path.  ``wait()`` joins before
    the next save or at shutdown, so at most one write is in flight."""

    def __init__(self, root: str, keep: int = 3, fault_plan=None):
        self.root = root
        self.keep = keep
        # health.FaultPlan seam: truncates a just-written shard on cue
        # (exercises the CRC check and restore_latest's fallback)
        self.fault_plan = fault_plan
        self._thread: Optional[threading.Thread] = None
        os.makedirs(root, exist_ok=True)

    def save(self, tree: Any, step: int) -> None:
        self.wait()
        host_tree = _map_leaves(to_host, tree)
        path = os.path.join(self.root, f"step_{step:09d}")

        def work():
            save_pytree(path, host_tree, step)
            if self.fault_plan is not None:
                self.fault_plan.after_checkpoint_save(path, step)
            self._gc()

        # non-daemon: an interpreter exit lets a bounded in-flight write
        # finish its atomic rename; only a hard kill abandons it, which the
        # .tmp protocol covers
        self._thread = threading.Thread(target=work, daemon=False)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, like: Any = None):
        """Restore the newest *verified* checkpoint: step directories are
        tried newest first, and corrupt or truncated ones
        (:class:`CheckpointCorrupt`) are skipped with a warning.  Returns
        ``(None, -1)`` when no verified checkpoint exists."""
        self.wait()
        if not os.path.isdir(self.root):
            return None, -1
        steps = sorted(_complete_step_dirs(self.root),
                       key=lambda d: int(d.split("_")[1]), reverse=True)
        for d in steps:
            path = os.path.join(self.root, d)
            try:
                tree = load_pytree(path, like)
                with open(os.path.join(path, "manifest.json")) as f:
                    step = json.load(f).get("step", -1)
            except CheckpointCorrupt as e:
                warnings.warn(f"skipping corrupt checkpoint: {e}",
                              stacklevel=2)
                continue
            return tree, step
        return None, -1

    def _gc(self) -> None:
        steps = sorted(_complete_step_dirs(self.root))
        for d in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.root, d), ignore_errors=True)
        # sweep .tmp orphans of crashed writes (never the in-flight one:
        # _gc runs on the writer thread after its own rename)
        for d in os.listdir(self.root):
            if d.startswith("step_") and d.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.root, d), ignore_errors=True)
