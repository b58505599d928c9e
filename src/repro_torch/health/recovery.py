"""Emergency dumps: the unrecoverable-verdict exit path.

Port of ``repro/health/recovery.py``.

When recovery is exhausted (guard trips persist past
``GuardConfig.max_rollbacks``, capacity growth hits
``EngineConfig.max_capacity_growths``, the window-start state is tainted
with no checkpoint to fall back to) the engine no longer loses the
trajectory to a bare ``RuntimeError``: :func:`dump_emergency` writes the
last known state as a normal CRC-verified checkpoint plus a JSON
diagnostics bundle, and the raised :class:`GuardTripError` /
``RuntimeError`` names the dump directory so a multi-day run can be
triaged and resumed (``MDEngine.restore`` reads the dump directly).
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Optional

import numpy as np
import torch

from ..ckpt.checkpoint import save_pytree


class GuardTripError(RuntimeError):
    """A numerical guard tripped and every recovery policy was exhausted."""


def _json_safe(obj: Any):
    """Best-effort conversion of a diagnostics dict to JSON-serializable
    values (tensors and numpy scalars/arrays -> python values, everything
    else -> str)."""
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().tolist()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer, np.floating, np.bool_)):
        return obj.item()
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return str(obj)


def dump_emergency(root: str, state_tree: Any, bundle: dict,
                   step: Optional[int] = None) -> str:
    """Write ``<root>/emergency_<stamp>/`` = checkpoint + diagnostics.json.

    The checkpoint goes through :func:`repro_torch.ckpt.save_pytree` (atomic
    rename, per-leaf CRC32), so the dump is itself restorable and
    integrity-verified; the bundle lands beside it as
    ``diagnostics.json``.  Returns the dump directory path.
    """
    os.makedirs(root, exist_ok=True)
    stamp = time.strftime("%Y%m%d-%H%M%S")
    base = os.path.join(root, f"emergency_{stamp}_{os.getpid()}")
    path, i = base, 0
    while os.path.exists(path) or os.path.exists(path + ".tmp"):
        i += 1
        path = f"{base}.{i}"
    save_pytree(path, state_tree, step=step)
    with open(os.path.join(path, "diagnostics.json"), "w") as f:
        json.dump(_json_safe(bundle), f, indent=2)
    return path
