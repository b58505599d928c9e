"""Optimizers (no library optimizer): Adam/AdamW, SGD-momentum, and an
8-bit block-quantized Adam for optimizer-state compression.

Port of ``repro/optim/adam.py``.  Each optimizer is an (init, update) pair
over nested dicts and lists of tensors, with the reference's state layout
(``{"m", "v", "count"}``, ``count`` an int32 0-d tensor; ``adam8bit``'s
slots ``{"q", "s"}``, ``{"v16"}`` or ``{"m"}``), so the port's ``ckpt``
saves it under JAX's key strings and a checkpoint restores in either
package.  ``update`` runs on the parameters' device and never reads a
value back to the host.  Over a process mesh (``lm/sharding.py``) the
leaves are DTensors: Adam's and SGD's updates are elementwise on them, and
``adam8bit``'s quantized blocks, which cross the shards, are updated by
:func:`_update_shards`.
"""
from __future__ import annotations

import sys
from typing import Any, Callable, NamedTuple

import torch
import torch.nn.functional as F


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]  # (grads, state, params) -> (updates, state)


def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of ``tree`` (nested dicts, lists and
    tuples), with the entries at the same place in each of ``rest``; the
    result keeps ``tree``'s nesting.  An entry of ``rest`` may be a subtree
    (an ``adam8bit`` slot): it is passed whole."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensor leaves in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _unzip(out, like, n: int):
    """A tree of n-tuples (shaped like ``like``) -> n trees."""
    return [tree_map(lambda _, o, i=i: o[i], like, out) for i in range(n)]


def _count0(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


# ---------------------------------------------------------------------------
# Adam / AdamW
# ---------------------------------------------------------------------------

def adam(lr: float | Callable[[torch.Tensor], torch.Tensor], b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": _count0(params)}

    def update(grads, state, params):
        count = state["count"] + 1
        lr_t = lr_fn(count)
        bc1 = 1 - b1 ** count.to(torch.float32)
        bc2 = 1 - b2 ** count.to(torch.float32)

        def upd(g, m, v, p):
            g = g.to(torch.float32)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mhat = m / bc1
            vhat = v / bc2
            u = -lr_t * (mhat / (torch.sqrt(vhat) + eps)
                         + weight_decay * p.to(torch.float32))
            return u, m, v

        out = tree_map(upd, grads, state["m"], state["v"], params)
        updates, m, v = _unzip(out, grads, 3)
        return updates, {"m": m, "v": v, "count": count}

    return Optimizer(init, update)


def adamw(lr, weight_decay: float = 0.1, **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, **kw)


def sgd(lr: float | Callable, momentum: float = 0.9) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        return {"mu": tree_map(lambda p: torch.zeros_like(
                    p, dtype=torch.float32), params),
                "count": _count0(params)}

    def update(grads, state, params):
        count = state["count"] + 1
        mu = tree_map(lambda g, m: momentum * m + g.to(torch.float32),
                      grads, state["mu"])
        updates = tree_map(lambda m: -lr_fn(count) * m, mu)
        return updates, {"mu": mu, "count": count}

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# 8-bit block-quantized Adam (optimizer-state compression)
# ---------------------------------------------------------------------------

_BLOCK = 256


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 block quantization of a flat fp32 array; rounds half
    to even, as ``jnp.round`` does."""
    n = x.numel()
    pad = (-n) % _BLOCK
    xf = F.pad(x.reshape(-1), (0, pad)).reshape(-1, _BLOCK)
    scale = xf.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    x = (q.to(torch.float32) * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return x[:n].reshape(shape)


def adam8bit(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
             weight_decay: float = 0.0, min_size: int = 4096) -> Optimizer:
    """Compressed-state Adam for tensors of at least ``min_size`` elements:
    the first moment m as blockwise int8 (1.004 B/elem), the second moment
    v as bf16 (2 B/elem: v spans orders of magnitude within a block, and
    linear int8 would round its small entries to zero, which blows up
    m/sqrt(v)).  Smaller tensors keep fp32 slots ``{"m": ...}``."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        def m_slot(p):
            if p.numel() >= min_size:
                q, s = _quantize(torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device))
                return {"q": q, "s": s}
            return {"m": torch.zeros_like(p, dtype=torch.float32)}

        def v_slot(p):
            if p.numel() >= min_size:
                return {"v16": torch.zeros(p.shape, dtype=torch.bfloat16,
                                           device=p.device)}
            return {"m": torch.zeros_like(p, dtype=torch.float32)}

        return {"m": tree_map(m_slot, params), "v": tree_map(v_slot, params),
                "count": _count0(params)}

    def update(grads, state, params):
        count = state["count"] + 1
        lr_t = lr_fn(count)
        bc1 = 1 - b1 ** count.to(torch.float32)
        bc2 = 1 - b2 ** count.to(torch.float32)

        def step(g, m, v, p):
            """The elementwise core: the new moments and the update."""
            m = b1 * m + (1 - b1) * g
            v = (b2 * v + (1 - b2) * g * g).clamp_min(0.0)
            u = -lr_t * ((m / bc1) / (torch.sqrt(v / bc2) + eps)
                         + weight_decay * p.to(torch.float32))
            return m, v, u

        def upd(g, ms, vs, p):
            if _is_dtensor(g):
                return _update_shards(g, ms, vs, p, step)
            g = g.to(torch.float32)
            m = _dequantize(ms["q"], ms["s"], g.shape) if "q" in ms else ms["m"]
            v = vs["v16"].to(torch.float32) if "v16" in vs else vs["m"]
            m, v, u = step(g, m, v, p)
            return u, _m_slot(m, ms, _quantize), _v_slot(v, vs)

        out = tree_map(upd, grads, state["m"], state["v"], params)
        updates, m, v = _unzip(out, grads, 3)
        return updates, {"m": m, "v": v, "count": count}

    return Optimizer(init, update)


def _is_dtensor(x) -> bool:
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def _m_slot(m, ms, quantize) -> dict:
    """The new first-moment slot of ``ms``'s kind: ``quantize(m)``'s
    blocks, or ``m`` itself."""
    if "q" in ms:
        q, s = quantize(m)
        return {"q": q, "s": s}
    return {"m": m}


def _v_slot(v, vs) -> dict:
    return {"v16": v.to(torch.bfloat16)} if "v16" in vs else {"m": v}


def _update_shards(g, ms, vs, p, step):
    """:func:`adam8bit`'s update of one leaf whose gradient, parameter and
    slots are DTensors over a process mesh (``lm/sharding.py``'s layout:
    ``v16`` and the fp32 slots as laid out, ``q`` and ``s`` blocks of the
    whole flattened parameter over "data" or replicated).  It computes
    what the one-device update computes for the whole tensor, bit for
    bit: ``q`` and ``s`` are gathered whole and dequantized, the first
    moment cut to the parameter's block (no communication), the same
    elementwise ``step`` run on that block, and the new first moment
    gathered whole to quantize it, each process keeping its block rows.
    Collectives: the all-gather of ``q`` and ``s`` (where sharded) and of
    the new fp32 moment, per quantized leaf.  Every new leaf keeps its
    old placements; the update takes the parameter's."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = g.device_mesh
    whole = (Replicate(),) * mesh.ndim

    def cut(t, like):
        """A tensor every process holds whole -> a DTensor laid out as
        ``like`` (each process keeps its block: no communication)."""
        return DTensor.from_local(t, mesh, whole, run_check=False
                                  ).redistribute(mesh, like.placements)

    def quantize(m):
        q, s = _quantize(m.full_tensor())
        return cut(q, ms["q"]), cut(s, ms["s"])

    g = g.to(torch.float32)
    if "q" in ms:
        m = cut(_dequantize(ms["q"].full_tensor(), ms["s"].full_tensor(),
                            g.shape), g)
    else:
        m = ms["m"].redistribute(mesh, g.placements)
    old_v = vs["v16"] if "v16" in vs else vs["m"]
    v = old_v.redistribute(mesh, g.placements).to(torch.float32)
    m, v, u = step(g, m, v, p.redistribute(mesh, g.placements))
    new_m = _m_slot(m, ms, quantize)
    if "m" in new_m:
        new_m["m"] = m.redistribute(mesh, ms["m"].placements)
    new_v = _v_slot(v, vs)
    return u, new_m, {k: t.redistribute(mesh, old_v.placements)
                      for k, t in new_v.items()}


# ---------------------------------------------------------------------------
# Gradient utilities
# ---------------------------------------------------------------------------

def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum((x.to(torch.float32) ** 2).sum()
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = (max_norm / (norm + 1e-9)).clamp_max(1.0)
    return tree_map(lambda g: g * scale, grads), norm
