"""Sharding rules (``repro/lm/sharding.py``): parameter path -> partition
spec over a mesh layout (``launch/mesh.py::MeshLayout``).

The reference's baseline strategy, rule for rule:
  * tensor parallel over "model": attention heads, ffn hidden, MoE experts,
    SSM/RWKV channels, vocab;
  * ZeRO/FSDP over "data": the largest remaining dim of every weight is
    sharded over the data axis (params, grads and optimizer states all
    follow), so per-device memory scales with 1/(data*model);
  * batch over ("pod", "data"); the residual stream sequence-sharded over
    "model" between layers.
Dims smaller than the axis they would shard over, or not divisible by it,
stay replicated (8 KV heads on a 16-way model axis).

A spec is a plain tuple, one entry per dim: ``None``, an axis name, or a
tuple of names; entries are normalised as ``tuple(PartitionSpec(...))``
gives them (an empty or one-name tuple becomes ``None`` or the name), so
the port's specs compare equal to JAX's.  Spec trees mirror the parameter
(or cache) tree's dicts and lists, with the ``"/"``-joined paths JAX's
``tree_flatten_with_path`` gives (``pattern/0/mixer/wq``).

The port executes on one card: the specs feed the accounting
(``shard_shape``, ``launch/dryrun.py``).  The reference's activation and
logits constraints come with multi-card execution, which has them to
apply.
"""
from __future__ import annotations

import math
from typing import Any, Optional

from . import layers as L

DP_AXES = ("pod", "data")   # multi-pod batch axes (pod absent on one pod)
TP = "model"
FSDP = "data"

# shard MoE experts over BOTH mesh axes (full 2-D expert parallelism)
EXPERT_2D = False


def set_expert_2d(v: bool) -> None:
    global EXPERT_2D
    EXPERT_2D = v


def P(*entries) -> tuple:
    """A spec with ``PartitionSpec``'s normalisation of its entries."""
    def norm(e):
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            return None if not e else (e[0] if len(e) == 1 else e)
        return e
    return tuple(norm(e) for e in entries)


def spec_axes(spec) -> set:
    """The axis names a spec uses."""
    out = set()
    for e in spec:
        out.update((e,) if isinstance(e, str) else (e or ()))
    return out


def require_one_card(mesh, what: str) -> None:
    """``mesh`` is None or a layout of one device (run as no mesh)."""
    if mesh is not None and mesh.size != 1:
        raise L.unported(f"{what} over {mesh.size} devices")


def _fit2(dim_size: int, mesh) -> tuple | None:
    """('data','model') combined sharding when it divides the dim."""
    axes = tuple(a for a in (FSDP, TP) if a in mesh.axis_names)
    n = _axes_size(mesh, axes)
    return axes if (len(axes) == 2 and dim_size >= n and dim_size % n == 0) \
        else None


def _dp_axes(mesh):
    return tuple(a for a in DP_AXES if a in mesh.axis_names)


def batch_spec(mesh) -> tuple:
    return P(_dp_axes(mesh))


def _fit(dim_size: int, axis: str, mesh) -> Optional[str]:
    """``axis`` only if it divides the dim evenly."""
    if axis not in mesh.axis_names:
        return None
    n = mesh.shape[axis]
    return axis if (dim_size >= n and dim_size % n == 0) else None


def _with_fsdp(spec: list, shape, mesh, fsdp_axis=FSDP) -> list:
    """Shard the largest not-yet-sharded divisible dim over the fsdp axis."""
    if fsdp_axis not in mesh.axis_names or fsdp_axis in spec_axes(spec):
        return spec
    n = mesh.shape[fsdp_axis]
    free = [i for i, s in enumerate(spec)
            if s is None and shape[i] >= n and shape[i] % n == 0]
    if not free:
        return spec
    spec[max(free, key=lambda i: shape[i])] = fsdp_axis
    return spec


def param_spec(path: str, shape: tuple, mesh, fsdp: bool = True,
               stacked: bool = False) -> tuple:
    """Spec of one parameter leaf; ``stacked``: the leading dim is the
    layer (step) axis, never sharded."""
    core = list(shape[1:]) if stacked else list(shape)
    spec: list = [None] * len(core)
    leaf = path.split("/")[-1]

    def tp(dim_idx):
        spec[dim_idx] = _fit(core[dim_idx], TP, mesh)

    if leaf == "embed":                          # (V, D)
        tp(0)
    elif leaf == "lm_head":                      # (D, V)
        tp(1)
    elif leaf in ("wq", "wk", "wv"):             # (D, H, hd); rwkv (D, D)
        tp(1)
    elif leaf == "wo":                           # (H, hd, D)
        tp(0)
    elif leaf in ("w_gate", "w_up"):             # (D, F) or (E, D, F)
        if len(core) == 3 and EXPERT_2D and _fit2(core[0], mesh):
            spec[0] = _fit2(core[0], mesh)
        else:
            tp(0 if len(core) == 3 else 1)
        if len(core) == 3 and spec[0] is None:
            spec[2] = _fit(core[2], TP, mesh)
    elif leaf == "w_down":                       # (F, D) or (E, F, D)
        if len(core) == 3 and EXPERT_2D and _fit2(core[0], mesh):
            spec[0] = _fit2(core[0], mesh)
        else:
            tp(0)
    elif leaf in ("w_uq", "w_uk", "w_uv"):       # MLA (rank, H, d)
        tp(1)
    elif leaf in ("w_in", "w_bcdt"):             # mamba (D, 2Di) / (Di, *)
        tp(1 if leaf == "w_in" else 0)
    elif leaf in ("conv_w", "conv_b", "A_log", "D", "dt_bias"):
        tp(len(core) - 1 if leaf in ("conv_w", "conv_b", "dt_bias", "D")
           else 0)
    elif leaf == "w_out":                        # mamba (Di, D)
        tp(0)
    elif leaf in ("w_r", "w_k", "w_v", "w_g"):   # rwkv (D, D) col-parallel
        tp(1)
    elif leaf == "w_o":                          # rwkv (D, D) row-parallel
        tp(0)
    elif leaf in ("w_lora_a", "w_lora_b"):
        tp(1 if leaf == "w_lora_a" else 0)
    # w_dq, w_dkv, w_kr, router, mtp_proj, frame_proj, img_proj: small
    # projections, fsdp only; 1-D norms and biases stay replicated
    if fsdp and len(core) >= 2:
        spec = _with_fsdp(spec, core, mesh)
    return P(*(([None] + spec) if stacked else spec))


def leaves_with_paths(tree, prefix: str = ""):
    """(path, leaf) of a tree of dicts and lists, JAX's order (dict keys
    sorted) and path strings (``pattern/0/mixer/wq``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def map_with_paths(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a tree of dicts and lists, keeping its
    nesting (the leaves of the result may be tuples: spec trees)."""
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_paths(fn, v, f"{prefix}{i}/")
                for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def params_shardings(params: Any, mesh, fsdp: bool = True):
    """The spec tree of a parameter tree (tensors, e.g. on ``meta``)."""
    def spec(path, leaf):
        stacked = path.startswith("pattern/") or path.startswith("encoder")
        return param_spec(path, tuple(leaf.shape), mesh, fsdp=fsdp,
                          stacked=stacked)
    return map_with_paths(spec, params)


def cache_spec(path: str, shape: tuple, mesh,
               seq_axis_shard: Optional[str] = None) -> tuple:
    """KV/state cache specs for serving."""
    dp = _dp_axes(mesh)
    leaf = path.split("/")[-1]
    stacked = path.startswith("pattern")
    core = list(shape[1:]) if stacked else list(shape)
    spec: list = [None] * len(core)
    dpn = max(1, _axes_size(mesh, dp))
    b_ok = core[0] >= dpn and core[0] % dpn == 0
    tp_n = mesh.shape.get(TP, 1)
    if b_ok:
        spec[0] = dp
    if leaf in ("k", "v", "ck", "cv"):  # (B, Hkv, S, hd)
        spec[1] = _fit(core[1], TP, mesh)
        if spec[1] is None and core[2] % tp_n == 0:
            # flash-decoding layout: too few KV heads for the model axis,
            # so the sequence dim is sharded instead
            spec[2] = TP
        if seq_axis_shard and spec[2] is None and not b_ok:
            spec[2] = seq_axis_shard
    elif leaf in ("ckv", "k_rope"):   # MLA (B, S, r) compressed cache
        if core[1] % tp_n == 0:
            spec[1] = TP
        elif seq_axis_shard and not b_ok:
            spec[1] = seq_axis_shard
    elif leaf == "S":                 # rwkv (B, H, hd, hd)
        spec[1] = _fit(core[1], TP, mesh)
    elif leaf == "ssm":               # mamba (B, Di, N): channels over TP
        spec[1] = _fit(core[1], TP, mesh)
    elif leaf == "conv":              # mamba (B, K, Di)
        spec[-1] = _fit(core[-1], TP, mesh)
    return P(*(([None] + spec) if stacked else spec))


def _axes_size(mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def cache_shardings(cache: Any, mesh, long_context: bool = False):
    """The spec tree of a cache tree (``serve_lib.abstract_cache``)."""
    seq_shard = FSDP if long_context else None
    return map_with_paths(
        lambda path, leaf: cache_spec(path, tuple(leaf.shape), mesh,
                                      seq_axis_shard=seq_shard), cache)


def shard_shape(shape, spec, mesh) -> tuple:
    """One device's block of a ``shape`` laid out by ``spec`` (JAX's
    ``NamedSharding(mesh, spec).shard_shape``): each dim divided by the
    product of the sizes of the axes its entry names; the rules above only
    shard dims they divide."""
    out = list(shape)
    for i, e in enumerate(spec):
        n = _axes_size(mesh, (e,) if isinstance(e, str) else (e or ()))
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                             f"over {e} ({n} devices)")
        out[i] //= n
    return tuple(out)


def shard_bytes(tree, specs, mesh) -> int:
    """Bytes one device holds of a tensor tree laid out by a spec tree."""
    spec_of = dict(leaves_with_paths(specs))
    return sum(math.prod(shard_shape(t.shape, spec_of[path], mesh))
               * t.element_size() for path, t in leaves_with_paths(tree))
