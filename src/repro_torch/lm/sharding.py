"""Sharding rules (``repro/lm/sharding.py``): parameter path -> partition
spec over a mesh (``launch/mesh.py``), and those specs applied as DTensor
placements over a process mesh (``LMMesh``).

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

Over a ``MeshLayout`` (no devices) the specs feed the accounting
(``shard_shape``, ``launch/dryrun.py``).  Over an ``LMMesh`` they are
DTensor placements (:func:`placements`: one per mesh axis, a tensor dim
named by several axes sharded by them in mesh order, JAX's block order):
:func:`distribute_params`, :func:`distribute_opt_state`,
:func:`distribute_batch` and :func:`distribute_cache` cut each process's
block from tensors every process holds whole (no communication), and
:func:`gather` puts the blocks back together.  The reference's
:func:`activation_constraint` and :func:`logits_constraint` are
redistributions to its specs.  :class:`MeshRun` is what the LM's blocks
use to run on local shards between redistributions (``lm/model.py``,
``lm/layers.py``, ``lm/serve_lib.py``): every registry architecture, its
mixers (attention, MLA, Mamba, RWKV6, cross-attention), MoE (with
:data:`EXPERT_2D`), the RWKV channel mix, the encoder and context stubs
and MTP, ``adam8bit``'s quantized state (``optim/adam.py``) and the
long-context cache layout (``cache_shardings(long_context=True)``: a
cache's sequence over "data" where its batch does not divide there,
decoded slice by slice and merged by the log-sum-exp over "data").
:func:`executing_mesh` refuses a ``MeshLayout`` of more than one device
(no devices behind it).
"""
from __future__ import annotations

import math
import sys
from typing import Any, Optional

import torch

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


def is_lm_mesh(mesh) -> bool:
    """``mesh`` is a process mesh (``launch/mesh.py::LMMesh``)."""
    return getattr(mesh, "device_mesh", None) is not None


def executing_mesh(mesh, what: str = "the LM"):
    """The mesh an entry point runs over: None for no mesh or a
    ``MeshLayout`` of one device (run as no mesh), the ``LMMesh`` itself
    for a process mesh (every registry architecture).  Raises
    ``unported`` for a ``MeshLayout`` of more devices (no devices behind
    it)."""
    if mesh is None:
        return None
    if not is_lm_mesh(mesh):
        if mesh.size != 1:
            raise L.unported(
                f"{what} over a MeshLayout of {mesh.size} devices (a layout "
                "has no devices behind it: run over an LMMesh, "
                "launch/mesh.py::make_lm_mesh)")
        return None
    return mesh


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


def activation_constraint(x, mesh, seq_shard: bool = True):
    """Residual-stream constraint: batch over the dp axes, the sequence
    over "model" (sequence parallelism) where ``seq_shard`` and it
    divides; a redistribution of the DTensor ``x`` over an ``LMMesh``, the
    identity without a mesh or over a one-device layout."""
    if not is_lm_mesh(mesh):
        executing_mesh(mesh, what="activation_constraint")
        return x
    if x.dim() != 3:
        return x
    seq = TP if (seq_shard and _fit(x.shape[1], TP, mesh)) else None
    return x.redistribute(mesh.device_mesh,
                          placements(P(dp_fit(x.shape[0], mesh), seq, None),
                                     mesh))


def logits_constraint(x, mesh):
    """Logits (B, S, V): batch over the dp axes, vocabulary over "model"
    where it divides (the identity without an ``LMMesh``, as above)."""
    if not is_lm_mesh(mesh):
        executing_mesh(mesh, what="logits_constraint")
        return x
    return x.redistribute(mesh.device_mesh,
                          placements(P(dp_fit(x.shape[0], mesh), None,
                                       _fit(x.shape[2], TP, mesh)), mesh))


def dp_fit(n: int, mesh):
    """The dp axes for a batch dim of ``n`` where they divide it."""
    dp = _dp_axes(mesh)
    k = _axes_size(mesh, dp)
    return dp if (dp and n >= k and n % k == 0) else None


# ---------------------------------------------------------------------------
# Specs as DTensor placements over an LMMesh
# ---------------------------------------------------------------------------

def dt_api():
    """``torch.distributed.tensor``, imported at first use (its import
    takes a second; nothing without a process mesh needs it)."""
    import torch.distributed.tensor as dt
    return dt


def is_dtensor(x) -> bool:
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def _entry_axes(e) -> tuple:
    return (e,) if isinstance(e, str) else tuple(e or ())


def placements(spec, mesh) -> tuple:
    """One placement per mesh axis: ``Shard(d)`` for each axis named by
    entry ``d`` of ``spec``, ``Replicate()`` for the others.  A dim named
    by several axes (``("data", "model")``) is sharded by them in mesh
    order, the first axis outermost: JAX's block order for that entry.
    Axes named against the mesh's order raise (a DTensor cannot hold that
    order)."""
    dt = dt_api()
    out = [dt.Replicate()] * len(mesh.axis_names)
    for dim, e in enumerate(spec):
        idx = [mesh.axis_names.index(a) for a in _entry_axes(e)]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {e!r} names its axes against the "
                             f"mesh's order {mesh.axis_names}")
        for i in idx:
            out[i] = dt.Shard(dim)
    return tuple(out)


def block_slices(shape, spec, mesh, coords=None) -> tuple:
    """This process's block of a ``shape`` laid out by ``spec``: JAX's
    ``NamedSharding(mesh, spec).devices_indices_map(shape)`` at the
    device with mesh coordinates ``coords`` (this process's by default)."""
    at = dict(zip(mesh.axis_names, coords or mesh.coords))
    block = shard_shape(shape, spec, mesh)
    out = []
    for dim, n in enumerate(block):
        i = 0
        for a in _entry_axes(spec[dim] if dim < len(spec) else None):
            i = i * mesh.shape[a] + at[a]
        out.append(slice(i * n, (i + 1) * n))
    return tuple(out)


def from_local(local: torch.Tensor, mesh, pl, shape=None):
    """A DTensor over ``mesh`` from this process's block (no check, no
    communication)."""
    dt = dt_api()
    kw = {}
    if shape is not None:
        kw = {"shape": torch.Size(shape),
              "stride": torch.empty(shape, device="meta").stride()}
    return dt.DTensor.from_local(local, mesh.device_mesh, pl,
                                 run_check=False, **kw)


def distribute(t: torch.Tensor, spec, mesh):
    """``t``, the whole tensor, held alike by every process, as a DTensor
    laid out by ``spec``: this process keeps a copy of its block."""
    local = t[block_slices(t.shape, spec, mesh)].clone(
        memory_format=torch.contiguous_format)
    return from_local(local, mesh, placements(spec, mesh), t.shape)


def distribute_tree(tree, specs, mesh):
    """:func:`distribute` over a tree and its spec tree (leaves that are
    DTensors already are kept)."""
    spec_of = dict(leaves_with_paths(specs))
    return map_with_paths(
        lambda path, t: t if is_dtensor(t) else distribute(t, spec_of[path],
                                                          mesh), tree)


def distribute_params(params, mesh, fsdp: bool = True):
    """A parameter tree laid out by :func:`params_shardings`."""
    return distribute_tree(params, params_shardings(params, mesh, fsdp), mesh)


def distribute_opt_state(opt_state, param_specs, mesh):
    """An optimizer state laid out by ``train_lib.opt_state_shardings``
    (Adam's m and v as their parameters, ``count`` replicated)."""
    from .train_lib import opt_state_shardings
    return distribute_tree(opt_state,
                           opt_state_shardings(opt_state, param_specs, mesh),
                           mesh)


def distribute_batch(batch: dict, mesh):
    """A training batch (``tokens``, ``labels`` (B, S); ``context`` (B, T,
    D)) with the batch dim over the dp axes (``train_lib.batch_specs``)."""
    dp = batch_spec(mesh)
    specs = {k: P(dp[0] if dp else None, *([None] * (v.dim() - 1)))
             for k, v in batch.items()}
    return distribute_tree(batch, specs, mesh)


def distribute_cache(cache, mesh, long_context: bool = False):
    """A serving cache laid out by :func:`cache_shardings` (with
    ``long_context``, the sequence of a cache whose batch does not divide
    over "data" sharded there; ``make_serve_step`` reads the layout from
    the cache's placements)."""
    executing_mesh(mesh, what="distribute_cache")
    return distribute_tree(cache, cache_shardings(cache, mesh, long_context),
                           mesh)


def gather(tree):
    """Whole tensors of a tree of DTensors (``full_tensor``; other leaves
    kept): for tests and checkpoints."""
    return map_with_paths(
        lambda _, t: t.full_tensor() if is_dtensor(t) else t, tree)


def unbind0(t) -> tuple:
    """``t.unbind(0)``; a DTensor's leading (layer) dim, which the rules
    never shard, unbound on its block, each step a DTensor."""
    if not is_dtensor(t):
        return t.unbind(0)
    dt = dt_api()
    if any(isinstance(p, dt.Shard) and p.dim == 0 for p in t.placements):
        raise ValueError("the stacked layer dim is sharded")
    pl = tuple(dt.Shard(p.dim - 1) if isinstance(p, dt.Shard) else p
               for p in t.placements)
    return tuple(dt.DTensor.from_local(x, t.device_mesh, pl, run_check=False)
                 for x in t.to_local().unbind(0))


class MeshRun:
    """The local computation of one call over an ``LMMesh`` (Megatron's
    tensor and sequence parallelism over "model", ZeRO over "data").

    A block takes the residual stream (a DTensor: batch over "data" where
    it divides, the sequence over "model" or replicated), gathers the
    sequence (:meth:`act`), its weights over "data" (:meth:`weight`,
    keeping their "model" shard where the block is tensor parallel), runs
    the plain functions on this process's local tensors, and hands back
    its output as a partial sum over "model" (tensor parallel) or whole,
    reduce-scattered or sliced to the stream's placements (:meth:`out`).
    The gradient placements given to ``to_local`` say what each process's
    local gradient is (a partial sum where it covers a part of the
    batch, of the heads or of the sequence), so DTensor's backward of each
    redistribution is the matching collective: a weight's gradient comes
    back reduce-scattered over "data" (ZeRO), an activation's
    all-gathered or reduced over "model"."""

    def __init__(self, mesh, batch: int):
        dt = dt_api()
        self.mesh, self.dm = mesh, mesh.device_mesh
        self.mp, self.mi = mesh.shape[TP], mesh.index(TP)
        self.dp, self.di = mesh.shape[FSDP], mesh.index(FSDP)
        sharded = dp_fit(batch, mesh) is not None
        self.bp = dt.Shard(0) if sharded else dt.Replicate()
        self.dgrad = dt.Partial() if sharded else dt.Replicate()
        # this process's rows of the global batch: all of them where it is
        # replicated over "data"
        n = batch // self.dp if sharded else batch
        lo = self.di * n if sharded else 0
        self.rows = slice(lo, lo + n)

    def _part(self, tp: bool):
        dt = dt_api()
        return dt.Partial() if tp else dt.Replicate()

    def heads(self, n: int, tp: bool) -> slice:
        """This process's block of ``n`` heads (all without ``tp``)."""
        if not tp:
            return slice(None)
        k = n // self.mp
        return slice(self.mi * k, (self.mi + 1) * k)

    def batch(self, t):
        """A batch tensor (B, ...) as a DTensor over this run's batch
        placement (kept if it is one)."""
        if is_dtensor(t):
            return t
        return distribute(t, P(dp_fit(t.shape[0], self.mesh),
                               *([None] * (t.dim() - 1))), self.mesh)

    def act(self, x, tp: bool) -> torch.Tensor:
        """The block's input, whole along the sequence, local to this
        process's batch rows; its gradient a partial sum over "model"
        where the block is tensor parallel."""
        dt = dt_api()
        return x.redistribute(self.dm, (self.bp, dt.Replicate())).to_local(
            grad_placements=(self.bp, self._part(tp)))

    def weight(self, w, keep_model: bool, tp: bool) -> torch.Tensor:
        """A weight gathered over "data" (ZeRO), keeping its "model" shard
        where ``keep_model``, as a local tensor; its gradient a partial sum
        over "data" (this process's batch rows) and over "model" where the
        block is tensor parallel and the weight whole."""
        dt = dt_api()
        mpl = w.placements[1] if keep_model else dt.Replicate()
        g = mpl if isinstance(mpl, dt.Shard) else self._part(tp)
        return w.redistribute(self.dm, (dt.Replicate(), mpl)).to_local(
            grad_placements=(self.dgrad, g))

    def out(self, o: torch.Tensor, tp: bool, like):
        """A block's local output (a partial sum over "model" where
        ``tp``) as a DTensor with the placements ``like``."""
        return from_local(o, self.mesh, (self.bp, self._part(tp))
                          ).redistribute(self.dm, like)

    def whole(self, x, grads) -> torch.Tensor:
        """The DTensor ``x`` whole on every process (all-gathered over
        both axes), as a local tensor whose gradient has the placements
        ``grads``: what each process's local gradient is (a partial sum
        where the processes split the work on it, whole where each does
        all of it)."""
        dt = dt_api()
        return x.redistribute(self.dm, (dt.Replicate(), dt.Replicate())
                              ).to_local(grad_placements=grads)

    def size(self, axis: str) -> int:
        return self.mp if axis == TP else self.dp

    def index(self, axis: str) -> int:
        """This process's coordinate along ``axis`` ("data" or "model")."""
        return self.mi if axis == TP else self.di

    def _along(self, axis: str, pl) -> tuple:
        """Placements with ``pl`` on ``axis`` and Replicate on the other."""
        dt = dt_api()
        return (pl, dt.Replicate()) if axis == FSDP else (dt.Replicate(), pl)

    def reduce(self, t: torch.Tensor, op: str = "sum",
               axis: str = TP) -> torch.Tensor:
        """The sum (or ``op``: "max") over ``axis`` of each process's
        ``t``, on every process; no autograd (:meth:`psum` has it)."""
        dt = dt_api()
        return from_local(t.contiguous(), self.mesh,
                          self._along(axis, dt.Partial(op))).redistribute(
            self.dm, (dt.Replicate(), dt.Replicate())).to_local()

    def gather(self, t: torch.Tensor, dim: int, axis: str = TP
               ) -> torch.Tensor:
        """The processes' blocks of ``t`` along ``dim``, concatenated in
        ``axis`` order, on every process (no autograd)."""
        dt = dt_api()
        return from_local(t.contiguous(), self.mesh,
                          self._along(axis, dt.Shard(dim))).redistribute(
            self.dm, (dt.Replicate(), dt.Replicate())).to_local()

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over "model" of partial sums each process computed from
        its channels, used by each process for its own channels: the
        gradient is summed over "model" the same way (Megatron's all-reduce
        whose consumers are not replicated)."""
        return _ModelSum.apply(t, self)


class _ModelSum(torch.autograd.Function):
    """:meth:`MeshRun.psum`: an all-reduce over "model" forward and
    backward."""

    @staticmethod
    def forward(ctx, t, run):
        ctx.run = run
        return run.reduce(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.run.reduce(g), None


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
