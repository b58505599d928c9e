"""Roofline accounting of the port's steps (``repro/launch/roofline.py``).

Three terms per (arch x shape x mesh), all per device:

  compute term    = FLOPs / peak FLOP/s                        [s]
  memory term     = bytes / HBM bandwidth                      [s]
  collective term = wire bytes (ring model) / link bandwidth   [s]

The reference reads FLOPs, bytes and collectives from XLA's compiled HLO
with TPU v5e constants.  The port runs eagerly, so :func:`count_step` counts
the step as it executes (on the ``meta`` device it touches no device):

* FLOPs by aten op, from ``torch.utils.flop_counter``'s registry (the
  matrix products and convolutions; elementwise ops count 0), plus each
  hand-written kernel's own formula (``kernels/flash_attn.py::
  attention_flops_bytes``), so the count is the same whichever branch of a
  wrapper runs.  ``torch.utils.checkpoint``'s recomputation executes, so
  it is counted, as XLA counts a rematerialised step: these are the
  hardware's FLOPs, not the model's (``model_flops_per_step``);
* bytes: each aten op's input plus output bytes, each tensor it touches
  counted once (a broadcast dim's stride 0 counts once), views and
  allocations without a fill at 0: the eager program's HBM traffic, since
  every eager op reads its inputs from and writes its outputs to device
  memory; plus each kernel's formula bytes.  An indexed op counts the rows
  it moves, not its table: a gather (``embedding``, ``index``,
  ``index_select``, ``gather``) the indices, the rows it reads and its
  output; an in-place indexed write (``index_copy_``, ``index_put_``,
  ``scatter_``, ``index_add_``, ...) the indices, its source and the rows
  it writes (read and written where it accumulates);
* the live-bytes high-water mark of the storages the step creates (inputs
  that exist before the step are not counted), and the order in which
  they were made and freed, so a caller can weigh each storage (its shard
  of a layout: :meth:`StepCount.peak_bytes`).

Collectives are modelled from the spec trees (``lm/sharding.py``), not
observed: :func:`parameter_collectives`.  The residual stream's
tensor-parallel collectives over "model" are not modelled.

Hardware constants: NVIDIA H100 SXM5 datasheet values, not measured.
"""
from __future__ import annotations

import dataclasses
import math
import weakref

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..lm import sharding as S

HW = {
    "peak_flops": 989e12,   # dense bf16 tensor cores / GPU (datasheet)
    "fp32_flops": 67e12,    # fp32 outside the tensor cores (datasheet)
    "hbm_bw": 3.35e12,      # B/s (datasheet)
    "nvlink_bw": 450e9,     # B/s per direction per GPU, NVLink 4
    "network_bw": 50e9,     # B/s per GPU between nodes (400 Gb/s NIC)
    "node_gpus": 8,         # GPUs one NVLink domain joins
}


@dataclasses.dataclass
class CollectiveRecord:
    kind: str
    result_bytes: int
    group_size: int
    loop_mult: int
    wire_bytes: float  # per device, ring model
    link: str = "network"   # "nvlink" | "network"

    def to_dict(self):
        return dataclasses.asdict(self)


def _wire_bytes(kind: str, result_bytes: int, g: int) -> float:
    """Per-device bytes on the wire under ring algorithms."""
    if g <= 1:
        return 0.0
    if kind == "all-gather":
        return result_bytes * (g - 1) / g      # result = gathered (full)
    if kind == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)          # result = shard; input g*shard
    if kind == "all-to-all":
        return result_bytes * (g - 1) / g
    if kind == "collective-permute":
        return float(result_bytes)
    return 0.0


def axis_link(mesh, axes) -> str:
    """The link a collective over ``axes`` crosses: devices are numbered
    row-major over the mesh and ``node_gpus`` consecutive ones share a node,
    so a group over axes from the first of them to the last spans
    prod(sizes from that axis on) consecutive devices; NVLink when that
    span is a node or fits it evenly, the network otherwise."""
    first = min(mesh.axis_names.index(a) for a in axes)
    span = math.prod(mesh.axis_sizes[first:])
    return "nvlink" if HW["node_gpus"] % span == 0 else "network"


def collective_summary(records: list[CollectiveRecord]) -> dict:
    """By kind: count, wire and result bytes; the total wire bytes; and
    ``collective_s``, each record's wire bytes over its link's rate."""
    by_kind: dict[str, dict] = {}
    for r in records:
        d = by_kind.setdefault(r.kind, {"count": 0, "wire_bytes": 0.0,
                                        "result_bytes": 0})
        d["count"] += r.loop_mult
        d["wire_bytes"] += r.wire_bytes
        d["result_bytes"] += r.result_bytes * r.loop_mult
    total = sum(d["wire_bytes"] for d in by_kind.values())
    by_link = {link: sum(r.wire_bytes for r in records if r.link == link)
               for link in ("nvlink", "network")}
    return {"by_kind": by_kind, "total_wire_bytes": total,
            "wire_bytes_by_link": by_link,
            "collective_s": sum(b / HW[f"{link}_bw"]
                                for link, b in by_link.items())}


def roofline_terms(flops: float, bytes_accessed: float, wire_bytes: float,
                   collective_s: float | None = None) -> dict:
    """The three terms and the dominant one; the collective term is
    ``collective_s`` where the caller split the wire bytes by link
    (``collective_summary``), else all of them at the network's rate."""
    t_c = flops / HW["peak_flops"]
    t_m = bytes_accessed / HW["hbm_bw"]
    t_x = wire_bytes / HW["network_bw"] if collective_s is None \
        else collective_s
    dom = max((t_c, "compute"), (t_m, "memory"), (t_x, "collective"))[1]
    return {
        "compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
        "dominant": dom,
        "step_lower_bound_s": max(t_c, t_m, t_x),
        "roofline_fraction": (t_c / max(t_c, t_m, t_x)
                              if max(t_c, t_m, t_x) > 0 else 0.0),
    }


def model_flops_per_step(arch, shape, chips: int, total_params: int,
                         active_params: int) -> float:
    """MODEL_FLOPS per device per step: 6*N*D train, 2*N*D inference."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * active_params * tokens / chips


def parameter_collectives(params, specs, mesh, *, train: bool,
                          remat: bool) -> list[CollectiveRecord]:
    """The parameters' collectives a step over ``mesh`` makes, from their
    specs: a parameter sharded over "data" (FSDP) is all-gathered over it
    in the forward, again in the remat recompute and in the backward; in
    training each gradient is reduce-scattered over "data" (all-reduced
    where its parameter is not sharded over it) and all-reduced over
    "pod"."""
    shape = mesh.shape
    g_data, g_pod = shape.get(S.FSDP, 1), shape.get("pod", 1)
    spec_of = dict(S.leaves_with_paths(specs))
    gathers = (3 if remat else 2) if train else 1
    records = []

    def add(kind, result, g, n, axis):
        if g > 1:
            records.append(CollectiveRecord(
                kind, result, g, n, _wire_bytes(kind, result, g) * n,
                axis_link(mesh, (axis,))))

    for path, t in S.leaves_with_paths(params):
        spec = spec_of[path]
        shard = math.prod(S.shard_shape(t.shape, spec, mesh)) * t.element_size()
        fsdp = S.FSDP in S.spec_axes(spec)
        if fsdp:
            add("all-gather", shard * g_data, g_data, gathers, S.FSDP)
        if train:
            if fsdp:
                add("reduce-scatter", shard, g_data, 1, S.FSDP)
            else:
                add("all-reduce", shard, g_data, 1, S.FSDP)
            add("all-reduce", shard, g_pod, 1, "pod")
    return records


# ---------------------------------------------------------------------------
# Counting an eager step
# ---------------------------------------------------------------------------

_a = torch.ops.aten

# no bytes move: fresh allocations without a fill, and aliases
_NO_TRAFFIC = {_a.empty.memory_format, _a.empty_strided.default,
               _a.new_empty.default, _a.new_empty_strided.default,
               _a.empty_like.default, _a._unsafe_view.default,
               _a.lift_fresh.default}

# out-of-place gathers from their first argument
_GATHERS = {_a.embedding, _a.index, _a.index_select, _a.gather}

# in-place writes of selected rows of their first argument -> whether they
# accumulate (read the rows they write)
_ROW_WRITES = {_a.index_copy_: False, _a.index_put_: False,
               _a.index_add_: True, _a.scatter_: False, _a.scatter_add_: True,
               _a.scatter_reduce_: True}


def _footprint(t: torch.Tensor) -> int:
    """Bytes of memory a tensor covers: a stride-0 (broadcast) dim once."""
    if t.numel() == 0:
        return 0
    return math.prod(n for n, st in zip(t.shape, t.stride()) if st != 0) \
        * t.element_size()


def _rows_written(func, args) -> int | None:
    """Elements an in-place indexed write stores into ``args[0]``; None
    where the count needs a value the host does not have (a boolean
    mask's)."""
    packet = func._overloadpacket
    if packet in (_a.index_copy_, _a.index_add_):
        return args[3].numel()
    if packet is _a.index_put_:
        if any(i is not None and i.dtype == torch.bool for i in args[1]):
            return None
        idx = tuple(slice(None) if i is None
                    else torch.empty(i.shape, dtype=i.dtype, device="meta")
                    for i in args[1])
        return torch.empty(args[0].shape, device="meta")[idx].numel()
    return args[2].numel()                    # scatter*: the index's size


def _op_bytes(func, args, kwargs, out) -> int:
    """The bytes one aten op moves (module docstring)."""
    ins = [t for t in tree_flatten((args, kwargs))[0]
           if isinstance(t, torch.Tensor)]
    outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
    packet = func._overloadpacket
    if packet in _GATHERS:
        src, rows = ins[0], sum(_footprint(t) for t in outs)
        return (sum(_footprint(t) for t in ins[1:]) + rows
                + min(rows, _footprint(src)))
    if packet in _ROW_WRITES:
        n = _rows_written(func, args)
        if n is not None:
            acc = _ROW_WRITES[packet] or (
                packet is _a.index_put_ and bool(
                    kwargs.get("accumulate", len(args) > 3 and args[3])))
            acc = acc or func in (_a.scatter_.reduce, _a.scatter_.value_reduce)
            return (sum(_footprint(t) for t in ins[1:])
                    + n * ins[0].element_size() * (2 if acc else 1))
    touched = {id(t): t for t in ins + outs}
    return sum(_footprint(t) for t in touched.values())


@dataclasses.dataclass(frozen=True)
class Storage:
    """A storage the counted step made: its bytes, the shape of the tensor
    that made it, and its path in the step's outputs (``"0/embed"``) or
    None if it is not one."""
    nbytes: int
    shape: tuple
    out: str | None = None


@dataclasses.dataclass
class StepCount:
    """What :func:`count_step` counted."""
    flops_by_op: dict            # aten op -> FLOPs
    bytes_by_op: dict            # aten op -> bytes
    kernels: dict                # wrapper -> {"calls", "flops", "bytes"}
    ops: int                     # aten ops counted
    storages: tuple = ()         # Storage per storage the step made
    events: tuple = ()           # i + 1 where storages[i] was made, -(i + 1)
                                 # where it was freed, in order

    @property
    def bytes(self) -> int:
        """Aten ops' and kernels' bytes."""
        return (sum(self.bytes_by_op.values())
                + sum(k["bytes"] for k in self.kernels.values()))

    @property
    def live_peak_bytes(self) -> int:
        """The high-water mark of the step's storages."""
        return int(self.peak_bytes())

    def peak_bytes(self, share=None) -> float:
        """The high-water mark of the step's storages, each counted at
        ``share(storage)`` of its bytes (all of them by default): a layout's
        per-device peak where ``share`` is a storage's shard."""
        live = peak = 0.0
        for e in self.events:
            st = self.storages[abs(e) - 1]
            w = st.nbytes * (1.0 if share is None else share(st))
            live += w if e > 0 else -w
            peak = max(peak, live)
        return peak

    @property
    def aten_flops(self) -> int:
        return sum(self.flops_by_op.values())

    @property
    def kernel_flops(self) -> int:
        return sum(k["flops"] for k in self.kernels.values())

    @property
    def flops(self) -> int:
        return self.aten_flops + self.kernel_flops

    def to_dict(self) -> dict:
        return {"flops": self.flops, "aten_flops": self.aten_flops,
                "kernel_flops": self.kernel_flops, "bytes": self.bytes,
                "live_peak_bytes": self.live_peak_bytes, "ops": self.ops,
                "flops_by_op": dict(self.flops_by_op),
                "bytes_by_op": dict(self.bytes_by_op),
                "kernels": {k: dict(v) for k, v in self.kernels.items()}}


class _StepCounter(TorchDispatchMode):
    """The dispatch mode behind :func:`count_step`; its ``account_kernel``
    is the hook ``kernels/accounting.py`` calls."""

    def __init__(self, positions=None):
        super().__init__()
        self.positions = positions
        self.flops_by_op: dict[str, int] = {}
        self.bytes_by_op: dict[str, int] = {}
        self.ops = 0
        self.kernels: dict[str, dict] = {}
        self.storages: list[Storage] = []
        self.events: list[int] = []
        self._index = weakref.WeakKeyDictionary()  # storage -> its number

    def _track(self, out, seen=()):
        """Record the fresh storages among ``out``'s tensors (not aliases
        of the op's inputs ``seen`` nor storages already recorded)."""
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st in self._index or any(st is s for s in seen):
                continue
            self._index[st] = len(self.storages)
            self.storages.append(Storage(st.nbytes(), tuple(t.shape)))
            self.events.append(len(self.storages))
            weakref.finalize(st, self.events.append, -len(self.storages))

    def mark_outputs(self, out):
        """Name the step's outputs among its storages, by their paths."""
        tree = list(out) if isinstance(out, tuple) else out
        for path, t in S.leaves_with_paths(tree):
            i = self._index.get(t.untyped_storage()) \
                if isinstance(t, torch.Tensor) else None
            if i is not None and self.storages[i].out is None:
                self.storages[i] = dataclasses.replace(self.storages[i],
                                                       out=path)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        packet = func._overloadpacket
        name = str(packet).split(".")[-1]
        if packet in flop_registry:
            self.flops_by_op[name] = self.flops_by_op.get(name, 0) + int(
                flop_registry[packet](*args, **kwargs, out_val=out))
        if not func.is_view and func not in _NO_TRAFFIC:
            self.bytes_by_op[name] = self.bytes_by_op.get(name, 0) + \
                _op_bytes(func, args, kwargs, out)
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        self._track(out, [t.untyped_storage() for t in ins])
        return out

    def account_kernel(self, name, fn, formula, out_like, args, kwargs):
        with _disable_current_modes():
            flops, nbytes = formula(*args, positions=self.positions, **kwargs)
            k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                               "bytes": 0})
            k["calls"] += 1
            k["flops"] += int(flops)
            k["bytes"] += int(nbytes)
            if args[0].device.type == "meta":
                out = out_like(*args, **kwargs)
            else:
                out = fn(*args, **kwargs)
            self._track(out)
        return out

    def result(self) -> StepCount:
        return StepCount(dict(self.flops_by_op), dict(self.bytes_by_op),
                         {k: dict(v) for k, v in self.kernels.items()},
                         self.ops, tuple(self.storages), tuple(self.events))


def count_step(fn, *args, positions=None, **kwargs):
    """Run ``fn(*args, **kwargs)`` once, counting it; returns
    (:class:`StepCount`, fn's result).  ``positions``: the host-side decode
    position, for a step whose position is a device tensor (the decode
    kernel's visible keys; the counter never reads a device value).  On the
    ``meta`` device the hand-written kernels' wrappers return empty outputs
    and every other op runs shapes only; on the card and the CPU the step
    runs for real.  A CUDA graph replays no Python: count the step
    eagerly."""
    counter = _StepCounter(positions)
    with counter:
        out = fn(*args, **kwargs)
    counter.mark_outputs(out)
    return counter.result(), out
