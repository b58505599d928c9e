"""The distributed force pipeline on virtual ranks: one set of stage bodies,
several entry functions.

Port of ``repro/core/pipeline.py``.  The stages are

    gather  ->  assemble  ->  evaluate  ->  reduce

* **gather** — collective 1: every rank holds the replicated coordinates;
* **assemble** — virtual DD: local/ghost selection, image shifts, the
  skin-widened subdomain neighbour list (:func:`ddinfer._assemble_ranks`);
* **evaluate** — buffer rebuild at fresh positions, exact-cutoff re-filter
  (the ``cell_filter`` kernel), DP inference with autograd forces;
* **reduce** — collective 2: energy sum + force all-reduce/reduce-scatter,
  plus the diagnostics dictionary.

The G = ``prod(cfg.grid_dims)`` ranks run in one of two layouts, behind
one set of collectives (all_gather, gather_ranks, psum, pmax,
psum_scatter):

* virtual (``mesh=None``): every rank on one device as a leading rank axis,
  and :class:`_AxisOps` implements the collectives as tensor ops over it
  (all-gather is the replicated buffer, psum a sum over ranks, pmax a max,
  psum_scatter a sum followed by a slice);
* over processes (``mesh`` a :class:`~repro_torch.launch.mesh.DDMesh`):
  each of W processes evaluates G / W ranks, and :class:`_GroupAxisOps`
  runs the collectives over its ``torch.distributed`` group (NCCL on
  cards, gloo on the CPU), the reference's ``shard_map`` over the ``"dd"``
  axis.  A step runs the paper's two collectives (the coordinates'
  all-gather, the forces' all-reduce or reduce-scatter + all-gather) and
  one gather of the per-rank scalars (energies, counts, flags), whose sums
  over ranks are taken locally, so every process branches on the same
  values.  With one process the results equal the virtual path's bit for
  bit; with more, the forces' all-reduce adds the processes' partial sums
  in the collective's own order (the DP gate, not the bits).

Replica batching (``n_replicas=R``) is a transform of the same bodies, not
a second copy of them: the stage bodies always see R replicas (R = 1
unbatched), their per-rank tensors stacked replica-major as R*G rows of
the rank axis, and every collective reduces over the G ranks of each
replica.  Positions arrive as (R, N, 3); energies return as (R,), forces as
(R, N, 3) and every per-trajectory diagnostic as (R,) (``rank_cost`` and
the other per-rank vectors as (R, G)).  All R*G buffers go through the
model as one flattened (R*G*C)-row batch (atom ids offset by the replica's
and the rank's position), so each model kernel and each force-scatter site
launches once per force call whatever R.  The replicas are virtual axes of
one device, or (``mesh`` an :class:`~repro_torch.launch.mesh.EnsembleMesh`,
the reference's 2-D ``(replica x dd)`` mesh) shard over its leading axis:
every process passes all R replicas and evaluates only its cell of the
work, its ``Rl = R / Rs`` resident replicas (shard ``rs`` holds replicas
``rs*Rl .. (rs+1)*Rl - 1``) and ``G / Wd`` ranks of each, with the dd
collectives over its shard's :class:`DDMesh`; the per-replica results are
then gathered over its replica group (:func:`_gather_replicas`, tagged
``"replica_gather"``), so every process gets every replica's energies,
forces, flags and per-rank vectors and the engine's host branches stay the
same everywhere.

Comms/compute overlap (``DDConfig.overlap``) splits the amortized
evaluation at the assemble/evaluate seam into an interior pass (pass A:
the local rows only, fed by the partition collective, no dependence on the
all-gather) and a boundary pass (pass B, after the gather), merged per row
by ``where`` (:func:`_evaluate_rank_overlap`).  Row classes come from the
assembled state alone (:func:`_overlap_masks`).  On one device the
all-gather is a reshape, so pass A hides nothing and is extra work; over
processes the all-gather is issued asynchronously before pass A and waited
on after it.  The semantics are the reference's, bit for bit at the
default full-size pass B (``overlap_capacity = 0``), whose operands are
the sequential evaluate's, and within ulps under a trimmed
``overlap_capacity`` (overflow flagged in ``diag["overflow"]``).  Pass A
keeps the sequential (C, K) shapes, ghost rows parked and ghost-pointing
slots masked, so every GEMM sees the same M.

Also here: the health layer's ``fault_hook`` seam on the pre-reduce
per-rank forces (:meth:`ForcePipeline._post_eval`), the per-rank
``rank_nonfinite`` diagnostic, and the prefix phase probes
(:meth:`ForcePipeline.build_phase_probes`, the paper's Fig. 12 split with
:func:`repro_torch.obs.timed_prefix_phases`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..dp.model import DPModel
from ..kernels.cell_filter import cell_filter
from ..kernels import force_scatter as fs
from ..launch.mesh import DDMesh, EnsembleMesh
from ..md.neighbors import _topk_list, max_displacement2
from .ddinfer import (DDConfig, DDState, _make_grid, _pad_atoms,
                      _pad_types, _park, _rank_lists, _select_ranks)

F32 = torch.float32


class _Ready:
    """A finished collective: ``wait()`` returns its result."""

    def __init__(self, value):
        self.value = value

    def wait(self):
        return self.value


@dataclasses.dataclass(frozen=True)
class _AxisOps:
    """Collectives over the virtual (replica, rank) axes of one device.
    Per-rank values are stacked replica-major along one leading axis of
    ``n_rep * n_ranks`` rows; each collective reduces the ranks of each
    replica and returns a leading replica axis.  ``tag`` names the
    collective for a process mesh's timing record (unused here)."""

    n_ranks: int
    n_rep: int = 1

    @property
    def local_ranks(self) -> int:
        """Ranks held here: all of them."""
        return self.n_ranks

    @property
    def first_rank(self) -> int:
        return 0

    def local_view(self, x):
        """This process's per-rank rows (R*G, ...) -> (R, G, ...)."""
        return x.reshape(self.n_rep, self.n_ranks, *x.shape[1:])

    def all_gather(self, x, tag="gather"):
        """(R, G, chunk, ...) shards -> the replicated (R, G*chunk, ...)."""
        return x.reshape(self.n_rep, -1, *x.shape[3:])

    def all_gather_start(self, x, tag="gather"):
        """:meth:`all_gather`, issued; ``.wait()`` returns its result."""
        return _Ready(self.all_gather(x, tag))

    def gather_ranks(self, x, tag="diag"):
        """Per-rank values (R*G, ...) -> (R, G, ...)."""
        return x.reshape(self.n_rep, self.n_ranks, *x.shape[1:])

    def psum(self, x, tag="diag"):
        return self.gather_ranks(x).sum(1)

    def pmax(self, x, tag="diag"):
        return self.gather_ranks(x).amax(1)

    def psum_scatter(self, x, tag="force_reduce"):
        """(R*G, n_pad, ...) -> each rank's summed shard (R, G, chunk, ...)."""
        s = self.psum(x)
        return s.reshape(self.n_rep, self.n_ranks, -1, *s.shape[2:])


def _dist_op(new: str, old: str):
    """A ``torch.distributed`` collective under its newer name where this
    PyTorch has it (``all_gather_single``, ``reduce_scatter_single``)."""
    return getattr(dist, new, None) or getattr(dist, old)


def _launch_on(mesh: DDMesh, group, tag, fn, out, inp, finish,
               async_op=False, **kw):
    """``fn(out, inp)`` (``inp`` None: in place on ``out``) over ``group``,
    through host copies under ``mesh.host_copy``, its time marks in
    ``mesh.record``; returns a :class:`_Pending` whose ``wait()`` gives
    ``finish(out)``."""
    t0 = mesh.mark() if mesh.record is not None else None
    o, i = out, inp
    if mesh.host_copy:
        o = out.cpu()
        i = None if inp is None else inp.cpu()
    args = (o,) if i is None else (o, i)
    work = fn(*args, group=group, async_op=async_op, **kw)

    def done():
        if o is not out:
            out.copy_(o)
        return finish(out)

    return _Pending(work if async_op else None, done, mesh, tag, t0)


def _all_gather_flat(o, i, **kw):
    """``torch.distributed``'s all-gather into one tensor, over flat views:
    every process's ``i`` laid out process-major in ``o``."""
    fn = _dist_op("all_gather_single", "all_gather_into_tensor")
    return fn(o.view(-1), i.view(-1), **kw)


class _Pending:
    """A collective in flight on a process group: ``wait()`` waits for it,
    copies a host-side result back, closes its timing mark and returns the
    result."""

    def __init__(self, work, finish, mesh: DDMesh, tag: str, t0):
        self._work, self._finish = work, finish
        self._mesh, self._tag, self._t0 = mesh, tag, t0

    def wait(self):
        if self._work is not None:
            self._work.wait()
        out = self._finish()
        if self._mesh.record is not None:
            self._mesh.record.append((self._tag, self._t0, self._mesh.mark()))
        return out


@dataclasses.dataclass(frozen=True)
class _GroupAxisOps:
    """The same five collectives over the processes of a :class:`DDMesh`
    (``torch.distributed``: NCCL on cards, gloo on the CPU).  Process ``p``
    of ``W`` holds ranks ``p * Gl .. (p + 1) * Gl - 1`` (``Gl = G / W``),
    stacked replica-major as ``n_rep * Gl`` rows; every collective returns
    what :class:`_AxisOps` returns for all G ranks (a gathered or reduced
    value is the same on every process).  The process-major layout of a
    gathered tensor, (W, R, Gl, ...), is reordered to the replica-major
    (R, G, ...) every caller expects.  Under ``mesh.host_copy`` (gloo on
    CUDA tensors) each collective runs on host copies."""

    n_ranks: int
    mesh: DDMesh
    n_rep: int = 1

    @property
    def local_ranks(self) -> int:
        return self.n_ranks // self.mesh.world

    @property
    def first_rank(self) -> int:
        return self.mesh.index * self.local_ranks

    def local_view(self, x):
        return x.reshape(self.n_rep, self.local_ranks, *x.shape[1:])

    def _launch(self, tag, fn, out, inp, finish, async_op=False, **kw):
        """``fn(out, inp)`` over the dd group (:func:`_launch_on`)."""
        return _launch_on(self.mesh, self.mesh.group, tag, fn, out, inp,
                          finish, async_op=async_op, **kw)

    def _gather(self, x, tag, finish, async_op=False):
        """Every process's ``x`` -> ``finish((W, *x.shape))``, pending."""
        x = x.contiguous()
        out = torch.empty((self.mesh.world,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        return self._launch(tag, _all_gather_flat, out, x, finish,
                            async_op=async_op)

    def all_gather(self, x, tag="gather"):
        """(R, Gl, chunk, ...) own shards -> the replicated
        (R, G*chunk, ...)."""
        return self.all_gather_start(x, tag).wait()

    def all_gather_start(self, x, tag="gather"):
        """:meth:`all_gather` issued asynchronously (``async_op=True``);
        ``.wait()`` returns its result."""
        return self._gather(x, tag, lambda g: g.transpose(0, 1).reshape(
            self.n_rep, -1, *x.shape[3:]), async_op=True)

    def gather_ranks(self, x, tag="diag"):
        """Own per-rank values (R*Gl, ...) -> every rank's (R, G, ...)."""
        return self._gather(self.local_view(x), tag, lambda g: g.transpose(
            0, 1).reshape(self.n_rep, self.n_ranks, *x.shape[1:])).wait()

    def _reduce(self, local, op, tag):
        local = local.contiguous()
        return self._launch(tag, dist.all_reduce, local, None, lambda o: o,
                            op=op).wait()

    def psum(self, x, tag="diag"):
        """A sum over own ranks, then ``all_reduce(SUM)``: (R,...)."""
        return self._reduce(self.local_view(x).sum(1), dist.ReduceOp.SUM, tag)

    def pmax(self, x, tag="diag"):
        return self._reduce(self.local_view(x).amax(1), dist.ReduceOp.MAX,
                            tag)

    def psum_scatter(self, x, tag="force_reduce"):
        """(R*Gl, n_pad, ...) -> each own rank's summed shard
        (R, Gl, chunk, ...): a sum over own ranks, then
        ``reduce_scatter`` of the process-major (W, R, Gl, chunk, ...)."""
        w, gl = self.mesh.world, self.local_ranks
        s = self.local_view(x).sum(1)                       # (R, n_pad, ...)
        s = s.reshape(self.n_rep, w, gl, -1, *s.shape[2:]).transpose(0, 1)
        s = s.contiguous()
        out = torch.empty(s.shape[1:], dtype=s.dtype, device=s.device)
        fn = _dist_op("reduce_scatter_single", "reduce_scatter_tensor")
        return self._launch(
            tag, lambda o, i, **kw: fn(o, i.view(-1, *o.shape[1:]), **kw),
            out, s, lambda o: o).wait()


def _replica_layout(mesh: EnsembleMesh, cfg: DDConfig,
                    n_replicas: int) -> int:
    """Validate the 2-D mesh for ``n_replicas`` replicas and return the
    replicas each replica shard holds (the reference's
    ``_replica_layout``)."""
    if n_replicas < 1:
        raise ValueError(
            f"mesh axes {tuple(mesh.shape)} shard replicas: a 2-D "
            "(replica x dd) mesh runs a replica-batched pipeline "
            "(n_replicas >= 1); one trajectory takes make_dd_mesh")
    if mesh.dd.n_ranks != cfg.n_ranks:
        raise ValueError(f"mesh {cfg.axis} size {mesh.dd.n_ranks} != grid "
                         f"{cfg.n_ranks} ranks")
    rs = mesh.n_replica_shards
    if n_replicas % rs:
        raise ValueError(f"n_replicas {n_replicas} not divisible by the "
                         f"{mesh.replica_axis!r} mesh axis ({rs})")
    return n_replicas // rs


def _axis_ops(cfg: DDConfig, n_replicas: int, mesh):
    """The collectives for a pipeline: virtual ranks of one device
    (``mesh=None``), the processes of a :class:`DDMesh`, or the dd
    processes of an :class:`EnsembleMesh`'s replica shard, holding its
    ``n_replicas / n_replica_shards`` replicas."""
    if n_replicas < 0:
        raise ValueError(f"n_replicas must be >= 0, got {n_replicas}")
    if mesh is None:
        return _AxisOps(cfg.n_ranks, max(n_replicas, 1))
    if isinstance(mesh, EnsembleMesh):
        return _GroupAxisOps(cfg.n_ranks, mesh.dd,
                             n_rep=_replica_layout(mesh, cfg, n_replicas))
    if not isinstance(mesh, DDMesh):
        raise ValueError(
            "mesh must be a repro_torch DDMesh (launch.mesh.make_dd_mesh), "
            "an EnsembleMesh (ensemble.make_ensemble_mesh) or None (the "
            "ranks as virtual axes of one device), got "
            f"{type(mesh).__name__}")
    if mesh.n_ranks != cfg.n_ranks:
        raise ValueError(f"mesh dd size {mesh.n_ranks} != grid "
                         f"{cfg.n_ranks} ranks")
    if n_replicas > 0:
        raise ValueError(
            f"mesh axes {tuple(mesh.shape)} must include 'replica' and "
            f"{cfg.axis!r}: a 1-D dd mesh runs one trajectory; replicas on "
            "devices take the 2-D mesh of ensemble.make_ensemble_mesh "
            "(ROADMAP Queue 1 item 14(b)), and mesh=None keeps every "
            "replica and rank as virtual axes of one device")
    return _GroupAxisOps(cfg.n_ranks, mesh)


def _leaves(tree) -> list:
    """The tensors of a tuple/list/dict tree, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [v for t in tree.values() for v in _leaves(t)]
    return [v for t in tree for v in _leaves(t)]


def _rebuilt(tree, leaves):
    """``tree`` with its tensors replaced, in order, from the iterator
    ``leaves``."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if isinstance(tree, dict):
        return {k: _rebuilt(v, leaves) for k, v in tree.items()}
    return type(tree)(_rebuilt(t, leaves) for t in tree)


def _gather_replicas(mesh: EnsembleMesh, tree, tag="replica_gather"):
    """The resident replicas' results (every leaf (Rl, ...)) -> every
    replica's (R, ...), the same on every process: ONE all-gather over the
    mesh's replica group.  The leaves travel packed as float64 (which
    carries fp32, the integer counts and the flags exactly), so the
    gather is a concatenation that changes no bit; the process-major
    (Rs, Rl, ...) result is replica order, as the shards are contiguous."""
    leaves = _leaves(tree)
    rl = leaves[0].shape[0]
    packed = torch.cat([v.reshape(rl, -1).to(torch.float64)
                        for v in leaves], 1)
    out = torch.empty((mesh.n_replica_shards,) + tuple(packed.shape),
                      dtype=packed.dtype, device=packed.device)
    whole = _launch_on(mesh.dd, mesh.replica_group, tag, _all_gather_flat,
                       out, packed, lambda o: o).wait()
    whole = whole.reshape(mesh.n_replica_shards * rl, -1)
    sizes = [v[0].numel() for v in leaves]
    parts = whole.split(sizes, 1)
    return _rebuilt(tree, iter(
        p.to(v.dtype).reshape(-1, *v.shape[1:])
        for p, v in zip(parts, leaves)))


_STATE_LEAVES = ("l_idx", "l_mask", "g_idx", "g_shift", "g_mask",
                 "buf_types", "buf_mask", "nbr_idx", "nbr_mask")


def _st_dict(st: DDState, ax: _AxisOps) -> dict:
    """Per-rank view of a state: every stacked leaf ((G*cap, ...), or
    (R, G*cap, ...) batched) reshaped to (R*G, cap, ...)."""
    rg = ax.n_rep * ax.local_ranks
    out = {}
    for name in _STATE_LEAVES:
        v = getattr(st, name)
        trail = v.shape[-1:] if name in ("g_shift", "nbr_idx",
                                         "nbr_mask") else ()
        out[name] = v.reshape(rg, -1, *trail)
    return out


def _flat_rows(idx, ax: _AxisOps, n: int):
    """Per-replica atom ids (R*G, cap) -> ids into the (R*n)-row flattened
    coordinate buffer (offset by the replica's position)."""
    rep = torch.arange(ax.n_rep, device=idx.device).repeat_interleave(
        ax.local_ranks)
    return idx.long() + (rep * n)[:, None]


# ---------------------------------------------------------------------------
# evaluate stage: buffer rebuild + exact-cutoff re-filter + DP inference,
# for all replicas' ranks at once
# ---------------------------------------------------------------------------

def _rebuild_buffer(coords_all, ref_all, st: dict, box, ax: _AxisOps):
    """Subdomain buffers (R*G, C, 3) at fresh positions: ``current +
    (shift - img) * box`` with ``img`` the integer box crossing since the
    reference — an exact unwrap, so with ``ref_all is coords_all`` the
    assembly-time buffers come back bit for bit.  ``coords_all`` and
    ``ref_all`` are (R, n, 3)."""
    dtype = coords_all.dtype
    n = coords_all.shape[1]
    cur, ref = coords_all.reshape(-1, 3), ref_all.reshape(-1, 3)
    l_idx, g_idx = _flat_rows(st["l_idx"], ax, n), _flat_rows(st["g_idx"],
                                                              ax, n)
    img_l = torch.round((cur[l_idx] - ref[l_idx]) / box)
    img_g = torch.round((cur[g_idx] - ref[g_idx]) / box)
    buf_l = cur[l_idx] - img_l.to(dtype) * box
    buf_g = cur[g_idx] + (st["g_shift"].to(dtype) - img_g) * box
    return _park(torch.cat([buf_l, buf_g], 1), st["buf_mask"], box)


def _refilter_compact(buf_coords, nbr_idx, nbr_mask, cfg: DDConfig,
                      rcut: float):
    """Re-filter the (skin-widened, possibly stale) lists (RG, C, K) to the
    exact cutoff with the ``cell_filter`` kernel (one launch for all
    buffers) and compact canonically: surviving entries by ascending buffer
    index, zeroed tail, trimmed to ``k_eval``.  The model input then depends
    only on the within-cutoff pair set, so a stale list gives the forces of
    a fresh one bit for bit.  Returns (idx, mask, trim_overflow (RG,))."""
    g, c, k = nbr_idx.shape
    dev = buf_coords.device
    off = (torch.arange(g, device=dev, dtype=torch.int32) * c)[:, None, None]
    flat = torch.where(nbr_mask > 0, nbr_idx + off,
                       torch.full_like(nbr_idx, -1)).reshape(g * c, k)
    within = cell_filter(buf_coords.reshape(g * c, 3), flat,
                         torch.ones(g * c, dtype=F32, device=dev), rcut)
    k_eval = min(cfg.k_eval, k)
    idx, take, counts = _topk_list(within, k_eval,
                                   cand=nbr_idx.reshape(g * c, k), fill=0)
    trim_overflow = (counts.reshape(g, c) > k_eval).any(1)
    mask = take.to(buf_coords.dtype)
    return idx.reshape(g, c, k_eval), mask.reshape(g, c, k_eval), trim_overflow


def _scatter_rows(n_rows: int, rows: torch.Tensor, vals: torch.Tensor):
    """(n_rows, 3) sums of ``vals`` (R, 3) by destination ``rows`` (R,),
    each from +0.0 in ascending R: the ``force_scatter`` kernel on the card,
    ``index_add_`` on the CPU, the same bits on both.  (PyTorch's
    ``index_put_`` with accumulate adds with atomics in thread order on the
    CPU once it has 32,768 or more elements and several intra-op threads.)"""
    return fs.force_scatter(vals[:, None], rows[:, None],
                            torch.ones(len(rows), 1, dtype=vals.dtype,
                                       device=vals.device), n_rows)


def _buffer_model(model: DPModel, params, buf_coords, types, nbr_idx,
                  nbr_mask, force_mask):
    """DP inference over every buffer (RG, C, 3) as one (RG*C)-row batch:
    per-row energies (RG, C) and the forces -d(sum e * force_mask)/dx
    (RG, C, 3) in the coordinate dtype (fp32)."""
    g, c, _ = buf_coords.shape
    dev, dtype = buf_coords.device, buf_coords.dtype
    off = (torch.arange(g, device=dev, dtype=torch.int32) * c)[:, None, None]
    flat_idx = (nbr_idx + off).reshape(g * c, -1)
    with torch.enable_grad():
        x = buf_coords.detach().reshape(g * c, 3).requires_grad_(True)
        e = model._atomic_e(params, x, types.reshape(g * c), flat_idx,
                            nbr_mask.reshape(g * c, -1))
        e_rows = e.reshape(g, c)
        (grad,) = torch.autograd.grad((e_rows * force_mask).sum(), x)
    return e_rows.detach(), (-grad).to(dtype).reshape(g, c, 3)


def _local_mask(st: dict, cfg: DDConfig, dtype):
    l_mask = st["l_mask"].to(dtype)
    return torch.cat([l_mask, torch.zeros(l_mask.shape[0], cfg.ghost_capacity,
                                          dtype=dtype, device=l_mask.device)],
                     1)


def _scatter_local(st: dict, f_buf, cfg: DDConfig, n: int, ghosts: bool):
    """Scatter every rank's buffer forces (RG, C, 3) into its (n, 3) global
    array (local rows; ghost rows too with ``ghosts``), all ranks in one
    force-scatter launch.  Returns f_global (RG, n, 3)."""
    g = f_buf.shape[0]
    dev, dtype = f_buf.device, f_buf.dtype
    cl = cfg.local_capacity
    rank_off = (torch.arange(g, device=dev) * n)[:, None]
    rows = [(st["l_idx"].long() + rank_off).reshape(-1)]
    vals = [(f_buf[:, :cl] * st["l_mask"].to(dtype)[..., None]).reshape(-1, 3)]
    if ghosts:
        rows.append((st["g_idx"].long() + rank_off).reshape(-1))
        vals.append((f_buf[:, cl:]
                     * st["g_mask"].to(dtype)[..., None]).reshape(-1, 3))
    f_global = _scatter_rows(g * n, torch.cat(rows), torch.cat(vals))
    return f_global.reshape(g, n, 3)


def _model_scatter(model: DPModel, params, buf_coords, st: dict, nbr_idx,
                   nbr_mask, cfg: DDConfig, n: int):
    """DP inference over all buffers as one (RG*C)-row batch, and the
    scatter of each rank's forces into its (n, 3) global array.

    owner_full (paper Sec. IV-A): the 2 r_c halo makes every first-layer
    ghost's descriptor exact, so differentiating the whole buffer's energy
    gives complete forces on local rows; ghost rows are dropped.
    ghost_reduce (Eq. 7): energy over local rows only; partial forces land
    on ghosts and are summed onto their owners by collective 2.  The scatter
    (:func:`_scatter_rows`) sums in an order fixed by its inputs.
    Returns (e_local (RG,), f_global (RG, n, 3))."""
    dtype = buf_coords.dtype
    local_mask = _local_mask(st, cfg, dtype)
    force_mask = (st["buf_mask"].to(dtype) if cfg.force_mode == "owner_full"
                  else local_mask)
    e_rows, f_buf = _buffer_model(model, params, buf_coords, st["buf_types"],
                                  nbr_idx, nbr_mask, force_mask)
    e_local = (e_rows * local_mask).sum(1)
    f_global = _scatter_local(st, f_buf, cfg, n,
                              ghosts=cfg.force_mode != "owner_full")
    return e_local, f_global


def _stats(nbr_mask, st: dict, cfg: DDConfig):
    """Occupancy of the model-facing list over the slots valid rows paid
    for, per rank."""
    k_eval = min(cfg.k_eval, st["nbr_idx"].shape[-1])
    return {"nbr_fill": (nbr_mask > 0).sum((1, 2)).to(F32),
            "nbr_slots": st["buf_mask"].sum(1) * k_eval}


def _evaluate_rank(model: DPModel, params, coords_all, ref_all, st: dict,
                   box, cfg: DDConfig, rcut: float, ax: _AxisOps):
    """Sequential evaluate stage for all ranks: reuse the assembled state at
    fresh positions (rebuild -> re-filter -> inference -> scatter).
    Returns (e_local (RG,), f_global (RG, n, 3), trim_overflow (RG,),
    stats)."""
    n = coords_all.shape[1]
    buf_coords = _rebuild_buffer(coords_all, ref_all, st, box, ax)
    nbr_idx, nbr_mask, trim_overflow = _refilter_compact(
        buf_coords, st["nbr_idx"], st["nbr_mask"], cfg, rcut)
    e_local, f_global = _model_scatter(model, params, buf_coords, st,
                                       nbr_idx, nbr_mask, cfg, n)
    return e_local, f_global, trim_overflow, _stats(nbr_mask, st, cfg)


# ---------------------------------------------------------------------------
# overlap evaluate: interior pass (pre-gather) + boundary pass (post-gather)
# ---------------------------------------------------------------------------

def _overlap_masks(cfg: DDConfig, st: dict):
    """Row classification from the assembled state alone (pre-gather), for
    every rank (RG, C) at once.

        gfree(i)    local row whose build-list neighbours are all local rows
        interior(i) gfree and every neighbour gfree (its force is ghost-free)
        deep(i)     interior and every neighbour interior
        deep2(i)    deep and every neighbour deep

    Propagated over the *build* (skin-widened) list, whose membership is
    symmetric whenever assembly did not overflow, so ``interior`` rows
    receive force contributions only from ``gfree`` rows and ``deep`` rows
    contribute only to ``interior`` rows."""
    c = st["buf_mask"].shape[1]
    rowvalid = st["buf_mask"] > 0
    local_row = (torch.arange(c, device=rowvalid.device)
                 < cfg.local_capacity)[None, :].expand_as(rowvalid)
    m = st["nbr_mask"] > 0
    idx = st["nbr_idx"].long()
    g = idx.shape[0]

    def allnbr(flag):
        nb = torch.gather(flag, 1, idx.reshape(g, -1)).reshape(idx.shape)
        return torch.where(m, nb, torch.ones_like(nb)).all(2)

    gfree = rowvalid & local_row & allnbr(local_row)
    interior = gfree & allnbr(gfree)
    deep = interior & allnbr(interior)
    deep2 = deep & allnbr(deep)
    return gfree, interior, deep, deep2


def _route_contrib(coords_shard, l_slot, chunk: int, first: int = 0):
    """Partition-stage send buffers of the source ranks held here: rank s's
    shard coordinates (``coords_shard`` (R, Gs, chunk, 3), ranks ``first``
    .. ``first + Gs - 1``) placed at every routing slot it owns (``l_slot``
    (R, G*Cl), every rank's local atom ids), zeros elsewhere:
    (R, Gs, G*Cl, 3).  Summed over all sources and scattered, they hand
    each rank exactly ``coords_all[l_idx]`` (one writer per slot) without
    the all-gather."""
    r, g = coords_shard.shape[:2]
    src = torch.arange(first, first + g, device=l_slot.device)[None, :, None]
    slot = l_slot.long()[:, None, :]
    mine = torch.div(slot, chunk, rounding_mode="floor") == src
    off = torch.clamp(slot - src * chunk, 0, chunk - 1)
    vals = torch.gather(coords_shard, 2,
                        off[..., None].expand(r, g, off.shape[2], 3))
    return torch.where(mine[..., None], vals, torch.zeros_like(vals))


def _partition(coords_shard, l_slot, ax: _AxisOps, chunk: int):
    """The overlap collective: the shards held here (R, Gl, chunk, 3) and
    the replicated routing table (R, G*Cl) -> each own rank's exact local
    coordinates (R*Gl, Cl, 3), as the reference's tiled ``psum_scatter`` of
    the send buffers delivers them."""
    rg = ax.n_rep * ax.local_ranks
    contrib = _route_contrib(coords_shard, l_slot, chunk, ax.first_rank)
    return ax.psum_scatter(contrib.reshape(rg, -1, 3),
                           tag="partition").reshape(rg, -1, 3)


def _evaluate_interior(model: DPModel, params, cur_l, ref_all, st: dict,
                       box, cfg: DDConfig, rcut: float, gfree, ax: _AxisOps):
    """Pass A: exact current local coordinates ``cur_l`` (RG, Cl, 3, from
    the partition collective), ghost rows parked, ghost-pointing list slots
    masked: no dependence on the all-gather.  The buffers keep the
    sequential (C, K) shapes, so every GEMM sees the sequential M and the
    per-row energies of gfree rows, and the accumulated forces of interior
    rows, are the sequential ones (ghost rows feed exactly-zero cotangents
    and masked slots, so their parked values reach no gfree row).  The
    compaction sorts by buffer index and ghost rows follow every local row,
    so masking the ghost slots only drops each list's tail: the local
    entries keep their slots, and the force scatter its order.  Returns
    (e_rows (RG, Cl), f_rows (RG, Cl, 3))."""
    cl = cfg.local_capacity
    dtype = cur_l.dtype
    n = ref_all.shape[1]
    ref_l = ref_all.reshape(-1, 3)[_flat_rows(st["l_idx"], ax, n)]
    img_l = torch.round((cur_l - ref_l) / box)
    buf_l = cur_l - img_l.to(dtype) * box
    g = cur_l.shape[0]
    row_mask = _local_mask(st, cfg, dtype)
    buf = _park(torch.cat([buf_l, torch.zeros(g, cfg.ghost_capacity, 3,
                                              dtype=dtype,
                                              device=cur_l.device)], 1),
                row_mask, box)
    idx = st["nbr_idx"]
    mask = st["nbr_mask"] * (idx < cl)
    idx = torch.where(mask > 0, idx, torch.zeros_like(idx))
    idx, mask, _ = _refilter_compact(buf, idx, mask, cfg, rcut)
    e_rows, f_rows = _buffer_model(model, params, buf, st["buf_types"], idx,
                                   mask, gfree.to(dtype))
    return e_rows[:, :cl], f_rows[:, :cl]


def _evaluate_boundary(model: DPModel, params, buf_coords, st: dict,
                       nbr_idx, nbr_mask, cfg: DDConfig, deep, deep2):
    """Pass B over every rank (RG, C).  At the full sub-buffer size (the
    default ``overlap_capacity = 0``) the pass is operand for operand the
    sequential evaluate (the untouched buffers, every valid row a centre),
    so its rows are the sequential ones bit for bit.  A trimmed capacity
    compacts the non-deep rows plus their neighbour closure (the non-deep2
    rows, order kept) into a static (RG, c_sub) sub-buffer, remaps the
    re-filtered lists into it and evaluates only the non-deep centres:
    other operand shapes, so ulp-level.  Returns full-shape per-row
    energies and forces (exact for every non-deep row) and the sub-buffer
    overflow flag (RG,)."""
    g, c, _ = buf_coords.shape
    dev, dtype = buf_coords.device, buf_coords.dtype
    c_sub = min(cfg.overlap_capacity or c, c)
    if c_sub == c:
        e_rows, f_rows = _buffer_model(model, params, buf_coords,
                                       st["buf_types"], nbr_idx, nbr_mask,
                                       st["buf_mask"].to(dtype))
        return e_rows, f_rows, torch.zeros(g, dtype=torch.bool, device=dev)
    rowvalid = st["buf_mask"] > 0
    centers = rowvalid & ~deep          # rows whose output pass A cannot give
    sources = rowvalid & ~deep2         # centres plus every row they gather
    order = torch.arange(c, device=dev, dtype=F32)[None, :].expand(g, c)
    score = torch.where(sources, -order, torch.full_like(order,
                                                         float("-inf")))
    _, sel = torch.topk(score, c_sub, dim=1, sorted=True)
    take = torch.gather(sources, 1, sel)
    sub_overflow = sources.sum(1) > c_sub
    sel = torch.where(take, sel, torch.zeros_like(sel))
    # full-index -> sub-index map; padding slots routed to a spill column
    inv = torch.zeros(g, c + 1, dtype=torch.int32, device=dev)
    slots = torch.arange(c_sub, dtype=torch.int32, device=dev)
    inv.scatter_(1, torch.where(take, sel, torch.full_like(sel, c)),
                 slots[None, :].expand(g, c_sub).contiguous())
    rows3 = sel[..., None].expand(g, c_sub, 3)
    coords_sub = torch.gather(buf_coords, 1, rows3)
    center_bf = (torch.gather(centers, 1, sel) & take).to(dtype)
    k = nbr_idx.shape[-1]
    rows_k = sel[..., None].expand(g, c_sub, k)
    nbr_sub = torch.gather(nbr_idx.long(), 1, rows_k)
    idx_sub = torch.gather(inv, 1, nbr_sub.reshape(g, -1)).reshape(g, c_sub, k)
    mask_sub = torch.gather(nbr_mask, 1, rows_k) * center_bf[..., None]
    idx_sub = torch.where(mask_sub > 0, idx_sub, torch.zeros_like(idx_sub))
    types_sub = torch.gather(st["buf_types"], 1, sel)
    e_sub, f_sub = _buffer_model(model, params, coords_sub, types_sub,
                                 idx_sub, mask_sub, center_bf)
    dest = torch.where(take, sel, torch.full_like(sel, c))
    e_rows = torch.zeros(g, c + 1, dtype=dtype, device=dev).scatter_(
        1, dest, e_sub * center_bf)[:, :c]
    f_rows = torch.zeros(g, c + 1, 3, dtype=dtype, device=dev).scatter_(
        1, dest[..., None].expand(g, c_sub, 3),
        f_sub * center_bf[..., None])[:, :c]
    return e_rows, f_rows, sub_overflow


def _evaluate_rank_overlap(model: DPModel, params, coords_all, ref_all,
                           st: dict, box, cfg: DDConfig, rcut: float,
                           e_rows_a, f_rows_a, masks, ax: _AxisOps):
    """Merge pass A (computed pre-gather) with pass B into the sequential
    evaluate-stage outputs: per-row selects, never adds — pass A's forces on
    interior rows, pass B's elsewhere; the energy from pass B's rows at the
    full size (bit for bit), from pass A's on gfree rows when trimmed.
    Returns (e_local (RG,), f_global (RG, n, 3), overflow (RG,), stats,
    n_interior (RG,))."""
    gfree, interior, deep, deep2 = masks
    n = coords_all.shape[1]
    dtype = coords_all.dtype
    cl = cfg.local_capacity
    buf_coords = _rebuild_buffer(coords_all, ref_all, st, box, ax)
    nbr_idx, nbr_mask, trim_overflow = _refilter_compact(
        buf_coords, st["nbr_idx"], st["nbr_mask"], cfg, rcut)
    e_rows_b, f_rows_b, sub_overflow = _evaluate_boundary(
        model, params, buf_coords, st, nbr_idx, nbr_mask, cfg, deep, deep2)
    c = buf_coords.shape[1]
    local_mask = _local_mask(st, cfg, dtype)
    if min(cfg.overlap_capacity or c, c) == c:
        e_rows = e_rows_b
    else:
        e_rows = torch.cat([torch.where(gfree[:, :cl], e_rows_a,
                                        e_rows_b[:, :cl]),
                            torch.zeros_like(e_rows_b[:, cl:])], 1)
    e_local = (e_rows * local_mask).sum(1)
    f_l = torch.where(interior[:, :cl, None], f_rows_a, f_rows_b[:, :cl])
    f_global = _scatter_local(st, f_l, cfg, n, ghosts=False)
    n_int = (interior[:, :cl] & st["l_mask"]).sum(1)
    return (e_local, f_global, trim_overflow | sub_overflow,
            _stats(nbr_mask, st, cfg), n_int)


def _rank_table(ax, cols: dict, tag: str = "diag") -> dict:
    """Per-rank scalars of the ranks held here, {name: (R*Gl,)} -> every
    rank's {name: (R, G)} in its own dtype, through ONE gather over the
    ranks (float64 carries the fp32 values and the integer counts
    exactly), so a sum over the rank axis of the result is the virtual
    path's ``psum`` bit for bit on every process."""
    names = list(cols)
    packed = torch.stack([cols[k].reshape(-1).to(torch.float64)
                          for k in names], 1)
    table = ax.gather_ranks(packed, tag=tag)
    return {k: table[..., i].to(cols[k].dtype) for i, k in enumerate(names)}


def _nonfinite(f_global):
    """Per-rank count of non-finite entries in the pre-reduce force
    scatter (R*Gl,) int32: the per-rank attribution signal for blown
    evaluations (``diag["rank_nonfinite"]`` once gathered)."""
    return (~torch.isfinite(f_global)).sum((-2, -1)).to(torch.int32)


def _occupancy(t: dict) -> dict:
    """Occupancy of the model-facing lists from the gathered per-rank
    ``nbr_fill`` / ``nbr_slots``: mesh-wide and per rank."""
    fill, slots = t["nbr_fill"], t["nbr_slots"]
    return {"nbr_occupancy": (fill.sum(1)
                              / torch.clamp_min(slots.sum(1), 1.0)),
            "rank_occupancy": fill / torch.clamp_min(slots, 1.0)}


@dataclasses.dataclass(frozen=True)
class Stage:
    """One pipeline stage: a body over a context dict, with its in/out keys
    declared and an optional probe reducer (a per-rank value that depends
    on every expensive output of the stage, which a prefix probe through
    this stage returns)."""

    name: str
    inputs: tuple
    outputs: tuple
    body: Callable            # body(ctx) -> None (mutates ctx)
    probe: Optional[Callable] = None   # probe(ctx) -> (R*G,) per-rank values


class ForcePipeline:
    """The distributed force pipeline for one (model, DDConfig, box,
    n_atoms) tuple over ``prod(cfg.grid_dims)`` ranks, optionally
    replica-batched (``n_replicas`` > 0: every input and output gains a
    leading replica axis, every DDState leaf too).

    ``mesh=None``: every rank is a virtual rank of one device.  ``mesh`` a
    :class:`~repro_torch.launch.mesh.DDMesh`: this process evaluates its
    ``mesh.ranks_per_process`` ranks, and the collectives run over the
    mesh's process group.  Every process passes the same positions (the MD
    state is replicated, as the reference's engine holds it outside the
    ``shard_map``) and gets the same energy, forces and diagnostics; a
    :class:`DDState` then holds this process's ranks' leaves (leading
    ``Gl * capacity``), every rank's ``l_slot``, and the whole-mesh scalars
    and ``ref``.  A :class:`DDMesh` takes no replicas; ``mesh`` an
    :class:`~repro_torch.launch.mesh.EnsembleMesh` (``n_replicas`` a
    multiple of its replica shards) runs the replica-batched pipeline over
    both axes: positions arrive as all (R, N, 3), this process evaluates
    its ``Rl`` resident replicas (from ``rep0``) and ``Gl`` ranks, and
    every result returns for all R replicas, the same on every process.
    Its :class:`DDState` holds the resident replicas' rows of its own
    ranks (and their ``l_slot`` and ``ref``); the leaves the provider and
    the engine read on the host (``local_count``, ``ghost_count``,
    ``cost_max``, ``overflow``) are whole (R,).

    The ``build_*`` methods return functions with the JAX signatures:
    ``build_force_fn`` (fused per-step), ``build_assembly_fn`` +
    ``build_evaluation_fn`` + ``build_check_fn`` (amortized split),
    ``build_phase_probes``.  ``model=None`` builds a check-only pipeline.
    ``fault_hook`` (``health.FaultPlan.pipeline_hook``) sees the per-rank
    results of the ranks held here before the force reduction; without it
    nothing changes.
    """

    def __init__(self, model: Optional[DPModel], cfg: DDConfig, box,
                 n_atoms: int, fault_hook=None, *, n_replicas: int = 0,
                 mesh=None):
        box = torch.as_tensor(box, dtype=F32)
        cfg.validate(box.cpu().numpy())
        self.batched = n_replicas > 0
        self.n_replicas = int(n_replicas)
        self.ax = _axis_ops(cfg, self.n_replicas, mesh)
        self.mesh = mesh
        # a 2-D mesh: this process's replica shard holds replicas
        # rep0 .. rep0 + Rl - 1 (Rl = self.ax.n_rep)
        self.replica_mesh = mesh if isinstance(mesh, EnsembleMesh) else None
        self.rep0 = (mesh.replica_index * self.ax.n_rep
                     if self.replica_mesh is not None else 0)
        self.model = model
        self.cfg = cfg
        self.box = box
        self.n_atoms = int(n_atoms)
        self.n_pad = cfg.padded_atoms(n_atoms)
        self.chunk = self.n_pad // cfg.n_ranks
        self.rcut = model.cfg.descriptor.rcut if model is not None else 0.0
        self.fault_hook = fault_hook
        self.stages = self._fused_stages()

    def _require_model(self, what: str) -> None:
        if self.model is None:
            raise ValueError(f"{what} needs a model; this ForcePipeline "
                             "was built with model=None (check-only)")

    def _box(self, like: torch.Tensor) -> torch.Tensor:
        return self.box.to(like.device)

    @property
    def own_ranks(self) -> range:
        """The global ids of the ranks this process evaluates."""
        first = self.ax.first_rank
        return range(first, first + self.ax.local_ranks)

    # -- layout at the entry points ------------------------------------------

    def _in(self, coords):
        """Caller positions -> the resident replicas' (Rl, N, 3) (all R of
        them without a replica axis on the mesh)."""
        want = 3 if self.batched else 2
        if coords.dim() != want or (self.batched and coords.shape[0]
                                    != self.n_replicas):
            lead = f"({self.n_replicas}, N, 3)" if self.batched else "(N, 3)"
            raise ValueError(f"positions of shape {tuple(coords.shape)}; "
                             f"this pipeline takes {lead}")
        return self._resident(coords) if self.batched else coords[None]

    def _resident(self, x):
        """A whole-ensemble leaf (R, ...) -> the resident replicas' rows."""
        if self.replica_mesh is None:
            return x
        return x[self.rep0:self.rep0 + self.ax.n_rep]

    def _whole(self, tree):
        """The resident replicas' results -> every replica's, the same on
        every process (:func:`_gather_replicas`); the identity without a
        replica axis on the mesh."""
        if self.replica_mesh is None:
            return tree
        return _gather_replicas(self.replica_mesh, tree)

    def _out(self, x):
        """Per-replica results (R, ...), through tuples and dicts -> the
        caller's layout."""
        if self.batched:
            return x
        if isinstance(x, dict):
            return {k: self._out(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(self._out(v) for v in x)
        return x[0]

    def _shard(self, coords, types=None):
        """(R, N, 3) -> the padded shards of the ranks held here
        (R, Gl, chunk, 3) (and the padded shared types)."""
        box = self._box(coords)
        g = self.cfg.n_ranks
        padded = torch.stack([_pad_atoms(c, self.n_pad, box) for c in coords])
        shards = padded.reshape(coords.shape[0], g, self.chunk, 3)
        if self.mesh is not None:
            own = self.own_ranks
            shards = shards[:, own.start:own.stop]
        if types is None:
            return shards
        return shards, _pad_types(types, self.n_pad)

    def _state_in(self, st: DDState):
        """A DDState in the caller's layout -> (per-rank dict, ref
        (Rl, n_pad, 3), and the resident replicas' rows of its
        whole-ensemble leaves, shaped (Rl,))."""
        r = self.ax.n_rep
        whole = {k: self._resident(getattr(st, k)).reshape(r)
                 for k in ("local_count", "ghost_count", "cost_max",
                           "overflow")}
        return _st_dict(st, self.ax), st.ref.reshape(r, self.n_pad, 3), whole

    # -- stage bodies (ctx maps names -> tensors) ----------------------------

    def _assemble(self, coords_all, types_all):
        """Assembly of the ranks held here, for every replica: selection per
        replica (its own planes, from the replicated coordinates), then the
        lists of all R*Gl buffers in one call."""
        cfg = self.cfg
        box = self._box(coords_all)
        parts = []
        for c in coords_all:
            grid = _make_grid(c, box, cfg, self.n_atoms)
            parts.append(_select_ranks(c, types_all, box, grid, cfg,
                                       self.own_ranks, self.n_atoms))
        st = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        st = _rank_lists(st, cfg, self.rcut)
        st.pop("buf_coords")
        return st

    def _fused_stages(self) -> tuple:
        model, cfg, ax = self.model, self.cfg, self.ax
        rcut = self.rcut

        def gather(ctx):
            ctx["coords_all"] = ax.all_gather(ctx["coords_shard"])

        def assemble(ctx):
            ctx["st"] = self._assemble(ctx["coords_all"], ctx["types_all"])

        def evaluate(ctx):
            coords = ctx["coords_all"]
            (ctx["e_local"], ctx["f_global"], ctx["trim_ovf"],
             ctx["stats"]) = _evaluate_rank(model, ctx["params"], coords,
                                            coords, ctx["st"],
                                            self._box(coords), cfg, rcut, ax)
            ctx["e_local"], ctx["f_global"] = self._post_eval(
                ctx["e_local"], ctx["f_global"])

        def reduce(ctx):
            st = ctx["st"]
            ctx["forces"] = self._reduce_forces(ctx["f_global"])
            t = _rank_table(ax, {
                "e_local": ctx["e_local"], "local": st["local_count"],
                "ghost": st["ghost_count"],
                "overflow": (st["overflow"] | ctx["trim_ovf"]).to(
                    torch.int32),
                "nonfinite": _nonfinite(ctx["f_global"]), **ctx["stats"]})
            ctx["energy"] = t["e_local"].sum(1)
            cost = t["local"] + t["ghost"]
            cost_max = cost.amax(1)
            diag = {"local_count": t["local"].sum(1),
                    "ghost_count": t["ghost"].sum(1),
                    "cost_max": cost_max,
                    "rank_cost": cost,
                    "rank_nonfinite": t["nonfinite"],
                    **_occupancy(t),
                    "overflow": t["overflow"].sum(1)}
            diag["cost_ratio"] = (
                cost_max * cfg.n_ranks
                / torch.clamp_min(diag["local_count"] + diag["ghost_count"],
                                  1).to(F32))
            ctx["diag"] = diag

        def per_rank(x):
            return x.reshape(ax.n_rep * ax.local_ranks, -1).sum(1)

        return (
            Stage("gather", ("coords_shard",), ("coords_all",), gather,
                  probe=lambda ctx: ctx["coords_all"].sum(
                      (1, 2)).repeat_interleave(ax.local_ranks)),
            Stage("assembly", ("coords_all", "types_all"), ("st",), assemble,
                  probe=lambda ctx: (
                      per_rank(ctx["st"]["nbr_idx"]).to(F32)
                      + per_rank(ctx["st"]["nbr_mask"]).to(F32)
                      + ctx["st"]["local_count"].to(F32)
                      + ctx["st"]["ghost_count"].to(F32))),
            Stage("inference", ("params", "coords_all", "st"),
                  ("e_local", "f_global", "trim_ovf", "stats"), evaluate,
                  probe=lambda ctx: (ctx["e_local"]
                                     + per_rank(ctx["f_global"]))),
            Stage("force_reduce", ("e_local", "f_global", "st"),
                  ("energy", "forces", "diag"), reduce),
        )

    def _post_eval(self, e_local, f_global):
        """Fault-injection seam on the pre-reduce per-rank results.

        The hook (``health.FaultPlan.pipeline_hook``) poisons a target
        rank's slice of ``f_global`` before the force reduction, so the
        failure propagates the way a real blown rank's would.  It is called
        as ``hook(rank, rep0, e_local, f_global)`` with the layout of the
        ranks held here, (Gl,) / (Gl, n, 3) unbatched and (R, Gl) /
        (R, Gl, n, 3) batched (R the resident replicas, Gl = G without a
        mesh), ``rank`` their global ids, and ``rep0`` the first resident
        replica's global index (0 unless a 2-D mesh shards the replicas:
        the reference's ``axis_index(replica) * r_local``).  It reads its
        armed/unfired specs at each call: with nothing armed it returns its
        inputs."""
        if self.fault_hook is None:
            return e_local, f_global
        ax = self.ax
        own = self.own_ranks
        rank = torch.arange(own.start, own.stop, device=f_global.device)
        e, f = ax.local_view(e_local), ax.local_view(f_global)
        if self.batched:
            rank = rank.expand(ax.n_rep, ax.local_ranks)
            e, f = self.fault_hook(rank, self.rep0, e, f)
        else:
            e, f = self.fault_hook(rank, 0, e[0], f[0])
        return e.reshape(e_local.shape), f.reshape(f_global.shape)

    def _reduce_forces(self, f_global):
        """Collective 2: the per-rank force arrays summed onto every
        process, by ``all_reduce`` or by ``reduce_scatter`` then
        ``all_gather``."""
        ax = self.ax
        if self.cfg.reduce_mode == "reduce_scatter":
            return ax.all_gather(ax.psum_scatter(f_global),  # collective 2'
                                 tag="force_reduce")
        return ax.psum(f_global, tag="force_reduce")        # collective 2

    # -- entry functions: thin compositions over the stage bodies ------------

    def _run(self, stages, params, coords, types):
        shards, types_p = self._shard(self._in(coords), types)
        ctx = {"params": params, "coords_shard": shards, "types_all": types_p}
        for stage in stages:
            stage.body(ctx)
        return ctx

    def build_force_fn(self):
        """Fused per-step function: f(params, coords, types) ->
        (energy, forces, diag) — every stage in order."""
        self._require_model("build_force_fn")
        stages, n_atoms = self.stages, self.n_atoms

        def fn(params, coords, types):
            ctx = self._run(stages, params, coords, types)
            return self._out(self._whole((ctx["energy"],
                                          ctx["forces"][:, :n_atoms],
                                          ctx["diag"])))

        return fn

    def build_assembly_fn(self):
        """Assembly function: f(coords, types) -> DDState (leaves with a
        leading replica axis when batched)."""
        self._require_model("build_assembly_fn")
        ax = self.ax
        gather_s, assemble_s = self.stages[0], self.stages[1]
        r = ax.n_rep

        def assemble(coords, types):
            ctx = self._run((gather_s, assemble_s), None, coords, types)
            st = ctx["st"]
            t = _rank_table(ax, {"local": st["local_count"],
                                 "ghost": st["ghost_count"],
                                 "overflow": st["overflow"].to(torch.int32)},
                            tag="assembly")
            whole = ("local_count", "ghost_count", "overflow")
            flat = {k: v.reshape(r, -1, *v.shape[2:]) for k, v in st.items()
                    if k not in whole}
            # every rank's local ids: the overlap's routing table
            l_slot = ax.all_gather(st["l_idx"].reshape(r, ax.local_ranks, -1),
                                   tag="assembly")
            scalars = self._whole({
                "cost_max": (t["local"] + t["ghost"]).amax(1),
                "local_count": t["local"].sum(1),
                "ghost_count": t["ghost"].sum(1),
                "overflow": t["overflow"].sum(1)})
            return DDState(l_slot=self._out(l_slot),
                           ref=self._out(ctx["coords_all"]),
                           **self._out({**scalars, **flat}))

        return assemble

    def build_evaluation_fn(self):
        """Evaluation function: f(params, coords, state) ->
        (energy, forces, diag), reusing the assembled state.  With
        ``cfg.overlap`` the partition collective and the interior pass run
        before the gather completes, the boundary pass and the merge after
        it."""
        self._require_model("build_evaluation_fn")
        if self.cfg.overlap:
            return self._build_evaluation_overlap()
        model, cfg, ax, rcut = self.model, self.cfg, self.ax, self.rcut
        n_atoms = self.n_atoms

        def evaluate(params, coords, st: DDState):
            shards = self._shard(self._in(coords))
            coords_all = ax.all_gather(shards)               # collective 1
            st_d, ref, whole = self._state_in(st)
            e_local, f_global, trim_ovf, stats = _evaluate_rank(
                model, params, coords_all, ref, st_d, self._box(coords), cfg,
                rcut, ax)
            e_local, f_global = self._post_eval(e_local, f_global)
            forces = self._reduce_forces(f_global)
            energy, diag = self._eval_diag(whole, st_d, trim_ovf, stats,
                                           self._disp2(coords_all, ref),
                                           e_local, f_global)
            return self._out(self._whole((energy, forces[:, :n_atoms],
                                          diag)))

        return evaluate

    def _build_evaluation_overlap(self):
        model, cfg, ax, rcut = self.model, self.cfg, self.ax, self.rcut
        n_atoms, chunk = self.n_atoms, self.chunk

        def evaluate(params, coords, st: DDState):
            shards = self._shard(self._in(coords))
            st_d, ref, whole = self._state_in(st)
            box = self._box(coords)
            # row classes from the state alone: known before the gather
            masks = _overlap_masks(cfg, st_d)
            l_slot = st.l_slot.reshape(ax.n_rep, -1)
            cur_l = _partition(shards, l_slot, ax, chunk)  # overlap collective
            gathering = ax.all_gather_start(shards)         # collective 1
            # pass A: nothing below depends on the all-gather
            e_a, f_a = _evaluate_interior(model, params, cur_l, ref, st_d,
                                          box, cfg, rcut, masks[0], ax)
            coords_all = gathering.wait()
            e_local, f_global, trim_ovf, stats, n_int = _evaluate_rank_overlap(
                model, params, coords_all, ref, st_d, box, cfg, rcut, e_a,
                f_a, masks, ax)
            e_local, f_global = self._post_eval(e_local, f_global)
            forces = self._reduce_forces(f_global)
            energy, diag = self._eval_diag(
                whole, st_d, trim_ovf, stats, self._disp2(coords_all, ref),
                e_local, f_global,
                {"n_int": n_int.to(torch.int32),
                 "n_loc": st_d["l_mask"].sum(-1).to(torch.int32)})
            return self._out(self._whole((energy, forces[:, :n_atoms],
                                          diag)))

        return evaluate

    def _disp2(self, coords_all, ref):
        """Max squared displacement since ``ref`` over every rank's shard,
        per replica (R,) (a max is exact in any grouping, so this is the
        pmax of the per-shard maxima)."""
        return max_displacement2(coords_all, ref, self._box(coords_all))

    def _needs_rebuild(self, disp2, overflow):
        half = torch.tensor((0.5 * self.cfg.skin) ** 2, dtype=F32,
                            device=disp2.device)
        return (disp2 > half) | (overflow > 0)

    def _eval_diag(self, whole: dict, st_d: dict, trim_ovf, stats, disp2,
                   e_local, f_global, extra=None):
        """The evaluation's energy and diagnostics from one gather of the
        per-rank scalars (``extra``: the overlap's interior counts)."""
        cfg = self.cfg
        t = _rank_table(self.ax, {
            "e_local": e_local, "trim": trim_ovf.to(torch.int32),
            "cost": (st_d["l_mask"].sum(-1).to(torch.int32)
                     + st_d["g_mask"].sum(-1).to(torch.int32)),
            "nonfinite": _nonfinite(f_global), **stats, **(extra or {})})
        total = whole["local_count"] + whole["ghost_count"]
        diag = {"local_count": whole["local_count"],
                "ghost_count": whole["ghost_count"],
                "overflow": whole["overflow"] + t["trim"].sum(1),
                "max_disp2": disp2,
                "cost_max": whole["cost_max"], "rank_cost": t["cost"],
                "rank_nonfinite": t["nonfinite"],
                **_occupancy(t),
                # max/mean per-rank Eq.-8 cost: the load-imbalance figure
                "cost_ratio": whole["cost_max"] * cfg.n_ranks
                              / torch.clamp_min(total, 1).to(F32),
                "needs_rebuild": self._needs_rebuild(disp2,
                                                     whole["overflow"])}
        if extra:
            diag["interior_frac"] = (
                t["n_int"].sum(1).to(F32)
                / torch.clamp_min(t["n_loc"].sum(1), 1).to(F32))
        return t["e_local"].sum(1), diag

    def build_check_fn(self):
        """Standalone rebuild check: f(coords, state) -> bool (per replica,
        (R,), when batched) — some atom moved more than skin/2 since
        ``state.ref``, or the build overflowed."""

        def check(coords, st: DDState):
            coords_all = self.ax.all_gather(self._shard(self._in(coords)))
            r = self.ax.n_rep
            ref = st.ref.reshape(r, self.n_pad, 3)
            return self._out(self._whole(self._needs_rebuild(
                self._disp2(coords_all, ref),
                self._resident(st.overflow).reshape(r))))

        return check

    def build_phase_probes(self) -> dict:
        """Prefix probes attributing the fused force function's cost to its
        stages: a walk over ``self.stages``, probe *k* running the pipeline
        through stage *k* and returning that stage's per-rank probe values
        ((G,), or (R, G) batched), so successive wall-time differences
        (:func:`repro_torch.obs.timed_prefix_phases`) measure the paper's
        Fig. 12 shares.  The last entry IS :meth:`build_force_fn`."""
        self._require_model("build_phase_probes")
        probes = {}
        for i, stage in enumerate(self.stages):
            if stage.probe is None:
                continue
            prefix = self.stages[: i + 1]

            def fn(params, coords, types, _prefix=prefix, _stage=stage):
                ctx = self._run(_prefix, params, coords, types)
                return self._out(self._whole(
                    self.ax.gather_ranks(_stage.probe(ctx))))

            probes[stage.name] = fn
        probes[self.stages[-1].name] = self.build_force_fn()
        return probes
