"""The distributed force pipeline on virtual ranks: one set of stage bodies,
several entry functions.

Port of the sequential path of ``repro/core/pipeline.py``.  The stages are

    gather  ->  assemble  ->  evaluate  ->  reduce

* **gather** — collective 1: every rank holds the replicated coordinates;
* **assemble** — virtual DD: local/ghost selection, image shifts, the
  skin-widened subdomain neighbour list (:func:`ddinfer._assemble_ranks`);
* **evaluate** — buffer rebuild at fresh positions, exact-cutoff re-filter
  (the ``cell_filter`` kernel), DP inference with autograd forces;
* **reduce** — collective 2: energy sum + force all-reduce/reduce-scatter,
  plus the diagnostics dictionary.

The G = ``prod(cfg.grid_dims)`` ranks are virtual: they live on one device
as a leading rank axis, and :class:`_AxisOps` implements the collectives as
tensor ops over it (all-gather is the replicated buffer, psum a sum over
ranks, pmax a max, psum_scatter a sum followed by a slice).  All ranks'
buffers go through the model as one flattened (G*C)-row batch, so each
model kernel launches once per force call.

Also here: the health layer's ``fault_hook`` seam on the pre-reduce
per-rank forces (:meth:`ForcePipeline._post_eval`), the per-rank
``rank_nonfinite`` diagnostic, and the prefix phase probes
(:meth:`ForcePipeline.build_phase_probes`, the paper's Fig. 12 split with
:func:`repro_torch.obs.timed_prefix_phases`).  Not ported yet: the
comms/compute overlap mode (ROADMAP Queue 1 item 5) and replica batching
(item 7).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..dp.model import DPModel
from ..kernels.cell_filter import cell_filter
from ..kernels import force_scatter as fs
from ..md.neighbors import _topk_list, max_displacement2
from .ddinfer import (DDConfig, DDState, _assemble_ranks, _make_grid,
                      _pad_atoms, _park)

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class _AxisOps:
    """Collectives over a leading virtual-rank axis on one device."""

    n_ranks: int

    def all_gather(self, x):
        """(G, chunk, ...) shards -> the replicated (G*chunk, ...) buffer."""
        return x.reshape(-1, *x.shape[2:])

    def gather_ranks(self, x):
        """Per-rank values (G,) -> the replicated rank vector."""
        return x

    def psum(self, x):
        return x.sum(0)

    def pmax(self, x):
        return x.amax(0)

    def psum_scatter(self, x):
        """(G, n_pad, ...) -> each rank's summed shard (G, chunk, ...)."""
        s = x.sum(0)
        return s.reshape(self.n_ranks, -1, *s.shape[1:])


def _st_dict(st: DDState, cfg: DDConfig) -> dict:
    """Per-rank view of a state: every stacked leaf reshaped to (G, ...)."""
    g = cfg.n_ranks
    out = {}
    for name in ("l_idx", "l_mask", "g_idx", "g_shift", "g_mask", "buf_types",
                 "buf_mask", "nbr_idx", "nbr_mask"):
        v = getattr(st, name)
        out[name] = v.reshape(g, -1, *v.shape[1:])
    return out


# ---------------------------------------------------------------------------
# evaluate stage: buffer rebuild + exact-cutoff re-filter + DP inference,
# for all ranks at once
# ---------------------------------------------------------------------------

def _rebuild_buffer(coords_all, ref_all, st: dict, box, cfg: DDConfig):
    """Subdomain buffers (G, C, 3) at fresh positions: ``current + (shift -
    img) * box`` with ``img`` the integer box crossing since the reference —
    an exact unwrap, so with ``ref_all is coords_all`` the assembly-time
    buffers come back bit for bit."""
    dtype = coords_all.dtype
    l_idx, g_idx = st["l_idx"].long(), st["g_idx"].long()
    img_l = torch.round((coords_all[l_idx] - ref_all[l_idx]) / box)
    img_g = torch.round((coords_all[g_idx] - ref_all[g_idx]) / box)
    buf_l = coords_all[l_idx] - img_l.to(dtype) * box
    buf_g = coords_all[g_idx] + (st["g_shift"].to(dtype) - img_g) * box
    return _park(torch.cat([buf_l, buf_g], 1), st["buf_mask"], box)


def _refilter_compact(buf_coords, nbr_idx, nbr_mask, cfg: DDConfig,
                      rcut: float):
    """Re-filter the (skin-widened, possibly stale) lists (G, C, K) to the
    exact cutoff with the ``cell_filter`` kernel (one launch for all
    ranks) and compact canonically: surviving entries by ascending buffer
    index, zeroed tail, trimmed to ``k_eval``.  The model input then depends
    only on the within-cutoff pair set, so a stale list gives the forces of
    a fresh one bit for bit.  Returns (idx, mask, trim_overflow (G,))."""
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


def _model_scatter(model: DPModel, params, buf_coords, st: dict, nbr_idx,
                   nbr_mask, cfg: DDConfig, n: int):
    """DP inference over all ranks' buffers as one (G*C)-row batch, and the
    scatter of each rank's forces into its (n, 3) global array.

    owner_full (paper Sec. IV-A): the 2 r_c halo makes every first-layer
    ghost's descriptor exact, so differentiating the whole buffer's energy
    gives complete forces on local rows; ghost rows are dropped.
    ghost_reduce (Eq. 7): energy over local rows only; partial forces land
    on ghosts and are summed onto their owners by collective 2.  The scatter
    (:func:`_scatter_rows`) sums in an order fixed by its inputs.
    Returns (e_local (G,), f_global (G, n, 3))."""
    g, c, _ = buf_coords.shape
    dev, dtype = buf_coords.device, buf_coords.dtype
    cl = cfg.local_capacity
    l_mask = st["l_mask"].to(dtype)
    local_mask = torch.cat([l_mask, torch.zeros(g, cfg.ghost_capacity,
                                                dtype=dtype, device=dev)], 1)
    force_mask = (st["buf_mask"].to(dtype) if cfg.force_mode == "owner_full"
                  else local_mask)
    off = (torch.arange(g, device=dev, dtype=torch.int32) * c)[:, None, None]
    flat_idx = (nbr_idx + off).reshape(g * c, -1)
    with torch.enable_grad():
        x = buf_coords.detach().reshape(g * c, 3).requires_grad_(True)
        e = model._atomic_e(params, x, st["buf_types"].reshape(g * c),
                            flat_idx, nbr_mask.reshape(g * c, -1))
        e_rows = e.reshape(g, c)
        (grad,) = torch.autograd.grad((e_rows * force_mask).sum(), x)
    e_local = (e_rows.detach() * local_mask).sum(1)
    # force reduction stays in the coordinate dtype (fp32)
    f_buf = (-grad).to(dtype).reshape(g, c, 3)
    rank_off = (torch.arange(g, device=dev) * n)[:, None]
    rows = [(st["l_idx"].long() + rank_off).reshape(-1)]
    vals = [(f_buf[:, :cl] * l_mask[..., None]).reshape(-1, 3)]
    if cfg.force_mode != "owner_full":
        rows.append((st["g_idx"].long() + rank_off).reshape(-1))
        vals.append((f_buf[:, cl:]
                     * st["g_mask"].to(dtype)[..., None]).reshape(-1, 3))
    f_global = _scatter_rows(g * n, torch.cat(rows), torch.cat(vals))
    return e_local, f_global.reshape(g, n, 3)


def _evaluate_rank(model: DPModel, params, coords_all, ref_all, st: dict,
                   box, cfg: DDConfig, rcut: float):
    """Sequential evaluate stage for all ranks: reuse the assembled state at
    fresh positions (rebuild -> re-filter -> inference -> scatter).
    Returns (e_local (G,), f_global (G, n, 3), trim_overflow (G,), stats)."""
    n = coords_all.shape[0]
    buf_coords = _rebuild_buffer(coords_all, ref_all, st, box, cfg)
    nbr_idx, nbr_mask, trim_overflow = _refilter_compact(
        buf_coords, st["nbr_idx"], st["nbr_mask"], cfg, rcut)
    e_local, f_global = _model_scatter(model, params, buf_coords, st,
                                       nbr_idx, nbr_mask, cfg, n)
    # occupancy of the model-facing list over the slots valid rows paid for
    k_eval = min(cfg.k_eval, st["nbr_idx"].shape[-1])
    stats = {"nbr_fill": (nbr_mask > 0).sum((1, 2)).to(F32),
             "nbr_slots": st["buf_mask"].sum(1) * k_eval}
    return e_local, f_global, trim_overflow, stats


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
    probe: Optional[Callable] = None   # probe(ctx) -> (G,) per-rank values


class ForcePipeline:
    """The distributed force pipeline for one (model, DDConfig, box,
    n_atoms) tuple, on ``prod(cfg.grid_dims)`` virtual ranks of one device.

    The ``build_*`` methods return functions with the JAX signatures:
    ``build_force_fn`` (fused per-step), ``build_assembly_fn`` +
    ``build_evaluation_fn`` + ``build_check_fn`` (amortized split),
    ``build_phase_probes``.  ``model=None`` builds a check-only pipeline.
    ``fault_hook`` (``health.FaultPlan.pipeline_hook``) sees the per-rank
    results before the force reduction; without it nothing changes.
    """

    def __init__(self, model: Optional[DPModel], cfg: DDConfig, box,
                 n_atoms: int, fault_hook=None):
        box = torch.as_tensor(box, dtype=F32)
        cfg.validate(box.cpu().numpy())
        self.ax = _AxisOps(cfg.n_ranks)
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

    # -- stage bodies (ctx maps names -> tensors) ----------------------------

    def _fused_stages(self) -> tuple:
        model, cfg, ax = self.model, self.cfg, self.ax
        rcut, n_atoms = self.rcut, self.n_atoms

        def gather(ctx):
            ctx["coords_all"] = ax.all_gather(ctx["coords_shard"])

        def assemble(ctx):
            coords = ctx["coords_all"]
            box = self._box(coords)
            grid = _make_grid(coords, box, cfg, n_atoms)
            st = _assemble_ranks(coords, ctx["types_all"], box, grid, cfg,
                                 rcut, range(cfg.n_ranks), n_atoms)
            st.pop("buf_coords")
            ctx["st"] = st

        def evaluate(ctx):
            coords = ctx["coords_all"]
            (ctx["e_local"], ctx["f_global"], ctx["trim_ovf"],
             ctx["stats"]) = _evaluate_rank(model, ctx["params"], coords,
                                            coords, ctx["st"],
                                            self._box(coords), cfg, rcut)
            ctx["e_local"], ctx["f_global"] = self._post_eval(
                ctx["e_local"], ctx["f_global"])

        def reduce(ctx):
            st = ctx["st"]
            ovf = st["overflow"] | ctx["trim_ovf"]
            ctx["energy"], ctx["forces"] = self._reduce_forces(
                ctx["e_local"], ctx["f_global"])
            l_count, g_count = st["local_count"], st["ghost_count"]
            cost_max = ax.pmax(l_count + g_count)
            diag = {"local_count": ax.psum(l_count),
                    "ghost_count": ax.psum(g_count),
                    "cost_max": cost_max,
                    "rank_cost": ax.gather_ranks(l_count + g_count),
                    "rank_nonfinite": self._rank_nonfinite(ctx["f_global"]),
                    **self._occupancy_diag(ctx["stats"]),
                    "overflow": ax.psum(ovf.to(torch.int32))}
            diag["cost_ratio"] = (
                cost_max * cfg.n_ranks
                / torch.clamp_min(diag["local_count"] + diag["ghost_count"],
                                  1).to(F32))
            ctx["diag"] = diag

        g = cfg.n_ranks

        def per_rank(x):
            return x.reshape(g, -1).sum(1)

        return (
            Stage("gather", ("coords_shard",), ("coords_all",), gather,
                  probe=lambda ctx: ctx["coords_all"].sum().expand(g)),
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
        rank's slice of ``f_global`` (G, n, 3) before the force reduction,
        so the failure propagates the way a real blown rank's would.  It
        reads its armed/unfired specs at each call: with nothing armed it
        returns its inputs."""
        if self.fault_hook is None:
            return e_local, f_global
        rank = torch.arange(self.cfg.n_ranks, device=f_global.device)
        return self.fault_hook(rank, 0, e_local, f_global)

    def _rank_nonfinite(self, f_global):
        """Per-rank count of non-finite entries in the pre-reduce force
        scatter (G,) int32: the per-rank attribution signal for blown
        evaluations."""
        bad = (~torch.isfinite(f_global)).sum((-2, -1)).to(torch.int32)
        return self.ax.gather_ranks(bad)

    def _reduce_forces(self, e_local, f_global):
        ax, cfg = self.ax, self.cfg
        energy = ax.psum(e_local)
        if cfg.reduce_mode == "reduce_scatter":
            forces = ax.all_gather(ax.psum_scatter(f_global))  # collective 2'
        else:
            forces = ax.psum(f_global)                        # collective 2
        return energy, forces

    def _occupancy_diag(self, stats) -> dict:
        ax = self.ax
        fill, slots = stats["nbr_fill"], stats["nbr_slots"]
        return {"nbr_occupancy": (ax.psum(fill)
                                  / torch.clamp_min(ax.psum(slots), 1.0)),
                "rank_occupancy": ax.gather_ranks(
                    fill / torch.clamp_min(slots, 1.0))}

    def _shard(self, coords, types=None):
        """Pad to a rank multiple and cut the atom axis into rank shards."""
        box = self._box(coords)
        if types is None:
            coords_p = _pad_atoms(coords, self.n_pad, box)
            return coords_p.reshape(self.cfg.n_ranks, self.chunk, 3)
        coords_p, types_p = _pad_atoms(coords, self.n_pad, box, types)
        return coords_p.reshape(self.cfg.n_ranks, self.chunk, 3), types_p

    # -- entry functions: thin compositions over the stage bodies ------------

    def build_force_fn(self):
        """Fused per-step function: f(params, coords, types) ->
        (energy, forces, diag) — every stage in order."""
        self._require_model("build_force_fn")
        stages, n_atoms = self.stages, self.n_atoms

        def fn(params, coords, types):
            shards, types_p = self._shard(coords, types)
            ctx = {"params": params, "coords_shard": shards,
                   "types_all": types_p}
            for stage in stages:
                stage.body(ctx)
            return ctx["energy"], ctx["forces"][:n_atoms], ctx["diag"]

        return fn

    def build_assembly_fn(self):
        """Assembly function: f(coords, types) -> DDState."""
        self._require_model("build_assembly_fn")
        ax = self.ax
        gather_s, assemble_s = self.stages[0], self.stages[1]

        def assemble(coords, types):
            shards, types_p = self._shard(coords, types)
            ctx = {"coords_shard": shards, "types_all": types_p}
            gather_s.body(ctx)
            assemble_s.body(ctx)
            st = ctx["st"]
            flat = {k: v.reshape(-1, *v.shape[2:]) for k, v in st.items()
                    if k not in ("local_count", "ghost_count", "overflow")}
            return DDState(
                l_slot=ax.all_gather(st["l_idx"]),
                cost_max=ax.pmax(st["local_count"] + st["ghost_count"]),
                local_count=ax.psum(st["local_count"]),
                ghost_count=ax.psum(st["ghost_count"]),
                overflow=ax.psum(st["overflow"].to(torch.int32)),
                ref=ctx["coords_all"], **flat)

        return assemble

    def build_evaluation_fn(self):
        """Evaluation function: f(params, coords, state) ->
        (energy, forces, diag), reusing the assembled state."""
        self._require_model("build_evaluation_fn")
        model, cfg, ax, rcut = self.model, self.cfg, self.ax, self.rcut
        n_atoms = self.n_atoms

        def evaluate(params, coords, st: DDState):
            shards = self._shard(coords)
            coords_all = ax.all_gather(shards)               # collective 1
            st_d = _st_dict(st, cfg)
            e_local, f_global, trim_ovf, stats = _evaluate_rank(
                model, params, coords_all, st.ref, st_d,
                self._box(coords), cfg, rcut)
            e_local, f_global = self._post_eval(e_local, f_global)
            energy, forces = self._reduce_forces(e_local, f_global)
            disp2 = self._disp2(coords_all, st.ref)
            diag = self._eval_diag(st, st_d, trim_ovf, stats, disp2,
                                   f_global)
            return energy, forces[:n_atoms], diag

        return evaluate

    def _disp2(self, coords_all, ref):
        """Max squared displacement since ``ref`` over every rank's shard
        (pmax of the per-shard maxima)."""
        box = self._box(coords_all)
        shards = coords_all.reshape(self.cfg.n_ranks, self.chunk, 3)
        ref_shards = ref.reshape(self.cfg.n_ranks, self.chunk, 3)
        return self.ax.pmax(torch.stack([
            max_displacement2(c, r, box) for c, r in zip(shards, ref_shards)]))

    def _needs_rebuild(self, disp2, overflow):
        half = torch.tensor((0.5 * self.cfg.skin) ** 2, dtype=F32,
                            device=disp2.device)
        return (disp2 > half) | (overflow > 0)

    def _eval_diag(self, st: DDState, st_d: dict, trim_ovf, stats,
                   disp2, f_global) -> dict:
        ax, cfg = self.ax, self.cfg
        overflow = st.overflow + ax.psum(trim_ovf.to(torch.int32))
        total = st.local_count + st.ghost_count
        rank_cost = ax.gather_ranks(st_d["l_mask"].sum(-1).to(torch.int32)
                                    + st_d["g_mask"].sum(-1).to(torch.int32))
        return {"local_count": st.local_count, "ghost_count": st.ghost_count,
                "overflow": overflow, "max_disp2": disp2,
                "cost_max": st.cost_max, "rank_cost": rank_cost,
                "rank_nonfinite": self._rank_nonfinite(f_global),
                **self._occupancy_diag(stats),
                # max/mean per-rank Eq.-8 cost: the load-imbalance figure
                "cost_ratio": st.cost_max * cfg.n_ranks
                              / torch.clamp_min(total, 1).to(F32),
                "needs_rebuild": self._needs_rebuild(disp2, st.overflow)}

    def build_check_fn(self):
        """Standalone rebuild check: f(coords, state) -> () bool — some atom
        moved more than skin/2 since ``state.ref``, or the build overflowed."""

        def check(coords, st: DDState):
            coords_all = self.ax.all_gather(self._shard(coords))
            return self._needs_rebuild(self._disp2(coords_all, st.ref),
                                       st.overflow)

        return check

    def build_phase_probes(self) -> dict:
        """Prefix probes attributing the fused force function's cost to its
        stages: a walk over ``self.stages``, probe *k* running the pipeline
        through stage *k* and returning that stage's per-rank probe values
        (G,), so successive wall-time differences
        (:func:`repro_torch.obs.timed_prefix_phases`) measure the paper's
        Fig. 12 shares.  The last entry IS :meth:`build_force_fn`."""
        self._require_model("build_phase_probes")
        probes = {}
        for i, stage in enumerate(self.stages):
            if stage.probe is None:
                continue
            prefix = self.stages[: i + 1]

            def fn(params, coords, types, _prefix=prefix, _stage=stage):
                shards, types_p = self._shard(coords, types)
                ctx = {"params": params, "coords_shard": shards,
                       "types_all": types_p}
                for s in _prefix:
                    s.body(ctx)
                return _stage.probe(ctx)

            probes[stage.name] = fn
        probes[self.stages[-1].name] = self.build_force_fn()
        return probes
