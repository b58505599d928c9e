"""One process of ``tests/test_torch_dd_procs.py``'s gloo group on the CPU.

    python tests/dd_procs_worker.py TASK RANK

``TASK`` is a ``torch.save``d dict written by the test (world size,
rendezvous file, model, params, positions, configurations); the process
joins the group through ``file://`` rendezvous, runs the DD force path
over it (``launch.mesh.make_dd_mesh``, ``ForcePipeline(mesh=...)``, the
provider inside ``MDEngine``, ``launch.protein_md``) and saves what it
computed to ``TASK.out<RANK>`` for the test to hold against the virtual
path.  Imports no JAX.
"""
import dataclasses
import datetime
import sys

import torch
import torch.distributed as dist

from repro_torch.core import DeepmdForceProvider, ForcePipeline
from repro_torch.core import pipeline as tpipe
from repro_torch.dp import DPModel
from repro_torch.health import FaultPlan, FaultSpec
from repro_torch.launch import protein_md
from repro_torch.launch.mesh import make_dd_mesh
from repro_torch.md import EngineConfig, MDEngine

RANKS = 8


def _error(fn) -> str:
    """The message of the ValueError ``fn()`` raises ("" if none)."""
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return ""


def force_path(task, model, params, mesh) -> dict:
    """Every entry function of the pipeline, per configuration."""
    x, t = torch.tensor(task["pos"]), torch.tensor(task["types"])
    drift, frozen = torch.tensor(task["drift"]), torch.tensor(task["frozen"])
    far = torch.tensor(task["far"])
    out = {}
    for mode, cfg in task["cfgs"].items():
        pipe = ForcePipeline(model, cfg, task["box"], len(x), mesh=mesh)
        asm, ev = pipe.build_assembly_fn(), pipe.build_evaluation_fn()
        st = asm(x, t)
        res = {"fused": pipe.build_force_fn()(params, x, t), "state": st,
               "eval": ev(params, drift, st),
               "check": (pipe.build_check_fn()(drift, st),
                         pipe.build_check_fn()(far, st)),
               "stale": ev(params, frozen, st),
               "fresh": ev(params, frozen, asm(frozen, t)),
               "probes": {k: f(params, x, t) for k, f in
                          pipe.build_phase_probes().items()
                          if k != "force_reduce"}}
        if cfg.force_mode == "owner_full":
            over = ForcePipeline(model, dataclasses.replace(cfg, overlap=True),
                                 task["box"], len(x), mesh=mesh)
            res["overlap"] = over.build_evaluation_fn()(params, drift, st)
        out[mode] = res
    return out


def fault(task, model, params, mesh) -> dict:
    """A ``nan_force`` aimed at global rank 5 through the fault hook: what
    the hook saw and returned here, and the evaluation's diagnostics."""
    x, t = torch.tensor(task["pos"]), torch.tensor(task["types"])
    plan = FaultPlan([FaultSpec("nan_force", step=0, rank=5)])
    plan.faults[0].armed = True
    inner = plan.pipeline_hook()
    seen = {}

    def hook(rank, rep0, e, f):
        e, f = inner(rank, rep0, e, f)
        seen["ranks"] = rank.clone()
        seen["nonfinite"] = (~torch.isfinite(f)).flatten(1).sum(1)
        return e, f

    cfg = task["cfgs"]["owner_full-all_reduce"]
    pipe = ForcePipeline(model, cfg, task["box"], len(x), fault_hook=hook,
                         mesh=mesh)
    st = pipe.build_assembly_fn()(x, t)
    e, f, diag = pipe.build_evaluation_fn()(params, x, st)
    return {"hook": seen, "diag": diag,
            "finite": bool(torch.isfinite(f).all())}


def layouts(mesh) -> dict:
    """The process-group collectives on R = 2 replicas: every value names
    its (replica, global rank), so the test sees the order."""
    ops = tpipe._GroupAxisOps(RANKS, mesh, n_rep=2)
    own = torch.arange(ops.first_rank, ops.first_rank + ops.local_ranks)
    rep = torch.arange(2)[:, None]
    ids = (100 * rep + own[None]).to(torch.float32)            # (R, Gl)
    chunk = 3
    shards = ids[..., None, None] + torch.arange(chunk)[:, None] * 0.01
    shards = shards.expand(2, len(own), chunk, 3).contiguous()
    # per-rank full-length arrays: rank g contributes g + 1 to every atom
    full = (own + 1.0)[None, :, None, None].expand(2, len(own),
                                                  RANKS * chunk, 3)
    return {"gather_ranks": ops.gather_ranks(ids.reshape(-1)),
            "all_gather": ops.all_gather(shards),
            "psum": ops.psum(ids.reshape(-1)),
            "pmax": ops.pmax(ids.reshape(-1)),
            "psum_scatter": ops.psum_scatter(full.reshape(-1, RANKS * chunk,
                                                          3)),
            "first_rank": ops.first_rank}


def md_run(task, model, params, mesh) -> dict:
    """MD steps of the provider inside ``MDEngine`` over the
    mesh, from a capacity too small (``k_eval``) for the list: positions at
    every step, the engine's diagnostics."""
    system, pos, nn = task["md_system"]
    prov = DeepmdForceProvider(model, params, nn, system.types, system.box,
                               system.n_atoms, dd_config=task["md_cfg"],
                               mesh=mesh, device="cpu")
    eng = MDEngine(system, EngineConfig(**task["md_engine"]),
                   special_force=prov)
    traj = []
    state = eng.run(eng.init_state(pos, 200.0), task["md_steps"],
                    observe=lambda s, obs: traj.append(s.positions.clone()),
                    observe_every=1)
    return {"traj": traj, "final": state.positions,
            "diagnostics": {k: eng.diagnostics[k] for k in (
                "special_growths", "special_rebuilds", "window_reruns",
                "capacity_growths")},
            "k_eval": prov.dd_config.k_eval}


def main(task_path: str, rank: int) -> None:
    torch.set_num_threads(1)
    task = torch.load(task_path, weights_only=False)
    dist.init_process_group(
        "gloo", init_method=f"file://{task['rendezvous']}", rank=rank,
        world_size=task["world"],
        timeout=datetime.timedelta(seconds=task["timeout_s"]))
    try:
        model = DPModel(task["model_cfg"], device="cpu")
        params = task["params"]
        mesh = make_dd_mesh(RANKS, device="cpu")
        out = {"mesh": (mesh.world, mesh.index, mesh.ranks_per_process,
                        mesh.shape, str(mesh.device), mesh.backend),
               "force_path": force_path(task, model, params, mesh),
               "fault": fault(task, model, params, mesh),
               "layouts": layouts(mesh),
               "md": md_run(task, model, params, mesh),
               "errors": {
                   "n_ranks": _error(lambda: make_dd_mesh(6, device="cpu")),
                   "nccl": _error(lambda: make_dd_mesh(RANKS, device="cuda",
                                                      backend="nccl")),
                   "replicas": _error(lambda: ForcePipeline(
                       model, task["cfgs"]["owner_full-all_reduce"],
                       task["box"], len(task["pos"]), n_replicas=2,
                       mesh=mesh))}}
        state, eng = protein_md.main(
            ["--device", "cpu", "--backend", "gloo", "--residues", "5",
             "--steps", str(task["launcher_steps"])], quiet=True)
        out["launcher"] = {"positions": state.positions,
                           "velocities": state.velocities,
                           "ghosts": eng.special_force.last_diag[
                               "ghost_count"]}
        torch.save(out, f"{task_path}.out{rank}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
