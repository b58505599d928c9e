"""One process of ``tests/test_torch_ensemble_procs.py``'s gloo group on
the CPU.

    python tests/ensemble_procs_worker.py TASK RANK

``TASK`` is a ``torch.save``d dict written by the test (world size,
rendezvous file, model, params, the replicas' positions, configurations);
the process joins the group through ``file://`` rendezvous, builds the
2-D ``(replica x dd)`` mesh (``ensemble.make_ensemble_mesh``), runs the
replica-batched force path over it (``ForcePipeline(n_replicas=R,
mesh=...)``, ``BatchedDeepmdProvider`` inside ``EnsembleEngine``,
``launch.remd``) and saves what it computed to ``TASK.out<RANK>`` for the
test to hold against the virtual path.  Imports no JAX.
"""
import dataclasses
import datetime
import sys

import torch
import torch.distributed as dist

from repro_torch.core import DeepmdForceProvider, ForcePipeline
from repro_torch.core import ddinfer as tdd
from repro_torch.core import pipeline as tpipe
from repro_torch.dp import DPModel
from repro_torch.ensemble import (BatchedDeepmdProvider, EnsembleConfig,
                                  EnsembleEngine, make_ensemble_mesh)
from repro_torch.health import FaultPlan, FaultSpec, GuardConfig
from repro_torch.launch import remd
from repro_torch.md import EngineConfig

SHARDS, RANKS = 2, 4


def _error(fn) -> str:
    """The message of the error ``fn()`` raises ("" if none)."""
    try:
        fn()
    except (ValueError, RuntimeError) as exc:
        return str(exc)
    return ""


def force_path(task, model, params, mesh) -> dict:
    """The pipeline's entry functions on all R replicas, per configuration
    (stale/fresh in the configurations ``task["extra"]`` names; the phase
    probes, the overlap evaluate and the ``make_batched_force_fn`` shim in
    its first)."""
    x, t = torch.tensor(task["pos"]), torch.tensor(task["types"])
    drift, frozen = torch.tensor(task["drift"]), torch.tensor(task["frozen"])
    far = torch.tensor(task["far"])
    r = len(x)
    out = {}
    for mode, cfg in task["cfgs"].items():
        pipe = ForcePipeline(model, cfg, task["box"], x.shape[1],
                             n_replicas=r, mesh=mesh)
        asm, ev = pipe.build_assembly_fn(), pipe.build_evaluation_fn()
        check = pipe.build_check_fn()
        st = asm(x, t)
        res = {"fused": pipe.build_force_fn()(params, x, t), "state": st,
               "eval": ev(params, drift, st),
               "check": (check(drift, st), check(far, st))}
        if mode in task["extra"]:
            res["stale"] = ev(params, frozen, st)
            res["fresh"] = ev(params, frozen, asm(frozen, t))
        if mode == task["extra"][0]:
            res["probes"] = {k: f(params, x, t) for k, f in
                             pipe.build_phase_probes().items()
                             if k != "force_reduce"}
            over = ForcePipeline(model, dataclasses.replace(cfg, overlap=True),
                                 task["box"], x.shape[1], n_replicas=r,
                                 mesh=mesh)
            res["overlap"] = over.build_evaluation_fn()(params, drift, st)
            res["shim"] = tdd.make_batched_force_fn(
                model, cfg, mesh, task["box"], x.shape[1], r)(params, x, t)
        out[mode] = res
    return out


def gather_order(mesh) -> tuple:
    """The replica gather on values naming each resident replica (Rl = 2):
    its global index, and the process that holds it."""
    rl = 2
    rep = mesh.replica_index * rl + torch.arange(rl, dtype=torch.float32)
    vals = torch.stack([rep, torch.full_like(rep, mesh.index)], 1)
    return tpipe._gather_replicas(mesh, (vals, rep.to(torch.int32)))


def hook_fault(task, model, params, mesh) -> dict:
    """A ``nan_force`` aimed at (replica 3, rank 2) through the fault hook
    on one evaluation: what the hook saw and returned here, and the
    evaluation's diagnostics."""
    x, t = torch.tensor(task["pos"]), torch.tensor(task["types"])
    plan = FaultPlan([FaultSpec("nan_force", step=0, rank=2, replica=3)])
    plan.faults[0].armed = True          # the engine arms it in a run
    inner = plan.pipeline_hook()
    seen = {}

    def hook(rank, rep0, e, f):
        e, f = inner(rank, rep0, e, f)
        seen["ranks"] = rank.clone()
        seen["rep0"] = rep0
        seen["nonfinite"] = (~torch.isfinite(f)).flatten(2).sum(2)
        return e, f

    cfg = task["cfgs"]["ghost_reduce-all_reduce"]
    pipe = ForcePipeline(model, cfg, task["box"], x.shape[1], fault_hook=hook,
                         n_replicas=len(x), mesh=mesh)
    st = pipe.build_assembly_fn()(x, t)
    e, f, diag = pipe.build_evaluation_fn()(params, x, st)
    return {"hook": seen, "rank_nonfinite": diag["rank_nonfinite"],
            "finite": torch.isfinite(f).flatten(1).all(1)}


def ensemble_run(task, model, params, mesh, exchange, guard=False,
                 fault=None) -> dict:
    """``task["md_steps"]`` steps of ``EnsembleEngine`` with the batched
    provider over ``mesh``: positions and ladder after every step, the
    exchange statistics and the engine's counts."""
    system, pos, nn = task["md_system"]
    plan = FaultPlan([FaultSpec("nan_force", **fault)] if fault else [])
    prov = BatchedDeepmdProvider(
        model, params, nn, system.types, system.box, system.n_atoms,
        n_replicas=len(task["temps"]), dd_config=task["md_cfg"], mesh=mesh,
        device="cpu", fault_hook=plan.pipeline_hook() if fault else None)
    eng = EnsembleEngine(
        system, EngineConfig(**task["md_engine"]),
        EnsembleConfig(n_replicas=len(task["temps"]), temps=task["temps"],
                       exchange_interval=exchange),
        special_force=prov, guard=GuardConfig(enabled=guard),
        faults=plan if fault else None)
    traj, ladders = [], []

    def observe(s, obs):
        traj.append(s.positions.clone())
        ladders.append(s.ladder.clone())

    state = eng.run(eng.init_state(pos), task["md_steps"], observe=observe,
                    observe_every=1)
    d = eng.diagnostics
    return {"traj": traj, "ladders": ladders, "final": state,
            "fired": bool(plan.faults[0].fired) if fault else None,
            "diagnostics": {k: (v.tolist() if hasattr(v, "tolist") else v)
                            for k, v in d.items() if k in (
                                "exchange_attempts", "exchange_accepts",
                                "pair_attempts", "pair_accepts",
                                "replica_guard_trips", "special_rebuilds",
                                "displacement_rebuilds", "window_reruns",
                                "special_growths")}}


def refusals(task, model, params, mesh) -> dict:
    x = task["pos"]
    cfg = task["cfgs"]["owner_full-all_reduce"]
    system, _, nn = task["md_system"]
    return {
        "shards": _error(lambda: make_ensemble_mesh(3, RANKS, device="cpu")),
        "n_dd": _error(lambda: make_ensemble_mesh(SHARDS, 3, device="cpu")),
        "nccl": _error(lambda: make_ensemble_mesh(SHARDS, RANKS,
                                                  device="cuda",
                                                  backend="nccl")),
        "cuda": _error(lambda: make_ensemble_mesh(SHARDS, RANKS,
                                                  device="cuda",
                                                  backend="gloo")),
        "n_replicas": _error(lambda: ForcePipeline(
            model, cfg, task["box"], x.shape[1], n_replicas=3, mesh=mesh)),
        "unbatched": _error(lambda: ForcePipeline(
            model, cfg, task["box"], x.shape[1], mesh=mesh)),
        "dd_size": _error(lambda: ForcePipeline(
            model, task["cfg8"], task["box"], x.shape[1], n_replicas=4,
            mesh=mesh)),
        "provider": _error(lambda: DeepmdForceProvider(
            model, params, nn, system.types, system.box, system.n_atoms,
            dd_config=task["md_cfg"], mesh=mesh, device="cpu"))}


def main(task_path: str, rank: int) -> None:
    torch.set_num_threads(1)
    task = torch.load(task_path, weights_only=False)
    timeout = datetime.timedelta(seconds=task["timeout_s"])
    dist.init_process_group(
        "gloo", init_method=f"file://{task['rendezvous']}", rank=rank,
        world_size=task["world"], timeout=timeout)
    try:
        model = DPModel(task["model_cfg"], device="cpu")
        params = task["params"]
        mesh = make_ensemble_mesh(SHARDS, RANKS, device="cpu",
                                  timeout=timeout)
        out = {"mesh": (mesh.world, mesh.index, mesh.replica_index,
                        mesh.dd.index, mesh.dd.world, mesh.shape,
                        str(mesh.device), mesh.backend),
               "force_path": force_path(task, model, params, mesh),
               "gather_order": gather_order(mesh),
               "hook_fault": hook_fault(task, model, params, mesh),
               "remd": ensemble_run(task, model, params, mesh,
                                    task["exchange"]),
               "independent": ensemble_run(task, model, params, mesh, 0),
               "guarded": ensemble_run(task, model, params, mesh, 0,
                                       guard=True),
               "faulted": ensemble_run(task, model, params, mesh, 0,
                                       guard=True, fault=task["fault"]),
               "errors": refusals(task, model, params, mesh)}
        state, eng = remd.main(
            ["--device", "cpu", "--backend", "gloo", "--replica-shards",
             str(SHARDS), "--ranks", str(RANKS), "--replicas", "4",
             "--residues", "4", "--steps", str(task["launcher_steps"]),
             "--exchange-interval", "1"], quiet=True)
        out["launcher"] = {"state": state,
                           "accepts": eng.diagnostics["exchange_accepts"],
                           "attempts": eng.diagnostics["exchange_attempts"]}
        torch.save(out, f"{task_path}.out{rank}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
