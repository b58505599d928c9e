"""Replica-exchange MD (parallel tempering) over the ensemble subsystem.

Port of ``examples/remd.py``: R replicas of a solvated protein run as one
batched program on one device — classical forces, DP inference and the
integrator all carry a leading replica axis — with a temperature-ladder
Metropolis exchange at window boundaries.  With ``--ranks`` > 1 the DP
force path also runs the virtual domain decomposition, R x ranks virtual
(replica, rank) buffers in one model call.  Under ``torchrun`` (or with
``--backend``) the replicas and ranks run over the processes of a
``torch.distributed`` group instead, on the 2-D layout of
``ensemble.make_ensemble_mesh(--replica-shards, --ranks)``: NCCL and one
card a process by default, gloo with ``--backend gloo``.

    python -m repro_torch.launch.remd --replicas 4 --steps 40 --exchange-interval 5
    python -m repro_torch.launch.remd --replicas 2 --ranks 4 --temp-ladder 280,340
    python -m repro_torch.launch.remd --device cpu --residues 4 --steps 10
    torchrun --nproc-per-node 4 -m repro_torch.launch.remd --replica-shards 2 --ranks 4
    torchrun --nproc-per-node 4 -m repro_torch.launch.remd --device cpu \
        --backend gloo --replica-shards 2 --ranks 4
(run with ``src`` on ``PYTHONPATH``)

Prints the ladder, the per-replica temperatures and DP energies at every
exchange window, and the acceptance statistics (process 0 prints; every
process holds the same ensemble).  Weights are random, from a seeded
``torch.Generator``.  ``--ckpt-dir DIR`` checkpoints the ensemble to DIR
every 10 steps (over W > 1 processes each writes its own
``DIR/process<p>``); when DIR already holds a checkpoint the run resumes
from it and runs ``--steps`` more steps.
"""
from __future__ import annotations

import argparse
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..core import suggest_config
from ..device import resolve_device
from ..dp import DPModel, paper_dpa1_config
from ..md import EngineConfig, build_solvated_protein, mark_nn_group
from ..ensemble import (BatchedDeepmdProvider, EnsembleConfig,
                        EnsembleEngine, geometric_ladder, make_ensemble_mesh)
from .protein_md import GROUP_TIMEOUT_S, start_group


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--replicas", type=int, default=4,
                    help="replica count R (the new scaling dimension)")
    ap.add_argument("--exchange-interval", type=int, default=5,
                    help="steps between exchange attempts; 0 disables REMD")
    ap.add_argument("--temp-ladder", default=None,
                    help="comma-separated ladder (len R), e.g. "
                         "300,330,365,400; default: geometric between "
                         "--tmin and --tmax")
    ap.add_argument("--tmin", type=float, default=300.0)
    ap.add_argument("--tmax", type=float, default=420.0)
    ap.add_argument("--ranks", type=int, default=1,
                    help="dd ranks per replica (1 = one domain on one "
                         "device; over processes, a multiple of the "
                         "processes on the dd axis)")
    ap.add_argument("--replica-shards", type=int, default=1,
                    help="over processes: the replica axis of the 2-D "
                         "(replica x dd) layout (the world size must be a "
                         "multiple of it; --replicas too)")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="run over a process group (default under "
                         "torchrun: nccl on cuda, gloo on cpu; gloo on "
                         "cuda lets processes share a card)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--residues", type=int, default=12)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def _ensemble_mesh(args):
    """The 2-D process mesh when the run is distributed (``--backend``
    given or under ``torchrun``), else None; returns (mesh, whether this
    call started the group)."""
    group = start_group(args)
    if group is None:
        return None, False
    backend, started = group
    return make_ensemble_mesh(
        args.replica_shards, args.ranks, device=args.device, backend=backend,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S)), started


def main(argv=None, quiet: bool = False):
    """Run the REMD entry point; returns (final ReplicaState, engine)."""
    args = parse_args(argv)
    mesh, started = _ensemble_mesh(args)
    try:
        return _run(args, mesh, quiet)
    finally:
        if started:
            dist.destroy_process_group()


def _run(args, mesh, quiet: bool):
    dev = resolve_device(args.device) if mesh is None else mesh.device
    say = (lambda *a: None) if quiet or (mesh and mesh.index) else print
    r = args.replicas
    temps = (tuple(float(t) for t in args.temp_ladder.split(","))
             if args.temp_ladder else geometric_ladder(args.tmin, args.tmax, r))
    if len(temps) != r:
        raise SystemExit(f"--temp-ladder has {len(temps)} rungs for "
                         f"{r} replicas")
    system, positions, nn_idx = build_solvated_protein(args.residues,
                                                       device=dev)
    system = mark_nn_group(system, nn_idx)
    say(f"{system.n_atoms} atoms, DP group {len(nn_idx)}, R={r} replicas "
        f"on {dev}, ladder {tuple(round(t, 1) for t in temps)} K, exchange "
        f"every {args.exchange_interval or 'never'} steps")

    model = DPModel(paper_dpa1_config(ntypes=4, rcut=0.6, sel=32), device=dev)
    params = model.init_params(torch.Generator().manual_seed(args.seed))
    box = system.box.cpu().numpy()
    dd = None
    if args.ranks > 1 or mesh is not None:
        dd = suggest_config(len(nn_idx), box, args.ranks, 0.6,
                            nbr_capacity=48, slack=2.5,
                            force_mode="ghost_reduce",
                            coords=positions.cpu().numpy()[nn_idx])
        where = ("virtually" if mesh is None else
                 f"over {mesh.world} {mesh.backend} processes as "
                 f"{mesh.shape}")
        say(f"(replica={r} x dd={args.ranks}) {where}, grid "
            f"{dd.grid_dims}")
    provider = BatchedDeepmdProvider(model, params, nn_idx, system.types,
                                     box, system.n_atoms, n_replicas=r,
                                     dd_config=dd, mesh=mesh, nbr_capacity=48,
                                     skin=0.0 if dd is not None else 0.08,
                                     device=dev)
    ckpt = args.ckpt_dir
    if ckpt and mesh is not None and mesh.world > 1:
        ckpt = os.path.join(ckpt, f"process{mesh.index}")
    ens = EnsembleConfig(n_replicas=r, temps=temps,
                         exchange_interval=args.exchange_interval)
    eng = EnsembleEngine(system,
                         EngineConfig(cutoff=0.9, neighbor_capacity=96,
                                      dt=0.0005, thermostat_t=temps[0],
                                      checkpoint_every=10 if ckpt else 0,
                                      checkpoint_path=ckpt),
                         ens, special_force=provider)
    state = eng.init_state(positions)
    if ckpt and os.path.exists(os.path.join(ckpt, "manifest.json")):
        state = EnsembleEngine.restore(ckpt, device=dev)
        say(f"[restore] resumed from step {int(state.step[0])}")

    def observe(s, obs):
        t = ", ".join(f"{x:5.1f}" for x in obs["temperature"])
        say(f"  step {obs['step']:4d} ladder {obs['ladder'].tolist()} "
            f"T [{t}] K  E_dp {np.round(obs['e_special'], 2).tolist()}")

    state = eng.run(state, args.steps, observe=observe,
                    observe_every=args.exchange_interval or 10)
    d = eng.diagnostics
    if args.exchange_interval:
        rate = d["exchange_accepts"] / max(d["exchange_attempts"], 1)
        say(f"exchange: {d['exchange_accepts']}/{d['exchange_attempts']} "
            f"accepted ({100 * rate:.0f}%), per-pair "
            f"{d['pair_accepts'].tolist()}/{d['pair_attempts'].tolist()}")
    say("final ladder:", state.ladder.tolist(),
        "finite:", bool(torch.isfinite(state.positions).all()))
    return state, eng


if __name__ == "__main__":
    main()
