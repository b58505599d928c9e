"""End-to-end run (the paper's production scenario): DP-aided MD of a
solvated protein, the DP group evaluated through the domain decomposition.

Port of ``examples/protein_md.py``: every MD step performs one distributed
DP evaluation over ``--ranks`` ranks, virtual ranks of one device, or,
under ``torchrun`` (or with ``--backend``), shared out over the processes
of a ``torch.distributed`` group (``launch.mesh.make_dd_mesh``: NCCL and
one card a process by default, gloo with ``--backend gloo``), as the
reference runs them on ``make_dd_mesh(ranks)``.

    python -m repro_torch.launch.protein_md --ranks 8 --steps 30
    python -m repro_torch.launch.protein_md --device cpu --residues 5
    torchrun --nproc-per-node 4 -m repro_torch.launch.protein_md --ranks 8
    torchrun --nproc-per-node 4 -m repro_torch.launch.protein_md \
        --device cpu --backend gloo --residues 5
(run with ``src`` on ``PYTHONPATH``)

Prints E_dp, the temperature and the gyration radii of the DP group at
every fifth step, with the decomposition's ghost count and overflow flag
(process 0 prints; every process holds the same trajectory).
Weights are random, from a seeded ``torch.Generator``.  ``--ckpt-dir DIR``
checkpoints the state to DIR every 10 steps (``checkpoint_path``, as the
reference's example; over W > 1 processes each writes its own
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

from ..core import DeepmdForceProvider, suggest_config
from ..device import resolve_device
from ..dp import DPModel, paper_dpa1_config
from ..md import EngineConfig, MDEngine, build_solvated_protein, mark_nn_group
from ..md.observables import gyration_radii_axes
from .mesh import make_dd_mesh

GROUP_TIMEOUT_S = 60      # a rendezvous or collective waits no longer


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--residues", type=int, default=16)
    ap.add_argument("--force-mode", default="owner_full",
                    choices=["owner_full", "ghost_reduce"])
    ap.add_argument("--nbr-method", default="cells", choices=["cells", "dense"],
                    help="subdomain assembly: cell list (linear) or dense oracle")
    ap.add_argument("--balanced", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="run the ranks over a process group (default "
                         "under torchrun: nccl on cuda, gloo on cpu; gloo "
                         "on cuda lets processes share a card)")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def start_group(args):
    """When the run is distributed (``args.backend`` given or under
    ``torchrun``): the backend (``args.backend``, else the device's), and
    whether this call started the default group (from the environment,
    unless the caller started one); else None."""
    if args.backend is None and "WORLD_SIZE" not in os.environ:
        return None
    backend = args.backend or ("nccl" if torch.device(args.device).type
                               == "cuda" else "gloo")
    started = not dist.is_initialized()
    if started:
        dist.init_process_group(
            backend, init_method="env://",
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return backend, started


def _dd_mesh(args):
    """The process mesh when the run is distributed, else None; returns
    (mesh, whether this call started the group)."""
    group = start_group(args)
    if group is None:
        return None, False
    backend, started = group
    return make_dd_mesh(args.ranks, device=args.device,
                        backend=backend), started


def main(argv=None, quiet: bool = False):
    """Run the MD entry point; returns (final MDState, engine)."""
    args = parse_args(argv)
    mesh, started = _dd_mesh(args)
    try:
        return _run(args, mesh, quiet)
    finally:
        if started:
            dist.destroy_process_group()


def _run(args, mesh, quiet: bool):
    dev = resolve_device(args.device) if mesh is None else mesh.device
    say = (lambda *a: None) if quiet or (mesh and mesh.index) else print
    system, positions, nn_idx = build_solvated_protein(args.residues,
                                                       device=dev)
    system = mark_nn_group(system, nn_idx)
    where = (f"virtual ranks on {dev}" if mesh is None else
             f"ranks over {mesh.world} {mesh.backend} processes "
             f"({mesh.ranks_per_process} each, on {dev})")
    say(f"{system.n_atoms} atoms, DP group {len(nn_idx)}, {args.ranks} "
        f"{where}, force_mode={args.force_mode}")

    model = DPModel(paper_dpa1_config(ntypes=4, rcut=0.6, sel=32), device=dev)
    params = model.init_params(torch.Generator().manual_seed(args.seed))
    box = system.box.cpu().numpy()
    dd = suggest_config(len(nn_idx), box, args.ranks, 0.6, nbr_capacity=48,
                        slack=2.5, balanced=args.balanced,
                        force_mode=args.force_mode,
                        nbr_method=args.nbr_method,
                        coords=positions.cpu().numpy()[nn_idx])
    say(f"DD grid {dd.grid_dims}, halo {dd.halo:.2f} nm, "
        f"capacities local={dd.local_capacity} ghost={dd.ghost_capacity}, "
        f"assembly={dd.nbr_method}")

    provider = DeepmdForceProvider(model, params, nn_idx, system.types, box,
                                   system.n_atoms, dd_config=dd, mesh=mesh,
                                   device=dev)
    ckpt = args.ckpt_dir
    if ckpt and mesh is not None and mesh.world > 1:
        ckpt = os.path.join(ckpt, f"process{mesh.index}")
    eng = MDEngine(system,
                   EngineConfig(cutoff=0.9, neighbor_capacity=96, dt=0.0005,
                                thermostat_t=200.0,
                                checkpoint_every=10 if ckpt else 0,
                                checkpoint_path=ckpt),
                   special_force=provider)
    state = eng.init_state(positions, 200.0)
    if ckpt and os.path.exists(os.path.join(ckpt, "manifest.json")):
        state = MDEngine.restore(ckpt, device=dev)
        say(f"[restore] resumed from step {int(state.step)}")
    sel = system.nn_mask

    def observe(s, obs):
        rg = gyration_radii_axes(s.positions, system.masses, sel)
        diag = provider.last_diag
        extra = ""
        if diag is not None:
            extra = (f" ghosts={int(diag['ghost_count'])}"
                     f" overflow={int(diag['overflow'])}")
        say(f"  step {obs['step']:4d} E_dp {obs['e_special']:9.3f} "
            f"T {obs['temperature']:5.1f}K Rg {np.round(rg.cpu().numpy(), 3)}"
            f"{extra}")

    state = eng.run(state, args.steps, observe=observe, observe_every=5)
    say("final positions finite:", bool(torch.isfinite(state.positions).all()))
    return state, eng


if __name__ == "__main__":
    main()
