"""End-to-end run (the paper's production scenario): DP-aided MD of a
solvated protein, the DP group evaluated through the virtual domain
decomposition on one device.

Port of ``examples/protein_md.py``: every MD step performs one distributed
DP evaluation over ``--ranks`` virtual ranks.

    python -m repro_torch.launch.protein_md --ranks 8 --steps 30
    python -m repro_torch.launch.protein_md --device cpu --residues 5
(run with ``src`` on ``PYTHONPATH``)

Prints E_dp, the temperature and the gyration radii of the DP group at
every fifth step, with the decomposition's ghost count and overflow flag.
Weights are random, from a seeded ``torch.Generator``.  ``--ckpt-dir DIR``
checkpoints the state to DIR every 10 steps (``checkpoint_path``, as the
reference's example); when DIR already holds a checkpoint the run resumes
from it and runs ``--steps`` more steps.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..core import DeepmdForceProvider, suggest_config
from ..device import resolve_device
from ..dp import DPModel, paper_dpa1_config
from ..md import EngineConfig, MDEngine, build_solvated_protein, mark_nn_group
from ..md.observables import gyration_radii_axes


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
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None, quiet: bool = False):
    """Run the MD entry point; returns (final MDState, engine)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    say = (lambda *a: None) if quiet else print
    system, positions, nn_idx = build_solvated_protein(args.residues,
                                                       device=dev)
    system = mark_nn_group(system, nn_idx)
    say(f"{system.n_atoms} atoms, DP group {len(nn_idx)}, {args.ranks} "
        f"virtual ranks on {dev}, force_mode={args.force_mode}")

    model = DPModel(paper_dpa1_config(ntypes=4, rcut=0.6, sel=32), device=dev)
    params = model.init_params(torch.Generator().manual_seed(args.seed))
    box = system.box.cpu().numpy()
    dd = suggest_config(len(nn_idx), box, args.ranks, 0.6, nbr_capacity=48,
                        slack=2.5, balanced=args.balanced,
                        force_mode=args.force_mode,
                        nbr_method=args.nbr_method,
                        coords=positions.cpu().numpy()[nn_idx])
    say(f"virtual DD grid {dd.grid_dims}, halo {dd.halo:.2f} nm, "
        f"capacities local={dd.local_capacity} ghost={dd.ghost_capacity}, "
        f"assembly={dd.nbr_method}")

    provider = DeepmdForceProvider(model, params, nn_idx, system.types, box,
                                   system.n_atoms, dd_config=dd, device=dev)
    eng = MDEngine(system,
                   EngineConfig(cutoff=0.9, neighbor_capacity=96, dt=0.0005,
                                thermostat_t=200.0,
                                checkpoint_every=10 if args.ckpt_dir else 0,
                                checkpoint_path=args.ckpt_dir),
                   special_force=provider)
    state = eng.init_state(positions, 200.0)
    if args.ckpt_dir and os.path.exists(os.path.join(args.ckpt_dir,
                                                     "manifest.json")):
        state = MDEngine.restore(args.ckpt_dir, device=dev)
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
