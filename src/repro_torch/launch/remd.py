"""Replica-exchange MD (parallel tempering) over the ensemble subsystem.

Port of ``examples/remd.py``: R replicas of a solvated protein run as one
batched program on one device — classical forces, DP inference and the
integrator all carry a leading replica axis — with a temperature-ladder
Metropolis exchange at window boundaries.  With ``--ranks`` > 1 the DP
force path also runs the virtual domain decomposition, R x ranks virtual
(replica, rank) buffers in one model call (no device mesh).

    python -m repro_torch.launch.remd --replicas 4 --steps 40 --exchange-interval 5
    python -m repro_torch.launch.remd --replicas 2 --ranks 4 --temp-ladder 280,340
    python -m repro_torch.launch.remd --device cpu --residues 4 --steps 10
(run with ``src`` on ``PYTHONPATH``)

Prints the ladder, the per-replica temperatures and DP energies at every
exchange window, and the acceptance statistics.  Weights are random, from
a seeded ``torch.Generator``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core import suggest_config
from ..device import resolve_device
from ..dp import DPModel, paper_dpa1_config
from ..md import EngineConfig, build_solvated_protein, mark_nn_group
from ..ensemble import (BatchedDeepmdProvider, EnsembleConfig,
                        EnsembleEngine, geometric_ladder)


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
                    help="virtual dd ranks per replica (1 = one domain)")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--residues", type=int, default=12)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None, quiet: bool = False):
    """Run the REMD entry point; returns (final ReplicaState, engine)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    say = (lambda *a: None) if quiet else print
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
    if args.ranks > 1:
        dd = suggest_config(len(nn_idx), box, args.ranks, 0.6,
                            nbr_capacity=48, slack=2.5,
                            force_mode="ghost_reduce",
                            coords=positions.cpu().numpy()[nn_idx])
        say(f"virtual (replica={r} x dd={args.ranks}) layout, grid "
            f"{dd.grid_dims}")
    provider = BatchedDeepmdProvider(model, params, nn_idx, system.types,
                                     box, system.n_atoms, n_replicas=r,
                                     dd_config=dd, nbr_capacity=48,
                                     skin=0.0 if dd is not None else 0.08,
                                     device=dev)
    ens = EnsembleConfig(n_replicas=r, temps=temps,
                         exchange_interval=args.exchange_interval)
    eng = EnsembleEngine(system,
                         EngineConfig(cutoff=0.9, neighbor_capacity=96,
                                      dt=0.0005, thermostat_t=temps[0]),
                         ens, special_force=provider)

    def observe(s, obs):
        t = ", ".join(f"{x:5.1f}" for x in obs["temperature"])
        say(f"  step {obs['step']:4d} ladder {obs['ladder'].tolist()} "
            f"T [{t}] K  E_dp {np.round(obs['e_special'], 2).tolist()}")

    state = eng.run(eng.init_state(positions), args.steps, observe=observe,
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
