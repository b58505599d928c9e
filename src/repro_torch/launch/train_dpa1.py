"""Train the paper's DPA-1 on solvated-fragment data (paper Sec. IV-B):
energy+force loss, exponential learning-rate decay, DeePMD's prefactor
schedule, asynchronous checkpoints, force-RMSE logging (the Fig. 7 curves).

Port of ``examples/train_dpa1.py``, with the same flags and ``--device``:

    python -m repro_torch.launch.train_dpa1                 # the card
    python -m repro_torch.launch.train_dpa1 --device cpu --steps 3
(run with ``src`` on ``PYTHONPATH``)

The data are the analytic oracle's (``repro_torch.data.make_dataset``,
seed 0); the weights start from a seeded ``torch.Generator``.  With
``--ckpt-dir DIR`` the run checkpoints to DIR and, when DIR already holds
a checkpoint, resumes from it.
"""
from __future__ import annotations

import argparse

import torch

from ..data import make_dataset
from ..device import resolve_device
from ..dp import DPModel, TrainConfig, fit_env_stats, paper_dpa1_config, train
from ..dp.networks import count_params


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--frames", type=int, default=128)
    ap.add_argument("--atoms", type=int, default=32)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)

    print("generating oracle-labelled dataset...")
    data = make_dataset(args.frames, n_atoms=args.atoms, seed=0, device=dev)
    train_set, valid_set = data.split(0.15)
    print(f"  {train_set.n_frames} train / {valid_set.n_frames} valid frames,"
          f" {data.n_atoms} atoms each")

    cfg = paper_dpa1_config(ntypes=4, rcut=0.6, sel=24)
    model = DPModel(cfg, fit_env_stats(cfg, train_set, device=dev), device=dev)
    n_params = count_params(model.init_params(torch.Generator().manual_seed(0)))
    print(f"DPA-1 parameters: {n_params / 1e6:.2f}M (paper: 1.6M)")

    params, history = train(
        model, train_set, valid_set,
        TrainConfig(n_steps=args.steps, eval_every=max(args.steps // 10, 1),
                    batch_size=8, lr0=2e-3, checkpoint_dir=args.ckpt_dir),
        log=lambda rec: print(
            f"  step {rec['step']:5d} loss {rec['loss']:.3e} "
            f"rmse_f train {rec['rmse_f_train']:.3f} "
            f"valid {rec['rmse_f_valid']:.3f} lr {rec['lr']:.2e}"))
    print("final force RMSE (valid):", history[-1]["rmse_f_valid"])
    return params, history


if __name__ == "__main__":
    main()
