"""LM training driver of the port (``repro/launch/train.py``).

Fault tolerance: async checkpoints every ``--ckpt-every`` steps, a
deterministic data order keyed to the global step (restart-safe), and an
automatic restore from the newest verified checkpoint at startup.
``--simulate-failure N`` kills the process at step N (exit 42) to exercise
the restart path (``launch/elastic.py`` is the supervisor).

Usage:
  python -m repro_torch.launch.train --reduced --device cpu --steps 12
  python -m repro_torch.launch.train --reduced --device cpu --steps 12 \\
      --ckpt-dir /tmp/ck --ckpt-every 4 --simulate-failure 6   # exits 42
  python -m repro_torch.launch.train --arch qwen2-1.5b --batch 4 --seq 2048

Weights are random, from the port's initialiser (a ``torch.Generator``
seeded 0 on the training device); the step's batch is drawn from
``np.random.default_rng((1234, step))``, as the reference draws it, with
the context stub (N(0, 1) frame or patch embeddings) for the
architectures that cross-attend.  The step is ``lm.train_lib``'s with
``TrainHParams``' defaults (``remat="full"``: the same bits as ``"none"``,
and the memory a full-width model needs) and the given ``--lr`` and
``--optimizer``.  ``main(argv)`` returns the last step's metrics as
floats, so tests call it in-process.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def make_batch(cfg, step: int, batch: int, seq: int, device) -> dict:
    """The batch of global step ``step``: token ids (and labels shifted by
    one) from ``np.random.default_rng((1234, step))``, then the context
    stub from the same generator where the architecture cross-attends."""
    from ..data.loader import synthetic_token_batch
    rng = np.random.default_rng((1234, step))
    out = synthetic_token_batch(rng, batch, seq, cfg.vocab, device=device)
    if cfg.enc_dec or cfg.cross_attn_every:
        t = cfg.n_audio_frames if cfg.enc_dec else cfg.n_image_tokens
        out["context"] = torch.tensor(
            rng.normal(0, 1, (batch, t, cfg.d_model)), dtype=torch.float32,
            device=device)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adam")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--simulate-failure", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--n-layers", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from ..ckpt import AsyncCheckpointer
    from ..configs import get_arch
    from ..device import resolve_device
    from ..lm import model as M
    from ..lm import train_lib

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced(n_layers=args.n_layers, d_model=args.d_model,
                          d_ff=2 * args.d_model, vocab=512)
    hp = train_lib.TrainHParams(lr=args.lr, optimizer=args.optimizer)

    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    step_fn, opt = train_lib.make_train_step(cfg, hp)
    opt_state = opt.init(params)

    ckpt = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ckpt is not None:
        restored, s = ckpt.restore_latest({"params": params, "opt": opt_state})
        if restored is not None:
            params, opt_state = restored["params"], restored["opt"]
            start = s + 1
            print(f"[restore] resumed from step {s}")

    metrics = {}
    t0 = time.time()
    for step in range(start, args.steps):
        batch = make_batch(cfg, step, args.batch, args.seq, dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.2f} "
                  f"({(time.time() - t0):.1f}s)", flush=True)
        if ckpt is not None and step and step % args.ckpt_every == 0:
            ckpt.save({"params": params, "opt": opt_state}, step)
        if args.simulate_failure and step == args.simulate_failure:
            print(f"[failure-injection] dying at step {step}", flush=True)
            if ckpt is not None:   # as the interpreter's exit would: the
                ckpt.wait()        # writer is no daemon (also in-process)
            raise SystemExit(42)
    if ckpt is not None:
        ckpt.save({"params": params, "opt": opt_state}, args.steps - 1)
        ckpt.wait()
    print("done")
    return {k: float(v) for k, v in metrics.items()}


if __name__ == "__main__":
    main()
