"""Serving entry point of the port (``repro/launch/serve.py``): LM token
serving, batched prefill plus greedy decode, for the attention/dense-MLP
architectures of the :mod:`repro_torch.configs` registry.

Usage:
  python -m repro_torch.launch.serve                       # gemma2-2b, card
  python -m repro_torch.launch.serve --reduced --device cpu --batch 2 --new 8

Weights are random, from the port's initialiser (``--seed``); the prompts
are token ids drawn from the same seed, so no tokenizer or checkpoint is
needed.  ``--backend force`` (the DP force server) is not ported yet
(ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

FORCE_ARCHS = ("dpa1", "dpa1-md", "dp")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_tokens(cfg, params, tokens, new: int) -> dict:
    """Prefill ``tokens`` (B, S) into a cache of length S + new, then greedy
    decode: ``new`` tokens per sequence, the first from the prefill's last
    logits, each further one from a decode step.  Returns the tokens
    (B, new), every step's logits [(B, V)] (the prefill's first), the cache
    and the host-clock seconds of the prefill and of the decode steps."""
    from ..lm.serve_lib import make_prefill, make_serve_step
    b, s = tokens.shape
    prefill = make_prefill(cfg, max_len=s + new)
    serve = make_serve_step(cfg)
    dev = tokens.device
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, tokens)
    tok = logits[:, -1:].argmax(-1)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    out, step_logits = [tok], [logits[:, -1]]
    t0 = time.perf_counter()
    for i in range(new - 1):
        logits, cache = serve(params, cache, tok, s + i)
        tok = logits.argmax(-1)
        out.append(tok)
        step_logits.append(logits[:, -1])
    _sync(dev)
    return {"tokens": torch.cat(out, 1), "logits": step_logits,
            "cache": cache, "prefill_s": prefill_s,
            "decode_s": time.perf_counter() - t0}


def main_lm(args):
    from ..configs import get_arch
    from ..device import resolve_device
    from ..lm import model as M

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = M.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    rng = np.random.default_rng(args.seed)
    tokens = torch.tensor(rng.integers(0, cfg.vocab, (args.batch,
                                                      args.prompt_len)),
                          device=dev)
    res = serve_tokens(cfg, params, tokens, args.new)
    steps = args.new - 1
    print(f"prefill {args.batch}x{args.prompt_len} in {res['prefill_s']:.2f}s")
    print(f"decoded {steps} steps in {res['decode_s']:.2f}s "
          f"({steps * args.batch / max(res['decode_s'], 1e-9):.1f} tok/s)")
    print("greedy tokens (batch 0):", res["tokens"][0, :16].tolist())
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "lm", "force"),
                    help="what to serve: LM tokens or DP forces "
                    "(auto resolves from --arch)")
    ap.add_argument("--arch", default="gemma2-2b",
                    help="LM arch id (the DP presets "
                    f"{'/'.join(FORCE_ARCHS)} select force serving)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    backend = args.backend
    if backend == "auto":
        backend = "force" if args.arch in FORCE_ARCHS else "lm"
    if backend == "force":
        raise NotImplementedError(
            "force serving is not ported yet (ROADMAP Queue 1 item 10)")
    return main_lm(args)


if __name__ == "__main__":
    main()
