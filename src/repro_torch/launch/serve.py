"""Serving entry point of the port (``repro/launch/serve.py``): LM token
serving, batched prefill plus greedy decode, for every architecture of the
:mod:`repro_torch.configs` registry (whisper and the vision model with the
reference's context stub: frame or patch embeddings drawn from ``--seed``),
and DP force serving (``--backend force``): a
:class:`repro_torch.serve.ForceServer` with ``--clients`` MD simulations on
threads, each driving its DP group through a
:class:`repro_torch.serve.RemoteForceProvider`.

Usage:
  python -m repro_torch.launch.serve                       # gemma2-2b, card
  python -m repro_torch.launch.serve --reduced --device cpu --batch 2 --new 8
  python -m repro_torch.launch.serve --arch deepseek-v3-671b --reduced --device cpu
  python -m repro_torch.launch.serve --backend force       # DPA-1, card
  python -m repro_torch.launch.serve --backend force --reduced --device cpu

Weights are random, from the port's initialiser (``--seed``); the prompts
are token ids drawn from the same seed, so no tokenizer or checkpoint is
needed.

On the card the decode step runs as a CUDA graph, the port's counterpart
of the reference's ``jax.jit`` of ``make_serve_step``: :class:`DecodeGraph`
captures it once per request over the request's cache, with the tokens and
the position as static device tensors and the greedy argmax inside, and
each further step replays it (``serve_tokens(..., graph=False)`` runs the
step op by op).
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


def recurrent_leaves(cache) -> list:
    """The cache's recurrent-state tensors (``serve_lib.RECURRENT``), which a
    decode step advances; raises on a leaf of a kind it does not know."""
    from ..lm.serve_lib import POSITIONAL, RECURRENT, STATIC
    out = []

    def walk(node, name=None):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, k)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v, name)
        elif name in RECURRENT:
            out.append(node)
        elif name not in POSITIONAL + STATIC:
            raise ValueError(f"DecodeGraph: cannot tell how a decode step "
                             f"writes the cache leaf {name!r}")
    walk(cache)
    return out


class DecodeGraph:
    """The greedy decode step ``make_serve_step(cfg)`` captured once as a
    CUDA graph over ``cache``: static inputs ``tok`` (B, 1) and ``pos`` (a
    0-d int64 tensor), both advanced inside the graph (the argmax of the
    step's logits becomes the next token, pos + 1 the next position), and
    ``logits`` (B, V), the step's last logits, a static output that each
    replay overwrites.

    Before the capture, one eager step on the capture stream at the first
    position runs the lazy set-up (kernel builds, library handles, the
    decode workspace).  It writes the positional cache entry that the first
    replay writes again with the same bits, and advances the recurrent
    state (Mamba's ``conv``/``ssm``, RWKV's ``S``/``shift``/``cmix_shift``),
    which is saved before it and restored after it, so that the first
    replay starts from the prefill's state.  The capture launches nothing,
    so the kernel launch counts it made are taken back and counted again at
    every replay (``launches``: per replay, by wrapper)."""

    def __init__(self, cfg, params, cache, tok, pos: int):
        from .. import kernels
        from ..lm.serve_lib import make_serve_step
        dev = tok.device
        step = make_serve_step(cfg)
        self.tok = tok.clone()
        self.pos = torch.tensor(pos, dtype=torch.int64, device=dev)
        state = recurrent_leaves(cache)
        saved = [t.clone() for t in state]
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        t0 = time.perf_counter()
        with torch.cuda.stream(stream):
            step(params, cache, self.tok, self.pos)
            for live, kept in zip(state, saved):
                live.copy_(kept)
        torch.cuda.current_stream(dev).wait_stream(stream)
        del saved
        before = kernels.launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream):
            logits, _ = step(params, cache, self.tok, self.pos)
            self.logits = logits[:, -1]
            self.tok.copy_(logits.argmax(-1))
            self.pos.add_(1)
        after = kernels.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        for name, n in self.launches.items():
            kernels.KERNELS[name].launches -= n
        _sync(dev)
        self.capture_s = time.perf_counter() - t0

    def replay(self):
        """One decode step: the next token in ``tok``, its position's logits
        in ``logits``."""
        from .. import kernels
        self.graph.replay()
        for name, n in self.launches.items():
            kernels.KERNELS[name].launches += n


def context_stub(cfg, batch: int, rng, device):
    """The reference's modality stub for ``cfg``: (B, T, D) fp32 frame
    embeddings (whisper, T audio frames) or patch embeddings (the vision
    model, T image tokens) drawn N(0, 1) from ``rng``; None for a text-only
    architecture."""
    if cfg.enc_dec:
        t = cfg.n_audio_frames
    elif cfg.cross_attn_every and cfg.family == "vlm":
        t = cfg.n_image_tokens
    else:
        return None
    return torch.tensor(rng.normal(0, 1, (batch, t, cfg.d_model)),
                        dtype=torch.float32, device=device)


def serve_tokens(cfg, params, tokens, new: int, graph=None,
                 context=None) -> dict:
    """Prefill ``tokens`` (B, S) (with ``context``, the frame or patch
    embeddings of an architecture that cross-attends) into a cache of
    length S + new, then greedy decode: ``new`` tokens per sequence, the
    first from the prefill's last logits, each further one from a decode
    step.  The steps replay a :class:`DecodeGraph` captured for this
    request (``graph``; default: on CUDA tensors) or run eagerly (CPU
    tensors, or ``graph=False``).
    Returns the tokens (B, new), every step's logits [(B, V)] (the
    prefill's first), the cache, the host-clock seconds of the prefill and
    of the decode loop (``decode_s``, the replays or eager steps only), and
    with a graph the seconds of its set-up and capture (``capture_s``) and
    its launches per replay (``graph_launches``)."""
    from ..lm.serve_lib import make_prefill, make_serve_step
    b, s = tokens.shape
    dev = tokens.device
    graph = dev.type == "cuda" if graph is None else graph
    if graph and dev.type != "cuda":
        raise ValueError("a CUDA graph decodes on a CUDA device only")
    prefill = make_prefill(cfg, max_len=s + new)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, tokens, context)
    tok = logits[:, -1:].argmax(-1)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    out, step_logits = [tok], [logits[:, -1]]
    res = {}
    if graph and new > 1:
        g = DecodeGraph(cfg, params, cache, tok, s)
        res.update(capture_s=g.capture_s, graph_launches=g.launches)
        t0 = time.perf_counter()
        for _ in range(new - 1):
            g.replay()
            out.append(g.tok.clone())
            step_logits.append(g.logits.clone())
    else:
        serve = make_serve_step(cfg)
        t0 = time.perf_counter()
        for i in range(new - 1):
            logits, cache = serve(params, cache, tok, s + i)
            tok = logits.argmax(-1)
            out.append(tok)
            step_logits.append(logits[:, -1])
    _sync(dev)
    res.update(tokens=torch.cat(out, 1), logits=step_logits, cache=cache,
               prefill_s=prefill_s, decode_s=time.perf_counter() - t0)
    return res


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
    ctx = context_stub(cfg, args.batch, rng, dev)
    res = serve_tokens(cfg, params, tokens, args.new, context=ctx)
    steps = args.new - 1
    print(f"prefill {args.batch}x{args.prompt_len} in {res['prefill_s']:.2f}s")
    if "capture_s" in res:
        print(f"decode step captured as a CUDA graph in "
              f"{res['capture_s']:.2f}s")
    print(f"decoded {steps} steps in {res['decode_s']:.2f}s "
          f"({steps * args.batch / max(res['decode_s'], 1e-9):.1f} tok/s)")
    print("greedy tokens (batch 0):", res["tokens"][0, :16].tolist())
    return res


def main_force(args):
    """DP force serving: ``--clients`` MD threads against one server;
    prints per-tenant metrics and returns {"snapshot", "totals", "s"}."""
    import threading

    from ..device import resolve_device
    from ..dp import DPModel, paper_dpa1_config
    from ..md import (EngineConfig, MDEngine, build_solvated_protein,
                      mark_nn_group)
    from ..serve import ForceServer, RemoteForceProvider, ServeConfig

    dev = resolve_device(args.device)
    # the served evaluator: the paper's DPA-1 (reduced shrinks sel so the
    # CPU demo stays interactive)
    cfg = (paper_dpa1_config(ntypes=4, rcut=0.6, sel=32) if args.reduced
           else paper_dpa1_config(ntypes=4))
    model = DPModel(cfg, device=dev)
    params = model.init_params(torch.Generator().manual_seed(args.seed))
    system, pos, nn_idx = build_solvated_protein(
        args.protein_atoms, water_per_protein_atom=2.0, device=dev)
    system = mark_nn_group(system, nn_idx)
    serve_cfg = ServeConfig(queue_bound=args.queue_bound,
                            batch_window_s=args.batch_window_ms * 1e-3,
                            default_timeout_s=args.timeout_s,
                            nbr_capacity=48)
    server = ForceServer(model, params, serve_cfg)
    print(f"force server up on {dev}: atom buckets "
          f"{serve_cfg.atom_buckets}, batch buckets "
          f"{serve_cfg.batch_buckets}, queue bound {serve_cfg.queue_bound}")
    errors = []

    def run_client(tid: int):
        try:
            provider = RemoteForceProvider(
                server, nn_idx, system.types, system.box, system.n_atoms,
                tenant=f"sim{tid}", timeout_s=args.timeout_s)
            eng = MDEngine(system, EngineConfig(cutoff=0.9,
                                                neighbor_capacity=96,
                                                dt=0.0005, thermostat_t=300.0),
                           special_force=provider)
            eng.run(eng.init_state(pos, 300.0, seed=tid), args.steps)
        except Exception as e:  # noqa: BLE001 — reported after the join
            errors.append(e)

    t0 = time.time()
    threads = [threading.Thread(target=run_client, args=(i,), daemon=True)
               for i in range(args.clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.time() - t0
    snap = server.metrics.snapshot()
    totals = server.metrics.totals()
    server.stop()
    if errors:
        raise errors[0]
    print(f"\n{args.clients} MD clients x {args.steps} steps "
          f"in {dt:.2f}s ({totals['completed'] / max(dt, 1e-9):.1f} req/s)")
    hdr = ("tenant", "submitted", "completed", "timeouts", "errors",
           "rejected", "max_depth", "mean_lat_ms", "p50_ms", "p99_ms", "rps")
    print(("{:>10}" * len(hdr)).format(*hdr))
    for tenant in sorted(snap):
        s = snap[tenant]
        print("{:>10}{:>10}{:>10}{:>10}{:>10}{:>10}{:>10}"
              "{:>10.1f}{:>10.1f}{:>10.1f}{:>10.2f}"
              .format(tenant, s["submitted"], s["completed"], s["timeouts"],
                      s["errors"], s["rejected"], s["max_queue_depth"],
                      1e3 * s["mean_latency_s"], 1e3 * s["p50_latency_s"],
                      1e3 * s["p99_latency_s"], s["rps"]))
    print("totals:", totals)
    return {"snapshot": snap, "totals": totals, "s": dt}


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
    ap.add_argument("--clients", type=int, default=4,
                    help="force serving: concurrent MD client threads")
    ap.add_argument("--steps", type=int, default=10,
                    help="force serving: MD steps per client")
    ap.add_argument("--protein-atoms", type=int, default=6,
                    help="force serving: residues of the solvated protein")
    ap.add_argument("--queue-bound", type=int, default=64)
    ap.add_argument("--batch-window-ms", type=float, default=2.0)
    ap.add_argument("--timeout-s", type=float, default=60.0)
    args = ap.parse_args(argv)
    backend = args.backend
    if backend == "auto":
        backend = "force" if args.arch in FORCE_ARCHS else "lm"
    if backend == "force":
        return main_force(args)
    return main_lm(args)


if __name__ == "__main__":
    main()
