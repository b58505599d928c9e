#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's paths once on one card: the DP force path,
DPA-1 training, gemma2-2b token serving, the other LM architectures (MLA,
MoE, Mamba, RWKV6, cross-attention, the encoder and MTP) and LM training.

    python3 chip_smoke.py                   # every phase
    python3 chip_smoke.py --phase lm        # the lm phase alone
    python3 chip_smoke.py --phase lm_archs  # the lm_archs phase alone
    python3 chip_smoke.py --phase lm_train  # the lm_train phase alone
    python3 chip_smoke.py --phase kernels   # the DP kernels phase alone
    python3 chip_smoke.py --phase md        # the md phase alone
    python3 chip_smoke.py --phase guard     # the guard phase alone
    python3 chip_smoke.py --phase train     # the train phase alone
    python3 chip_smoke.py --phase ensemble  # the ensemble phase alone
    python3 chip_smoke.py --phase serve     # the serve phase alone
    python3 chip_smoke.py --phase roofline  # the roofline phase alone
    python3 chip_smoke.py --phase dd_procs  # the dd_procs phase alone
    python3 chip_smoke.py --phase ensemble_procs  # ensemble_procs alone
    python3 chip_smoke.py --phase lm_mesh   # the lm_mesh phase alone
    python3 chip_smoke.py --phase serve_procs  # serve_procs alone

Builds the kernels from ``src/repro_torch/kernels`` (one nvcc per CUDA
source, all started together; Triton at first launch), then runs phases
1-4 on the paper's DPA-1 at full width (``paper_dpa1_config(ntypes=4,
rcut=0.6, sel=64)``, fp32, random weights from a seed) over uniform random
atoms at 30 atoms/nm^3, phases 5-6 on the MD engine with the same model,
phase 7 trains the DPA-1, phase 8 serves gemma2-2b, phases 9-10 run
replica ensembles and DP force serving (run after phase 6), phase 11 the
other LM architectures, phase 12 LM training, phase 13 the LM over a
device mesh and phase 14 the step accounting against the card:

1. kernels: the env-matrix, attention and force-scatter kernels against
   their plain PyTorch versions on the card, at the shapes and on the data
   the force path gives them (N = 15,668 atoms; K = 64, 82, and K = 128
   from the MD cutoff r_c = 0.8 with sel 128), with timings (median of 10
   runs, CUDA events, L2 flushed before each run); the forward and the
   force-path backward (both on compacted rows) also held to exact zeros
   at the masked slots and repeated bit for bit, the forward also split
   into passes of 2^16 rows bit for bit; the force scatter (the neighbour
   gather's backward) bit for bit on one force call's cotangents, timed
   with its reverse list's build apart and beside PyTorch's indexing
   backward; at K = 82 the parameter-gradient backward timed;
2. path parity: the single-domain provider on the card against the port on
   the CPU at 2,048 atoms, and one launch of each of its kernels per call;
   the same at 160 atoms for a reduced DPA-1 whose embedding width M = 62
   is not a multiple of 4 (the wrappers pad it for the attention kernels);
3. requests: ``DeepmdForceProvider(skin=0.05).compute`` on one domain of the
   15,668-atom 1HCI-sized system (4 drifts inside skin/4, then a rebuild);
4. dd: the virtual domain decomposition on the same system and model,
   8 ranks on this card (``suggest_config(n_ranks=8, skin=0.05)``): the
   ``cell_filter`` kernel against its plain version bit for bit (at the
   shapes of the cell-list assembly and of the evaluation's re-filter, and
   on pairs placed at the cutoff), the five model kernels against their
   plain versions on the exact tensors one DD evaluate gives them (all
   ranks' capacity rows, fully masked padding rows included; the attention
   stack in row chunks, its stash on the valid rows the forward kept for
   the backward; both force-scatter calls, the gather's backward and the
   force reduction, bit for bit), cells == dense and stale == fresh bit for bit,
   DD == single domain within phase 3's gate, the fused force function
   split into the paper's Fig.-12 phases by its prefix probes
   (``ForcePipeline.build_phase_probes`` + ``obs.timed_prefix_phases``:
   gather, assembly, inference, force_reduce; median of 3), then requests
   through ``DeepmdForceProvider(dd_config=...)`` and one assembly
   profiled; then dd_procs, the same path over ``torch.distributed``
   processes (``launch.mesh.make_dd_mesh``, ``ForcePipeline(mesh=...)``),
   held against the virtual path in all four configurations (both force
   modes x both reduce modes; the fused call, the assembly, an evaluate,
   the rebuild check): (i) one process through an NCCL group, every
   output bit for bit, overlap == sequential bit for bit; (ii) two child
   processes sharing this card over gloo (CUDA tensors through host
   copies), 4 ranks each: E and F within the DP gate, every integer output
   exactly (each process's state the virtual state's rows of its ranks),
   both processes' outputs the same bits, the model kernels against their
   plain versions on each process's evaluate, 10 MD steps of the stand-in
   below with the same positions on both after every step; (iii) with 2,
   4 or 8 cards the same over NCCL, one card a process, else a line saying
   why not; for each case ms per force call and per MD step and the
   paper's Fig.-12 split per process (inference, collective 1, collective
   2; CUDA events around the collectives);
5. md: the port's MD engine (``repro_torch.md.MDEngine``) on the solvated
   1HCI stand-in (``build_solvated_protein(3917)``: 62,210 atoms, the
   15,668 protein atoms the DP group; ``examples/protein_md.py``'s engine
   settings): a warm-up window, then 20 scan-mode steps timed step by step
   (evaluate-only and rebuild steps apart), repeated, in step mode (the
   Fig. 9 split and the DP share) and in windows of 10 steps, all bit for
   bit; launches per MD step; the memory held between steps held to the
   first step's, the peak within each step reported;
   one MD step profiled (no indexing backward); 10 steps on 8 virtual
   ranks, the first step's DP forces against one domain; at 40 residues
   the card against the CPU and the DD trajectory with cells against
   dense, bit for bit;
6. guard: guarded MD on the same stand-in and model, 10 steps a run from
   the md phase's 5-step warm-up: guards on and quiet, and obs on (spans,
   per-step counters, calibrated stage timings, the trace flushed and
   validated), each equal to the unguarded run bit for bit, their ms per
   step beside it (the variants alternated, twice); an engine-level
   ``nan_force`` inside the window rolled back and replayed to the same
   bits (one trip, one rollback; the replayed window's cost); checkpoints
   every 5 steps through an ``AsyncCheckpointer`` whose newest save is
   truncated: ``restore_latest`` falls back and the resumed run gives the
   same bits (the save's own ms apart); on 8 virtual ranks (5 steps) a
   rank-3 ``nan_force`` through the pipeline's fault hook recovers bit
   for bit; every kernel of each guarded path launched;
7. train: DPA-1 force-matching training (``repro_torch.dp.train``, the
   paper's Fig. 7 pipeline) at the paper's width: the reference example's
   run (``paper_dpa1_config(ntypes=4, rcut=0.6, sel=24)``,
   ``make_dataset(128, n_atoms=32, seed=0)``, split 0.15, batch 8, lr0
   2e-3, 20 steps, evaluated every 10) through ``train`` with its history
   printed and every value finite; a run restored from its step-10
   checkpoint ending with the uninterrupted run's parameters bit for bit;
   the first two steps' loss, gradient and gradient norm on the card
   against the port on the CPU (the CPU tests' gates); 11 of its steps
   timed (ms per step, median of steps 2-10); then a timed run at
   the MD model's capacity (sel 64, 8 frames of 256 atoms a step: ms per
   step, median of steps 2-10, synchronised; a ``force_rmse`` call's ms;
   peak memory); one step of each run and one ``force_rmse`` call under
   ``torch.profiler`` (device time by kernel, idle share, host ops).  The loss takes the training route (the env matrix and
   the attention stack in plain PyTorch under autograd, the force scatter
   in both orders): a training step must launch the force scatter and no
   model kernel, a ``force_rmse`` call (the kernel route) each of the
   env-matrix, attention and force-scatter kernels;
8. lm: gemma2-2b at full width (26 layers, d_model 2304, vocab 256000,
   bf16, random weights from the port's initialiser), 4 prompts of 6,144
   random token ids, 32 greedy new tokens through ``launch/serve.py``'s
   ``serve_tokens``: an eager request with every attention call recorded
   (26 ``flash_attention`` launches per prefill, 26 ``flash_decode`` per
   decode step), then the main path, a request whose decode steps replay a
   captured CUDA graph (26 ``flash_decode`` launches captured per replay,
   counted per replay), equal to the eager request bit for bit; the
   prefill kernel and the decode kernel against their plain versions on
   the tensors of a local and a global layer of the prefill and of the
   last decode step (bf16, and the same inputs in fp32), with times,
   bounds and, at each of the four call shapes, SDPA beside the kernel at
   softcap 0; the decode kernel at lengths 1, 63, 64, 65 and the cache's
   capacity with one grid; decode == forward at full width; card == CPU
   at a reduced width in fp32; 3 timed rounds each of graphed and eager
   requests, then a profiled prefill, 4 profiled graphed decode steps and
   4 eager ones;
9. ensemble: on the md phase's stand-in, 4 replicas through one
   ``BatchedDeepmdProvider`` call (one domain) against the unbatched
   provider, each kernel launched once per call as at R = 1 and held
   against its plain version on the call's tensors; REMD
   (``EnsembleEngine``, R = 4, geometric 300-420 K ladder, exchange every 5
   steps; 5 warm-up, 20 timed steps); exchange off, R = 2 against two
   ``MDEngine`` runs; 2 replicas x 4 virtual ranks against one domain,
   per-replica rebuild flags, a ``nan_force`` on rank 2 of replica 1
   recovered with only replica 1 tripped; then the overlap evaluation on
   the dd phase's 8 ranks: == sequential bit for bit (build and drifted
   positions), ``interior_frac``, a trimmed and a tiny
   ``overlap_capacity``, both timed, each pass's kernels held; then
   ensemble_procs, replicas on devices: R = 4 replicas of the stand-in x 8
   DD ranks (skin 0.05) over the 2-D ``(replica x dd)`` process layout of
   ``ensemble.make_ensemble_mesh``, held against the virtual R x 8
   pipeline (the fused call, the assembly, an evaluate, the rebuild
   checks): (i) one process through an NCCL group as ``(1, 1)``, bit for
   bit; (ii) two child processes sharing this card over gloo as ``(2,
   1)``, 2 replicas each: E and F within the DP gate, every integer output
   exactly, both processes' outputs the same bits; (iii) with 4 cards
   ``(2, 2)`` over NCCL, else a line saying why not; in each case each
   process's kernels held against their plain versions on its own
   evaluate, 10 REMD steps (``EnsembleEngine`` + ``BatchedDeepmdProvider``
   over the mesh, geometric 300-420 K, exchange every 5) with the same
   positions, ladders and rebuild counts on every process after every
   step; ms per ensemble step and per force call, the collectives by tag,
   the inference share and peak memory per process;
10. serve: a ``ForceServer`` (full-width model, atom bucket 4,096, batch
   buckets 1, 2, 4) for 4 MD client threads through
   ``RemoteForceProvider`` on a solvated protein with a 4,096-atom DP
   group (after a warm-up, a window of 400 requests: requests/s, p50/p99
   of the requests' own latencies, every dispatch's launches counted on
   the server's stream); a batch of 4 against ``evaluate_direct``; ms and
   launches per executor call at batch 1, 2, 4;
   an expired deadline, a full queue and a ``serve_fail`` each failing only
   their own request or batch; the ``pipeline_executor_factory`` route at
   batch 2 x 4 virtual ranks; then serve_procs, the same serving over a
   ``(replica x dd)`` process mesh (``pipeline_executor_factory(...,
   mesh_for=...)``: the server on process 0, ``follow_dispatches`` on the
   others, batch buckets 1, 2, 4 over 8 // batch dd ranks): (i) a (1, 1)
   NCCL mesh in this process, every served result bit for bit against the
   virtual route, the launches per dispatch equal, each model kernel
   against its plain version on the batch-4 dispatch's rows; (ii) two gloo
   processes sharing this card as (2, 1), within the DP gate with the same
   bits on both, a request after a 5 s idle spell (the followers give up
   on a header after 4 s; keep-alive headers every 0.5 s) with its earlier
   bits, and 10 client MD steps; (iii) with 4 cards (2, 2) over
   NCCL with 4 client MD threads for 100 steps (requests/s, p50/p99, ms
   and collectives by tag per dispatch), else a line saying why not;
11. lm_archs: deepseek-v3 (4 layers: 3 dense MLA + 1 MoE MLA, and the MTP
   head; B 2, prompt 1,024, 8 new), jamba-1.5-large (2 layers: mamba/dense,
   mamba/MoE; B 2, prompt 2,048, 8 new), rwkv6-3b (all 32 layers; B 4,
   prompt 2,048, 16 new) and whisper-medium (24 encoder + 24 decoder
   layers, 1,500 frames of the context stub; B 4, prompt 448, 16 new), each
   at its published width in bf16 with random weights from the port's
   initialiser, alone (parameters freed before the next): the launches of
   one prefill, the main path (a request whose decode steps replay a CUDA
   graph; every launch accounted for) equal to an eager request bit for
   bit, a second timed pair, decode == forward at the bf16 gate (for the
   MoE archs at capacity factor 8.0, no drop; at the published 1.25
   reported, not gated), ``mtp_logits`` finite, the card against the port
   on the CPU at a reduced fp32 width the kernel has heads for, and
   MLA's (192, 128) ``flash_attention`` instance against its plain version
   on the first MLA prefill call's tensors (bf16 and fp32, a repeat bit for
   bit, times, bound and SDPA's time);
12. lm_train: LM training (``lm/train_lib.py`` through
   ``launch/train.py``; the attention's gradient through
   ``kernels.ops.FlashAttention``: the prefill kernels with the rows'
   log-sum-exp forward, a plain chunked backward): (a) at qwen2-1.5b's
   and gemma2-2b's attention shapes (B 4 x 2,048, causal; gemma2's
   window and softcap 50), bf16 and fp32, the Function's forward and
   backward against plain autograd through ``attention_ref``, a repeat bit
   for bit, the kernel with the LSE giving the serving call's bits, and
   times (the forward, the plain backward, both routes' forward +
   backward, and SDPA's forward + backward at softcap 0 as the library
   time, and the forwards alone at softcap 0: the kernel's and SDPA's);
   (b) the main path: qwen2-1.5b at full width (28 layers, bf16,
   random weights) through ``launch.train.main``, B 4 x 2,048, Adam,
   ``remat="full"``, 12 steps, each timed (median of steps 2-11), 56
   ``flash_attention`` launches a step and no other kernel, the peak
   memory, the last step profiled; (c) ``remat="full"`` == ``"none"`` bit
   for bit at full width cut to 4 layers; (d) every registry arch at a
   reduced fp32 width: two steps on the card against the CPU at the CPU
   tests' gates; (e) the launcher killed at step 6 and resumed on the
   card, equal to the uninterrupted run bit for bit;
13. lm_mesh: the LM over a ``("data", "model")`` process mesh
   (``lm.make_lm_mesh``; parameters, optimizer state, batch and caches
   DTensors laid out by ``lm/sharding.py``'s specs): (a) the decode
   kernel's slice instance (``kv_base``, the rows' LSE: a cache sharded by
   its sequence) against its plain version over 4 slices at gemma2-2b's
   and qwen2-1.5b's head widths, bf16 and fp32, a slice with no visible
   key giving O = 0 and LSE = -inf, the slices merged by their LSE equal
   to the whole cache, timed beside its bound and SDPA, also at the
   long-context slices a (4, 1) and a (2, 2) mesh give one process of
   long_500k's 524,288 keys (131,072 and 262,144 keys, B 1); (b) the main
   path: a ``(1, 1)`` mesh through one NCCL process, bit for bit against
   no mesh, eager on both sides: qwen2-1.5b's training step (12's
   configuration, 2 steps: loss, grad_norm, every parameter), the same
   with ``adam8bit`` (B 2 x 1,024: every ``q``, ``s``, ``v16`` too), its
   decode at B 1 into a seeded cache of 524,288 positions laid out with
   ``long_context=True`` (8 greedy steps), and gemma2-2b's
   prefill and 31 greedy decode steps (8's configuration: the prefill
   logits, the 32 tokens, every step's logits); (c) two gloo processes
   sharing this card as ``(1, 2)`` (every collective DTensor issues on CUDA
   tensors through gloo, probed first: a collective gloo refuses is
   printed and the case left out), 4 layers of each at full width,
   against no mesh at the same depth at the bf16 gates, decode fed the
   no-mesh greedy tokens; (d) with 4 cards, NCCL one card a process:
   ``(2, 2)`` training and serving at full depth, ``(1, 4)`` qwen2-1.5b's
   decode (B 4 x 2,048; Hkv 2 < 4, so the cache lies sharded by its
   sequence) with ``FLASH_DECODE`` off and on and ``GQA_REPEAT`` on,
   ``adam8bit`` training at ``(2, 2)`` and the long-context decode at
   ``(2, 2)`` and ``(4, 1)`` (the cache's sequence over "data": no cache
   all-gather, three all-reduces a layer more than the plain layout), else
   a line saying why not.  Each case prints ms a training step and
   tokens/s, ms a prefill and a decode step, peak MiB per process and the
   collectives of one step by kind (``CommDebugMode``) with their ms
   (``torch.profiler``: NCCL kernels' device time, gloo's host time);
14. roofline: the step accounting (``launch/roofline.py::count_step``)
   held against the card: qwen2-1.5b's training step (12's config),
   gemma2-2b's prefill and one eager decode step (8's config, the last
   decode position) counted on ``meta`` and on the card, the counts equal
   (FLOPs and bytes by op, the live-bytes peak, the flash kernels'
   formulas); one JSON line per cell with the card's name and power limit:
   mfu (model FLOPs: 6 N D, 2 N D; the prefill's less the LM head at the
   positions it does not project), hfu (counted FLOPs) over the bf16
   peak and the bytes
   share of 3.35 TB/s at the times phases 12 and 8 measured, the
   live-bytes peak beside ``torch.cuda.max_memory_allocated``;
15. a ``kernels`` JSON line (launches per force call, per MD step, per
   guarded MD run, per training step and ``force_rmse`` call, per
   request, per batched force call, per ensemble step, per served
   dispatch (on one process and over a process mesh), per overlap
   evaluation and per LM training step;
   ``flash_attention`` and ``flash_decode`` also per prefill and decode
   step of each lm_archs architecture, the MLA instance's numbers, the
   LM training route's times, the lm_mesh main path's launches and the
   decode kernel's slice instance), then the result line.

Any failed check raises, and the script exits non-zero.  It needs one CUDA
card and the repository's ``src/`` beside it; it imports no JAX.
"""
import dataclasses
import datetime
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parent / "src"
DENSITY = 30.0            # atoms / nm^3 (benchmarks/dp_inference.py)
N_PATH = 15_668           # the paper's 1HCI DP group
N_PARITY = 2_048
DEVICE = "cuda"
SKIN = 0.05
SEED = 0
REPS = 10
F32_PEAK = 67e12          # H100 SXM fp32 FLOP/s outside the tensor cores
HBM_RATE = 3.35e12        # H100 SXM bytes/s
N_RANKS = 8
TPU_SOURCES = {
    "env_mat_fwd": "src/repro/kernels/env_mat.py:66",
    "env_mat_bwd": "src/repro/kernels/env_mat.py:90",
    "nbr_attention_stack_fwd": "src/repro/kernels/nbr_attn.py:145",
    "nbr_attention_stack_bwd": "src/repro/kernels/nbr_attn.py:164",
    "cell_filter": "src/repro/kernels/cell_gather.py:26",
    # no TPU kernel: XLA scatter-adds the gradient of this gather
    "force_scatter": "src/repro/dp/model.py:88",
}
SINGLE_DOMAIN_KERNELS = ("env_mat_fwd", "env_mat_bwd",
                         "nbr_attention_stack_fwd", "nbr_attention_stack_bwd",
                         "force_scatter")
DP_KERNELS = SINGLE_DOMAIN_KERNELS + ("cell_filter",)
TPU_FUNCTIONS = {
    "env_mat_fwd": "src/repro/kernels/env_mat.py::_env_mat_kernel",
    "env_mat_bwd": "src/repro/kernels/env_mat.py::_env_mat_bwd_kernel",
    "nbr_attention_stack_fwd": "src/repro/kernels/nbr_attn.py::_stack_fwd_kernel",
    "nbr_attention_stack_bwd": "src/repro/kernels/nbr_attn.py::_stack_bwd_kernel",
    "cell_filter": "src/repro/kernels/cell_gather.py::_cell_filter_kernel",
    "force_scatter": "none: XLA's scatter-add of the gradient of coords[safe] "
                     "(src/repro/dp/model.py::_atomic_e)",
}
PORT_SOURCES = {
    "env_mat_fwd": ("triton", "src/repro_torch/kernels/env_mat_triton.py"),
    "env_mat_bwd": ("triton", "src/repro_torch/kernels/env_mat_triton.py"),
    "nbr_attention_stack_fwd": ("cuda", "src/repro_torch/kernels/csrc/nbr_attn.cu"),
    "nbr_attention_stack_bwd": ("cuda", "src/repro_torch/kernels/csrc/nbr_attn.cu"),
    "cell_filter": ("cuda", "src/repro_torch/kernels/csrc/cell_filter.cu"),
    "force_scatter": ("cuda", "src/repro_torch/kernels/csrc/force_scatter.cu"),
}


def fail(msg):
    raise RuntimeError(msg)


def check(name, got, want, rtol=0.0, atol=0.0):
    """|got - want| <= atol + rtol |want| everywhere; returns max |err|."""
    err = (got - want).abs()
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite output")
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        fail(f"{name}: {int(bad.sum())} entries out of tolerance "
             f"(max err {float(err.max()):.3e}, rtol {rtol}, atol {atol:.3e})")
    return float(err.max())


_FLUSH = None


def time_ms(fn):
    """Median over REPS runs after two warm-ups; L2 (50 MB) flushed first."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 * 2 ** 20, device=DEVICE)
    for _ in range(2):
        fn()
    times = []
    for _ in range(REPS):
        _FLUSH.zero_()
        # keep the card busy while the host enqueues, so the events time
        # the kernel and not the host's launch latency
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def system(n, seed):
    rng = np.random.default_rng(seed)
    side = (n / DENSITY) ** (1.0 / 3.0)
    coords = rng.uniform(0, side, (n, 3)).astype(np.float32)
    types = rng.integers(0, 4, n).astype(np.int32)
    return coords, types, np.full(3, side, np.float32)


def path_inputs(model, params, coords, types, box, nlist):
    """The tensors the force path hands to each kernel (the steps of
    ``DPModel._atomic_e`` and ``apply_descriptor`` up to the attention
    stack), from a real skin-widened list re-filtered to the cutoff."""
    from repro_torch.dp.common import _guarded_env
    from repro_torch.dp.descriptors import _stack_params
    from repro_torch.dp.networks import mlp_apply
    from repro_torch.kernels.ref import env_mat_ref
    from repro_torch.md.neighbors import minimum_image
    cfg = model.cfg.descriptor
    idx = nlist.idx.long()
    safe = torch.where(idx >= 0, idx, torch.zeros_like(idx))
    dr = minimum_image(coords[safe] - coords[:, None, :], box)
    mask = nlist.mask * ((dr * dr).sum(-1) < cfg.rcut ** 2)
    planes = [dr[..., i].contiguous() for i in range(3)]
    s = env_mat_ref(*planes, mask, cfg.rcut_smth, cfg.rcut)[0]
    dist, _, r_hat = _guarded_env(dr, mask, cfg.rcut_smth, cfg.rcut)
    r_hat = r_hat * mask[..., None]
    pd = params["descriptor"]
    feat = torch.cat([s[..., None],
                      pd["type_embed"][types[safe]] * mask[..., None]], -1)
    g = mlp_apply(pd["embed"], feat) * mask[..., None]
    attn = [g.contiguous()] + [r_hat[..., i].contiguous() for i in range(3)]
    attn += [(s * dist).contiguous(), mask.contiguous()]
    attn += [w.contiguous() for w in _stack_params(pd["attn"])]
    return (*planes, mask.contiguous()), attn


def env_bound(n_planes, numel):
    return n_planes * numel * 4 / HBM_RATE * 1e3, "bytes"


def attn_bound(attn, backward, param_grads=False):
    """Least time for the stack: FLOPs the valid neighbours need (per atom
    with n valid of K: forward 8nMH + 4n^2 H per layer; backward without
    parameter gradients, recompute included, 16nMH + 12n^2 H; the parameter
    gradients add 8nMH) at the fp32 peak, against each input read once and
    each output written once."""
    g, mask = attn[0], attn[5]
    layers, m, h = attn[6].shape
    nv = (mask > 0).sum(1).double()
    per = (16 * nv * m * h + 12 * nv * nv * h) if backward else \
        (8 * nv * m * h + 4 * nv * nv * h)
    if param_grads:
        per = per + 8 * nv * m * h
    flops = float(layers * per.sum())
    weights = sum(w.numel() for w in attn[6:])
    # forward: g + 5 planes in, out + the stash of the valid rows out;
    # backward: that stash + dout + 5 planes in, dg + 4 planes out
    stash = layers * float(nv.sum()) * m
    words = (2 * g.numel() + stash + 5 * mask.numel() if not backward
             else 2 * g.numel() + stash + 9 * mask.numel())
    nbytes = 4 * (words + (2 if param_grads else 1) * weights)
    t_ops, t_bytes = flops / F32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_kernels(model, params, skin, main=False):
    """The env-matrix, attention and force-scatter kernels against their
    plain versions at the shapes and on the data of the force path whose
    list has this skin (K = sel at skin 0, the skin-widened capacity of the
    provider otherwise); with ``main`` (the provider's K) also bf16
    operands at the path's shape, the parameter-gradient backward timed,
    one forward under ``torch.profiler`` and the scatter's edge cases."""
    from repro_torch.core.ddinfer import single_domain_state
    from repro_torch.kernels import env_mat, nbr_attn, ref
    cfg = model.cfg.descriptor
    coords, types, box = system(N_PATH, SEED)
    coords, types, box = (torch.tensor(a, device=DEVICE)
                          for a in (coords, types, box))
    capacity = int(np.ceil(cfg.sel * ((cfg.rcut + skin) / cfg.rcut) ** 3))
    nlist = single_domain_state(model, coords, box, capacity, skin)
    env_in, attn = path_inputs(model, params, coords, types, box, nlist)
    n, k = env_in[3].shape
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    rand = lambda *s: torch.randn(*s, device=DEVICE, generator=gen)
    results = {}

    def report(name, err, tol, kernel_ms, plain_ms, bound, **extra):
        line = {"phase": "kernels", "name": name, "K": k, "N": n,
                "tpu_source": TPU_FUNCTIONS[name], "max_err": err, "tol": tol,
                "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1], **extra}
        print(json.dumps(line), flush=True)
        results[name] = line

    # the force scatter on the cotangents of one force call on this list
    _, seen = record_model_kernels(
        lambda: model.energy_and_forces(params, coords, types, nlist.idx,
                                        env_in[3], torch.ones_like(coords[:, 0]),
                                        box), FORCE_SCATTER)
    calls = seen["force_scatter"]
    fs_args = calls[0][0]
    line = check_force_scatter(*fs_args, edge=main, profile=main)
    report("force_scatter", 0.0, "exact (bitwise)", line.pop("kernel_ms"),
           line.pop("plain_ms"), (line.pop("bound_ms"), line.pop("bound_by")),
           launches_per_force_call=len(calls), **line)
    del seen, calls, fs_args

    rs, rc = cfg.rcut_smth, cfg.rcut
    out = env_mat.env_mat_fwd(*env_in, rs, rc)
    want = ref.env_mat_ref(*env_in, rs, rc)
    err = max(check(f"env_mat_fwd[{i}]", o, w, rtol=1e-5,
                    atol=1e-6 * float(w.abs().max()))
              for i, (o, w) in enumerate(zip(out, want)))
    report("env_mat_fwd", err, "rtol 1e-5, atol 1e-6*max",
           time_ms(lambda: env_mat.env_mat_fwd(*env_in, rs, rc)),
           time_ms(lambda: ref.env_mat_ref(*env_in, rs, rc)),
           env_bound(8, n * k))

    cts = [rand(n, k) for _ in range(4)]
    out = env_mat.env_mat_bwd(*env_in, *cts, rs, rc)
    want = ref.env_mat_bwd_ref(*env_in, *cts, rs, rc)
    err = max(check(f"env_mat_bwd[{i}]", o, w, rtol=2e-4, atol=5e-5)
              for i, (o, w) in enumerate(zip(out, want)))
    report("env_mat_bwd", err, "rtol 2e-4, atol 5e-5",
           time_ms(lambda: env_mat.env_mat_bwd(*env_in, *cts, rs, rc)),
           time_ms(lambda: ref.env_mat_bwd_ref(*env_in, *cts, rs, rc)),
           env_bound(11, n * k))

    fwd = nbr_attn.nbr_attention_stack_fwd
    out, stash = fwd(*attn, stash=True)
    want, want_stash = ref.nbr_attention_stack_ref(*attn, stash=True)
    scale = float(want.abs().max())
    err = check("nbr_attention_stack_fwd", out, want, atol=1e-4 * scale)
    check("nbr_attention_stack_fwd stash", stash, want_stash,
          atol=1e-4 * float(want_stash.abs().max()))
    # compacted rows: exact zeros at the masked slots, the same bits on a
    # repeat (keeping the valid rows' stash, as the force path does) and
    # in passes of 2^16 stacked rows (other GEMM tiles and CTA widths)
    masked = attn[5] == 0
    if bool(out[masked].any()):
        fail("nbr_attention_stack_fwd: nonzero at a masked slot")
    again, rs = fwd(*attn, stash="rows")
    if not torch.equal(again, out):
        fail("nbr_attention_stack_fwd: a repeat differs")
    split_rows = 1 << 16
    n_split = len(nbr_attn.row_passes(rs.count_h, split_rows))
    full_rows, nbr_attn.ROW_PASS = nbr_attn.ROW_PASS, split_rows
    try:
        again = fwd(*attn)
    finally:
        nbr_attn.ROW_PASS = full_rows
    if not torch.equal(again, out):
        fail(f"nbr_attention_stack_fwd: {n_split} passes differ from one")
    del again
    print(json.dumps({"phase": "kernels", "name": "nbr_attention_stack_fwd",
                      "K": k, "masked_slots_exact_zero": True,
                      "repeat_bitwise": True, "pass_split_bitwise": True,
                      "passes": [len(rs.passes), n_split],
                      "stash_elements_rows": rs.x.numel(),
                      "stash_elements_dense": stash.numel(),
                      "kernel_ms_no_stash": time_ms(lambda: fwd(*attn)),
                      "kernel_ms_dense_stash": time_ms(
                          lambda: fwd(*attn, stash=True))}), flush=True)
    report("nbr_attention_stack_fwd", err, "atol 1e-4*max|out|",
           time_ms(lambda: fwd(*attn, stash="rows")),
           time_ms(lambda: ref.nbr_attention_stack_ref(*attn, stash=True)),
           attn_bound(attn, backward=False))
    del out, want, stash

    dout = rand(*attn[0].shape)
    got = nbr_attn.nbr_attention_stack_bwd(want_stash, *attn[1:], dout,
                                           param_grads=False)
    want = ref.nbr_attention_stack_bwd_ref(want_stash, *attn[1:], dout)
    names = "dg drx dry drz dsw".split()
    err = max(check(f"nbr_attention_stack_bwd[{nm}]", a, b,
                    atol=1e-4 * float(b.abs().max()))
              for nm, a, b in zip(names, got, want))
    # the force-path instance: compacted rows, exact zeros at the masked
    # slots, the same bits on a repeat
    again = nbr_attn.nbr_attention_stack_bwd(want_stash, *attn[1:], dout,
                                             param_grads=False)
    for nm, a, b in zip(names, got, again):
        if not torch.equal(a, b):
            fail(f"nbr_attention_stack_bwd[{nm}]: a repeat differs")
        if bool(a[masked].any()):
            fail(f"nbr_attention_stack_bwd[{nm}]: nonzero at a masked slot")
    del again
    print(json.dumps({"phase": "kernels", "name": "nbr_attention_stack_bwd",
                      "K": k, "valid_per_atom_mean":
                          float(attn[5].sum(1).float().mean()),
                      "valid_per_atom_max": int(attn[5].sum(1).max()),
                      "masked_slots_exact_zero": True,
                      "repeat_bitwise": True}), flush=True)
    # timed as the force path runs it: from the forward's compacted stash
    report("nbr_attention_stack_bwd", err, "atol 1e-4*max|grad| per output",
           time_ms(lambda: nbr_attn.nbr_attention_stack_bwd(
               rs, *attn[1:], dout, param_grads=False)),
           time_ms(lambda: ref.nbr_attention_stack_bwd_ref(
               want_stash, *attn[1:], dout)),
           attn_bound(attn, backward=True))
    if main:
        # the parameter-gradient backward (training; off the force path)
        pg = nbr_attn.nbr_attention_stack_bwd(want_stash, *attn[1:], dout,
                                              param_grads=True)
        names = "dg drx dry drz dsw dwq dwk dwv dwo dgamma dbeta".split()
        err = max(check(f"nbr_attention_stack_bwd param_grads [{nm}]", a, b,
                        atol=1e-4 * float(b.abs().max()))
                  for nm, a, b in zip(names, pg, want))
        del pg
        bound = attn_bound(attn, backward=True, param_grads=True)
        print(json.dumps({
            "phase": "kernels", "name": "nbr_attention_stack_bwd",
            "case": "parameter gradients (stack_bwd_kernel, all K slots)",
            "K": k, "N": n, "max_err": err,
            "tol": "atol 1e-4*max|grad| per output",
            "kernel_ms": time_ms(lambda: nbr_attn.nbr_attention_stack_bwd(
                want_stash, *attn[1:], dout, param_grads=True)),
            "bound_ms": bound[0], "bound_by": bound[1]}), flush=True)
    del got, want, want_stash, rs

    # bf16 operands at the path's shapes; heads=2 and parameter gradients
    # at a small shape (the force path uses neither)
    if main:
        device_profile(lambda: fwd(*attn, stash="rows"), "kernels_profile",
                       f"one forward over compacted rows, K = {k}")
        out = nbr_attn.nbr_attention_stack_fwd(*attn, compute_dtype="bfloat16")
        want = ref.nbr_attention_stack_ref(*attn, compute_dtype="bfloat16")
        err = check("nbr_attention_stack_fwd bf16", out, want,
                    atol=2e-2 * float(want.abs().max()))
        print(json.dumps({"phase": "kernels", "name": "nbr_attention_stack_fwd",
                          "case": "bfloat16 operands", "K": k, "max_err": err,
                          "tol": "atol 2e-2*max|out|"}), flush=True)
    small = [a[:64] for a in attn[:6]] + attn[6:]
    for heads in (1, 2):
        out, st = nbr_attn.nbr_attention_stack_fwd(*small, heads=heads,
                                                   stash=True)
        want, wst = ref.nbr_attention_stack_ref(*small, heads=heads,
                                                stash=True)
        err = check(f"fwd heads={heads}", out, want,
                    atol=1e-4 * float(want.abs().max()))
        d = rand(*out.shape)
        got = nbr_attn.nbr_attention_stack_bwd(wst, *small[1:], d,
                                               heads=heads, param_grads=True)
        exp = ref.nbr_attention_stack_bwd_ref(wst, *small[1:], d, heads=heads)
        names = "dg drx dry drz dsw dwq dwk dwv dwo dgamma dbeta".split()
        err_b = max(check(f"bwd heads={heads} [{nm}]", a, b,
                          atol=1e-4 * float(b.abs().max()))
                    for nm, a, b in zip(names, got, exp))
        print(json.dumps({"phase": "kernels", "case": f"N=64 K={k} "
                          f"heads={heads}, parameter gradients",
                          "backward_instance": ("device workspace"
                                                if nbr_attn.uses_workspace(k, 128)
                                                else "shared memory"),
                          "fwd_max_err": err,
                          "bwd_max_err": err_b,
                          "tol": "atol 1e-4*max per output"}), flush=True)
    print(f"[kernels] N={n} K={k}: all five kernels within tolerance",
          flush=True)
    del attn, env_in, nlist
    torch.cuda.empty_cache()
    return results


def phase_parity(model, params, n_atoms=N_PARITY, phase="parity"):
    """Provider on the card vs the port on the CPU, same params and coords."""
    from repro_torch import kernels
    from repro_torch.backend import ForceRequest
    from repro_torch.core import DeepmdForceProvider
    from repro_torch.dp import DPModel
    coords, types, box = system(n_atoms, SEED + 1)
    nn = np.arange(n_atoms)
    cpu_model = DPModel(model.cfg, device="cpu")
    cpu_params = _tree(params, lambda t: t.cpu())
    res = {}
    for dev, mdl, prm in ((DEVICE, model, params), ("cpu", cpu_model,
                                                      cpu_params)):
        prov = DeepmdForceProvider(mdl, prm, nn, types, box, n_atoms,
                                   nbr_capacity=model.cfg.descriptor.sel,
                                   skin=SKIN, device=dev)
        kernels.reset_launch_counts()
        res[dev] = prov.compute(ForceRequest(positions=torch.tensor(coords)))
        counts = kernels.launch_counts()
        want = 1 if mdl is model else 0
        if (any(counts[k] != want for k in SINGLE_DOMAIN_KERNELS)
                or counts["cell_filter"]):
            fail(f"{dev} force call launched {counts}, expected {want} each "
                 "(no cell_filter on one domain)")
    e_gpu, e_cpu = float(res[DEVICE].energy), float(res["cpu"].energy)
    if abs(e_gpu - e_cpu) > 1e-5 * abs(e_cpu):
        fail(f"{phase}: E card {e_gpu} vs cpu {e_cpu}")
    f_cpu = res["cpu"].forces
    err = check(f"{phase} forces", res[DEVICE].forces.cpu(), f_cpu,
                atol=1e-4 * float(f_cpu.abs().max()))
    desc = model.cfg.descriptor
    print(json.dumps({"phase": phase, "atoms": n_atoms,
                      "embedding": list(desc.neuron),
                      "attention": [desc.attn_layers, desc.attn_hidden,
                                    desc.attn_heads],
                      "E_card": e_gpu,
                      "E_cpu": e_cpu, "F_max_abs_err": err,
                      "F_tol": "atol 1e-4*max|F|",
                      "launches_per_force_call": 1}), flush=True)


def phase_any_width():
    """A reduced DPA-1 whose embedding width M = 62 is not a multiple of 4
    (embedding (30, 62), 2 attention layers of 64 in 2 heads; the wrappers
    pad M to 64 for the attention kernels) on 160 atoms: the provider on
    the card against the port on the CPU at the DP gate, one launch of
    each single-domain kernel."""
    from repro_torch.dp import DescriptorConfig, DPConfig, DPModel
    cfg = DPConfig(descriptor=DescriptorConfig(
        kind="dpa1", rcut=0.6, rcut_smth=0.3, sel=64, ntypes=4,
        neuron=(30, 62), axis_neuron=16, attn_layers=2, attn_hidden=64,
        attn_heads=2))
    model = DPModel(cfg, device=DEVICE)
    phase_parity(model, model.init_params(torch.Generator().manual_seed(SEED)),
                 n_atoms=160, phase="any_width")


def _tree(t, fn):
    if isinstance(t, dict):
        return {k: _tree(v, fn) for k, v in t.items()}
    if isinstance(t, list):
        return [_tree(v, fn) for v in t]
    return fn(t)


def drifts(coords, n_eval, seed):
    """``n_eval`` drifts inside skin/4 of ``coords``, then one atom moved by
    the whole skin (a rebuild)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_eval):
        d = rng.normal(0, 1, coords.shape)
        d *= rng.uniform(0, SKIN / 4, (len(coords), 1)) / np.linalg.norm(
            d, axis=1, keepdims=True)
        out.append((coords + d).astype(np.float32))
    far = coords.copy()
    far[0] += np.float32(SKIN)
    return out + [far]


def run_requests(prov, requests, phase):
    """Each request through ``prov.compute``, timed on the host clock around
    a synchronised call; checks finiteness, overflow, growth and
    translation invariance.  Returns [(kind, ms)]."""
    from repro_torch.backend import ForceRequest
    times, state = [], None
    for i, pos in enumerate(requests):
        x = torch.tensor(pos, device=DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = prov.compute(ForceRequest(positions=x, req_id=i))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        kind = ("assemble+evaluate" if state is None else
                "rebuild" if prov._state is not state else "evaluate")
        state = prov._state
        f = r.forces
        fsum = float(f.sum(0).abs().max())
        fabs = float(f.abs().sum(0).max())
        if not (bool(torch.isfinite(f).all()) and bool(torch.isfinite(r.energy))):
            fail(f"{phase} request {i}: non-finite result")
        if r.diagnostics["overflow"] or prov.growths:
            fail(f"{phase} request {i}: capacity overflow")
        if fsum > 1e-4 * fabs:
            fail(f"{phase} request {i}: |sum F| {fsum} > 1e-4 sum|F| {fabs}")
        times.append((kind, ms))
        print(json.dumps({"phase": phase, "req": i, "kind": kind, "ms": ms,
                          "energy": float(r.energy), "sum_F": fsum,
                          "sum_abs_F": fabs}), flush=True)
    if times[-1][0] != "rebuild":
        fail(f"{phase}: the last drift did not trigger a rebuild")
    return times


def phase_requests(model, params):
    """The single-domain path: 4 evaluate-only requests and one rebuild."""
    from repro_torch import kernels
    from repro_torch.core import DeepmdForceProvider
    coords, types, box = system(N_PATH, SEED)
    prov = DeepmdForceProvider(model, params, np.arange(N_PATH), types, box,
                               N_PATH, nbr_capacity=model.cfg.descriptor.sel,
                               skin=SKIN, device=DEVICE)
    requests = drifts(coords, 4, SEED + 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times = run_requests(prov, requests, "requests")
    counts = kernels.launch_counts()
    profile_request(prov, requests[-1])         # evaluate-only after rebuild
    if any(counts[k] == 0 for k in SINGLE_DOMAIN_KERNELS):
        fail(f"a kernel of the path was never launched: {counts}")
    if counts["cell_filter"]:
        fail(f"the single-domain path launched cell_filter: {counts}")
    evals = [ms for kind, ms in times if kind == "evaluate"]
    print(json.dumps({"phase": "requests", "atoms": N_PATH,
                      "K": prov.nbr_capacity,
                      "evaluate_ms_median": statistics.median(evals),
                      "rebuild_ms": times[-1][1],
                      "first_ms": times[0][1],
                      "max_memory_allocated_MiB":
                          torch.cuda.max_memory_allocated() / 2 ** 20,
                      "launches": counts}), flush=True)
    return counts


def cutoff_pairs(rcut, n, seed):
    """Pairs (p, q) whose float32 d^2 = (dx*dx + dy*dy) + dz*dz lands on
    fp32(rcut*rcut) or one ulp either side of it (numpy float32 arithmetic,
    no FMA).  Returns p (n, 3), q (n, 3) and the expected flags d^2 < thr."""
    thr = np.float32(rcut * rcut)
    targets = {np.nextafter(thr, np.float32(0)), thr,
               np.nextafter(thr, np.float32(np.inf))}
    rng = np.random.default_rng(seed)
    ps, qs, want = [], [], []
    while len(ps) < n:
        p = rng.uniform(0.5, 7.5, 3).astype(np.float32)
        u = rng.normal(size=3)
        q = (p + rcut * u / np.linalg.norm(u)).astype(np.float32)
        for step in range(-64, 65):
            qq = q.copy()
            qq[0] = q[0] + np.float32(step) * np.spacing(q[0])
            d = qq - p
            d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
            if d2 in targets:
                ps.append(p)
                qs.append(qq)
                want.append(d2 < thr)
    return np.array(ps[:n]), np.array(qs[:n]), np.array(want[:n])


def cell_filter_bound(idx, mask=None):
    """Least time of one cell_filter call: the int32 indices of the rows
    whose mask is > 0 read (a row masked out has all flags 0: its indices
    are not needed; every row without ``mask``) and the (R, M) one-byte
    flags written, plus 16 bytes of coordinates and mask per row, at the
    card's memory rate."""
    r, m = idx.shape
    live = r if mask is None else int((mask > 0).sum())
    return (live * m * 4 + r * m + r * 16) / HBM_RATE * 1e3, "bytes"


def check_cell_filter(rcut):
    """The kernel against its plain version on pairs placed at the cutoff
    and one ulp either side: flags equal bit for bit, and equal to the
    float32 comparison numpy makes."""
    from repro_torch.kernels import cell_filter as cf
    p, q, want = cutoff_pairs(rcut, 3000, SEED + 5)
    m = len(p)
    xyz = torch.tensor(np.concatenate([p, q]), device=DEVICE)
    idx = torch.full((2 * m, 2), -1, dtype=torch.int32, device=DEVICE)
    idx[:m, 0] = torch.arange(m, 2 * m, device=DEVICE, dtype=torch.int32)
    idx[:m, 1] = torch.arange(m, device=DEVICE, dtype=torch.int32)  # self
    mask = torch.ones(2 * m, device=DEVICE)
    got = cf.cell_filter(xyz, idx, mask, rcut)
    plain = cf.cell_filter_plain(xyz, idx, mask, rcut)
    if not torch.equal(got, plain):
        fail(f"cell_filter at the cutoff ({rcut}): {int((got != plain).sum())}"
             " flags differ from the plain version")
    if not np.array_equal(got[:m, 0].cpu().numpy(), want) or got[:, 1].any():
        fail(f"cell_filter at the cutoff ({rcut}): flags differ from the "
             "float32 comparison")
    print(json.dumps({"phase": "dd", "case": "cell_filter pairs at the cutoff",
                      "rcut": rcut, "pairs": m, "inside": int(want.sum()),
                      "equal_bitwise": True}), flush=True)


def record_cell_filter(fn):
    """Run ``fn()`` with the DD path's ``cell_filter`` replaced by one that
    records its arguments and launches; returns (fn's result, [args])."""
    from repro_torch.core import ddinfer, pipeline
    from repro_torch.kernels import cell_filter as cf
    calls = []

    def record(*args):
        calls.append(args)
        return cf.cell_filter(*args)

    ddinfer.cell_filter = pipeline.cell_filter = record
    try:
        res = fn()
    finally:
        ddinfer.cell_filter = pipeline.cell_filter = cf.cell_filter
    return res, calls


def check_cell_filter_calls(calls, phase, sites=("assembly", "refilter")):
    """The recorded calls of one assembly and one evaluate (the cell-list
    assembly, then the evaluation's re-filter; or the given ``sites``)
    against the plain version bit for bit, with times.  Returns {site:
    line}."""
    from repro_torch.kernels import cell_filter as cf
    if len(calls) != len(sites):
        fail(f"{phase}: expected {len(sites)} cell_filter calls {sites}, "
             f"got {len(calls)}")
    rows = {}
    for site, args in zip(sites, calls):
        got = cf.cell_filter(*args)
        plain = cf.cell_filter_plain(*args)
        if not torch.equal(got, plain):
            fail(f"{phase} cell_filter ({site}): "
                 f"{int((got != plain).sum())} flags differ from the plain "
                 "version")
        del got, plain
        torch.cuda.empty_cache()
        bound = cell_filter_bound(args[1], args[2])
        rows[site] = {"phase": phase, "name": "cell_filter", "site": site,
                      "rows": args[1].shape[0], "M": args[1].shape[1],
                      "max_err": 0.0, "tol": "exact",
                      "kernel_ms": time_ms(lambda: cf.cell_filter(*args)),
                      "plain_ms": time_ms(lambda: cf.cell_filter_plain(*args)),
                      "bound_ms": bound[0], "bound_by": bound[1],
                      "bound_ms_all_rows": cell_filter_bound(args[1])[0],
                      "rows_masked_out": int((args[2] <= 0).sum())}
        rows[site]["share_of_bound"] = bound[0] / rows[site]["kernel_ms"]
        print(json.dumps(rows[site]), flush=True)
    return rows


def frozen_drift(coords, box, dims, halo, scale=2e-4, seed=SEED + 6):
    """An in-bound random step with the atoms near a (uniform) plane or a
    plane +- the halo frozen, so no local/ghost set changes (stale == fresh
    holds bit for bit only while the selection sets stay)."""
    frozen = np.zeros(len(coords), bool)
    for a in range(3):
        length = float(box[a])
        planes = np.linspace(0.0, length, dims[a] + 1)
        crit = np.concatenate([planes % length, (planes + halo) % length,
                               (planes - halo) % length])
        d = np.abs(coords[:, a][:, None] - crit[None, :])
        frozen |= (np.minimum(d, length - d) < 1e-3).any(1)
    step = np.random.default_rng(seed).uniform(-scale, scale, coords.shape)
    step[frozen] = 0.0
    return np.mod(coords + step, box).astype(np.float32)


FORCE_SCATTER = (("force_scatter", "force_scatter"),)
MODEL_KERNELS = (("env_mat", "env_mat_fwd"), ("env_mat", "env_mat_bwd"),
                 ("nbr_attn", "nbr_attention_stack_fwd"),
                 ("nbr_attn", "nbr_attention_stack_bwd")) + FORCE_SCATTER


def record_model_kernels(fn, which=MODEL_KERNELS, keep=None):
    """Run ``fn()`` with each named kernel wrapper (module, name) replaced
    by one that records (args, kwargs, outputs) of every call (with
    ``keep``, only the calls i of a kernel for which ``keep(name, i)``);
    returns (fn's result, {name: [calls]}).  The wrappers still launch;
    their counts, which they keep on the module-level name, go back to
    them afterwards."""
    from repro_torch import kernels
    mods = {m: getattr(kernels, m) for m, _ in which}
    seen = {name: [] for _, name in which}
    originals = {name: getattr(mods[m], name) for m, name in which}

    made = {name: 0 for _, name in which}

    def recorder(name):
        def rec(*args, **kw):
            out = originals[name](*args, **kw)
            if keep is None or keep(name, made[name]):
                seen[name].append((args, kw, out))
            made[name] += 1
            return out
        rec.launches = 0
        return rec

    for m, name in which:
        setattr(mods[m], name, recorder(name))
    try:
        res = fn()
    finally:
        for m, name in which:
            originals[name].launches += getattr(mods[m], name).launches
            setattr(mods[m], name, originals[name])
    return res, seen


def scatter_calls_by_shape(fn):
    """Run ``fn()`` with ``force_scatter`` replaced by a wrapper that tallies
    its calls by the (rows, K) of their index table and calls through, so
    the launches of a run split by call site; returns (fn's result,
    {(rows, K): calls}).  The launches go back to the wrapper's count."""
    from repro_torch.kernels import force_scatter as fs
    original, tally = fs.force_scatter, {}

    def rec(g, idx, mask, n):
        shape = tuple(idx.shape)
        tally[shape] = tally.get(shape, 0) + 1
        return original(g, idx, mask, n)

    rec.launches = 0
    fs.force_scatter = rec
    try:
        res = fn()
    finally:
        fs.force_scatter = original
        original.launches += rec.launches
    return res, tally


def scatter_bound(idx, mask, n, with_list=False, entry_bytes=4):
    """Least time of the force scatter: the valid slots' 12-byte cotangent
    rows and their reverse-list entries read, the offsets read (one entry
    per atom), the (n, 3) sums written; ``with_list`` adds idx and mask
    read once (what building the list needs).  The list's entries and
    offsets are 4 bytes (int32); ``entry_bytes=8`` gives the bound of an
    int64 list, as counted before the list became int32."""
    valid = int(((idx >= 0) & (mask > 0)).sum())
    nbytes = (12 + entry_bytes) * valid + entry_bytes * (n + 1) + 12 * n
    if with_list:
        nbytes += idx.numel() * (idx.element_size() + mask.element_size())
    return nbytes / HBM_RATE * 1e3, "bytes"


def check_force_scatter(g, idx, mask, n, edge=False, library=True,
                        profile=False):
    """The force scatter on one force call's cotangents ``g`` (C, K, 3):
    the kernel bit for bit against the plain version (on CPU copies: on the
    card ``index_add_`` adds with atomics) and on a repeat, and ``g``
    exactly 0 at every masked or padded slot (the kernel skips them, so its
    sums are the full scatter's only then); with ``edge`` also all slots
    masked and N = 0.  Times (median of 10, L2 flushed): the reverse list's
    build, the kernel on it, both, the plain version on the card, and
    PyTorch's indexing backward (``index_put_`` with accumulate, what
    autograd runs for ``coords[safe]``) with padded slots at atom 0 and,
    where row i holds atom i's slots (C == n, the gather's backward), at
    their own atom; ``library=False`` leaves out those two timings (each
    padded slot an atomic add on atom 0: seconds a call at tens of
    millions of padded slots) and times PyTorch's call on the valid slots
    alone instead.  With ``profile``, one call under
    ``torch.profiler`` splits its device time by kernel (the list's sort
    passes, offsets and sums).  The card's list (``_build_list``) is held
    against ``reverse_list`` element for element; ``reverse_list_ms`` times
    the card's list, ``plain_list_ms`` ``reverse_list`` (a stable
    ``torch.sort``, the card's list before it was written by hand).
    Returns a dict of the numbers."""
    from repro_torch.kernels import force_scatter as fs
    got = fs.force_scatter(g, idx, mask, n)
    want = fs.force_scatter_plain(g.cpu(), idx.cpu(), mask.cpu(), n)
    if not torch.equal(got.cpu(), want):
        fail(f"force_scatter: {int((got.cpu() != want).any(1).sum())} atoms "
             "differ from the plain version")
    if not torch.equal(fs.force_scatter(g, idx, mask, n), got):
        fail("force_scatter: a repeat differs")
    skipped = g[~((idx >= 0) & (mask > 0))]
    skipped_max = float(skipped.abs().max()) if skipped.numel() else 0.0
    if skipped_max != 0.0:
        fail(f"force_scatter: cotangent up to {skipped_max:.3e} at a masked "
             "or padded slot, which the kernel skips")
    del skipped
    if edge:
        zero = fs.force_scatter(g, idx, torch.zeros_like(mask), n)
        if tuple(zero.shape) != (n, 3) or bool(zero.any()):
            fail("force_scatter: nonzero sums with every slot masked")
        if tuple(fs.force_scatter(g[:0], idx[:0], mask[:0], 0).shape) != (0, 3):
            fail("force_scatter: wrong shape at N = 0")
    c, k = idx.shape
    # the card's list (the hand-written sort) against the plain one
    rl = fs._build_list(idx, mask, n)
    want_perm, want_off = fs.reverse_list(idx, mask, n)
    valid = int(want_off[-1]) if n else 0
    if not (torch.equal(rl[1].long(), want_off)
            and torch.equal(rl[0][:valid].long(), want_perm[:valid])):
        fail("force_scatter: the card's reverse list differs from "
             "reverse_list")
    del want_perm, want_off
    bound = scatter_bound(idx, mask, n)
    line = {"valid_slots": valid,
            "padded_slots": int((idx < 0).sum()),
            "masked_slots": int(((idx >= 0) & ~(mask > 0)).sum()),
            "repeat_bitwise": True, "list_equal_reverse_list": True,
            "masked_slot_cotangent_max_abs": skipped_max,
            "kernel_ms": time_ms(lambda: fs._launch(g, *rl, n)),
            "reverse_list_ms": time_ms(lambda: fs._build_list(idx, mask, n)),
            "kernel_with_list_ms": time_ms(
                lambda: fs.force_scatter(g, idx, mask, n)),
            "plain_ms": time_ms(lambda: fs.force_scatter_plain(g, idx, mask, n)),
            "plain_list_ms": time_ms(lambda: fs.reverse_list(idx, mask, n)),
            "bound_ms": bound[0], "bound_by": bound[1],
            "bound_with_list_ms": scatter_bound(idx, mask, n, True)[0],
            "bound_ms_int64_list": scatter_bound(idx, mask, n,
                                                 entry_bytes=8)[0],
            "bound_with_list_ms_int64_list": scatter_bound(
                idx, mask, n, True, entry_bytes=8)[0]}
    del rl
    if profile:
        line["profile_kernel_ms"] = device_profile(
            lambda: fs.force_scatter(g, idx, mask, n), "force_scatter_profile",
            f"one force_scatter call over {c} x {k} slots onto {n} atoms")
    if edge:
        line["all_masked_zero_and_empty"] = True

    def index_put(safe, vals=g):
        return torch.zeros(n, 3, device=g.device).index_put_(
            (safe,), vals, accumulate=True)

    if not library:
        # every padded slot an atomic add on atom 0 would take seconds: the
        # library call on the valid slots alone (compacted before timing)
        sel = (idx >= 0) & (mask > 0)
        g_valid, i_valid = g[sel], idx[sel].long()
        line.update({
            "library_ms": time_ms(lambda: index_put(i_valid, g_valid)),
            "library_max_abs_err": float((index_put(i_valid, g_valid).cpu()
                                          - want).abs().max()) if n else 0.0,
            "library": "zeros.index_put_((idx[valid],), g[valid], "
                       "accumulate=True): the valid slots only, compacted "
                       "before the timing"})
        return line

    safe_zero = torch.where(idx >= 0, idx.long(), torch.zeros_like(idx.long()))
    line.update({
        "library_ms": time_ms(lambda: index_put(safe_zero)),
        "library_max_abs_err": float((index_put(safe_zero).cpu() - want)
                                     .abs().max()) if n else 0.0,
        "library": "zeros.index_put_((safe,), g, accumulate=True), the "
                   "backward of coords[safe]; padded slots at atom 0"})
    if c == n:
        own = torch.arange(c, device=idx.device)[:, None].expand(c, k)
        safe_own = torch.where((idx >= 0) & (mask > 0), idx.long(), own)
        line["library_own_index_ms"] = time_ms(lambda: index_put(safe_own))
        line["library"] += (", and (library_own_index_ms) every masked or "
                            "padded slot at its own atom")
    return line


def check_rows(name, got, plain, n, padded, chunk=8192):
    """Hold kernel outputs ``got`` against ``plain(r0, r1)`` (the plain
    version's outputs on rows r0:r1) chunk by chunk: each output within
    atol 1e-4 * max|plain| over all rows.  An output is (tensor, row axis),
    or a function of (r0, r1) giving its part for those rows.  Returns the
    largest error over all rows and over the rows flagged in ``padded``
    (N,) of the (tensor, row axis) outputs."""
    errs = [0.0] * len(got)
    pad_errs = [0.0] * len(got)
    scales = [0.0] * len(got)
    for r0 in range(0, n, chunk):
        r1 = min(n, r0 + chunk)
        rows_pad = padded[r0:r1]
        for i, (out, want) in enumerate(zip(got, plain(r0, r1))):
            ax = None if callable(out) else out[1]
            part = out(r0, r1) if ax is None else out[0].narrow(ax, r0,
                                                                 r1 - r0)
            if not part.numel():      # rows with no valid slot
                continue
            if not bool(torch.isfinite(part).all()):
                fail(f"{name}[{i}]: non-finite output in rows {r0}:{r1}")
            err = (part - want).abs()
            errs[i] = max(errs[i], float(err.max()))
            scales[i] = max(scales[i], float(want.abs().max()))
            if ax is not None and bool(rows_pad.any()):
                pad = err.movedim(ax, 0)[rows_pad]
                pad_errs[i] = max(pad_errs[i], float(pad.max()))
    for i, (err, scale) in enumerate(zip(errs, scales)):
        if err > 1e-4 * scale:
            fail(f"{name}[{i}]: max err {err:.3e} > 1e-4 * max|plain| "
                 f"{scale:.3e} at the DD path's shape")
    return max(errs), max(pad_errs)


@torch.no_grad()
def check_dd_model_kernels(seen, phase="dd",
                           scatter_cases=("gather_backward",
                                          "force_reduction")):
    """The five model kernels against their plain versions on the exact
    tensors one DD evaluate gave them (all ranks' capacity rows, padded
    rows included): env_mat whole, the attention stack in row chunks, the
    force scatter's calls (``scatter_cases``: the gather's backward, then
    the reduction of the ranks' forces onto the atoms; a single-domain call
    has the first only) bit for bit.  Lines and failures carry ``phase``.
    Returns the force scatter's lines, {case: line}."""
    from repro_torch.kernels import nbr_attn, ref
    for name, calls in seen.items():
        want_calls = len(scatter_cases) if name == "force_scatter" else 1
        if len(calls) != want_calls:
            fail(f"{phase} evaluate: {name} launched {len(calls)} times, "
                 f"expected {want_calls}")
    args, _, out = seen["env_mat_fwd"][0]
    mask = args[3]
    n, k = mask.shape
    padded = mask.sum(1) == 0
    lines = []

    def pad_err(outs, wants):
        if not bool(padded.any()):
            return 0.0
        return max(float((o - w).abs()[padded].max())
                   for o, w in zip(outs, wants))

    want = ref.env_mat_ref(*args)
    err = max(check(f"{phase} env_mat_fwd[{i}]", o, w, rtol=1e-5,
                    atol=1e-6 * float(w.abs().max()))
              for i, (o, w) in enumerate(zip(out, want)))
    lines.append(("env_mat_fwd", err, pad_err(out, want),
                  "rtol 1e-5, atol 1e-6*max"))
    args, _, out = seen["env_mat_bwd"][0]
    want = ref.env_mat_bwd_ref(*args)
    err = max(check(f"{phase} env_mat_bwd[{i}]", o, w, rtol=2e-4, atol=5e-5)
              for i, (o, w) in enumerate(zip(out, want)))
    lines.append(("env_mat_bwd", err, pad_err(out, want),
                  "rtol 2e-4, atol 5e-5"))
    del want

    args, kw, (out, stash) = seen["nbr_attention_stack_fwd"][0]
    attn, opts = args[:12], args[12:]
    # the card's autograd keeps the valid rows' stash for the force path;
    # the plain version (a CPU rehearsal) keeps the dense one
    rows_kept = DEVICE == "cuda"
    if kw.get("stash") != ("rows" if rows_kept else True) or \
            tuple(attn[5].shape) != (n, k):
        fail(f"{phase} evaluate: the attention forward saw another list or kept "
             "another stash")
    if rows_kept:
        x, rows = stash.x, stash.rows
    else:
        rows = nbr_attn.compact_rows(attn[5])[3]
        x = nbr_attn.compact_stash(stash, rows)
    layers, m = x.shape[0], x.shape[2]

    def atoms(r0, r1):
        """The stacked rows of atoms r0:r1 (positions in x) and their flat
        slots counted from atom r0."""
        sel = torch.nonzero((rows >= r0 * k) & (rows < r1 * k)).reshape(-1)
        return sel, rows[sel] - r0 * k

    def plain_fwd(r0, r1):
        o, s = ref.nbr_attention_stack_ref(*[a[r0:r1] for a in attn[:6]],
                                           *attn[6:], *opts, stash=True)
        return o, s.reshape(layers, -1, m)[:, atoms(r0, r1)[1]]

    err, pad = check_rows(f"{phase} nbr_attention_stack_fwd",
                          [(out, 0), lambda r0, r1: x[:, atoms(r0, r1)[0]]],
                          plain_fwd, n, padded)
    lines.append(("nbr_attention_stack_fwd", err, pad,
                  "atol 1e-4*max|plain| per output (out, stash of the "
                  "valid rows)"))

    args, kw, got = seen["nbr_attention_stack_bwd"][0]
    st, planes, weights, dout = args[0], args[1:6], args[6:12], args[12]
    if (st.x if rows_kept else st).data_ptr() != \
            (stash.x if rows_kept else stash).data_ptr():
        fail(f"{phase} evaluate: the attention backward did not take the "
             "forward's stash")

    def plain_bwd(r0, r1):
        sel, slots = atoms(r0, r1)
        dense = nbr_attn.dense_stash(attn[0][r0:r1], x[:, sel], slots)
        res = ref.nbr_attention_stack_bwd_ref(
            dense, *[p[r0:r1] for p in planes], *weights,
            dout[r0:r1], heads=kw["heads"],
            compute_dtype=kw["compute_dtype"])
        return res[:5]

    err, pad = check_rows(f"{phase} nbr_attention_stack_bwd",
                          [(t, 0) for t in got[:5]], plain_bwd, n, padded)
    lines.append(("nbr_attention_stack_bwd", err, pad,
                  "atol 1e-4*max|plain| per output (dg drx dry drz dsw)"))
    for name, err, pad, tol in lines:
        print(json.dumps({"phase": phase, "name": name,
                          "case": "inputs of one DD evaluate",
                          "rows": n, "K": k,
                          "fully_masked_rows": int(padded.sum()),
                          "stash_elements": x.numel(),
                          "dense_stash_elements": layers * n * k * m,
                          "max_err": err,
                          "fully_masked_rows_max_err": pad, "tol": tol}),
              flush=True)
    scatter = {}
    for case, (args, _, _) in zip(scatter_cases, seen["force_scatter"]):
        rows_k = tuple(args[1].shape)
        if case == "gather_backward" and rows_k != (n, k):
            fail(f"{phase} evaluate: the first force scatter took {rows_k} slots, "
                 f"not the model's ({n}, {k})")
        if case == "force_reduction" and rows_k[1] != 1:
            fail(f"{phase} evaluate: the second force scatter took {rows_k} slots,"
                 " not one per force row")
        scatter[case] = {"phase": phase, "name": "force_scatter",
                         "case": f"{case}, inputs of one DD evaluate",
                         "rows": rows_k[0], "K": rows_k[1], "atoms": args[3],
                         "max_err": 0.0, "tol": "exact (bitwise)",
                         **check_force_scatter(*args)}
        print(json.dumps(scatter[case]), flush=True)
    return scatter


def to_cpu(obj):
    """A copy of ``obj`` with every tensor in it (through dicts, lists,
    tuples, named tuples and dataclasses) detached and on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_cpu(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_cpu(v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_cpu(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


def save_fig12_mismatch(pipe, params, x, t, probe_out, fn_out):
    """Both results of a fused DD call that differed, the inputs, and each
    stage's context (the pipeline's stages run one by one, as the prefix
    probes run them), saved to ``build/diagnostics/fig12_mismatch.pt``
    beside this script; returns the path."""
    shards, types_p = pipe._shard(pipe._in(x), t)
    ctx = {"params": params, "coords_shard": shards, "types_all": types_p}
    stages = {}
    for stage in pipe.stages:
        stage.body(ctx)
        stages[stage.name] = to_cpu({k: v for k, v in ctx.items()
                                     if k != "params"})
    out = Path(__file__).resolve().parent / "build" / "diagnostics"
    out.mkdir(parents=True, exist_ok=True)
    path = out / "fig12_mismatch.pt"
    torch.save({"probe_force_reduce": to_cpu(probe_out),
                "force_fn": to_cpu(fn_out), "coords": to_cpu(x),
                "types": to_cpu(t), "params": to_cpu(params),
                "stages": stages}, path)
    return path


def fig12_split(pipe, params, x, t):
    """The paper's Fig.-12 phase split of one fused force call: the prefix
    probes of ``pipe`` (gather, assembly, inference, force_reduce; the last
    is the fused force function itself, bit for bit) timed by
    ``obs.timed_prefix_phases`` (median of 3, synchronised)."""
    from repro_torch.obs import ObsConfig, Tracer, report, timed_prefix_phases
    probes = pipe.build_phase_probes()
    probe_out = probes["force_reduce"](params, x, t)
    fn_out = pipe.build_force_fn()(params, x, t)
    (e0, f0, _), (e1, f1, _) = probe_out, fn_out
    if not (torch.equal(e0, e1) and torch.equal(f0, f1)):
        path = save_fig12_mismatch(pipe, params, x, t, probe_out, fn_out)
        fail("dd fig12: the last phase probe differs from the force "
             f"function; both results, the inputs and each stage's "
             f"tensors are saved in {path}")
    tracer = Tracer(ObsConfig(enabled=True))
    split = timed_prefix_phases(
        tracer, {k: (lambda fn=fn: fn(params, x, t))
                 for k, fn in probes.items()})
    frac = report.stage_fractions(tracer.events)
    print(json.dumps({"phase": "dd", "fig12_split_ms":
                      {k: v * 1e3 for k, v in split.items()},
                      "fig12_shares": {k: a["fraction"]
                                       for k, a in frac.items()},
                      "fused_call_ms": sum(split.values()) * 1e3,
                      "paper": "> 90% of the time in inference",
                      "probe_is": "the pipeline run through the phase, "
                                  "median of 3 synchronised calls; a "
                                  "phase's ms is its probe's minus the "
                                  "previous probe's"}), flush=True)
    del probes
    torch.cuda.empty_cache()


def phase_dd(model, params):
    """The virtual domain decomposition on this card: 8 ranks, the same
    15,668-atom system and model as phase 3."""
    from repro_torch import kernels
    from repro_torch.core import (DeepmdForceProvider, ForcePipeline,
                                  single_domain_forces, suggest_config)
    coords, types, box = system(N_PATH, SEED)
    rcut = model.cfg.descriptor.rcut
    sel = model.cfg.descriptor.sel
    t0 = time.perf_counter()
    cfgs = {fm: suggest_config(N_PATH, box, N_RANKS, rcut, nbr_capacity=sel,
                               skin=SKIN, force_mode=fm, coords=coords)
            for fm in ("owner_full", "ghost_reduce")}
    cfg = cfgs["owner_full"]
    print(json.dumps({"phase": "dd", "config": dataclasses.asdict(cfg),
                      "suggest_config_s": time.perf_counter() - t0}),
          flush=True)
    x = torch.tensor(coords, device=DEVICE)
    t = torch.tensor(types, device=DEVICE)

    # -- cell_filter at the path's shapes: record its inputs at both call
    #    sites (cell-list assembly, evaluation re-filter) during one call
    pipe = ForcePipeline(model, cfg, box, N_PATH)
    (e_of, f_of, d_of), calls = record_cell_filter(
        lambda: pipe.build_force_fn()(params, x, t))
    rows = check_cell_filter_calls(calls, "dd")
    del calls
    torch.cuda.empty_cache()
    for r in (rcut, rcut + SKIN):
        check_cell_filter(r)

    # -- contracts inside the port
    out = {("owner_full", "cells"): (e_of, f_of, d_of)}
    for fm, c in cfgs.items():
        for method in ("cells", "dense"):
            if (fm, method) in out:
                continue
            fn = ForcePipeline(model, dataclasses.replace(c, nbr_method=method),
                               box, N_PATH).build_force_fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[(fm, method)] = fn(params, x, t)
            torch.cuda.synchronize()
            print(json.dumps({"phase": "dd", "fused_call": [fm, method],
                              "ms": (time.perf_counter() - t0) * 1e3}),
                  flush=True)
    for fm in cfgs:
        (e_c, f_c, d_c), (e_d, f_d, _) = out[(fm, "cells")], out[(fm, "dense")]
        if float(e_c) != float(e_d) or not torch.equal(f_c, f_d):
            fail(f"dd {fm}: cells != dense (dE {float(e_c - e_d):.3e}, "
                 f"max dF {float((f_c - f_d).abs().max()):.3e})")
        if int(d_c["overflow"]):
            fail(f"dd {fm}: overflow {int(d_c['overflow'])}")
    e_sd, f_sd = single_domain_forces(model, params, x, t,
                                      torch.tensor(box, device=DEVICE), sel)
    fmax = float(f_sd.abs().max())
    gate = {}
    for fm in cfgs:
        e, f, _ = out[(fm, "cells")]
        if abs(float(e) - float(e_sd)) > 1e-5 * abs(float(e_sd)):
            fail(f"dd {fm}: E {float(e)} vs single domain {float(e_sd)}")
        gate[fm] = check(f"dd {fm} forces vs single domain", f, f_sd,
                         atol=1e-4 * fmax)
        fsum, fabs = float(f.sum(0).abs().max()), float(f.abs().sum(0).max())
        if fsum > 1e-4 * fabs:
            fail(f"dd {fm}: |sum F| {fsum} > 1e-4 sum|F| {fabs}")
    del out
    torch.cuda.empty_cache()
    asm, ev = pipe.build_assembly_fn(), pipe.build_evaluation_fn()
    st0 = asm(x, t)
    moved = torch.tensor(frozen_drift(coords, box, cfg.grid_dims,
                                      cfg.halo_eff), device=DEVICE)
    # the model kernels on the exact tensors this evaluate gives them
    (e_stale, f_stale, d_stale), seen = record_model_kernels(
        lambda: ev(params, moved, st0))
    dd_scatter = check_dd_model_kernels(seen)
    del seen
    torch.cuda.empty_cache()
    e_fresh, f_fresh, _ = ev(params, moved, asm(moved, t))
    if float(e_stale) != float(e_fresh) or not torch.equal(f_stale, f_fresh):
        fail("dd: stale state != fresh assembly inside skin/2")
    if bool(d_stale["needs_rebuild"]):
        fail("dd: a drift of 2e-4 nm asked for a rebuild")
    g = cfg.n_ranks
    local = st0.l_mask.reshape(g, -1).sum(1).cpu().tolist()
    ghost = st0.g_mask.reshape(g, -1).sum(1).cpu().tolist()
    del st0, f_stale, f_fresh
    torch.cuda.empty_cache()
    print(json.dumps({"phase": "dd", "cells_equal_dense_bitwise": True,
                      "stale_equal_fresh_bitwise": True,
                      "E_single": float(e_sd), "E_owner_full": float(e_of),
                      "F_max_abs_err_vs_single": gate,
                      "F_tol": "atol 1e-4*max|F|", "E_tol": "rtol 1e-5"}),
          flush=True)
    fig12_split(pipe, params, x, t)

    # -- requests through the provider
    prov = DeepmdForceProvider(model, params, np.arange(N_PATH), types, box,
                               N_PATH, dd_config=cfg, device=DEVICE)
    requests = drifts(coords, 3, SEED + 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = prov.assemble(x)
    torch.cuda.synchronize()
    asm_ms = (time.perf_counter() - t0) * 1e3
    device_profile(lambda: prov.assemble(x), "dd_assembly_profile",
                   "one cell-list assembly (8 ranks)", host_ops=True)
    kernels.reset_launch_counts()
    prov.evaluate(torch.tensor(requests[0], device=DEVICE), state)
    per_call = kernels.launch_counts()
    del state
    prov._state = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times = run_requests(prov, requests, "dd_requests")
    counts = kernels.launch_counts()
    profile_request(prov, requests[-1], "dd_profile")  # evaluate-only
    if any(counts[k] == 0 for k in DP_KERNELS):
        fail(f"dd: a kernel of the path was never launched: {counts}")
    evals = [ms for kind, ms in times if kind == "evaluate"]
    c = cfg.local_capacity + cfg.ghost_capacity
    print(json.dumps({
        "phase": "dd", "atoms": N_PATH, "ranks": g, "grid": cfg.grid_dims,
        "force_mode": cfg.force_mode, "K_build": cfg.nbr_capacity,
        "K_eval": cfg.k_eval, "evaluate_ms_median": statistics.median(evals),
        "rebuild_ms": times[-1][1], "first_ms": times[0][1],
        "assembly_ms": asm_ms,
        "max_memory_allocated_MiB": torch.cuda.max_memory_allocated() / 2 ** 20,
        "local_per_rank": local, "ghost_per_rank": ghost,
        "ghost_over_local": sum(ghost) / sum(local),
        "rows_per_rank_capacity": c, "model_rows": g * c,
        "launches": counts, "launches_per_evaluate_call": per_call}),
        flush=True)
    return rows["refilter"], counts, per_call, dd_scatter


# ---------------------------------------------------------------------------
# dd_procs: the DD force path over processes (torch.distributed)
# ---------------------------------------------------------------------------

PROCS_GROUP_S = 60        # seconds a rendezvous or collective may wait
PROCS_CHILD_S = 300       # seconds a group of child processes may take
PROCS_REPS = 5            # timed evaluate calls per case
PROCS_MD_STEPS = 10
PROCS_DIR = Path(__file__).resolve().parent / "build" / "dd_procs"
PROCS_INT_DIAG = ("local_count", "ghost_count", "cost_max", "rank_cost",
                  "rank_nonfinite", "overflow")
PROCS_LEAVES = ("l_idx", "l_mask", "g_idx", "g_shift", "g_mask",
                "buf_types", "buf_mask", "nbr_idx", "nbr_mask")


def same_bits(a, b) -> bool:
    """Bit for bit, through tuples, lists, dicts and dataclasses."""
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a, b))
    if isinstance(a, dict):
        return list(a) == list(b) and all(same_bits(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same_bits(u, v) for u, v in zip(a, b))
    if dataclasses.is_dataclass(a):
        return all(same_bits(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    return a == b


def procs_inputs(model):
    """The dd phase's system (15,668 atoms) and its four configurations
    (both force modes x both reduce modes), the evaluated positions (a
    drift inside skin/4) and a rebuild-triggering one."""
    from repro_torch.core import suggest_config
    coords, types, box = system(N_PATH, SEED)
    rcut, sel = model.cfg.descriptor.rcut, model.cfg.descriptor.sel
    cfgs = {}
    for fm in ("owner_full", "ghost_reduce"):
        cfg = suggest_config(N_PATH, box, N_RANKS, rcut, nbr_capacity=sel,
                             skin=SKIN, force_mode=fm, coords=coords)
        for rm in ("all_reduce", "reduce_scatter"):
            cfgs[f"{fm}-{rm}"] = dataclasses.replace(cfg, reduce_mode=rm)
    moved, far = drifts(coords, 1, SEED + 3)
    return coords, types, box, cfgs, moved, far


def procs_force_path(model, params, mesh, inputs):
    """Every entry function of the pipeline in each configuration, on
    ``mesh`` (None: the virtual ranks): the fused call, the assembly, an
    evaluate reusing it, the rebuild check inside and beyond the skin; on
    CPU copies."""
    from repro_torch.core import ForcePipeline
    coords, types, box, cfgs, moved, far = inputs
    x, t = (torch.tensor(a, device=DEVICE) for a in (coords, types))
    xm, xf = (torch.tensor(a, device=DEVICE) for a in (moved, far))
    out = {}
    for mode, cfg in cfgs.items():
        pipe = ForcePipeline(model, cfg, box, N_PATH, mesh=mesh)
        st = pipe.build_assembly_fn()(x, t)
        check_fn = pipe.build_check_fn()
        out[mode] = to_cpu({
            "fused": pipe.build_force_fn()(params, x, t), "state": st,
            "eval": pipe.build_evaluation_fn()(params, xm, st),
            "check": (check_fn(xm, st), check_fn(xf, st))})
        del pipe, st
        torch.cuda.empty_cache()
    return out


def procs_timed(mesh, fn, reps):
    """``reps`` calls of ``fn`` (each after a barrier, so the processes
    start together), CUDA events around each, the mesh's collectives
    recorded by tag: ms per call and the paper's Fig.-12 split per call
    (inference: the call less its collectives; collective 1: the
    coordinates' all-gather; collective 2: the forces' reduction; the
    per-rank scalars' gather apart)."""
    import torch.distributed as dist
    fn()                                               # warm
    calls = []
    if mesh is not None:
        mesh.record = []
    for _ in range(reps):
        if mesh is not None:
            dist.barrier()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        calls.append((start, end))
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e in calls]
    line = {"ms_per_call_median": statistics.median(ms), "ms_per_call": ms}
    if mesh is None:
        return line
    coll = {k: v / reps for k, v in mesh.collective_ms().items()}
    mesh.record = None
    per_call = sum(ms) / reps
    c1, c2 = coll.pop("gather", 0.0), coll.pop("force_reduce", 0.0)
    other = sum(coll.values())
    infer = per_call - c1 - c2 - other
    line["fig12_ms"] = {"inference": infer, "collective_1": c1,
                        "collective_2": c2, "other_collectives": coll}
    line["fig12_shares"] = {"inference": infer / per_call,
                            "collective_1": c1 / per_call,
                            "collective_2": c2 / per_call,
                            "other_collectives": other / per_call}
    return line


def procs_md(model, params, mesh):
    """``PROCS_MD_STEPS`` MD steps of ``DeepmdForceProvider`` + ``MDEngine``
    over ``mesh`` on the md phase's 62,210-atom stand-in (8 ranks, skin
    0.05), a window a step: the positions after every step (CPU), ms per
    step, the engine's rebuild counts and the kernels' launches in the
    run."""
    from repro_torch import kernels
    from repro_torch.core import DeepmdForceProvider, suggest_config
    from repro_torch.md import (EngineConfig, MDEngine,
                                build_solvated_protein, mark_nn_group)
    system_, pos, nn = build_solvated_protein(MD_RESIDUES, device=DEVICE)
    system_ = mark_nn_group(system_, nn)
    box = system_.box.cpu().numpy()
    coords_nn = pos[torch.as_tensor(nn, device=DEVICE)].cpu().numpy()
    dd = suggest_config(len(nn), box, N_RANKS, model.cfg.descriptor.rcut,
                        nbr_capacity=model.cfg.descriptor.sel, skin=SKIN,
                        coords=coords_nn)
    prov = DeepmdForceProvider(model, params, nn, system_.types, box,
                               system_.n_atoms, dd_config=dd, mesh=mesh,
                               device=mesh.device)
    eng = MDEngine(system_, EngineConfig(**MD_CFG), special_force=prov)
    start = eng.init_state(pos, 200.0)
    stamps, traj, marks = [], [], []

    def observe(s, o):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        traj.append(s.positions.cpu())
        marks.append(rebuild_marks(eng))

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = eng.run(start, PROCS_MD_STEPS, observe=observe, observe_every=1)
    counts = kernels.launch_counts()
    check_finite_state(f"dd_procs md (process {mesh.index})", st)
    steps = [((stamps[i] - stamps[i - 1]) * 1e3, marks[i] != marks[i - 1])
             for i in range(1, len(stamps))]
    return {"positions": traj, "wall_ms": (stamps[-1] - t0) * 1e3,
            **step_split(steps), "grid": dd.grid_dims,
            "diagnostics": {k: eng.diagnostics[k] for k in (
                "displacement_rebuilds", "special_rebuilds",
                "cadence_rebuilds", "capacity_growths", "special_growths")},
            "launches": counts}


def procs_run(model, params, mesh, inputs, check_kernels):
    """What each process of a group runs: the force path in every
    configuration, the overlap evaluate against the sequential one bit for
    bit, the model kernels against their plain versions on this process's
    evaluate (``check_kernels``), the timed calls and the MD run."""
    from repro_torch.core import ForcePipeline
    coords, types, box, cfgs, moved, _ = inputs
    out = {"process": mesh.index, "device": str(mesh.device),
           "force_path": procs_force_path(model, params, mesh, inputs)}
    x, t = (torch.tensor(a, device=DEVICE) for a in (coords, types))
    xm = torch.tensor(moved, device=DEVICE)
    cfg = cfgs["owner_full-all_reduce"]
    pipe = ForcePipeline(model, cfg, box, N_PATH, mesh=mesh)
    st = pipe.build_assembly_fn()(x, t)
    ev = pipe.build_evaluation_fn()
    over = ForcePipeline(model, dataclasses.replace(cfg, overlap=True), box,
                         N_PATH, mesh=mesh).build_evaluation_fn()
    (e_o, f_o, d_o), (e, f, d) = over(params, xm, st), ev(params, xm, st)
    if not same_bits((e_o, f_o, {k: d_o[k] for k in d}), (e, f, d)):
        fail(f"dd_procs process {mesh.index}: overlap != sequential")
    out["interior_frac"] = float(d_o["interior_frac"])
    out["overlap_equal_sequential_bitwise"] = True
    if check_kernels:
        _, seen = record_model_kernels(lambda: ev(params, xm, st))
        out["kernel_checks"] = check_dd_model_kernels(
            seen, phase=f"dd_procs process {mesh.index}")
        del seen
    fused = pipe.build_force_fn()
    out["evaluate"] = procs_timed(mesh, lambda: ev(params, xm, st),
                                  PROCS_REPS)
    out["fused"] = procs_timed(mesh, lambda: fused(params, x, t), 2)
    del pipe, st, ev, over, fused
    torch.cuda.empty_cache()
    out["md"] = procs_md(model, params, mesh)
    return out


def dd_procs_child(task_path, rank):
    """One process of a ``dd_procs`` or ``ensemble_procs`` group
    (``chip_smoke.py --dd-procs-child TASK RANK``): joins the group through
    ``file://`` rendezvous, runs :func:`procs_run` (or, with ``shards`` in
    the task, :func:`ens_procs_run` on the 2-D mesh) on its card and saves
    the result beside ``TASK``."""
    import torch.distributed as dist
    from repro_torch.dp import DPModel, paper_dpa1_config
    from repro_torch.launch.mesh import make_dd_mesh, make_ensemble_mesh
    task = torch.load(task_path, weights_only=False)
    dev = torch.device("cuda", task["devices"][rank])
    torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=PROCS_GROUP_S)
    dist.init_process_group(
        task["backend"], init_method=f"file://{task['rendezvous']}",
        rank=rank, world_size=task["world"], timeout=timeout)
    try:
        model = DPModel(paper_dpa1_config(ntypes=4, rcut=0.6, sel=64),
                        device=dev)
        params = model.init_params(torch.Generator().manual_seed(SEED))
        if task.get("shards"):
            mesh = make_ensemble_mesh(task["shards"], N_RANKS, device=dev,
                                      backend=task["backend"],
                                      timeout=timeout)
            out = ens_procs_run(model, params, mesh, task["case"])
        else:
            mesh = make_dd_mesh(N_RANKS, device=dev, backend=task["backend"])
            out = procs_run(model, params, mesh, procs_inputs(model),
                            check_kernels=True)
        torch.save(out, f"{task_path}.out{rank}")
    finally:
        dist.destroy_process_group()
    return 0


def procs_spawn(case, world, backend, devices, shards=0):
    """Start ``world`` child processes of this script on ``devices`` (a
    ``dd_procs`` group, or with ``shards`` an ``ensemble_procs`` one) and
    wait for all; any child's failure, or a group still running after
    ``PROCS_CHILD_S`` seconds, kills every child and fails the phase."""
    task = PROCS_DIR / f"{case}.pt"
    torch.save({"world": world, "backend": backend, "devices": devices,
                "shards": shards, "case": case,
                "rendezvous": str(PROCS_DIR / f"{case}.rendezvous")}, task)
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               "--dd-procs-child", str(task), str(r)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    deadline = time.perf_counter() + PROCS_CHILD_S
    logs = {}
    try:
        for r, p in enumerate(procs):
            logs[r] = p.communicate(
                timeout=max(deadline - time.perf_counter(), 1.0))[0]
    except subprocess.TimeoutExpired:
        fail(f"procs {case}: the {world} processes did not finish in "
             f"{PROCS_CHILD_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        for line in logs[r].splitlines():
            if line.startswith("{"):
                print(line, flush=True)          # the children's kernel lines
        if p.returncode != 0:
            fail(f"procs {case}: process {r} exited {p.returncode}:\n"
                 f"{logs[r][-6000:]}")
    return [torch.load(f"{task}.out{r}", weights_only=False)
            for r in range(world)]


def procs_gates(case, outs, virtual, bitwise):
    """Each process against the virtual path (``bitwise``: every output
    bit for bit; else E and F within the DP gate and every integer output
    exactly, each process's state leaves the virtual state's rows of its
    ranks), and the processes against each other: the same E, F and
    diagnostics, and the same MD positions after every step."""
    world = len(outs)
    errs = {}
    for p, out in enumerate(outs):
        for mode, v in virtual.items():
            got = out["force_path"][mode]
            if bitwise:
                if not same_bits(got, v):
                    fail(f"dd_procs {case} {mode}: not the virtual path's "
                         "bits")
                continue
            st, vst = got["state"], v["state"]
            for name in PROCS_LEAVES:
                leaf = getattr(vst, name)
                rows = leaf.shape[0] // world
                if not torch.equal(getattr(st, name),
                                   leaf[p * rows:(p + 1) * rows]):
                    fail(f"dd_procs {case} {mode}: process {p}'s {name} is "
                         "not the virtual state's rows of its ranks")
            for name in ("l_slot", "local_count", "ghost_count", "cost_max",
                         "overflow", "ref"):
                if not torch.equal(getattr(st, name), getattr(vst, name)):
                    fail(f"dd_procs {case} {mode}: state {name} differs")
            if [bool(c) for c in got["check"]] != [False, True]:
                fail(f"dd_procs {case} {mode}: rebuild checks "
                     f"{got['check']}")
            for call in ("fused", "eval"):
                (e, f, d), (e0, f0, d0) = got[call], v[call]
                for key in PROCS_INT_DIAG:
                    if not torch.equal(d[key], d0[key]):
                        fail(f"dd_procs {case} {mode} {call}: {key} "
                             f"{d[key]} != {d0[key]}")
                if abs(float(e) - float(e0)) > 1e-5 * abs(float(e0)):
                    fail(f"dd_procs {case} {mode} {call}: E {float(e)} vs "
                         f"{float(e0)}")
                err = check(f"dd_procs {case} {mode} {call} F", f, f0,
                            atol=1e-4 * float(f0.abs().max()))
                errs[f"{mode} {call}"] = max(errs.get(f"{mode} {call}", 0.0),
                                             err)
    for out in outs[1:]:
        for mode in virtual:
            if not same_bits(out["force_path"][mode]["fused"],
                             outs[0]["force_path"][mode]["fused"]) or \
                    not same_bits(out["force_path"][mode]["eval"],
                                  outs[0]["force_path"][mode]["eval"]):
                fail(f"dd_procs {case} {mode}: the processes' E, F or "
                     "diagnostics differ")
        md, md0 = out["md"], outs[0]["md"]
        if len(md["positions"]) != PROCS_MD_STEPS or not all(
                torch.equal(a, b) for a, b in zip(md["positions"],
                                                  md0["positions"])):
            fail(f"dd_procs {case}: the processes' MD positions differ")
        if md["diagnostics"] != md0["diagnostics"]:
            fail(f"dd_procs {case}: rebuild counts differ: "
                 f"{md['diagnostics']} vs {md0['diagnostics']}")
    for out in outs:
        missing = [k for k in DP_KERNELS if out["md"]["launches"][k] == 0]
        if missing:
            fail(f"dd_procs {case}: process {out['process']}'s MD run "
                 f"launched no {missing}")
    return errs


def procs_report(case, outs, smi, errs=None, **extra):
    """One line per process (ms per force call and per MD step, the Fig.-12
    split, launches) and the case's line."""
    for out in outs:
        md = out["md"]
        print(json.dumps({
            "phase": "dd_procs", "case": case, "process": out["process"],
            "device": out["device"], "card": smi,
            "evaluate": out["evaluate"], "fused_call": out["fused"],
            "md": {k: v for k, v in md.items() if k != "positions"},
            "launches_md_run": md["launches"]}), flush=True)
    split = [o["evaluate"]["fig12_ms"] for o in outs]
    print(json.dumps({"phase": "dd_procs", "case": case,
                      "processes": len(outs), "card": smi,
                      "evaluate_ms_median_by_process": [
                          o["evaluate"]["ms_per_call_median"] for o in outs],
                      "md_step_ms_median_by_process": [
                          o["md"]["step_ms_median"] for o in outs],
                      # the last process to reach a collective waits least:
                      # its time is closest to the transfer alone
                      "evaluate_collective_ms_min_over_processes": {
                          k: min(f[k] for f in split)
                          for k in ("collective_1", "collective_2")},
                      "evaluate_inference_share_by_process": [
                          o["evaluate"]["fig12_shares"]["inference"]
                          for o in outs],
                      "F_max_abs_err_vs_virtual": errs,
                      "paper": "> 90% of the time in inference, < 10% in "
                               "the collectives (Fig. 12)",
                      **extra}), flush=True)


def phase_dd_procs(model, params, smi):
    """The DD force path over ``torch.distributed`` processes on the dd
    phase's system and model, 8 ranks: (i) one process through an NCCL
    group, bit for bit the virtual path; (ii) two processes sharing this
    card over gloo (CUDA tensors through host copies), 4 ranks each,
    within the DP gate of the virtual path, the same bits on both, 10 MD
    steps the same on both; (iii) more than one card over NCCL, or a line
    saying why not.  Returns the launches of each case's MD run."""
    import shutil

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_dd_mesh
    t_phase = time.perf_counter()
    shutil.rmtree(PROCS_DIR, ignore_errors=True)
    PROCS_DIR.mkdir(parents=True)
    inputs = procs_inputs(model)
    virtual = procs_force_path(model, params, None, inputs)
    launches = {}

    # (i) one process through the process-group path
    dist.init_process_group(
        "nccl", init_method=f"file://{PROCS_DIR / 'one.rendezvous'}",
        rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=PROCS_GROUP_S))
    try:
        mesh = make_dd_mesh(N_RANKS, device=torch.device(
            "cuda", torch.cuda.current_device()))
        one = procs_run(model, params, mesh, inputs, check_kernels=False)
    finally:
        dist.destroy_process_group()
    procs_gates("nccl_1_process", [one], virtual, bitwise=True)
    procs_report("nccl_1_process", [one], smi,
                 bitwise_equal_virtual=True,
                 overlap_equal_sequential_bitwise=True)
    launches["nccl_1_process"] = [one["md"]["launches"]]
    del one
    torch.cuda.empty_cache()

    # (ii) two processes sharing this card: gloo on CUDA tensors
    card = torch.cuda.current_device()
    outs = procs_spawn("gloo_2_processes", 2, "gloo", [card, card])
    errs = procs_gates("gloo_2_processes", outs, virtual, bitwise=False)
    procs_report("gloo_2_processes", outs, smi, errs,
                 processes_bit_identical=True,
                 md_positions_bit_identical_every_step=True,
                 E_tol="rtol 1e-5", F_tol="atol 1e-4*max|F|")
    launches["gloo_2_processes"] = [o["md"]["launches"] for o in outs]
    del outs

    # (iii) more than one card: NCCL, one card a process
    n_cards = torch.cuda.device_count()
    world = max((w for w in (2, 4, 8) if w <= n_cards), default=0)
    if world:
        case = f"nccl_{world}_cards"
        outs = procs_spawn(case, world, "nccl", list(range(world)))
        errs = procs_gates(case, outs, virtual, bitwise=False)
        procs_report(case, outs, smi, errs, processes_bit_identical=True,
                     md_positions_bit_identical_every_step=True)
        launches[case] = [o["md"]["launches"] for o in outs]
        del outs
    else:
        print(json.dumps({
            "phase": "dd_procs", "case": "nccl_multi_card", "ran": False,
            "why": f"{n_cards} CUDA device(s) here: NCCL takes one card a "
                   "process and refuses two ranks on one device, so the "
                   "multi-card case needs at least 2 cards"}), flush=True)
    shutil.rmtree(PROCS_DIR, ignore_errors=True)
    print(json.dumps({"phase": "dd_procs",
                      "s": time.perf_counter() - t_phase}), flush=True)
    return launches


# ---------------------------------------------------------------------------
# ensemble_procs: replicas on devices, the 2-D (replica x dd) process layout
# ---------------------------------------------------------------------------

ENS_PROCS_STEPS = 10      # REMD steps per case


def ens_procs_setup(model):
    """The md phase's stand-in (62,210 atoms, 15,668 DP atoms), its
    ``ENS_R`` replicas (the ensemble phase's), the 8-rank DD configuration
    (skin 0.05) and the geometric ladder; the DP group's inputs in model
    units at the replicas' positions, drifted inside skin/4, and with one
    atom of replica 1 moved by the skin."""
    from repro_torch.core import suggest_config
    from repro_torch.ensemble import geometric_ladder
    from repro_torch.md import build_solvated_protein, mark_nn_group
    from repro_torch.md.integrators import wrap
    msys, pos, nn = build_solvated_protein(MD_RESIDUES, device=DEVICE)
    msys = mark_nn_group(msys, nn)
    box = msys.box.cpu().numpy()
    nn_t = torch.as_tensor(nn, device=DEVICE)
    dd = suggest_config(len(nn), box, N_RANKS, model.cfg.descriptor.rcut,
                        nbr_capacity=model.cfg.descriptor.sel, skin=SKIN,
                        coords=pos[nn_t].cpu().numpy())
    xs = replica_positions(pos, msys.box, ENS_R)
    x = wrap(xs[:, nn_t], msys.box)          # the provider's model input
    step = np.random.default_rng(SEED + 8).uniform(-1, 1, tuple(x.shape))
    moved = wrap(x + torch.tensor((step * 0.2 * SKIN / np.sqrt(3)).astype(
        np.float32), device=DEVICE), msys.box)
    far = moved.clone()
    far[1, 0, 0] += SKIN
    return {"msys": msys, "pos": pos, "nn": nn, "box": box, "dd": dd,
            "x": x, "t": msys.types[nn_t], "moved": moved,
            "far": wrap(far, msys.box),
            "temps": geometric_ladder(*ENS_LADDER, ENS_R)}


def ens_procs_force_path(model, params, mesh, s):
    """The replica-batched pipeline's entry functions on all ``ENS_R``
    replicas over ``mesh`` (None: the virtual replicas and ranks): the
    fused call, the assembly, an evaluate reusing it at the drifted
    positions, the rebuild check there and beyond the skin; on CPU
    copies."""
    from repro_torch.core import ForcePipeline
    pipe = ForcePipeline(model, s["dd"], s["box"], len(s["nn"]),
                         n_replicas=ENS_R, mesh=mesh)
    st = pipe.build_assembly_fn()(s["x"], s["t"])
    check_fn = pipe.build_check_fn()
    out = to_cpu({"fused": pipe.build_force_fn()(params, s["x"], s["t"]),
                  "state": st,
                  "eval": pipe.build_evaluation_fn()(params, s["moved"], st),
                  "check": (check_fn(s["moved"], st), check_fn(s["far"], st))})
    del pipe, st
    torch.cuda.empty_cache()
    return out


def ens_procs_remd(model, params, mesh, s):
    """``ENS_PROCS_STEPS`` REMD steps (``EnsembleEngine`` +
    ``BatchedDeepmdProvider`` over ``mesh``, the geometric ladder,
    exchange every ``ENS_EXCHANGE`` steps, a window a step): positions and
    ladder after every step (CPU), ms per step, the collectives' ms by tag
    per step, the engine's rebuild and exchange counts, the kernels'
    launches and the peak memory of the run."""
    from repro_torch import kernels
    from repro_torch.ensemble import (BatchedDeepmdProvider, EnsembleConfig,
                                      EnsembleEngine)
    from repro_torch.md import EngineConfig
    msys, temps = s["msys"], s["temps"]
    prov = BatchedDeepmdProvider(model, params, s["nn"], msys.types, s["box"],
                                 msys.n_atoms, n_replicas=ENS_R,
                                 dd_config=s["dd"], mesh=mesh,
                                 device=mesh.device)
    eng = EnsembleEngine(msys, EngineConfig(**{**MD_CFG,
                                               "thermostat_t": temps[0]}),
                         EnsembleConfig(n_replicas=ENS_R, temps=temps,
                                        exchange_interval=ENS_EXCHANGE),
                         special_force=prov)
    start = eng.init_state(s["pos"])
    stamps, traj, ladders, marks = [], [], [], []

    def observe(st, o):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        traj.append(st.positions.cpu())
        ladders.append(st.ladder.cpu())
        marks.append(rebuild_marks(eng))

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mesh.record = []
    t0 = time.perf_counter()
    st = eng.run(start, ENS_PROCS_STEPS, observe=observe, observe_every=1)
    counts = kernels.launch_counts()
    coll = mesh.collective_ms()
    mesh.record = None
    peak = torch.cuda.max_memory_allocated()
    check_finite_state(f"ensemble_procs remd (process {mesh.index})", st)
    steps = [((stamps[i] - stamps[i - 1]) * 1e3, marks[i] != marks[i - 1])
             for i in range(1, len(stamps))]
    d = eng.diagnostics
    return {"positions": traj, "ladders": ladders,
            "wall_ms": (stamps[-1] - t0) * 1e3, **step_split(steps),
            "collective_ms_per_step": {k: v / ENS_PROCS_STEPS
                                       for k, v in coll.items()},
            "diagnostics": {k: d[k] for k in (
                "displacement_rebuilds", "special_rebuilds",
                "cadence_rebuilds", "capacity_growths", "special_growths")},
            "exchange": {"attempts": d["exchange_attempts"],
                         "accepts": d["exchange_accepts"],
                         "pair_attempts": d["pair_attempts"].tolist(),
                         "pair_accepts": d["pair_accepts"].tolist(),
                         "final_ladder": st.ladder.tolist()},
            "peak_MiB": peak / 2 ** 20, "launches": counts}


def ens_procs_run(model, params, mesh, case, s=None):
    """What each process of an ``ensemble_procs`` group runs: the force
    path, its kernels against their plain versions on its own assembly
    and evaluate (its resident replicas and ranks), the timed evaluate and
    the REMD run."""
    from repro_torch.core import ForcePipeline
    s = s or ens_procs_setup(model)
    out = {"process": mesh.index, "cell": [mesh.replica_index,
                                           mesh.dd.index],
           "device": str(mesh.device),
           "force_path": ens_procs_force_path(model, params, mesh, s)}
    pipe = ForcePipeline(model, s["dd"], s["box"], len(s["nn"]),
                         n_replicas=ENS_R, mesh=mesh)
    asm, ev = pipe.build_assembly_fn(), pipe.build_evaluation_fn()
    (_, seen), cf_calls = record_cell_filter(
        lambda: record_model_kernels(
            lambda: ev(params, s["moved"], asm(s["x"], s["t"]))))
    phase = f"ensemble_procs {case} process {mesh.index}"
    out["kernel_checks"] = {
        "force_scatter": check_dd_model_kernels(seen, phase),
        "cell_filter": check_cell_filter_calls(cf_calls, phase)}
    del seen, cf_calls
    torch.cuda.empty_cache()
    st = asm(s["x"], s["t"])
    out["evaluate"] = procs_timed(mesh, lambda: ev(params, s["moved"], st),
                                  PROCS_REPS)
    del pipe, asm, ev, st
    torch.cuda.empty_cache()
    out["remd"] = ens_procs_remd(model, params, mesh, s)
    return out


def ens_procs_gates(case, outs, virtual, bitwise):
    """Each process against the virtual R x 8 pipeline (``bitwise``: every
    output bit for bit; else E and F within the DP gate and every integer
    output exactly, each process's state leaves the virtual state's rows
    of its resident replicas and ranks), only replica 1 flagged beyond the
    skin, and the processes against each other: the same E, F, diagnostics
    and flags, and the same REMD positions, ladders and counts after every
    step.  Returns the largest F error against virtual."""
    shards = 1 + max(o["cell"][0] for o in outs)
    wd, rl = len(outs) // shards, ENS_R // shards
    err = 0.0
    for out in outs:
        got = out["force_path"]
        rs, col = out["cell"]
        reps = slice(rs * rl, (rs + 1) * rl)
        if [c.tolist() for c in got["check"]] != [
                [False] * ENS_R, [r == 1 for r in range(ENS_R)]]:
            fail(f"ensemble_procs {case}: rebuild flags {got['check']}")
        if bitwise:
            if not same_bits(got, virtual):
                fail(f"ensemble_procs {case}: not the virtual pipeline's "
                     "bits")
            continue
        st, vst = got["state"], virtual["state"]
        for name in PROCS_LEAVES:
            leaf = getattr(vst, name)[reps]
            rows = leaf.shape[1] // wd
            if not torch.equal(getattr(st, name),
                               leaf[:, col * rows:(col + 1) * rows]):
                fail(f"ensemble_procs {case}: process {out['process']}'s "
                     f"{name} is not the virtual state's rows of its "
                     "replicas and ranks")
        for name in ("l_slot", "ref"):
            if not torch.equal(getattr(st, name), getattr(vst, name)[reps]):
                fail(f"ensemble_procs {case}: state {name} differs")
        for name in ("local_count", "ghost_count", "cost_max", "overflow"):
            if not torch.equal(getattr(st, name), getattr(vst, name)):
                fail(f"ensemble_procs {case}: state {name} differs")
        for call in ("fused", "eval"):
            (e, f, d), (e0, f0, d0) = got[call], virtual[call]
            for key in PROCS_INT_DIAG:
                if not torch.equal(d[key], d0[key]):
                    fail(f"ensemble_procs {case} {call}: {key} {d[key]} != "
                         f"{d0[key]}")
            if bool(((e - e0).abs() > 1e-5 * e0.abs()).any()):
                fail(f"ensemble_procs {case} {call}: E {e.tolist()} vs "
                     f"{e0.tolist()}")
            err = max(err, check(f"ensemble_procs {case} {call} F", f, f0,
                                 atol=1e-4 * float(f0.abs().max())))
    first = outs[0]
    for out in outs[1:]:
        for call in ("fused", "eval", "check"):
            if not same_bits(out["force_path"][call],
                             first["force_path"][call]):
                fail(f"ensemble_procs {case}: the processes' {call} "
                     "results differ")
        md, md0 = out["remd"], first["remd"]
        for key in ("positions", "ladders"):
            if not all(torch.equal(a, b) for a, b in zip(md[key], md0[key])):
                fail(f"ensemble_procs {case}: the processes' REMD {key} "
                     "differ")
        for key in ("diagnostics", "exchange"):
            if md[key] != md0[key]:
                fail(f"ensemble_procs {case}: REMD {key} differ: {md[key]} "
                     f"vs {md0[key]}")
    for out in outs:
        md = out["remd"]
        if len(md["positions"]) != ENS_PROCS_STEPS or \
                sorted(md["exchange"]["final_ladder"]) != list(range(ENS_R)):
            fail(f"ensemble_procs {case}: {len(md['positions'])} steps, "
                 f"ladder {md['exchange']['final_ladder']}")
        missing = [k for k in DP_KERNELS if md["launches"][k] == 0]
        if missing:
            fail(f"ensemble_procs {case}: process {out['process']}'s REMD "
                 f"run launched no {missing}")
    return err


def ens_procs_report(case, outs, smi, err=None, **extra):
    """One line per process (ms per force call and per ensemble step, the
    collectives by tag, the inference share, peak memory, launches) and
    the case's line."""
    for out in outs:
        md = out["remd"]
        print(json.dumps({
            "phase": "ensemble_procs", "case": case,
            "process": out["process"], "cell": out["cell"],
            "device": out["device"], "card": smi,
            "evaluate": out["evaluate"],
            "remd": {k: v for k, v in md.items()
                     if k not in ("positions", "ladders")}}), flush=True)
    ev = [o["evaluate"] for o in outs]
    print(json.dumps({
        "phase": "ensemble_procs", "case": case, "processes": len(outs),
        "layout": {"replica": 1 + max(o["cell"][0] for o in outs),
                   "dd": N_RANKS, "replicas": ENS_R,
                   "processes_on_dd_axis": 1 + max(o["cell"][1]
                                                   for o in outs)},
        "card": smi,
        "ensemble_step_ms_median_by_process": [
            o["remd"]["step_ms_median"] for o in outs],
        "force_call_ms_median_by_process": [
            e["ms_per_call_median"] for e in ev],
        "force_call_collective_ms_by_tag_by_process": [
            {"gather": e["fig12_ms"]["collective_1"],
             "force_reduce": e["fig12_ms"]["collective_2"],
             **e["fig12_ms"]["other_collectives"]} for e in ev],
        "ensemble_step_collective_ms_by_tag_by_process": [
            o["remd"]["collective_ms_per_step"] for o in outs],
        "force_call_inference_share_by_process": [
            e["fig12_shares"]["inference"] for e in ev],
        "remd_peak_MiB_by_process": [o["remd"]["peak_MiB"] for o in outs],
        "exchange": outs[0]["remd"]["exchange"],
        "F_max_abs_err_vs_virtual": err,
        "classical_work": "every process integrates all replicas: the "
                          "classical forces, lists and integration of R = "
                          f"{ENS_R} replicas",
        **extra}), flush=True)


def phase_ensemble_procs(model, params, smi):
    """Replicas on devices: ``ENS_R`` replicas of the stand-in x 8 DD ranks
    over the 2-D ``(replica x dd)`` process layout of
    ``ensemble.make_ensemble_mesh``: (i) one process through an NCCL group
    as (1, 1), bit for bit the virtual pipeline; (ii) two processes sharing
    this card over gloo as (2, 1), 2 replicas each; (iii) with 4 cards (2,
    2) over NCCL, else a line saying why not.  Returns the launches of
    each case's REMD run, per process."""
    import shutil

    import torch.distributed as dist
    from repro_torch.ensemble import make_ensemble_mesh
    t_phase = time.perf_counter()
    shutil.rmtree(PROCS_DIR, ignore_errors=True)
    PROCS_DIR.mkdir(parents=True)
    s = ens_procs_setup(model)
    virtual = ens_procs_force_path(model, params, None, s)
    launches = {}

    # (i) one process, (1, 1)
    timeout = datetime.timedelta(seconds=PROCS_GROUP_S)
    dist.init_process_group(
        "nccl", init_method=f"file://{PROCS_DIR / 'ens_one.rendezvous'}",
        rank=0, world_size=1, timeout=timeout)
    try:
        mesh = make_ensemble_mesh(1, N_RANKS, device=torch.device(
            "cuda", torch.cuda.current_device()), timeout=timeout)
        one = ens_procs_run(model, params, mesh, "nccl_1_process", s)
    finally:
        dist.destroy_process_group()
    del s
    torch.cuda.empty_cache()
    ens_procs_gates("nccl_1_process", [one], virtual, bitwise=True)
    ens_procs_report("nccl_1_process", [one], smi,
                     bitwise_equal_virtual=True)
    launches["nccl_1_process"] = [one["remd"]["launches"]]
    del one

    # (ii) two processes sharing this card: gloo on CUDA tensors, (2, 1)
    card = torch.cuda.current_device()
    outs = procs_spawn("ens_gloo_2_processes", 2, "gloo", [card, card],
                       shards=2)
    err = ens_procs_gates("gloo_2_processes", outs, virtual, bitwise=False)
    ens_procs_report("gloo_2_processes", outs, smi, err,
                     processes_bit_identical=True,
                     remd_bit_identical_every_step=True,
                     E_tol="rtol 1e-5", F_tol="atol 1e-4*max|F|")
    launches["gloo_2_processes"] = [o["remd"]["launches"] for o in outs]
    del outs

    # (iii) four cards: NCCL, one card a process, (2, 2)
    n_cards = torch.cuda.device_count()
    if n_cards >= 4:
        outs = procs_spawn("ens_nccl_4_cards", 4, "nccl", [0, 1, 2, 3],
                           shards=2)
        err = ens_procs_gates("nccl_4_cards", outs, virtual, bitwise=False)
        ens_procs_report("nccl_4_cards", outs, smi, err,
                         processes_bit_identical=True,
                         remd_bit_identical_every_step=True)
        launches["nccl_4_cards"] = [o["remd"]["launches"] for o in outs]
        del outs
    else:
        print(json.dumps({
            "phase": "ensemble_procs", "case": "nccl_4_cards", "ran": False,
            "why": f"{n_cards} CUDA device(s) here: the (2, 2) layout takes "
                   "4 processes and NCCL one card a process"}), flush=True)
    shutil.rmtree(PROCS_DIR, ignore_errors=True)
    print(json.dumps({"phase": "ensemble_procs",
                      "s": time.perf_counter() - t_phase}), flush=True)
    return launches


# ---------------------------------------------------------------------------
# md: the MD engine driving the DP provider (the main path's third stage)
# ---------------------------------------------------------------------------

MD_RESIDUES = 3_917       # the 1HCI stand-in: 15,668 DP atoms (md/system.py)
MD_WARM, MD_STEPS, MD_DD_STEPS = 5, 20, 10
MD_SMALL = 40             # residues of the card-vs-CPU and cells-vs-dense runs
# examples/protein_md.py's engine settings
MD_CFG = dict(cutoff=0.9, neighbor_capacity=96, dt=0.0005, thermostat_t=200.0)
MD_POS_TOL = 1e-5         # nm: tests/test_torch_engine.py's gate against JAX
STATE_KEYS = ("positions", "velocities", "forces", "step")


def same_state(a, b):
    return all(torch.equal(getattr(a, k), getattr(b, k)) for k in STATE_KEYS)


def check_finite_state(name, st):
    for k in ("positions", "velocities", "forces"):
        if not bool(torch.isfinite(getattr(st, k)).all()):
            fail(f"{name}: non-finite {k}")


def rebuild_marks(eng):
    """The engine's rebuild and growth counters: a step rebuilt a list iff
    they differ before and after it."""
    d = eng.diagnostics
    return (d["displacement_rebuilds"], d["special_rebuilds"],
            d["cadence_rebuilds"], len(d["capacity_growths"]),
            d["special_growths"])


def md_run(eng, start, n, per_step=True):
    """``eng.run(start, n)`` on the host clock; with ``per_step`` every step
    ends at a host boundary (``observe_every=1``) where the card is
    synchronised, the clock read, and the memory read: allocated at the
    boundary, and the peak since the last boundary (then reset).  Returns (state, wall ms, [(ms,
    rebuilt)] for steps 2..n: step 1 also carries the pre-loop build,
    {"allocated": [bytes], "peak": [bytes]} per step)."""
    stamps, marks = [], []
    mem = {"allocated": [], "peak": []}

    def observe(s, o):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        marks.append(rebuild_marks(eng))
        mem["allocated"].append(torch.cuda.memory_allocated())
        mem["peak"].append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st = eng.run(start, n, observe=observe if per_step else None,
                 observe_every=1)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    steps = [((stamps[i] - stamps[i - 1]) * 1e3, marks[i] != marks[i - 1])
             for i in range(1, len(stamps))]
    return st, wall, steps, mem


def profile_run_step(eng, start):
    """Step 2 of ``eng.run(start, 2)``, the step as ``md_run`` times it
    (windows of one step, its host boundary included), under
    ``torch.profiler``: the profiler starts at the boundary after step 1
    and stops at the one after step 2.  Returns (prof, wall ms, whether
    step 2 rebuilt a list)."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    seen = []

    def observe(s, o):
        torch.cuda.synchronize()
        seen.append((time.perf_counter(), rebuild_marks(eng)))
        if len(seen) == 1:
            prof.start()
            seen[0] = (time.perf_counter(), seen[0][1])
        else:
            prof.stop()

    eng.run(start, 2, observe=observe, observe_every=1)
    (t1, m1), (t2, m2) = seen
    return prof, (t2 - t1) * 1e3, m1 != m2


def fresh_step(eng, st):
    """One scan-mode window of one step from lists built at ``st``: no atom
    has moved since, so the step evaluates without a rebuild.  A synthetic
    step, built from the engine's private parts: on the hot stand-in every
    step that ``MDEngine.run`` takes rebuilds."""
    nl = eng._build_nlist_grown(st.positions)
    sp = eng._assemble_special_grown(st.positions) if eng._stateful else None
    step0 = int(st.step)
    return lambda: eng._run_segment_scan(st, nl, sp, 1, step0)


def fresh_step_ms(eng, st, reps=3):
    """Median host-clock ms (synchronised) of ``fresh_step`` over ``reps``
    runs, after one warm-up."""
    fn = fresh_step(eng, st)
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def pair_dr_forms(system, pos, caps=(96, 192, 384, 512)):
    """The classical forces at list capacities ``caps``, with the port's
    pair displacements (one (N, 2K) gather table of both ends) and with
    the reference's broadcast form ``pos[j] - pos[i]`` (j gathered through
    ``neighbor_gather``, whose backward is a sum over K): for each form,
    whether every capacity gives the same bits.  Returns {form: bool}."""
    from repro_torch.kernels.force_scatter import neighbor_gather
    from repro_torch.md import build_neighbor_list
    from repro_torch.md import forcefield as ff
    from repro_torch.md.neighbors import minimum_image

    def broadcast(p, sys_, nl):
        return minimum_image(neighbor_gather(p, nl.idx, nl.mask)
                             - p[:, None, :], sys_.box)

    table, out = ff._pair_dr, {}
    cfg = ff.ForceFieldConfig(cutoff=MD_CFG["cutoff"])
    try:
        for name, form in (("table", table), ("broadcast", broadcast)):
            ff._pair_dr = form
            forces = []
            for cap in caps:
                nl = build_neighbor_list(pos, system.box, cfg.cutoff, cap,
                                         half=True, skin=0.1,
                                         cell_cap_scale=cap / caps[0])
                if bool(nl.overflow):
                    fail(f"pair_dr_forms: the list overflows at {cap}")
                forces.append(ff.classical_forces(pos, system, nl, cfg)[1])
            out[name] = all(torch.equal(forces[0], f) for f in forces[1:])
    finally:
        ff._pair_dr = table
    return out


def step_split(steps):
    ev = [ms for ms, rebuilt in steps if not rebuilt]
    rb = [ms for ms, rebuilt in steps if rebuilt]
    return {"evaluate_only_steps": len(ev), "rebuild_steps": len(rb),
            "evaluate_only_ms_median": statistics.median(ev) if ev else None,
            "rebuild_ms_median": statistics.median(rb) if rb else None,
            "step_ms_median": statistics.median(ms for ms, _ in steps)}


def phase_md(model, params):
    """The port's MD engine on the card: the solvated 1HCI stand-in
    (``build_solvated_protein(3917)``, 62,210 atoms, the 15,668 protein
    atoms the DP group) with the classical force field on every atom and
    phases 1-4's DPA-1 on the group, one domain (skin 0.05), then 8
    virtual ranks; card vs CPU and cells vs dense at 40 residues.  Returns
    ({kernel: launches per MD step}, single domain and DD) and the classical
    pair table's force-scatter numbers."""
    from repro_torch import kernels
    from repro_torch.core import DeepmdForceProvider, suggest_config
    from repro_torch.launch import protein_md
    from repro_torch.md import (EngineConfig, MDEngine,
                                build_solvated_protein, mark_nn_group)
    from repro_torch.md.forcefield import classical_forces
    t_phase = t0 = time.perf_counter()
    system, pos, nn = build_solvated_protein(MD_RESIDUES, device=DEVICE)
    system = mark_nn_group(system, nn)
    box = system.box.cpu().numpy()
    print(json.dumps({"phase": "md", "atoms": system.n_atoms,
                      "dp_atoms": len(nn), "water": system.n_atoms - len(nn),
                      "box_nm": box.tolist(),
                      "build_s": time.perf_counter() - t0}), flush=True)
    if len(nn) != N_PATH:
        fail(f"md: DP group of {len(nn)} atoms, expected {N_PATH}")
    sel = model.cfg.descriptor.sel

    def provider(dd_config=None):
        return DeepmdForceProvider(model, params, nn, system.types, box,
                                   system.n_atoms, nbr_capacity=sel,
                                   skin=SKIN, dd_config=dd_config,
                                   device=DEVICE)

    prov = provider()

    def engine(special=prov, **kw):
        return MDEngine(system, EngineConfig(**{**MD_CFG, **kw}),
                        special_force=special)

    # -- warm-up window, then the main path: 20 scan-mode steps
    eng = engine()
    t0 = time.perf_counter()
    warm = eng.run(eng.init_state(pos, 200.0), MD_WARM)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    warm_diag = dict(eng.diagnostics)
    eng = engine()
    kernels.reset_launch_counts()
    st_a, wall_a, steps_a, mem = md_run(eng, warm, MD_STEPS)
    counts = kernels.launch_counts()
    diag_a = dict(eng.diagnostics)
    # the same run again, its force scatters tallied by call site
    eng_b = engine()
    st_b, by_shape = scatter_calls_by_shape(
        lambda: md_run(eng_b, warm, MD_STEPS)[0])
    eng_c = engine(loop_mode="step")
    st_c = eng_c.run(warm, MD_STEPS)
    eng_d = engine()
    st_d, wall_d = md_run(eng_d, warm, MD_STEPS, per_step=False)[:2]
    tm = eng_c.timings
    fig9 = {k: tm[k] * 1e3 for k in ("neighbor", "classical", "special",
                                      "integrate")}
    total = sum(fig9.values())
    mib = lambda b: b / 2 ** 20
    window = eng.config.rebuild_every       # scan mode's first window
    per_step = {k: counts[k] / MD_STEPS for k in counts}
    cap = eng.config.neighbor_capacity
    sites = {}
    for (rows, k), calls in by_shape.items():
        site = ("classical pairs" if (rows, k) == (system.n_atoms, 2 * cap)
                else {2: "bonds", 3: "angles", 4: "dihedrals"}.get(k)
                if rows < system.n_atoms else None) or \
            ("dp gather" if (rows, k) == (len(nn), prov.nbr_capacity)
             else f"{rows} x {k}")
        sites[site] = sites.get(site, 0) + calls / MD_STEPS
    if abs(sum(sites.values()) - per_step["force_scatter"]) > 1e-9:
        fail(f"md: force scatters by call site {sites} do not add up to "
             f"{per_step['force_scatter']} per step")
    split_a = step_split(steps_a)
    line = {"phase": "md", "mode": "single domain", "atoms": system.n_atoms,
            "dp_atoms": len(nn), "steps": MD_STEPS,
            "warm_up": {"steps": MD_WARM, "ms": warm_ms,
                        "capacity_growths": warm_diag["capacity_growths"]},
            "neighbor_capacity": eng.config.neighbor_capacity,
            "dp_K": prov.nbr_capacity,
            "scan_1_step_windows": {"wall_ms": wall_a, **split_a},
            "scan_10_step_windows_ms_per_step": wall_d / MD_STEPS,
            "fig9_split_ms_step_mode": fig9,
            "md_step_ms_median": split_a["step_ms_median"],
            "classical_ms_per_step_step_mode": fig9["classical"] / MD_STEPS,
            "force_scatter_launches_per_md_step_by_site": sites,
            "dp_share_of_step": fig9["special"] / total,
            "neighbor_includes": "the pre-loop build of each run",
            "diagnostics": {k: diag_a[k] for k in (
                "displacement_rebuilds", "special_rebuilds",
                "cadence_rebuilds", "capacity_growths", "special_growths",
                "window_reruns")},
            "dp_growths": prov.growths,
            "max_memory_allocated_MiB": mib(max(mem["peak"])),
            "first_window_peak_MiB": mib(max(mem["peak"][:window])),
            "peak_MiB_per_step": [mib(b) for b in mem["peak"]],
            "allocated_at_step_end_MiB": [mib(b) for b in mem["allocated"]],
            "launches": counts, "launches_per_md_step": per_step,
            "engine_host_reads_per_step_scan": 1,
            "repeat_bitwise": same_state(st_a, st_b),
            "scan_equals_step_bitwise": same_state(st_a, st_c),
            "windows_of_10_equal_windows_of_1_bitwise": same_state(st_a, st_d)}
    print(json.dumps(line), flush=True)
    check_finite_state("md scan", st_a)
    for k in SINGLE_DOMAIN_KERNELS:
        if counts[k] == 0:
            fail(f"md: {k} was never launched in {MD_STEPS} MD steps: {counts}")
    if counts["cell_filter"] or counts["flash_attention"] or \
            counts["flash_decode"]:
        fail(f"md: the single-domain MD path launched {counts}")
    for key, what in (("repeat_bitwise", "a repeat of the scan-mode steps"),
                      ("scan_equals_step_bitwise", "step mode"),
                      ("windows_of_10_equal_windows_of_1_bitwise",
                       "scan mode in windows of 10 steps")):
        if not line[key]:
            fail(f"md: {what} differs from the scan-mode run")
    # no graph or state survives a step: what stays allocated between steps
    # is the first step's, and the peak of all steps the first window's
    # (a step that rebuilds the classical list holds the old one while it
    # builds the new; the first step after a fresh build does not)
    if max(mem["allocated"]) > 1.01 * mem["allocated"][0]:
        fail(f"md: allocated memory between steps grew from "
             f"{mem['allocated'][0]} to {max(mem['allocated'])} bytes")
    if max(mem["peak"]) > 1.01 * max(mem["peak"][:window]):
        fail(f"md: peak memory {max(mem['peak'])} over {MD_STEPS} steps > "
             f"1.01 x the first window's {max(mem['peak'][:window])}")
    # the classical force field's force scatters at full width: one
    # classical_forces call at the grown capacity, its cotangents recorded,
    # each scatter against the plain version
    nl = eng.build_nlist(st_a.positions)
    nlist_bytes = sum(t.nbytes for t in (nl.idx, nl.mask, nl.ref_positions))
    seen = record_model_kernels(lambda: classical_forces(
        st_a.positions, system, nl, eng.config.ff), FORCE_SCATTER)[1]
    terms = {2: "bonds", 3: "angles", 4: "dihedrals",
             2 * nl.capacity: "pairs"}
    done = set()
    for args, _, _ in seen["force_scatter"]:
        rows, k = args[1].shape
        term = terms.get(k)
        if term is None or term in done or \
                (term == "pairs") != (rows == system.n_atoms):
            fail(f"md classical: a force scatter over {rows} x {k} slots")
        done.add(term)
        # the pair table's padded slots (tens of millions) would pile onto
        # atom 0 in the library call: it is timed on the bonded tables only
        row = {"phase": "md", "name": "force_scatter",
               "case": f"classical {term}, one full-width classical_forces "
                       "call",
               "rows": rows, "K": k, "atoms": args[3], "max_err": 0.0,
               "tol": "exact (bitwise)",
               **check_force_scatter(*args, library=term != "pairs")}
        print(json.dumps(row), flush=True)
        if term == "pairs":
            md_pairs = {key: row[key] for key in (
                "rows", "K", "kernel_ms", "reverse_list_ms",
                "kernel_with_list_ms", "bound_ms", "bound_with_list_ms",
                "plain_ms", "plain_list_ms", "bound_ms_int64_list",
                "bound_with_list_ms_int64_list")}
            md_pairs["launches_per_md_step"] = sites["classical pairs"]
            md_pairs["md_step_ms_median"] = split_a["step_ms_median"]
            md_pairs["classical_ms_per_step_step_mode"] = \
                fig9["classical"] / MD_STEPS
    if done != set(terms.values()):
        fail(f"md classical: force scatters for {sorted(done)}")
    del seen, nl
    torch.cuda.empty_cache()
    print(json.dumps({
        "phase": "md", "mode": "single domain",
        "classical_nlist_MiB": mib(nlist_bytes),
        "neighbor_capacity": eng.config.neighbor_capacity,
        "peak_rise_after_step_1_MiB": mib(max(mem["peak"][1:])
                                          - mem["peak"][0]),
        "why": "a rebuild step builds the new classical list while the old "
               "one is still referenced (MDEngine.run's loop variable and "
               "_run_segment_scan's saved window start, which a replay "
               "needs); step 1, right after the pre-loop build, builds "
               "none"}), flush=True)

    # one MD step profiled as MDEngine.run takes it (step 2 of a run of 2:
    # on the hot stand-in a rebuild step), and a synthetic evaluate-only
    # step (a window of one from freshly built lists), also timed alone
    eng_r = engine()
    prof, run_ms, rebuilt = profile_run_step(eng_r, st_a)
    kern_run = profile_report(
        prof, run_ms, "md_profile",
        "step 2 of MDEngine.run(st, 2), windows of one step: "
        + ("a rebuild step" if rebuilt else "an evaluate-only step"))
    del prof
    eng_p = engine()
    fresh_ms = fresh_step_ms(eng_p, st_a)
    kern = device_profile(fresh_step(eng_p, st_a), "md_profile",
                          "a synthetic evaluate-only scan-mode step (a "
                          "window of 1 from freshly built lists, not a step "
                          "MDEngine.run takes here)")
    for what, kk in (("the run's step", kern_run), ("the synthetic step",
                                                     kern)):
        if not kk:
            fail(f"md_profile: the profiler recorded no device time for "
                 f"{what}")
        if any("indexing_backward" in k for k in kk):
            fail(f"md_profile: {what} ran PyTorch's indexing backward")
    print(json.dumps({"phase": "md", "mode": "single domain",
                      "profiled_run_step_rebuilt": rebuilt,
                      "synthetic_evaluate_only_step_ms": fresh_ms}),
          flush=True)
    del eng, eng_b, eng_c, eng_d, eng_p, eng_r, st_b, st_c, st_d
    torch.cuda.empty_cache()

    # -- 8 virtual ranks (cell-list assembly)
    coords_nn = pos[torch.as_tensor(nn, device=DEVICE)].cpu().numpy()
    dd = suggest_config(len(nn), box, N_RANKS, model.cfg.descriptor.rcut,
                        nbr_capacity=sel, skin=SKIN, coords=coords_nn)
    dd_prov = provider(dd)
    x = warm.positions
    # one assembly and evaluate on the column's ranks, the kernels' inputs
    # recorded: each kernel against its plain version on them below
    ((e_dd, f_dd, fl_dd), seen), cf_calls = record_cell_filter(
        lambda: record_model_kernels(
            lambda: dd_prov.evaluate(x, dd_prov.assemble(x))))
    e_sd, f_sd, fl_sd = prov.evaluate(x, prov.assemble(x))
    if bool(fl_dd["overflow"]) or bool(fl_sd["overflow"]):
        fail("md dd: a capacity overflowed at the first step's positions")
    if abs(float(e_dd) - float(e_sd)) > 1e-5 * abs(float(e_sd)):
        fail(f"md dd: E_dp {float(e_dd)} vs single domain {float(e_sd)}")
    f_err = check("md dd first-step DP forces vs single domain", f_dd, f_sd,
                  atol=1e-4 * float(f_sd.abs().max()))
    check_dd_model_kernels(seen, "md dd")
    check_cell_filter_calls(cf_calls, "md dd")
    del seen, cf_calls
    torch.cuda.empty_cache()
    eng_dd = engine(special=dd_prov)
    kernels.reset_launch_counts()
    st_dd, wall_dd, steps_dd, mem_dd = md_run(eng_dd, warm, MD_DD_STEPS)
    counts_dd = kernels.launch_counts()
    dd_line = {"phase": "md", "mode": "dd", "ranks": dd.n_ranks,
               "grid": dd.grid_dims, "K_eval": dd.k_eval,
               "steps": MD_DD_STEPS, "wall_ms": wall_dd, **step_split(steps_dd),
               "synthetic_evaluate_only_step_ms": fresh_step_ms(
                   engine(special=dd_prov), st_dd),
               "first_step_dp_E": [float(e_dd), float(e_sd)],
               "first_step_dp_F_max_abs_err_vs_single": f_err,
               "F_tol": "atol 1e-4*max|F|", "E_tol": "rtol 1e-5",
               "diagnostics": {k: eng_dd.diagnostics[k] for k in (
                   "displacement_rebuilds", "special_rebuilds",
                   "cadence_rebuilds", "capacity_growths",
                   "special_growths")},
               "max_memory_allocated_MiB": max(mem_dd["peak"]) / 2 ** 20,
               "launches": counts_dd,
               "launches_per_md_step": {k: c / MD_DD_STEPS
                                        for k, c in counts_dd.items()}}
    print(json.dumps(dd_line), flush=True)
    check_finite_state("md dd", st_dd)
    for k in DP_KERNELS:
        if counts_dd[k] == 0:
            fail(f"md dd: {k} was never launched: {counts_dd}")
    del eng_dd, dd_prov, st_dd, f_dd, f_sd, system, pos, prov, warm, st_a
    torch.cuda.empty_cache()

    # -- card vs CPU at 40 residues, same start; cells == dense on the card
    small = {}
    cpu_model = type(model)(model.cfg, device="cpu")
    cpu_params = _tree(params, lambda t: t.cpu())
    start = None
    for dev, mdl, prm in ((DEVICE, model, params),
                          ("cpu", cpu_model, cpu_params)):
        s_sys, s_pos, s_nn = build_solvated_protein(MD_SMALL, device=dev)
        s_sys = mark_nn_group(s_sys, s_nn)
        s_prov = DeepmdForceProvider(mdl, prm, s_nn, s_sys.types,
                                     s_sys.box.cpu().numpy(), s_sys.n_atoms,
                                     nbr_capacity=sel, skin=SKIN, device=dev)
        s_eng = MDEngine(s_sys, EngineConfig(**MD_CFG), special_force=s_prov)
        if dev == DEVICE:
            forms = pair_dr_forms(s_sys, s_pos)
            print(json.dumps({"phase": "md", "check": "classical forces at "
                              "list capacities 96, 192, 384 and 512",
                              "residues": MD_SMALL,
                              "pair_table_equal_bitwise": forms["table"],
                              "broadcast_form_equal_bitwise":
                                  forms["broadcast"]}), flush=True)
            if not forms["table"]:
                fail("md small: the classical forces' bits depend on the "
                     "list capacity")
        if start is None:
            start = s_eng.init_state(s_pos, 200.0)
            st = start
        else:
            st = dataclasses.replace(
                start, rng=torch.Generator().manual_seed(SEED).get_state(),
                **{k: getattr(start, k).cpu() for k in STATE_KEYS})
        small[dev] = (s_eng.run(st, 10), dict(s_eng.diagnostics))
    (g, g_diag), (c, c_diag) = small[DEVICE], small["cpu"]
    check_finite_state("md small", g)
    err = check("md small: card vs CPU positions after 10 steps",
                g.positions.cpu(), c.positions, atol=MD_POS_TOL)
    if g_diag != c_diag:
        fail(f"md small: card diagnostics {g_diag} != CPU {c_diag}")
    dd_runs = {m: protein_md.main(["--residues", str(MD_SMALL), "--steps",
                                   "10", "--nbr-method", m, "--device",
                                   DEVICE], quiet=True)[0]
               for m in ("cells", "dense")}
    if not same_state(dd_runs["cells"], dd_runs["dense"]):
        fail("md small: DD trajectory with cells != dense")
    print(json.dumps({"phase": "md", "check": "card vs cpu, cells vs dense",
                      "residues": MD_SMALL, "atoms": int(g.positions.shape[0]),
                      "steps": 10, "positions_max_abs_err_nm": err,
                      "tol": f"atol {MD_POS_TOL} nm", "diagnostics_equal": True,
                      "dd_cells_equal_dense_bitwise": True}), flush=True)
    print(f"[md] {time.perf_counter() - t_phase:.1f} s", flush=True)
    return per_step, dd_line["launches_per_md_step"], md_pairs


# ---------------------------------------------------------------------------
# guard: guarded MD (fault injection, rollback-and-replay, CRC-checked
# checkpoints) and the engine's observability on the MD stand-in
# ---------------------------------------------------------------------------

GUARD_STEPS, GUARD_DD_STEPS = 10, 5
GUARD_FAULT_AT = 3          # steps into the timed run (inside its window)


def timed_run(eng, start, n):
    """``eng.run(start, n)``, synchronised: (state, wall ms, the windows'
    ms (``timings["scan"]``, the window's verdict read included))."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = eng.run(start, n)
    torch.cuda.synchronize()
    return st, (time.perf_counter() - t0) * 1e3, eng.timings["scan"] * 1e3


def phase_guard(model, params):
    """Guarded MD on the 62,210-atom stand-in at full width (the md phase's
    system, model and engine settings), 10 steps a run from a 5-step warm
    state: guards on and quiet == unguarded; an engine-level ``nan_force``
    inside the window recovers bit for bit; obs on == obs off with a trace
    that validates; ``checkpoint_every=5`` through an ``AsyncCheckpointer``
    whose newest save is truncated falls back and resumes bit for bit; on
    8 virtual ranks (5 steps) a rank-3 ``nan_force`` through the pipeline's
    fault hook recovers bit for bit.  Times each variant (ms per MD step)
    and the replayed window.  Returns ({kernel: launches} of the guarded
    single-domain path, of the guarded DD path)."""
    import os
    import tempfile
    import warnings
    from repro_torch import kernels
    from repro_torch.ckpt import AsyncCheckpointer
    from repro_torch.core import DeepmdForceProvider, suggest_config
    from repro_torch.health import FaultPlan, FaultSpec, GuardConfig
    from repro_torch.md import (EngineConfig, MDEngine,
                                build_solvated_protein, mark_nn_group)
    from repro_torch.md.engine import state_tree
    from repro_torch.obs import ObsConfig, export, report
    t_phase = time.perf_counter()
    system, pos, nn = build_solvated_protein(MD_RESIDUES, device=DEVICE)
    system = mark_nn_group(system, nn)
    box = system.box.cpu().numpy()
    sel = model.cfg.descriptor.sel

    def provider(dd_config=None, hook=None):
        return DeepmdForceProvider(model, params, nn, system.types, box,
                                   system.n_atoms, nbr_capacity=sel,
                                   skin=SKIN, dd_config=dd_config,
                                   device=DEVICE, fault_hook=hook)

    prov = provider()

    def engine(special=prov, **kw):
        cfg = {k: kw.pop(k) for k in list(kw) if k in
               ("checkpoint_every", "checkpoint_path", "loop_mode")}
        return MDEngine(system, EngineConfig(**{**MD_CFG, **cfg}),
                        special_force=special, **kw)

    eng = engine()
    warm = eng.run(eng.init_state(pos, 200.0), MD_WARM)
    step0 = int(warm.step)
    fault_step = step0 + GUARD_FAULT_AT
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_guard_")
    trace_dir = os.path.join(tmp.name, "trace")
    # the variants alternate (off, guard, obs, off, guard, obs) in one call
    runs = {"off": [], "guard": [], "obs": []}
    engines = {}
    for _ in range(2):
        for tag, kw in (("off", {}),
                        ("guard", dict(guard=GuardConfig(enabled=True))),
                        ("obs", dict(obs=ObsConfig(enabled=True,
                                                   trace_dir=trace_dir)))):
            engines[tag] = engine(**kw)
            runs[tag].append(timed_run(engines[tag], warm, GUARD_STEPS))
    ref = runs["off"][0][0]
    for tag in runs:
        for st, _, _ in runs[tag]:
            if not same_state(st, ref):
                fail(f"guard: {tag} run differs from the unguarded run")
    check_finite_state("guard", ref)
    # the trace the obs run flushed: validates, renders, one step record
    # per step, the calibrated stage spans present
    events = export.read_jsonl(os.path.join(trace_dir, "events.jsonl"))
    export.validate_events(events)
    steps = [e["step"] for e in events if e["type"] == "step"]
    if steps != list(range(step0, step0 + GUARD_STEPS)):
        fail(f"guard obs: step records {steps}")
    frac = report.stage_fractions(events)
    if set(frac) != {"scan.neighbor", "scan.classical", "scan.inference",
                     "scan.integrate"}:
        fail(f"guard obs: calibrated stages {sorted(frac)}")
    phases = report.phase_table(events)

    # an engine-level NaN inside the window: rollback, replay, same bits
    plan = FaultPlan([FaultSpec("nan_force", step=fault_step)])
    eng_f = engine(guard=GuardConfig(enabled=True), faults=plan)
    kernels.reset_launch_counts()
    st_f, wall_f, scan_f = timed_run(eng_f, warm, GUARD_STEPS)
    counts_sd = kernels.launch_counts()
    d = eng_f.diagnostics
    if not (plan.faults[0].fired and d["guard_trips"] == 1
            and d["guard_rollbacks"] == 1 and d["window_reruns"] == 1):
        fail(f"guard: nan_force at step {fault_step}: {d}")
    if not same_state(st_f, ref):
        fail("guard: the recovered run differs from the fault-free run")
    for k in SINGLE_DOMAIN_KERNELS:
        if counts_sd[k] == 0:
            fail(f"guard: {k} was never launched in the guarded run: "
                 f"{counts_sd}")

    # checkpoints every 5 steps, the newest truncated: fall back, resume
    ck_root = os.path.join(tmp.name, "ck")
    cplan = FaultPlan([FaultSpec("truncate_ckpt",
                                 step=step0 + GUARD_STEPS)])
    ck = AsyncCheckpointer(ck_root, keep=5, fault_plan=cplan)
    save_ms = []
    save = ck.save

    def timed_save(tree, step):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(tree, step)
        save_ms.append((time.perf_counter() - t0) * 1e3)

    ck.save = timed_save
    eng_c = engine(checkpoint_every=5, checkpointer=ck)
    st_c, wall_c, scan_c = timed_run(eng_c, warm, GUARD_STEPS)
    t0 = time.perf_counter()
    ck.wait()
    write_tail_ms = (time.perf_counter() - t0) * 1e3
    if not same_state(st_c, ref):
        fail("guard: the checkpointed run differs from the unguarded run")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tree, cstep = ck.restore_latest(state_tree(warm))
    if not (cplan.faults[0].fired and cstep == step0 + GUARD_STEPS - 5
            and any("corrupt" in str(w.message) for w in caught)):
        fail(f"guard: restore_latest gave step {cstep} "
             f"(fired {cplan.faults[0].fired})")
    resumed = engine(checkpoint_every=5).run(
        MDEngine.restore(os.path.join(ck_root, f"step_{cstep:09d}"),
                         device=DEVICE), step0 + GUARD_STEPS - cstep)
    if not (same_state(resumed, ref)
            and torch.equal(tree["positions"], MDEngine.restore(
                os.path.join(ck_root, f"step_{cstep:09d}"),
                DEVICE).positions)):
        fail("guard: the restart from the fallback checkpoint differs")
    ckpt_neighbor_ms = eng_c.timings["neighbor"] * 1e3
    del engines, eng_f, eng_c, tree
    tmp.cleanup()
    torch.cuda.empty_cache()

    def per_step(rs, i):
        return [r[i] / GUARD_STEPS for r in rs]

    line = {"phase": "guard", "mode": "single domain",
            "atoms": system.n_atoms, "dp_atoms": len(nn),
            "steps": GUARD_STEPS, "start_step": step0,
            "wall_ms_per_step": {t: per_step(r, 1) for t, r in runs.items()},
            "window_ms_per_step": {t: per_step(r, 2)
                                   for t, r in runs.items()},
            "wall_ms_per_step_is": "eng.run(warm, 10) synchronised, the "
                                   "pre-loop build (and with obs the "
                                   "calibration probes) included",
            "window_ms_is": "timings['scan']: the windows, each ending "
                            "in its one verdict read",
            "guard_on_equals_off_bitwise": True,
            "obs_on_equals_off_bitwise": True,
            "nan_force": {"step": fault_step, "guard_trips": d["guard_trips"],
                          "guard_rollbacks": d["guard_rollbacks"],
                          "wall_ms": wall_f, "window_ms": scan_f,
                          "rollback_ms": wall_f - runs["guard"][1][1],
                          "rollback_window_ms": scan_f - runs["guard"][1][2],
                          "recovered_bitwise": True,
                          "launches": counts_sd},
            "checkpoint_every_5": {
                "wall_ms_per_step": wall_c / GUARD_STEPS,
                "window_ms_per_step": scan_c / GUARD_STEPS,
                "save_ms_caller_thread": save_ms,
                "write_tail_ms": write_tail_ms,
                "neighbor_ms_incl_rebuild_after_saves": ckpt_neighbor_ms,
                "truncated_step": step0 + GUARD_STEPS,
                "restored_step": cstep, "resumed_bitwise": True},
            "obs_trace": {"events": len(events), "step_records": len(steps),
                          "stage_fractions": frac,
                          "phase_table": phases}}
    print(json.dumps(line), flush=True)

    # -- 8 virtual ranks: a rank-3 NaN through the pipeline's fault hook
    coords_nn = pos[torch.as_tensor(nn, device=DEVICE)].cpu().numpy()
    dd = suggest_config(len(nn), box, N_RANKS, model.cfg.descriptor.rcut,
                        nbr_capacity=sel, skin=SKIN, coords=coords_nn)
    st_ref, wall_ref, scan_ref = timed_run(engine(special=provider(dd)), warm,
                                           GUARD_DD_STEPS)
    rplan = FaultPlan([FaultSpec("nan_force", step=step0 + 2, rank=3)])
    eng_r = engine(special=provider(dd, rplan.pipeline_hook()),
                   guard=GuardConfig(enabled=True), faults=rplan)
    kernels.reset_launch_counts()
    st_r, wall_r, scan_r = timed_run(eng_r, warm, GUARD_DD_STEPS)
    counts_dd = kernels.launch_counts()
    dr = eng_r.diagnostics
    if not (rplan.faults[0].fired and dr["guard_trips"] == 1
            and dr["guard_rollbacks"] == 1):
        fail(f"guard dd: rank fault: {dr}")
    if not same_state(st_r, st_ref):
        fail("guard dd: the recovered 8-rank run differs from the "
             "fault-free one")
    for k in DP_KERNELS:
        if counts_dd[k] == 0:
            fail(f"guard dd: {k} was never launched: {counts_dd}")
    print(json.dumps({"phase": "guard", "mode": "dd", "ranks": dd.n_ranks,
                      "steps": GUARD_DD_STEPS, "fault": "nan_force rank 3 "
                      f"at step {step0 + 2}",
                      "wall_ms": {"fault_free": wall_ref, "recovered": wall_r},
                      "window_ms": {"fault_free": scan_ref,
                                    "recovered": scan_r},
                      "rollback_ms": wall_r - wall_ref,
                      "guard_trips": dr["guard_trips"],
                      "recovered_bitwise": True, "launches": counts_dd}),
          flush=True)
    print(f"[guard] {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts_sd, counts_dd


# ---------------------------------------------------------------------------
# ensemble: replica batching (single domain and DD), REMD, and the
# comms/compute overlap evaluation
# ---------------------------------------------------------------------------

ENS_R = 4                 # replicas of the batched single-domain call, REMD
ENS_LADDER = (300.0, 420.0)
ENS_EXCHANGE = 5          # steps between exchange attempts
ENS_IND_STEPS = 5         # exchange-off R = 2 vs two MDEngine runs
ENS_DD = (2, 4)           # replicas x virtual ranks of the batched DD call
ENS_FAULT_STEPS = 6       # the guarded batched-DD runs (fault at step 5)
ENS_NOISE = 0.002         # nm: the replicas' offsets from the stand-in


def host_ms(fn, reps=3):
    """Median host-clock ms of ``fn()`` over ``reps`` synchronised runs,
    after one warm-up (for calls that sync on the host inside)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def launches_of(fn):
    """({kernel: launches}, fn's result) of one call of ``fn``."""
    from repro_torch import kernels
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    res = fn()
    torch.cuda.synchronize()
    return kernels.launch_counts(), res


def check_launch_pattern(counts, want, what):
    """Every kernel of ``want`` launched exactly that often, every other
    DP kernel not at all."""
    for k in DP_KERNELS:
        if counts[k] != want.get(k, 0):
            fail(f"{what}: {k} launched {counts[k]} times, expected "
                 f"{want.get(k, 0)} ({counts})")


def replica_positions(pos, box, r):
    """``r`` replicas of the stand-in: the positions themselves, then
    offsets of ENS_NOISE nm (normal, seeded) wrapped into the box."""
    from repro_torch.md.integrators import wrap
    rng = np.random.default_rng(SEED + 7)
    out = [pos]
    for _ in range(r - 1):
        d = torch.tensor(rng.normal(0, ENS_NOISE, tuple(pos.shape)).astype(
            np.float32), device=pos.device)
        out.append(wrap(pos + d, box))
    return torch.stack(out)


def gemm_rows_by_m(model, params, n, k, copies=4):
    """Whether the model's two MLPs give each row the same bits when the
    batch holds ``copies`` copies of the same rows (M x ``copies``): the
    embedding net on (n, k) neighbour features, the fitting net on (n,)
    descriptors (random inputs from a seeded generator, on the card).  A
    False names the op that makes a batched force call differ from the
    unbatched one in its last bits."""
    from repro_torch.dp.networks import mlp_apply
    cfg = model.cfg.descriptor
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    feat = torch.randn(n * k, 1 + cfg.type_embed_dim, generator=gen,
                       device=DEVICE)
    desc = torch.randn(n, cfg.out_dim, generator=gen, device=DEVICE)
    out = {}
    with torch.no_grad():
        for name, net, x in (("embedding", params["descriptor"]["embed"],
                              feat), ("fitting", params["fitting"], desc)):
            one = mlp_apply(net, x)
            many = mlp_apply(net, torch.cat([x] * copies))
            out[name] = all(torch.equal(one, part)
                            for part in many.split(len(x)))
    return out


def phase_ensemble(model, params):
    """Replica batching and REMD on the 62,210-atom stand-in (its 15,668
    DP atoms), then the overlap evaluation on the dd phase's system.

    (a) R = 4 replicas through one ``BatchedDeepmdProvider`` call (one
    domain, skin 0.05) against the unbatched provider per replica; the
    kernels' launches per call against R = 1's; the kernels against their
    plain versions on the call's tensors; peak memory.  (b) REMD:
    ``EnsembleEngine`` with R = 4 on a geometric 300-420 K ladder, exchange
    every 5 steps, 5 warm-up and 20 timed steps (ms per ensemble step,
    launches per step, exchange statistics); exchange off, R = 2 against
    two ``MDEngine`` runs.  (c) R = 2 x 4 virtual ranks: forces against one
    domain, per-replica rebuild flags, a ``nan_force`` on rank 2 of
    replica 1 recovered with only replica 1 tripped, the kernels against
    their plain versions, peak memory.  (d) the overlap evaluation (8
    ranks, the dd phase's 15,668 random atoms): == sequential bit for bit
    at the build and drifted positions, ``interior_frac``, a trimmed and a
    tiny ``overlap_capacity``, both evaluations timed, each pass's kernels
    against their plain versions.  Returns {"batched_force_call",
    "ensemble_step", "overlap_evaluation": {kernel: launches}}."""
    from repro_torch.core import (DeepmdForceProvider, ForcePipeline,
                                  suggest_config)
    from repro_torch.core import pipeline as tpipe
    from repro_torch.ensemble import (BatchedDeepmdProvider, EnsembleConfig,
                                      EnsembleEngine, geometric_ladder)
    from repro_torch.health import FaultPlan, FaultSpec, GuardConfig
    from repro_torch.md import (EngineConfig, MDEngine,
                                build_solvated_protein, mark_nn_group)
    t_phase = time.perf_counter()
    msys, pos, nn = build_solvated_protein(MD_RESIDUES, device=DEVICE)
    msys = mark_nn_group(msys, nn)
    box = msys.box.cpu().numpy()
    sel = model.cfg.descriptor.sel
    rcut = model.cfg.descriptor.rcut
    mib = lambda b: b / 2 ** 20
    out = {}

    def batched(r, dd=None, hook=None):
        return BatchedDeepmdProvider(model, params, nn, msys.types, box,
                                     msys.n_atoms, n_replicas=r,
                                     nbr_capacity=sel, skin=SKIN,
                                     dd_config=dd, device=DEVICE,
                                     fault_hook=hook)

    single = DeepmdForceProvider(model, params, nn, msys.types, box,
                                 msys.n_atoms, nbr_capacity=sel, skin=SKIN,
                                 device=DEVICE)

    # -- (a) R = 4 through one batched single-domain call
    xs = replica_positions(pos, msys.box, ENS_R)
    bprov = batched(ENS_R)
    st_b = bprov.assemble(xs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    per_call, (e_b, f_b, fl_b) = launches_of(lambda: bprov.evaluate(xs, st_b))
    peak_b = torch.cuda.max_memory_allocated()
    if bool(fl_b["overflow"].any()) or bool(fl_b["needs_rebuild"].any()):
        fail(f"ensemble batched: flags {fl_b}")
    singles, errs, bitwise = [], [], []
    per_call_1 = None
    for r in range(ENS_R):
        st_r = single.assemble(xs[r])
        counts_1, (e_r, f_r, _) = launches_of(
            lambda: single.evaluate(xs[r], st_r))
        per_call_1 = per_call_1 or counts_1
        if abs(float(e_b[r]) - float(e_r)) > 1e-5 * abs(float(e_r)):
            fail(f"ensemble batched: replica {r} E {float(e_b[r])} vs "
                 f"unbatched {float(e_r)}")
        errs.append(check(f"ensemble batched replica {r} forces vs "
                          "unbatched", f_b[r], f_r,
                          atol=1e-4 * float(f_r.abs().max())))
        bitwise.append(bool(torch.equal(f_b[r], f_r))
                       and float(e_b[r]) == float(e_r))
        singles.append(f_r)
    del st_r
    want = {k: 1 for k in SINGLE_DOMAIN_KERNELS}
    check_launch_pattern(per_call, want, "ensemble batched force call")
    check_launch_pattern(per_call_1, want, "ensemble R = 1 force call")
    gemm_bits = gemm_rows_by_m(model, params, len(nn), bprov.nbr_capacity)
    ms_b = host_ms(lambda: bprov.evaluate(xs, st_b))
    ms_1 = host_ms(lambda: single.evaluate(xs[0], single.assemble(xs[0])))
    st0 = single.assemble(xs[0])
    ms_1_eval = host_ms(lambda: single.evaluate(xs[0], st0))
    del st0
    _, seen = record_model_kernels(lambda: bprov.evaluate(xs, st_b))
    check_dd_model_kernels(seen, "ensemble batched",
                           scatter_cases=("gather_backward",))
    del seen
    torch.cuda.empty_cache()
    print(json.dumps({
        "phase": "ensemble", "case": "batched single domain",
        "replicas": ENS_R, "dp_atoms": len(nn), "K": bprov.nbr_capacity,
        "model_rows": ENS_R * len(nn),
        "E_tol": "rtol 1e-5", "F_tol": "atol 1e-4*max|F|",
        "F_max_abs_err_vs_unbatched": errs,
        "bitwise_vs_unbatched": bitwise,
        "mlp_rows_bitwise_at_4x_rows": gemm_bits,
        "launches_per_batched_force_call": per_call,
        "launches_per_unbatched_force_call": per_call_1,
        "batched_evaluate_ms": ms_b, "unbatched_evaluate_ms": ms_1_eval,
        "unbatched_assemble_and_evaluate_ms": ms_1,
        "batched_ms_per_replica": ms_b / ENS_R,
        "max_memory_allocated_MiB": mib(peak_b)}), flush=True)
    out["batched_force_call"] = per_call
    del st_b

    # -- (b) REMD: R = 4 on a geometric ladder, exchange every 5 steps
    temps = geometric_ladder(*ENS_LADDER, ENS_R)

    def ensemble(r, temps_r, ex, special, **kw):
        cfg = {**MD_CFG, "thermostat_t": temps_r[0]}
        return EnsembleEngine(msys, EngineConfig(**cfg),
                              EnsembleConfig(n_replicas=r, temps=temps_r,
                                             exchange_interval=ex),
                              special_force=special, **kw)

    eng = ensemble(ENS_R, temps, ENS_EXCHANGE, bprov)
    warm = eng.run(eng.init_state(pos), MD_WARM)
    eng = ensemble(ENS_R, temps, ENS_EXCHANGE, bprov)
    from repro_torch import kernels
    kernels.reset_launch_counts()
    st_e, wall_e, steps_e, mem_e = md_run(eng, warm, MD_STEPS)
    counts_e = kernels.launch_counts()
    check_finite_state("ensemble remd", st_e)
    d = eng.diagnostics
    split_e = step_split(steps_e)
    per_step = {k: c / MD_STEPS for k, c in counts_e.items()}
    for k in SINGLE_DOMAIN_KERNELS:
        if counts_e[k] == 0:
            fail(f"ensemble remd: {k} was never launched: {counts_e}")
    if sorted(st_e.ladder.tolist()) != list(range(ENS_R)):
        fail(f"ensemble remd: ladder {st_e.ladder.tolist()} is no "
             "permutation")
    line_b = {"phase": "ensemble", "case": "remd", "replicas": ENS_R,
              "atoms": msys.n_atoms, "dp_atoms": len(nn),
              "ladder_K": list(temps), "exchange_interval": ENS_EXCHANGE,
              "steps": MD_STEPS, "wall_ms": wall_e, **split_e,
              "ensemble_step_ms_median": split_e["step_ms_median"],
              "ms_per_replica_step": split_e["step_ms_median"] / ENS_R,
              "single_replica_step": "the md phase's md_step_ms_median",
              "exchange_attempts": d["exchange_attempts"],
              "exchange_accepts": d["exchange_accepts"],
              "pair_attempts": d["pair_attempts"].tolist(),
              "pair_accepts": d["pair_accepts"].tolist(),
              "final_ladder": st_e.ladder.tolist(),
              "diagnostics": {k: d[k] for k in (
                  "displacement_rebuilds", "special_rebuilds",
                  "cadence_rebuilds", "capacity_growths", "special_growths")},
              "max_memory_allocated_MiB": mib(max(mem_e["peak"])),
              "launches_per_ensemble_step": per_step}
    print(json.dumps(line_b), flush=True)
    out["ensemble_step"] = per_step
    # the batched classical path at R x 62,210 atoms: each force scatter
    # (the pair table's takes the 3-pass list) against its plain version,
    # and each replica's forces against an unbatched call, bit for bit
    nl = eng.build_nlist(st_e.positions)
    (e_c, f_c), seen = record_model_kernels(
        lambda: eng._classical_batched(st_e.positions, nl), FORCE_SCATTER)
    cap = nl.idx.shape[-1]
    terms = {2: "bonds", 3: "angles", 4: "dihedrals", 2 * cap: "pairs"}
    for args, _, _ in seen["force_scatter"]:
        rows, k = args[1].shape
        term = terms.get(k)
        row = {"phase": "ensemble", "name": "force_scatter",
               "case": f"batched classical {term}, {ENS_R} replicas",
               "rows": rows, "K": k, "atoms": args[3], "max_err": 0.0,
               "tol": "exact (bitwise)",
               **check_force_scatter(*args, library=term != "pairs")}
        print(json.dumps(row), flush=True)
    del seen
    same = []
    for r in range(ENS_R):
        one = type(nl)(idx=nl.idx[r], mask=nl.mask[r],
                       ref_positions=nl.ref_positions[r],
                       overflow=nl.overflow[r])
        e1, f1 = eng._classical_one(st_e.positions[r], one)
        same.append(bool(torch.equal(f1, f_c[r])) and float(e1) ==
                    float(e_c[r]))
    print(json.dumps({"phase": "ensemble",
                      "case": "batched classical forces vs one replica",
                      "atoms": ENS_R * msys.n_atoms,
                      "bitwise_per_replica": same}), flush=True)
    if not all(same):
        fail(f"ensemble: batched classical forces differ from the "
             f"unbatched ones ({same})")
    del eng, warm, st_e, bprov, nl, e_c, f_c
    torch.cuda.empty_cache()

    # exchange off: R = 2 batched == two MDEngine runs
    b2 = batched(2)
    eng2 = ensemble(2, temps[:2], 0, b2)
    st2 = eng2.run(eng2.init_state(pos), ENS_IND_STEPS)
    errs, bitwise = [], []
    for r in range(2):
        t_r = float(np.float32(temps[r]))
        eng1 = MDEngine(msys, EngineConfig(**{**MD_CFG, "thermostat_t": t_r}),
                        special_force=single)
        st1 = eng1.run(eng1.init_state(pos, t_r, seed=r), ENS_IND_STEPS)
        errs.append(check(f"ensemble exchange-off replica {r} positions vs "
                          "MDEngine", st2.positions[r], st1.positions,
                          atol=MD_POS_TOL))
        bitwise.append(all(torch.equal(getattr(st2, k)[r], getattr(st1, k))
                           for k in STATE_KEYS))
    print(json.dumps({"phase": "ensemble",
                      "case": "exchange off, R = 2 vs two MDEngine runs",
                      "steps": ENS_IND_STEPS,
                      "positions_max_abs_err_nm": errs,
                      "tol": f"atol {MD_POS_TOL} nm",
                      "bitwise": bitwise}), flush=True)
    del eng2, st2, b2, eng1, st1
    torch.cuda.empty_cache()

    # -- (c) R = 2 x 4 virtual ranks of the DP group
    r_dd, g_dd = ENS_DD
    coords_nn = pos[torch.as_tensor(nn, device=DEVICE)].cpu().numpy()
    dd4 = suggest_config(len(nn), box, g_dd, rcut, nbr_capacity=sel,
                         skin=SKIN, coords=coords_nn)
    dprov = batched(r_dd, dd4)
    x2 = xs[:r_dd]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    st_d = dprov.assemble(x2)
    per_call_dd, (e_d, f_d, fl_d) = launches_of(lambda: dprov.evaluate(x2,
                                                                       st_d))
    peak_d = torch.cuda.max_memory_allocated()
    if bool(fl_d["overflow"].any()):
        fail(f"ensemble dd: overflow {fl_d}")
    errs = [check(f"ensemble dd replica {r} forces vs one domain", f_d[r],
                  singles[r], atol=1e-4 * float(singles[r].abs().max()))
            for r in range(r_dd)]
    check_launch_pattern(per_call_dd, {**want, "force_scatter": 2,
                                       "cell_filter": 1},
                         "ensemble dd evaluate")
    far = x2.clone()
    far[1, int(nn[0]), 0] += SKIN
    flags = dprov.needs_rebuild(far, st_d).tolist()
    if flags != [False, True]:
        fail(f"ensemble dd: rebuild flags {flags} after moving an atom of "
             "replica 1 by the skin")
    (_, seen), cf_calls = record_cell_filter(
        lambda: record_model_kernels(lambda: dprov.evaluate(
            x2, dprov.assemble(x2))))
    check_dd_model_kernels(seen, "ensemble dd")
    check_cell_filter_calls(cf_calls, "ensemble dd")
    del seen, cf_calls, st_d
    torch.cuda.empty_cache()
    # a nan_force on rank 2 of replica 1: only replica 1 trips, and the
    # ensemble ends on the fault-free bits
    runs = {}
    for name in ("clean", "faulted"):
        plan = FaultPlan([FaultSpec("nan_force", step=5, rank=2, replica=1)]
                         if name == "faulted" else [])
        eng = ensemble(r_dd, temps[:r_dd], 0,
                       batched(r_dd, dd4, plan.pipeline_hook()),
                       guard=GuardConfig(enabled=True), faults=plan)
        runs[name] = (eng.run(eng.init_state(pos), ENS_FAULT_STEPS), eng,
                      plan)
    (st_c, _, _), (st_f, eng_f, plan) = runs["clean"], runs["faulted"]
    trips = eng_f.diagnostics["replica_guard_trips"].tolist()
    if not plan.faults[0].fired or trips != [0, 1]:
        fail(f"ensemble dd fault: fired {plan.faults[0].fired}, replica "
             f"trips {trips}")
    if not all(torch.equal(getattr(st_c, k), getattr(st_f, k))
               for k in (*STATE_KEYS, "ladder")):
        fail("ensemble dd fault: the recovered ensemble differs from the "
             "fault-free run")
    print(json.dumps({
        "phase": "ensemble", "case": "batched dd", "replicas": r_dd,
        "ranks": g_dd, "grid": dd4.grid_dims, "K_eval": dd4.k_eval,
        "model_rows": r_dd * dd4.n_ranks * (dd4.local_capacity
                                            + dd4.ghost_capacity),
        "F_max_abs_err_vs_one_domain": errs, "F_tol": "atol 1e-4*max|F|",
        "rebuild_flags_after_moving_replica_1": flags,
        "fault": "nan_force step 5, rank 2, replica 1",
        "replica_guard_trips": trips,
        "recovered_equals_fault_free_bitwise": True,
        "launches_per_batched_dd_evaluate": per_call_dd,
        "max_memory_allocated_MiB": mib(peak_d)}), flush=True)
    del runs, st_c, st_f, eng_f, eng, dprov, xs, x2, far, singles, single
    del msys, pos
    torch.cuda.empty_cache()

    # -- (d) overlap: 8 ranks on the dd phase's system
    coords, types, box_r = system(N_PATH, SEED)
    cfg8 = suggest_config(N_PATH, box_r, N_RANKS, rcut, nbr_capacity=sel,
                          skin=SKIN, coords=coords)
    pipe = ForcePipeline(model, cfg8, box_r, N_PATH)
    ev = pipe.build_evaluation_fn()
    x = torch.tensor(coords, device=DEVICE)
    t = torch.tensor(types, device=DEVICE)
    st = pipe.build_assembly_fn()(x, t)
    masks = tpipe._overlap_masks(cfg8, tpipe._st_dict(st, pipe.ax))
    c_full = cfg8.local_capacity + cfg8.ghost_capacity
    sources = ((st.buf_mask.reshape(N_RANKS, -1) > 0) & ~masks[3]).sum(1)
    c_trim = min(c_full, -(-int(sources.max()) // 64) * 64)

    def overlap(**kw):
        return ForcePipeline(model, dataclasses.replace(cfg8, overlap=True,
                                                        **kw),
                             box_r, N_PATH).build_evaluation_fn()

    ov = overlap()
    moved = torch.tensor(frozen_drift(coords, box_r, cfg8.grid_dims,
                                      cfg8.halo_eff), device=DEVICE)
    res = {}
    for where, y in (("build", x), ("drifted", moved)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        e0, f0, d0 = ev(params, y, st)
        torch.cuda.synchronize()
        peak0 = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        e1, f1, d1 = ov(params, y, st)
        torch.cuda.synchronize()
        peak1 = torch.cuda.max_memory_allocated()
        if float(e0) != float(e1) or not torch.equal(f0, f1):
            fail(f"ensemble overlap ({where}): overlap != sequential (dE "
                 f"{float(e1 - e0):.3e}, max dF "
                 f"{float((f1 - f0).abs().max()):.3e})")
        if int(d1["overflow"]) or bool(d1["needs_rebuild"]):
            fail(f"ensemble overlap ({where}): overflow or rebuild flagged")
        res[where] = (e0, f0, float(d1["interior_frac"]), peak0, peak1)
    e0, f0, frac, peak0, peak1 = res["build"]
    e4, f4, d4 = overlap(overlap_capacity=c_trim)(params, x, st)
    trim_df = float((f4 - f0).abs().max())
    trim_de = abs(float(e4 - e0)) / abs(float(e0))
    if int(d4["overflow"]) or trim_df > 1e-5 * float(f0.abs().max()) or \
            trim_de > 1e-5:
        fail(f"ensemble overlap trimmed to {c_trim}: overflow "
             f"{int(d4['overflow'])}, dF {trim_df:.3e}, dE {trim_de:.3e}")
    _, _, d5 = overlap(overlap_capacity=8)(params, x, st)
    if not int(d5["overflow"]):
        fail("ensemble overlap: a capacity of 8 rows raised no overflow")
    del f4, d4, d5
    per_ov, _ = launches_of(lambda: ov(params, x, st))
    check_launch_pattern(per_ov, {**{k: 2 for k in SINGLE_DOMAIN_KERNELS},
                                  "force_scatter": 3, "cell_filter": 2},
                         "ensemble overlap evaluation")
    ms_seq = host_ms(lambda: ev(params, x, st))
    ms_ov = host_ms(lambda: ov(params, x, st))
    # each pass's kernels on the tensors it gave them
    model_names = [n for _, n in MODEL_KERNELS if n != "force_scatter"]
    for label, idx, sc in (("pass A", (0,), (0,)), ("pass B", (1,), (1, 2))):
        _, seen = record_model_kernels(
            lambda: ov(params, x, st),
            keep=lambda name, i, idx=idx, sc=sc: i in (
                sc if name == "force_scatter" else idx))
        cases = (("gather_backward",) if label == "pass A"
                 else ("gather_backward", "force_reduction"))
        check_dd_model_kernels(seen, f"ensemble overlap {label}",
                               scatter_cases=cases)
        del seen
        torch.cuda.empty_cache()
    _, cf_calls = record_cell_filter(lambda: ov(params, x, st))
    check_cell_filter_calls(cf_calls, "ensemble overlap",
                            sites=("pass_a_refilter", "pass_b_refilter"))
    del cf_calls
    print(json.dumps({
        "phase": "ensemble", "case": "overlap", "ranks": N_RANKS,
        "atoms": N_PATH, "rows_per_rank_capacity": c_full,
        "bitwise_vs_sequential": {"build": True, "drifted": True},
        "interior_frac": frac, "interior_frac_drifted": res["drifted"][2],
        "trimmed_capacity": c_trim, "trimmed_F_max_abs_err": trim_df,
        "trimmed_E_rel_err": trim_de, "tiny_capacity_overflow": True,
        "sequential_evaluate_ms": ms_seq, "overlap_evaluate_ms": ms_ov,
        "overlap_extra_ms": ms_ov - ms_seq,
        "sequential_peak_MiB": mib(peak0), "overlap_peak_MiB": mib(peak1),
        "launches_per_overlap_evaluation": per_ov,
        "model_kernels_checked": model_names}), flush=True)
    out["overlap_evaluation"] = per_ov
    del st, res, f0, e0
    torch.cuda.empty_cache()
    print(f"[ensemble] {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# serve: multi-tenant force serving (ForceServer + RemoteForceProvider)
# ---------------------------------------------------------------------------

SERVE_RESIDUES = 1_024    # a solvated protein whose DP group is 4,096 atoms
SERVE_CLIENTS = 4
SERVE_WARM, SERVE_STEPS = 5, 100   # client MD steps before / in the window
SERVE_BATCHES = (1, 2, 4)
SERVE_K = 96              # the served lists' capacity (<= 128)


def _stream_key():
    """The CUDA stream current on the calling thread (a backward runs on
    its forward's stream, whichever thread the autograd engine uses)."""
    return torch.cuda.current_stream().stream_id


def stream_tally(fn, which=MODEL_KERNELS):
    """Run ``fn(tally)`` with each named kernel wrapper (module, name)
    replaced by one that calls through and adds one to
    ``tally[stream][name]`` for the stream current at the call, so the
    launches of a run in which several threads launch split by stream;
    returns fn's result.  Meanwhile the wrappers' launches count on the
    module-level name, the replacement; they go back to the wrappers'
    counts afterwards."""
    from repro_torch import kernels
    mods = {m: getattr(kernels, m) for m, _ in which}
    originals = {name: getattr(mods[m], name) for m, name in which}
    tally = {}

    def counter(name):
        def rec(*args, **kw):
            per = tally.setdefault(_stream_key(), {})
            per[name] = per.get(name, 0) + 1
            return originals[name](*args, **kw)
        rec.launches = 0
        return rec

    for m, name in which:
        setattr(mods[m], name, counter(name))
    try:
        return fn(tally)
    finally:
        for m, name in which:
            originals[name].launches += getattr(mods[m], name).launches
            setattr(mods[m], name, originals[name])


def phase_serve(model, params):
    """Force serving with the full-width model: 4 client MD threads
    (``RemoteForceProvider``) against one ``ForceServer`` (atom bucket
    4,096, batch buckets 1, 2, 4); every served result of a batch of 4
    against ``evaluate_direct`` on the same request; an expired deadline, a
    full queue and a ``serve_fail`` failing only their own request or
    batch; the ``pipeline_executor_factory`` route at batch 2 x 4 virtual
    ranks; ms and launches per executor call at batch 1/2/4 (each model
    kernel once whatever the batch; the batch-4 call's kernels against
    their plain versions); then the clients' served run: SERVE_WARM steps
    each, then a window of SERVE_STEPS steps each in which requests/s,
    p50/p99 of every request's own latency and the launches of every
    dispatch (counted on the server's stream inside the dispatch) are
    read.  Returns {kernel: launches per served dispatch} (every dispatch
    of the window launches the same)."""
    import threading
    from repro_torch.backend import ForceRequest
    from repro_torch.core import suggest_config
    from repro_torch.health import FaultPlan, FaultSpec
    from repro_torch.md import build_solvated_protein, mark_nn_group
    from repro_torch.md.integrators import wrap
    from repro_torch.serve import (ForceServer, ServeConfig,
                                   ServerOverloaded, pad_group,
                                   pipeline_executor_factory)
    t_phase = time.perf_counter()
    msys, pos, nn = build_solvated_protein(SERVE_RESIDUES, device=DEVICE)
    msys = mark_nn_group(msys, nn)
    n_dp = len(nn)
    box = msys.box.cpu()
    types_nn = msys.types.cpu()[torch.as_tensor(nn)]
    sel = model.cfg.descriptor.sel
    rcut = model.cfg.descriptor.rcut
    server = ForceServer(model, params, ServeConfig(
        atom_buckets=(n_dp,), batch_buckets=SERVE_BATCHES,
        nbr_capacity=SERVE_K, batch_window_s=0.05))
    t0 = time.perf_counter()
    server.warmup()
    warm_s = time.perf_counter() - t0
    xs = replica_positions(pos, msys.box, max(SERVE_BATCHES))

    def request(k, tenant="direct"):
        nn_pos = wrap(xs[k].cpu()[torch.as_tensor(nn)], box)
        return ForceRequest(positions=nn_pos, box=box, types=types_nn,
                            tenant=tenant)

    try:
        # every served result of one batch of 4 vs evaluate_direct
        reqs = [request(k, f"parity{k}") for k in range(max(SERVE_BATCHES))]
        futs = [server.submit(r) for r in reqs]
        got = [f.result(120.0) for f in futs]
        sizes = [g.diagnostics.get("batch_size") for g in got]
        errs = []
        for req, res in zip(reqs, got):
            direct = server.evaluate_direct(req)
            if not (res.ok and direct.ok):
                fail(f"serve: {res.error or direct.error}")
            if abs(float(res.energy) - float(direct.energy)) > \
                    1e-5 * abs(float(direct.energy)):
                fail(f"serve: E {float(res.energy)} vs direct "
                     f"{float(direct.energy)}")
            errs.append(check("serve: served vs direct forces", res.forces,
                              direct.forces,
                              atol=1e-4 * float(direct.forces.abs().max())))
        # ms and launches of one executor call at each batch bucket (the
        # bucket function called on this thread, outside the queue)
        per_dispatch, ms_dispatch = {}, {}
        for b in SERVE_BATCHES:
            arrs = [torch.as_tensor(a, device=DEVICE) for a in
                    pad_group(reqs[:b], n_dp, SERVE_BATCHES)]
            fn = server._bucket_fn(n_dp, b)
            with torch.no_grad():
                per_dispatch[b], _ = launches_of(lambda: fn(params, *arrs))
                ms_dispatch[b] = host_ms(lambda: fn(params, *arrs))
            check_launch_pattern(per_dispatch[b],
                                 {k: 1 for k in SINGLE_DOMAIN_KERNELS},
                                 f"serve executor at batch {b}")
            if b == max(SERVE_BATCHES):
                with torch.no_grad():
                    _, seen = record_model_kernels(lambda: fn(params, *arrs))
                check_dd_model_kernels(seen, "serve batch 4",
                                       scatter_cases=("gather_backward",))
                del seen
        print(json.dumps({"phase": "serve", "dp_atoms": n_dp,
                          "atoms": msys.n_atoms, "K": SERVE_K,
                          "warmup_s": warm_s,
                          "parity_batch_sizes": sizes,
                          "F_max_abs_err_vs_direct": errs,
                          "F_tol": "atol 1e-4*max|F|", "E_tol": "rtol 1e-5",
                          "executor_ms_by_batch": ms_dispatch,
                          "executor_launches_by_batch": per_dispatch}),
              flush=True)

        served = serve_clients(server, msys, nn, box, xs)
    finally:
        server.stop()

    # degradation: an expired deadline, a full queue and a serve_fail each
    # fail only their own request or batch (512 random atoms a request)
    sc, st_, sb = system(512, SEED + 8)
    small = [ForceRequest(positions=torch.tensor(sc), box=torch.tensor(sb),
                          types=torch.tensor(st_), tenant=f"s{i}")
             for i in range(4)]
    plan = FaultPlan([FaultSpec("serve_fail", nth=3)])
    srv = ForceServer(model, params, ServeConfig(
        atom_buckets=(512,), batch_buckets=(1, 2), nbr_capacity=SERVE_K,
        queue_bound=1, batch_window_s=0.001), fault_plan=plan)
    try:
        ok0 = srv.compute(small[0])                          # dispatch 1
        late = dataclasses.replace(small[1], deadline=time.monotonic() - 1)
        r_late = srv.submit(late).result(60.0)
        real = srv._bucket_fn(512, 1)
        release = threading.Event()

        def slow(*a):
            release.wait(60.0)
            return real(*a)

        srv._fns[(512, 1)] = srv._fns[(512, 2)] = slow
        f_a = srv.submit(dataclasses.replace(small[2], deadline=None))
        time.sleep(0.3)                                      # dispatch 2
        f_b = srv.submit(dataclasses.replace(small[3], deadline=None))
        try:
            srv.submit(dataclasses.replace(small[0], deadline=None,
                                           tenant="burst"))
            fail("serve: a full queue accepted a request")
        except ServerOverloaded:
            pass
        release.set()
        r_a, r_b = f_a.result(60.0), f_b.result(60.0)       # dispatches 2, 3
        srv._fns[(512, 1)] = srv._fns[(512, 2)] = real
        r_after = srv.compute(dataclasses.replace(small[0], deadline=None))
    finally:
        srv.stop()
    outcome = {"first": ok0.ok, "expired": r_late.ok, "queued_a": r_a.ok,
               "failed_batch": r_b.ok, "after": r_after.ok}
    if outcome != {"first": True, "expired": False, "queued_a": True,
                   "failed_batch": False, "after": True} or \
            "deadline" not in r_late.error or "injected" not in r_b.error:
        fail(f"serve degradation: {outcome} ({r_late.error}; {r_b.error})")
    print(json.dumps({"phase": "serve", "case": "degradation",
                      "outcomes_ok": outcome,
                      "rejected_when_full": True}), flush=True)

    # the pipeline executor: batch 2 x 4 virtual ranks of the DP group
    coords_nn = xs[0][torch.as_tensor(nn, device=DEVICE)].cpu().numpy()
    factory = pipeline_executor_factory(
        model, box.numpy(), types_nn.numpy(),
        lambda nb, ranks: suggest_config(nb, box.numpy(), ranks, rcut,
                                         nbr_capacity=sel, coords=coords_nn),
        ranks_for=lambda b: 4)
    psrv = ForceServer(model, params, ServeConfig(
        atom_buckets=(n_dp,), batch_buckets=(2,), nbr_capacity=SERVE_K,
        batch_window_s=0.2), executor_factory=factory)
    dsrv = ForceServer(model, params, ServeConfig(
        atom_buckets=(n_dp,), batch_buckets=(1,), nbr_capacity=SERVE_K))
    try:
        reqs = [request(k, f"pipe{k}") for k in range(2)]
        from repro_torch import kernels
        kernels.reset_launch_counts()
        futs = [psrv.submit(r) for r in reqs]
        got = [f.result(300.0) for f in futs]
        counts_p = kernels.launch_counts()
        errs = []
        for req, res in zip(reqs, got):
            direct = dsrv.evaluate_direct(req)
            if not res.ok or res.diagnostics["batch_size"] != 2:
                fail(f"serve pipeline route: {res.error} "
                     f"{res.diagnostics}")
            if abs(float(res.energy) - float(direct.energy)) > \
                    1e-5 * abs(float(direct.energy)):
                fail(f"serve pipeline route: E {float(res.energy)} vs "
                     f"{float(direct.energy)}")
            errs.append(check("serve pipeline route forces vs direct",
                              res.forces, direct.forces,
                              atol=1e-4 * float(direct.forces.abs().max())))
        check_launch_pattern(counts_p, {**{k: 1 for k in
                                           SINGLE_DOMAIN_KERNELS},
                                        "force_scatter": 2, "cell_filter": 2},
                             "serve pipeline dispatch")
        pipe = psrv._fns[(n_dp, 2)].pipeline
        print(json.dumps({"phase": "serve", "case": "pipeline executor",
                          "batch": 2, "ranks": pipe.cfg.n_ranks,
                          "grid": pipe.cfg.grid_dims,
                          "F_max_abs_err_vs_direct": errs,
                          "launches_per_dispatch": counts_p}), flush=True)
    finally:
        psrv.stop()
        dsrv.stop()
    torch.cuda.empty_cache()
    print(f"[serve] {time.perf_counter() - t_phase:.1f} s", flush=True)
    return served


def serve_clients(server, msys, nn, box, xs):
    """SERVE_CLIENTS MD threads, each through a ``RemoteForceProvider``,
    against ``server``: SERVE_WARM steps each, then (all clients released
    together, counts and tallies reset) SERVE_STEPS steps each.  Every
    request of the window is timed from its submit to its answer
    (``ForceServer._settle``), every dispatch's launches are read inside
    it on the server's stream (the clients' own classical force scatters
    run on theirs), and each model kernel and the DP scatter must launch
    exactly once in every dispatch.  Returns that {kernel: launches}."""
    import threading
    from repro_torch import kernels
    from repro_torch.md import EngineConfig, MDEngine
    from repro_torch.serve import RemoteForceProvider
    window = {"t0": None}
    latencies, dispatches, errors = [], [], []
    settle = server._settle

    def timed_settle(fut, result, event):
        settle(fut, result, event)
        if window["t0"] is not None and fut.t_submit >= window["t0"]:
            latencies.append((fut.request.tenant, event,
                              result.diagnostics["latency_s"]))

    def per_dispatch(fn, tally):
        def run(params_, coords, *rest):
            key = _stream_key()
            before = dict(tally.get(key, {}))
            out = fn(params_, coords, *rest)
            after = tally.get(key, {})
            dispatches.append((int(coords.shape[0]), {
                k: after.get(k, 0) - before.get(k, 0) for k in DP_KERNELS}))
            return out
        return run

    def start_window():
        # every client has its warm-up answers: no dispatch is in flight
        kernels.reset_launch_counts()
        for m, name in MODEL_KERNELS:    # stream_tally's stand-ins count
            getattr(getattr(kernels, m), name).launches = 0
        tally.clear()
        dispatches.clear()
        window["t0"] = time.monotonic()

    barrier = threading.Barrier(SERVE_CLIENTS, action=start_window)

    def client(i):
        try:
            prov = RemoteForceProvider(server, nn, msys.types, box,
                                       msys.n_atoms, tenant=f"sim{i}",
                                       timeout_s=120.0)
            eng = MDEngine(msys, EngineConfig(**MD_CFG), special_force=prov)
            st = eng.run(eng.init_state(xs[i], 200.0, seed=i), SERVE_WARM)
            barrier.wait(300.0)
            st = eng.run(st, SERVE_STEPS)
            check_finite_state(f"serve client {i}", st)
        except Exception as e:  # noqa: BLE001 — reported after the join
            errors.append(e)
            barrier.abort()

    def served_run(tally_):
        nonlocal tally
        tally = tally_
        fns = dict(server._fns)
        for key, fn in fns.items():
            server._fns[key] = per_dispatch(fn, tally)
        server._settle = timed_settle
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(SERVE_CLIENTS)]
        try:
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            torch.cuda.synchronize()
            return time.monotonic() - window["t0"]
        finally:
            server._fns.update(fns)
            server._settle = settle

    tally = None
    wall = stream_tally(served_run)
    counts = kernels.launch_counts()
    if errors:
        raise errors[0]
    n_req = SERVE_CLIENTS * SERVE_STEPS
    if len(latencies) != n_req or any(ev != "complete"
                                      for _, ev, _ in latencies):
        fail(f"serve clients: {len(latencies)} answers in the window for "
             f"{n_req} requests, events "
             f"{sorted({ev for _, ev, _ in latencies})}")
    want = {k: 1 for k in SINGLE_DOMAIN_KERNELS}
    for b, got in dispatches:
        check_launch_pattern(got, want, f"served dispatch of batch {b}")
    if sum(b for b, _ in dispatches) < n_req:
        fail(f"serve clients: {len(dispatches)} dispatches of "
             f"{sum(b for b, _ in dispatches)} rows for {n_req} requests")
    # every launch of the window is one the tallies saw, and the model
    # kernels launched in the dispatches only
    seen = {k: sum(per.get(k, 0) for per in tally.values())
            for k in DP_KERNELS}
    for k in DP_KERNELS:
        if seen[k] != counts[k]:
            fail(f"serve clients: {k} launched {counts[k]} times, "
                 f"{seen[k]} calls tallied")
        in_dispatch = sum(got[k] for _, got in dispatches)
        if k != "force_scatter" and in_dispatch != counts[k]:
            fail(f"serve clients: {k} launched {counts[k]} times, "
                 f"{in_dispatch} of them in dispatches")
    lat = np.array([x for _, _, x in latencies]) * 1e3
    by_tenant = {}
    for t, _, x in latencies:
        by_tenant.setdefault(t, []).append(x * 1e3)
    sizes = [b for b, _ in dispatches]
    per = {k: want.get(k, 0) for k in kernels.KERNELS}
    print(json.dumps({
        "phase": "serve", "case": "md clients", "clients": SERVE_CLIENTS,
        "warmup_steps": SERVE_WARM, "steps": SERVE_STEPS,
        "requests": n_req, "window_s": wall,
        "requests_per_s": n_req / wall, "dispatches": len(dispatches),
        "mean_batch": n_req / len(dispatches),
        "batch_sizes": {b: sizes.count(b) for b in sorted(set(sizes))},
        "latency_ms": {"p50": float(np.percentile(lat, 50)),
                       "p99": float(np.percentile(lat, 99)),
                       "max": float(lat.max()), "mean": float(lat.mean())},
        "latency_how": "each request's submit-to-answer time, over every "
                       "request of the window (numpy percentile, linear)",
        "p50_latency_ms_by_tenant": {t: float(np.percentile(v, 50))
                                     for t, v in sorted(by_tenant.items())},
        "launches_per_served_dispatch": per,
        "force_scatter_launches_outside_dispatches":
            counts["force_scatter"] - len(dispatches),
        "launches": counts}), flush=True)
    return per


# ---------------------------------------------------------------------------
# serve_procs: DP force serving over a (replica x dd) process mesh
# ---------------------------------------------------------------------------

SERVE_PROCS_DIR = Path(__file__).resolve().parent / "build" / "serve_procs"
SERVE_PROCS_SHARDS = 2        # replica shards of the (2, 1) and (2, 2) layouts
SERVE_PROCS_GLOO_STEPS = 10   # client MD steps of the two gloo processes
# the two gloo processes' idle spell: process 0 idles SERVE_PROCS_IDLE_S,
# longer than a follower waits for a header (SERVE_PROCS_FOLLOW_S; a
# keep-alive header after an eighth of it idle)
SERVE_PROCS_IDLE_S, SERVE_PROCS_FOLLOW_S = 5.0, 4.0


def serve_procs_setup(model, device):
    """The serve phase's system (a DP group of 4,096 atoms), its box and
    types, one request per replica position (SERVE_BATCHES' largest), and
    the DD configuration of a request over ``ranks`` ranks."""
    from repro_torch.backend import ForceRequest
    from repro_torch.core import suggest_config
    from repro_torch.md import build_solvated_protein, mark_nn_group
    from repro_torch.md.integrators import wrap
    msys, pos, nn = build_solvated_protein(SERVE_RESIDUES, device=device)
    msys = mark_nn_group(msys, nn)
    box = msys.box.cpu()
    nn_t = torch.as_tensor(nn)
    types_nn = msys.types.cpu()[nn_t]
    xs = replica_positions(pos, msys.box, max(SERVE_BATCHES))
    coords_nn = xs[0].cpu()[nn_t].numpy()
    desc = model.cfg.descriptor
    return {"msys": msys, "nn": nn, "box": box, "types": types_nn,
            "xs": xs, "n": len(nn),
            "reqs": [ForceRequest(positions=wrap(x.cpu()[nn_t], box),
                                  box=box, types=types_nn, tenant=f"r{k}")
                     for k, x in enumerate(xs)],
            "cfg_for": lambda nb, ranks: suggest_config(
                nb, box.numpy(), ranks, desc.rcut, nbr_capacity=desc.sel,
                coords=coords_nn)}


def serve_procs_factory(model, s, device=None, backend=None, shards=1,
                        timeout=None, idle=False):
    """The served pipeline's executor factory: virtual (``device`` None:
    8 // batch virtual ranks) or over the process mesh of each batch
    bucket, ``min(batch, shards)`` replica shards x 8 // batch dd ranks
    (the virtual route's ranks); with ``idle`` the followers wait
    SERVE_PROCS_FOLLOW_S for a header."""
    from repro_torch.launch.mesh import make_ensemble_mesh
    from repro_torch.serve import pipeline_executor_factory
    mesh_for = None
    if device is not None:
        def mesh_for(b):
            return make_ensemble_mesh(min(b, shards), max(N_RANKS // b, 1),
                                      device=device, backend=backend,
                                      timeout=timeout)
    kw = {"follow_timeout": datetime.timedelta(
        seconds=SERVE_PROCS_FOLLOW_S)} if idle else {}
    return pipeline_executor_factory(model, s["box"].numpy(),
                                     s["types"].numpy(), s["cfg_for"],
                                     mesh_for=mesh_for, **kw)


def serve_procs_server(model, params, s, factory):
    from repro_torch.serve import ForceServer, ServeConfig
    return ForceServer(model, params, ServeConfig(
        atom_buckets=(s["n"],), batch_buckets=SERVE_BATCHES,
        nbr_capacity=SERVE_K, batch_window_s=0.5), executor_factory=factory)


def serve_procs_sequence(server, s):
    """The requests every route serves: the 4 requests at once (one
    dispatch of the batch bucket 4), then 2 (bucket 2), then
    ``evaluate_direct`` of the first (bucket 1).  Returns each result's
    (energy, forces, overflow, batch bucket)."""
    out = []
    for group in (s["reqs"], s["reqs"][:2]):
        futs = [server.submit(r) for r in group]
        out += [f.result(300.0) for f in futs]
    out.append(server.evaluate_direct(s["reqs"][0]))
    for r in out:
        if not r.ok:
            fail(f"serve_procs: {r.error}")
    return [(r.energy, r.forces, r.diagnostics["overflow"],
             r.diagnostics["batch_bucket"]) for r in out]


def serve_procs_dispatch(server, params, s, b):
    """The bucket-``b`` executor and its padded arguments on the card."""
    from repro_torch.serve import pad_group
    arrs = [torch.as_tensor(a, device=server.device) for a in
            pad_group(s["reqs"][:b], s["n"], SERVE_BATCHES)]
    fn = server._bucket_fn(s["n"], b)
    return lambda: fn(params, *arrs)


def serve_procs_clients(server, s, steps, meshes):
    """SERVE_CLIENTS MD threads through ``RemoteForceProvider``s against
    ``server``: SERVE_WARM steps each, then ``steps`` each, timed: requests/s,
    every request's latency, the dispatches' ms (host clock, synchronised
    inside the dispatch) and the meshes' collectives by tag (this
    process's)."""
    import threading
    from repro_torch.md import EngineConfig, MDEngine
    from repro_torch.serve import RemoteForceProvider
    window = {"t0": None}
    latencies, dispatch_ms, errors = [], [], []
    settle = server._settle

    def timed_settle(fut, result, event):
        settle(fut, result, event)
        if window["t0"] is not None and fut.t_submit >= window["t0"]:
            latencies.append((event, result.diagnostics["latency_s"]))

    def timed(fn):
        def run(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            if window["t0"] is not None:
                dispatch_ms.append((int(args[1].shape[0]),
                                    (time.perf_counter() - t0) * 1e3))
            return out
        return run

    def start_window():
        for m in meshes:
            m.record = []
        window["t0"] = time.monotonic()

    barrier = threading.Barrier(SERVE_CLIENTS, action=start_window)
    msys = s["msys"]

    def client(i):
        try:
            prov = RemoteForceProvider(server, s["nn"], msys.types, s["box"],
                                       msys.n_atoms, tenant=f"sim{i}",
                                       timeout_s=300.0)
            eng = MDEngine(msys, EngineConfig(**MD_CFG), special_force=prov)
            st = eng.run(eng.init_state(s["xs"][i], 200.0, seed=i),
                         SERVE_WARM)
            barrier.wait(600.0)
            check_finite_state(f"serve_procs client {i}",
                               eng.run(st, steps))
        except Exception as e:  # noqa: BLE001 — reported after the join
            errors.append(e)
            barrier.abort()

    fns = dict(server._fns)
    for key, fn in fns.items():
        server._fns[key] = timed(fn)
    server._settle = timed_settle
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(SERVE_CLIENTS)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        torch.cuda.synchronize()
        wall = time.monotonic() - window["t0"]
    finally:
        server._fns.update(fns)
        server._settle = settle
    if errors:
        raise errors[0]
    n_req = SERVE_CLIENTS * steps
    if len(latencies) != n_req or any(ev != "complete"
                                      for ev, _ in latencies):
        fail(f"serve_procs clients: {len(latencies)} answers for {n_req} "
             f"requests, events {sorted({ev for ev, _ in latencies})}")
    lat = np.array([x for _, x in latencies]) * 1e3
    coll = {}
    for m in meshes:
        for tag, ms in m.collective_ms().items():
            coll[tag] = coll.get(tag, 0.0) + ms
        m.record = None
    sizes = [b for b, _ in dispatch_ms]
    return {"clients": SERVE_CLIENTS, "warmup_steps": SERVE_WARM,
            "steps": steps, "requests": n_req, "window_s": wall,
            "requests_per_s": n_req / wall,
            "latency_ms": {"p50": float(np.percentile(lat, 50)),
                           "p99": float(np.percentile(lat, 99)),
                           "max": float(lat.max())},
            "dispatches": len(dispatch_ms),
            "batch_sizes": {b: sizes.count(b) for b in sorted(set(sizes))},
            "ms_per_dispatch_median": statistics.median(
                [ms for _, ms in dispatch_ms]),
            "collective_ms_per_dispatch_by_tag_process0": {
                k: v / len(dispatch_ms) for k, v in coll.items()}}


def serve_procs_child(task_path, rank):
    """One process of a ``serve_procs`` group (``chip_smoke.py
    --serve-procs-child TASK RANK``): joins the group through ``file://``
    rendezvous; process 0 runs the ``ForceServer`` over the mesh (the
    served sequence, then the task's client MD run), the others
    ``follow_dispatches``; every process keeps each dispatch's outputs and
    its collectives' ms.  Saves the result beside ``TASK``."""
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.dp import DPModel, paper_dpa1_config
    from repro_torch.serve import follow_dispatches
    task = torch.load(task_path, weights_only=False)
    dev = torch.device(DEVICE, task["devices"][rank]) if DEVICE == "cuda" \
        else torch.device(DEVICE)
    torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=PROCS_GROUP_S)
    dist.init_process_group(
        task["backend"], init_method=f"file://{task['rendezvous']}",
        rank=rank, world_size=task["world"], timeout=timeout)
    try:
        model = DPModel(paper_dpa1_config(ntypes=4, rcut=0.6, sel=64),
                        device=dev)
        params = model.init_params(torch.Generator().manual_seed(SEED))
        s = serve_procs_setup(model, dev)
        factory = serve_procs_factory(model, s, dev, task["backend"],
                                      SERVE_PROCS_SHARDS, timeout,
                                      idle=task["idle"])
        out = {"process": rank, "device": str(dev)}
        kernels.reset_launch_counts()
        if rank == 0:
            server = serve_procs_server(model, params, s, factory)
            factory.kept = []
            try:
                server.warmup()
                out["results"] = serve_procs_sequence(server, s)
                if task["idle"]:
                    # idle past the followers' header timeout, then serve
                    # the first request alone again: evaluate_direct's bits
                    time.sleep(SERVE_PROCS_IDLE_S)
                    res = server.evaluate_direct(s["reqs"][0])
                    if not res.ok:
                        fail(f"serve_procs: after the idle spell: "
                             f"{res.error}")
                    out["idle"] = (res.energy, res.forces)
                out["layouts"] = {b: dict(m.shape) for b, m in
                                  factory.meshes.items()}
                if task["steps"]:
                    out["clients"] = serve_procs_clients(
                        server, s, task["steps"],
                        list(factory.meshes.values()))
            finally:
                server.stop()
            out["kept"] = factory.kept
        else:
            out["kept"] = follow_dispatches(factory, params, SERVE_BATCHES,
                                            keep=True)
        out["launches"] = {k: n for k, n in kernels.launch_counts().items()
                           if n}
        torch.save(out, f"{task_path}.out{rank}")
    finally:
        dist.destroy_process_group()
    return 0


def serve_procs_spawn(case, world, backend, devices, steps, idle=False):
    """Start ``world`` children on ``devices`` and wait for all (the
    dd_procs phase's rules: any failure, or a group still running after
    PROCS_CHILD_S, fails the phase)."""
    task = SERVE_PROCS_DIR / f"{case}.pt"
    torch.save({"world": world, "backend": backend, "devices": devices,
                "steps": steps, "idle": idle,
                "rendezvous": str(SERVE_PROCS_DIR / f"{case}.rendezvous")},
               task)
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               "--serve-procs-child", str(task), str(r)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    deadline = time.perf_counter() + PROCS_CHILD_S
    logs = {}
    try:
        for r, p in enumerate(procs):
            logs[r] = p.communicate(
                timeout=max(deadline - time.perf_counter(), 1.0))[0]
    except subprocess.TimeoutExpired:
        fail(f"serve_procs {case}: the {world} processes did not finish in "
             f"{PROCS_CHILD_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            fail(f"serve_procs {case}: process {r} exited {p.returncode}:\n"
                 f"{logs[r][-6000:]}")
    return [torch.load(f"{task}.out{r}", weights_only=False)
            for r in range(world)]


def serve_procs_gates(case, outs, want):
    """Process 0's served results within the DP gate of ``want`` (E rtol
    1e-5, F atol 1e-4 x max|F|), overflow flags and buckets exact, and
    every process's kept dispatches the same bits as process 0's."""
    got = outs[0]["results"]
    errs = []
    for (e, f, ovf, b), (e0, f0, ovf0, b0) in zip(got, want):
        if (ovf, b) != (ovf0, b0):
            fail(f"serve_procs {case}: overflow/bucket {(ovf, b)} vs "
                 f"{(ovf0, b0)}")
        if abs(float(e) - float(e0)) > 1e-5 * abs(float(e0)):
            fail(f"serve_procs {case}: E {float(e)} vs {float(e0)}")
        errs.append(check(f"serve_procs {case} forces", f, f0,
                          atol=1e-4 * float(f0.abs().max())))
    kept = outs[0]["kept"]
    for out in outs[1:]:
        if len(out["kept"]) != len(kept) or not all(
                a[:3] == b[:3] and all(torch.equal(x, y)
                                       for x, y in zip(a[3:], b[3:]))
                for a, b in zip(out["kept"], kept)):
            fail(f"serve_procs {case}: process {out['process']}'s "
                 "dispatches differ from process 0's")
    return max(errs)


def phase_serve_procs(model, params, smi):
    """DP force serving over a process mesh (``pipeline_executor_factory(
    ..., mesh_for=...)``, the ``ForceServer`` on process 0,
    ``follow_dispatches`` on the others), the serve phase's model and DP
    group, batch buckets 1, 2 and 4 (each request over 8 // batch dd
    ranks): (i) a (1, 1) NCCL mesh in this process against the virtual
    route, every served result bit for bit, the launches per dispatch
    equal, each model kernel against its plain version on the batch-4
    dispatch's rows; (ii) two gloo processes sharing this card as (2, 1):
    within the DP gate of (i), the same bits on both processes, a request
    served after an idle spell longer than the followers' header timeout
    with the bits it got before, and SERVE_PROCS_GLOO_STEPS client MD
    steps; (iii) with 4 cards (2, 2) over
    NCCL, 4 client MD threads on process 0 for SERVE_STEPS, else a line
    saying why not.  Returns the launches per served dispatch over the
    (1, 1) mesh."""
    import shutil

    import torch.distributed as dist
    t_phase = time.perf_counter()
    shutil.rmtree(SERVE_PROCS_DIR, ignore_errors=True)
    SERVE_PROCS_DIR.mkdir(parents=True)
    s = serve_procs_setup(model, DEVICE)
    n = s["n"]
    # the virtual route
    vserver = serve_procs_server(model, params, s,
                                 serve_procs_factory(model, s))
    try:
        vserver.warmup()
        want = serve_procs_sequence(vserver, s)
        vfn = serve_procs_dispatch(vserver, params, s, max(SERVE_BATCHES))
        with torch.no_grad():
            v_counts, _ = launches_of(vfn)
            v_ms = host_ms(vfn)
    finally:
        vserver.stop()
    del vserver, vfn
    torch.cuda.empty_cache()
    # (i) one process, (1, 1) NCCL
    timeout = datetime.timedelta(seconds=PROCS_GROUP_S)
    dist.init_process_group(
        "nccl", init_method=f"file://{SERVE_PROCS_DIR / 'one.rendezvous'}",
        rank=0, world_size=1, timeout=timeout)
    try:
        dev = torch.device(DEVICE, torch.cuda.current_device()) \
            if DEVICE == "cuda" else torch.device(DEVICE)
        factory = serve_procs_factory(model, s, dev, None, 1, timeout)
        server = serve_procs_server(model, params, s, factory)
        try:
            server.warmup()
            got = serve_procs_sequence(server, s)
            fn = serve_procs_dispatch(server, params, s, max(SERVE_BATCHES))
            with torch.no_grad():
                counts, _ = launches_of(fn)
                (_, seen), cf_calls = record_cell_filter(
                    lambda: record_model_kernels(fn))
                phase = "serve_procs (1, 1) batch 4"
                checks = {"force_scatter": check_dd_model_kernels(seen,
                                                                  phase),
                          "cell_filter": check_cell_filter_calls(cf_calls,
                                                                 phase)}
                del seen, cf_calls
                ms = host_ms(fn)
            layouts = {b: dict(m.shape) for b, m in factory.meshes.items()}
        finally:
            server.stop()
    finally:
        dist.destroy_process_group()
    del server, factory, fn
    torch.cuda.empty_cache()
    if not all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
               and a[2:] == b[2:] for a, b in zip(got, want)):
        fail("serve_procs (1, 1): a served result differs from the "
             "virtual route's")
    if counts != v_counts:
        fail(f"serve_procs (1, 1): launches per dispatch {counts} vs the "
             f"virtual route's {v_counts}")
    check_launch_pattern(counts, {**{k: 1 for k in SINGLE_DOMAIN_KERNELS},
                                  "force_scatter": 2, "cell_filter": 2},
                         "serve_procs (1, 1) dispatch")
    per = {k: n for k, n in counts.items() if n}
    print(json.dumps({
        "phase": "serve_procs", "case": "nccl_1x1", "device": smi,
        "dp_atoms": n, "batch_buckets": SERVE_BATCHES,
        "layouts_by_bucket": layouts, "served": len(got),
        "bitwise_equal_virtual": True,
        "launches_per_dispatch_batch4": per,
        "virtual_launches_per_dispatch_batch4": {
            k: v for k, v in v_counts.items() if v},
        "ms_per_dispatch_batch4": ms, "virtual_ms_per_dispatch_batch4": v_ms,
        "ms_is": "host clock, median of 3 synchronised executor calls",
        "kernel_checks": {"cell_filter": list(checks["cell_filter"])}}),
        flush=True)
    # (ii) two processes sharing this card: gloo on CUDA tensors, (2, 1)
    card = torch.cuda.current_device()
    outs = serve_procs_spawn("gloo_2_processes", 2, "gloo", [card, card],
                             SERVE_PROCS_GLOO_STEPS, idle=True)
    err = serve_procs_gates("gloo_2_processes", outs, want)
    e_idle, f_idle = outs[0]["idle"]
    e_dir, f_dir = outs[0]["results"][-1][:2]
    if not (torch.equal(e_idle, e_dir) and torch.equal(f_idle, f_dir)):
        fail("serve_procs gloo_2_processes: the request after the idle "
             "spell differs from the same request before it")
    print(json.dumps({
        "phase": "serve_procs", "case": "gloo_2_processes", "device": smi,
        "layouts_by_bucket": outs[0]["layouts"],
        "F_max_abs_err_vs_1x1": err, "E_tol": "rtol 1e-5",
        "F_tol": "atol 1e-4*max|F|", "processes_bit_identical": True,
        "idle_s": SERVE_PROCS_IDLE_S, "follow_timeout_s": SERVE_PROCS_FOLLOW_S,
        "served_after_idle_bitwise": True,
        "dispatches": len(outs[0]["kept"]),
        "clients": outs[0].get("clients"),
        "launches_by_process": [o["launches"] for o in outs]}), flush=True)
    del outs
    # (iii) four cards: NCCL, one card a process, (2, 2)
    n_cards = torch.cuda.device_count()
    if n_cards >= 4:
        outs = serve_procs_spawn("nccl_4_cards", 4, "nccl", [0, 1, 2, 3],
                                 SERVE_STEPS)
        err = serve_procs_gates("nccl_4_cards", outs, want)
        print(json.dumps({
            "phase": "serve_procs", "case": "nccl_4_cards", "device": smi,
            "layouts_by_bucket": outs[0]["layouts"],
            "F_max_abs_err_vs_1x1": err, "processes_bit_identical": True,
            "dispatches": len(outs[0]["kept"]),
            "clients": outs[0]["clients"],
            "launches_by_process": [o["launches"] for o in outs]}),
            flush=True)
        del outs
    else:
        print(json.dumps({
            "phase": "serve_procs", "case": "nccl_4_cards", "ran": False,
            "why": f"{n_cards} CUDA device(s) here: the (2, 2) layout takes "
                   "4 processes and NCCL one card a process"}), flush=True)
    shutil.rmtree(SERVE_PROCS_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    print(json.dumps({"phase": "serve_procs", "device": smi,
                      "s": time.perf_counter() - t_phase}), flush=True)
    return per


# ---------------------------------------------------------------------------
# train: DPA-1 force-matching training (the paper's Fig. 7 pipeline)
# ---------------------------------------------------------------------------

# the reference example's run (examples/train_dpa1.py) and a timed run at
# the MD model's capacity (sel 64; 8 frames of 256 atoms = 2,048 a step)
TRAIN_EXAMPLE = dict(frames=128, atoms=32, sel=24, batch=8, lr0=2e-3,
                     steps=20, eval_every=10)
TRAIN_TIMED = dict(frames=64, atoms=256, sel=64, batch=8, steps=11)
# tests/test_torch_train.py's gates against JAX: the loss rtol 1e-5, each
# gradient leaf atol 2e-5 x max|leaf|; the global norm sums the leaves
TRAIN_LOSS_RTOL, TRAIN_GRAD_ATOL = 1e-5, 2e-5
TRAIN_ROUTE = {"loss": "second_order: env matrix and attention stack in "
                       "plain PyTorch under autograd (the reference's jnp "
                       "training route), the neighbour gather's force "
                       "scatter kernel in both orders",
               "force_rmse": "kernels, first order (env_mat, "
                             "nbr_attention_stack, force_scatter)"}
TRAIN_LOSS_KERNELS = ("force_scatter",)
TRAIN_NO_KERNELS = ("env_mat_fwd", "env_mat_bwd", "nbr_attention_stack_fwd",
                    "nbr_attention_stack_bwd", "cell_filter")


def train_counts(fn, where):
    """(fn's result, launches by kernel, force-scatter calls by call site)
    of one call of ``fn``, with the counts reset just before it and read
    just after it (synchronised); the sites are named by ``where`` from
    the (rows, K) of their index table."""
    from repro_torch import kernels
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    res, by_shape = scatter_calls_by_shape(fn)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    if sum(by_shape.values()) != counts["force_scatter"]:
        fail(f"train {where}: force scatter calls by site {by_shape} do not "
             f"add up to its {counts['force_scatter']} launches")
    return res, counts, _sites(where, by_shape)


def _sites(where, by_shape):
    return {f"{where} gather backward {rows}x{k}": n
            for (rows, k), n in by_shape.items()}


def _per(counts, n):
    return {k: v / n for k, v in counts.items()}


def train_run_counts(fn):
    """One training run ``fn()`` (``train`` as a user calls it) with the
    counts reset just before it and read just after it, and ``force_rmse``
    wrapped so that the launches of its evaluations are told apart from
    the steps'.  Returns (fn's result, launches of the whole run, of its
    steps, of its force_rmse calls, their force-scatter calls by (rows,
    K), the number of force_rmse calls)."""
    import importlib
    from repro_torch import kernels
    dtrain = importlib.import_module("repro_torch.dp.train")
    original = dtrain.force_rmse
    inside = {k: 0 for k in kernels.KERNELS}
    inside_shapes, calls = {}, [0]

    def counted(*args, **kwargs):
        torch.cuda.synchronize()
        before = kernels.launch_counts()
        out, by_shape = scatter_calls_by_shape(
            lambda: original(*args, **kwargs))
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        for k in inside:
            inside[k] += after[k] - before[k]
        for shape, n in by_shape.items():
            inside_shapes[shape] = inside_shapes.get(shape, 0) + n
        calls[0] += 1
        return out

    dtrain.force_rmse = counted
    try:
        res, counts, _ = train_counts(fn, "train run")
    finally:
        dtrain.force_rmse = original
    # the force scatter's launches go to the wrapper while it is in place,
    # so its share inside force_rmse is the tally's
    inside["force_scatter"] = sum(inside_shapes.values())
    steps = {k: counts[k] - inside[k] for k in counts}
    return res, counts, steps, inside, inside_shapes, calls[0]


def check_step_launches(step_counts, what):
    """Training steps launch the gather's force scatter and no model
    kernel (the training route)."""
    for k in TRAIN_LOSS_KERNELS:
        if step_counts[k] == 0:
            fail(f"train {what}: the training steps never launched {k}: "
                 f"{step_counts}")
    for k in TRAIN_NO_KERNELS:
        if step_counts[k]:
            fail(f"train {what}: a training step launched {k}: {step_counts}")


def check_rmse_launches(rmse_counts, what):
    """force_rmse launches rows 1-4 and 7 (the kernel route) and no cell
    filter."""
    for k in SINGLE_DOMAIN_KERNELS:
        if rmse_counts[k] == 0:
            fail(f"train {what}: force_rmse never launched {k}: {rmse_counts}")
    if rmse_counts["cell_filter"]:
        fail(f"train {what}: force_rmse launched cell_filter: {rmse_counts}")


def train_setup(spec, device):
    """Dataset (seed 0), split 0.15, the paper's DPA-1 at ``spec``'s sel
    with env stats from the training set, and the initial parameters
    (``torch.Generator`` seeded 0, energy bias fitted) on ``device``."""
    from repro_torch.data import make_dataset
    from repro_torch.dp import DPModel, fit_env_stats, paper_dpa1_config
    from repro_torch.dp.train import fit_energy_bias
    t0 = time.perf_counter()
    data = make_dataset(spec["frames"], n_atoms=spec["atoms"], seed=0,
                        device=device)
    tr, va = data.split(0.15)
    cfg = paper_dpa1_config(ntypes=4, rcut=0.6, sel=spec["sel"])
    model = DPModel(cfg, fit_env_stats(cfg, tr, device=device), device=device)
    params = model.init_params(torch.Generator().manual_seed(0))
    params["bias"] = torch.as_tensor(fit_energy_bias(tr, 4), device=device)
    return tr, va, model, params, (time.perf_counter() - t0) * 1e3


def train_steps(model, params, arrays, cfg, steps, timed=False):
    """``steps`` Adam steps from ``params``, each as ``train`` takes it
    (the step's batch selected on the device, its step counter made, the
    step); returns (params, per-step [loss, global gradient norm, grads,
    ms]).  With ``timed`` each step is synchronised at both ends, so its
    ms covers all of it, the batch selection included."""
    from repro_torch.dp.train import make_train_step, select_batch
    from repro_torch.optim import adam, exponential_decay, global_norm
    lr_fn = exponential_decay(cfg.lr0, cfg.decay_steps, cfg.decay_rate)
    opt = adam(lr_fn)
    step_fn = make_train_step(model, cfg, lr_fn, opt)
    state = opt.init(params)
    dev = model.device
    out = []
    for step in range(steps):
        if timed:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss, _, _, grads = step_fn(
            params, state, select_batch(arrays, cfg, step),
            torch.tensor(step, dtype=torch.int32, device=dev))
        if timed:
            torch.cuda.synchronize()
        out.append((loss, grads, (time.perf_counter() - t0) * 1e3))
    return params, [(float(loss), float(global_norm(grads)), grads, ms)
                    for loss, grads, ms in out]


def check_train_steps(card, cpu, what):
    """Training steps on the card against the port's on the CPU from the
    same parameters and batches: the loss rtol TRAIN_LOSS_RTOL, the global
    gradient norm rtol TRAIN_GRAD_ATOL, each gradient leaf atol
    TRAIN_GRAD_ATOL x max|leaf|.  Returns the largest leaf error over its
    leaf's max."""
    from repro_torch.optim.adam import tree_leaves
    grad_err = 0.0
    for i, (a, b) in enumerate(zip(card, cpu)):
        if abs(a[0] - b[0]) > TRAIN_LOSS_RTOL * abs(b[0]):
            fail(f"train {what}: step {i} loss card {a[0]} vs cpu {b[0]}")
        if abs(a[1] - b[1]) > TRAIN_GRAD_ATOL * abs(b[1]):
            fail(f"train {what}: step {i} gradient norm card {a[1]} vs cpu "
                 f"{b[1]}")
        for ga, gb in zip(tree_leaves(a[2]), tree_leaves(b[2])):
            scale = float(gb.abs().max()) or 1.0
            grad_err = max(grad_err, check(
                f"train {what} step {i} gradient", ga.cpu(), gb,
                atol=TRAIN_GRAD_ATOL * scale) / scale)
    return grad_err


def check_force_rmse(model, params, arrays, got, what, frames=32):
    """The force calls behind ``force_rmse(model, params, arrays, frames)``
    on the card against the port's on the CPU with the same parameters and
    arrays, at the DP gate (F atol 1e-4 x max|F| per call), and ``got``
    (the card's force_rmse) against force_rmse's sum over the CPU's
    forces.  Forces within d of each other everywhere give RMSEs within d,
    so the RMSE's gate is 1e-4 x the largest max|F|.  Returns (the CPU's
    RMSE, the largest force error over its call's max|F|)."""
    from repro_torch.dp import DPModel
    from repro_torch.dp.train import EVAL_CHUNK
    cpu_model = DPModel(model.cfg, model.stats, device="cpu")
    p_cpu = _tree(params, lambda t: t.cpu())
    a_cpu = {k: v.cpu() for k, v in arrays.items()}
    n = min(frames, len(arrays["energies"]))
    fmax = err = sq = 0.0
    count = 0
    for lo in range(0, n, EVAL_CHUNK):
        sl = slice(lo, min(lo + EVAL_CHUNK, n))
        f_card, f_cpu = (
            m.energy_and_forces_batched(
                p, a["coords"][sl], a["types"][sl], a["nbr_idx"][sl],
                a["nbr_mask"][sl], torch.ones(a["coords"][sl].shape[:2],
                                              device=a["coords"].device))[1]
            for m, p, a in ((model, params, arrays),
                            (cpu_model, p_cpu, a_cpu)))
        scale = float(f_cpu.abs().max())
        err = max(err, check(f"train {what} force_rmse forces, frames "
                             f"{sl.start}-{sl.stop}", f_card.cpu(), f_cpu,
                             atol=1e-4 * scale) / scale)
        fmax = max(fmax, scale)
        sq += float(((f_cpu - a_cpu["forces"][sl]) ** 2).sum())
        count += f_cpu.numel()
    want = float(np.sqrt(sq / count))   # force_rmse's sum, on the CPU
    if abs(got - want) > 1e-4 * fmax:
        fail(f"train {what}: force_rmse card {got} vs cpu {want} "
             f"(gate 1e-4 x max|F| = {1e-4 * fmax:.3e})")
    return want, err


def phase_train():
    """The example's run through ``train`` on the card (its history, the
    launches of its steps and of its ``force_rmse`` calls, its force RMSEs
    at the mid-run checkpoint and at the end against the CPU, a restart
    from that checkpoint bit for bit, the first two steps against the
    port on the CPU, 11 timed steps), then the timed run at sel 64 (11
    timed steps, the first against the CPU; three timed ``force_rmse``
    calls, held against the CPU)."""
    import shutil
    import tempfile
    from repro_torch.ckpt import load_pytree
    from repro_torch.dp import DPModel, TrainConfig, force_rmse, train
    from repro_torch.dp.train import prepare_batches
    from repro_torch.optim import adam, exponential_decay
    from repro_torch.optim.adam import tree_leaves
    t_phase = time.perf_counter()
    ex = TRAIN_EXAMPLE
    tr, va, model, params0, setup_ms = train_setup(ex, DEVICE)
    cfg = TrainConfig(n_steps=ex["steps"], eval_every=ex["eval_every"],
                      batch_size=ex["batch"], lr0=ex["lr0"],
                      checkpoint_every=ex["steps"] // 2)
    d = model.cfg.descriptor
    # the arrays that train() builds, for the checks against the CPU
    arrays = prepare_batches(tr, d.rcut, d.sel, DEVICE)
    arrays_va = prepare_batches(va, d.rcut, d.sel, DEVICE)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_train_")
    try:
        full_dir, resumed_dir = Path(tmp.name, "full"), Path(tmp.name, "resumed")
        # the main path: train() as a user calls it
        hist = []
        t0 = time.perf_counter()
        (params, _), counts, step_counts, rmse_counts, rmse_shapes, n_rmse = \
            train_run_counts(lambda: train(model, tr, va, dataclasses.replace(
                cfg, checkpoint_dir=str(full_dir)), log=hist.append))
        run_ms = (time.perf_counter() - t0) * 1e3
        for rec in hist:
            if not all(np.isfinite(v) for v in rec.values()):
                fail(f"train: non-finite history record {rec}")
            print(json.dumps({"phase": "train", "run": "example", **rec}),
                  flush=True)
        check_step_launches(step_counts, "example run")
        check_rmse_launches(rmse_counts, "example run")
        # the history's force RMSEs at the mid-run checkpoint and at the end
        mid = f"step_{cfg.checkpoint_every:09d}"
        opt_like = adam(exponential_decay(cfg.lr0, cfg.decay_steps,
                                          cfg.decay_rate)).init(params)
        mid_params = load_pytree(str(full_dir / mid), like={
            "params": params, "opt": opt_like})["params"]
        by_step = {rec["step"]: rec for rec in hist}
        rmse_checks = []
        for step, p in ((cfg.checkpoint_every, mid_params),
                        (cfg.n_steps - 1, params)):
            for key, arr in (("rmse_f_train", arrays),
                             ("rmse_f_valid", arrays_va)):
                got = by_step[step][key]
                want, err = check_force_rmse(model, p, arr, got,
                                             f"example step {step} {key}")
                rmse_checks.append({"step": step, "key": key, "card": got,
                                    "cpu": want, "F_max_err_over_max": err})
        # a restart from the mid-run checkpoint
        shutil.copytree(full_dir / mid, resumed_dir / mid)
        resumed, hist_b = train(model, tr, va, dataclasses.replace(
            cfg, checkpoint_dir=str(resumed_dir)))
        diffs = [float((a - b).abs().max())
                 for a, b in zip(tree_leaves(resumed), tree_leaves(params))]
        if max(diffs) != 0.0 or hist_b[-1]["loss"] != hist[-1]["loss"]:
            fail(f"train: the run restored from {mid} ends {max(diffs):.3e} "
                 "away from the uninterrupted run (required: bit for bit)")
    finally:
        tmp.cleanup()
    # the first two steps on the card against the port on the CPU
    cpu_model = DPModel(model.cfg, model.stats, device="cpu")
    _, card = train_steps(model, params0, arrays, cfg, 2)
    _, cpu = train_steps(cpu_model, _tree(params0, lambda t: t.cpu()),
                         {k: v.cpu() for k, v in arrays.items()}, cfg, 2)
    grad_err = check_train_steps(card, cpu, "example")
    (_, timed), timed_counts, timed_sites = train_counts(
        lambda: train_steps(model, params0, arrays, cfg, 11, timed=True),
        "training step")
    check_step_launches(timed_counts, "example, timed steps")
    if timed[0][0] != card[0][0]:
        fail("train: a repeated first step gave another loss")
    device_profile(lambda: train_steps(model, params0, arrays, cfg, 1),
                   "train", "one training step, example run (256 atoms, "
                   "sel 24)", host_ops=True)
    print(json.dumps({
        "phase": "train", "run": "example", "route": TRAIN_ROUTE,
        "config": "paper_dpa1_config(ntypes=4, rcut=0.6, sel=24), "
                  "make_dataset(128, n_atoms=32, seed=0), split 0.15, "
                  "TrainConfig(batch_size=8, lr0=2e-3), 20 steps, "
                  "eval_every=10",
        "setup_ms": setup_ms, "train_ms": run_ms,
        "ms_per_train_step_median_steps_2_10":
            statistics.median(s[3] for s in timed[2:11]),
        "ms_per_train_step_covers": "the batch selection and the step, "
                                    "synchronised at both ends",
        "loss_card_vs_cpu": [[a[0], b[0]] for a, b in zip(card, cpu)],
        "grad_norm_card_vs_cpu": [[a[1], b[1]] for a, b in zip(card, cpu)],
        "grad_max_err_over_max": grad_err,
        "tol": f"loss rtol {TRAIN_LOSS_RTOL}, each gradient leaf atol "
               f"{TRAIN_GRAD_ATOL} x max|leaf|, norm rtol {TRAIN_GRAD_ATOL}",
        "force_rmse_card_vs_cpu": rmse_checks,
        "force_rmse_tol": "forces atol 1e-4 x max|F| per call, the RMSE "
                          "within 1e-4 x max|F|",
        "restart_from": f"step {cfg.checkpoint_every}",
        "restart_equals_uninterrupted": "bit for bit",
        "launches_train_run": counts,
        "force_rmse_calls_in_train_run": n_rmse,
        "launches_per_train_step": _per(step_counts, cfg.n_steps),
        "launches_per_force_rmse": _per(rmse_counts, n_rmse),
        "force_scatter_per_force_rmse_by_site": _per(
            _sites("force_rmse", rmse_shapes), n_rmse),
        "launches_per_timed_step": _per(timed_counts, 11),
        "force_scatter_per_timed_step_by_site": _per(timed_sites, 11)}),
        flush=True)
    del model, params, params0, arrays, arrays_va, cpu_model
    torch.cuda.empty_cache()

    # the timed run at the MD model's capacity
    tm = TRAIN_TIMED
    n = tm["steps"]
    tr, _, model, params0, setup_ms = train_setup(tm, DEVICE)
    cfg = TrainConfig(batch_size=tm["batch"], lr0=2e-3)
    arrays = prepare_batches(tr, model.cfg.descriptor.rcut,
                             model.cfg.descriptor.sel, DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    (params, steps), step_counts, step_sites = train_counts(
        lambda: train_steps(model, params0, arrays, cfg, n, timed=True),
        "training step")
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(s[0]) and np.isfinite(s[1]) for s in steps):
        fail("train timed: non-finite loss or gradient")
    check_step_launches(step_counts, "timed")
    # its first step against the port on the CPU
    _, cpu = train_steps(DPModel(model.cfg, model.stats, device="cpu"),
                         _tree(params0, lambda t: t.cpu()),
                         {k: v.cpu() for k, v in arrays.items()}, cfg, 1)
    grad_err = check_train_steps(steps[:1], cpu, "timed")

    def timed_rmse():
        out = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rmse = force_rmse(model, params, arrays, 32)
            torch.cuda.synchronize()
            out.append((rmse, (time.perf_counter() - t0) * 1e3))
        return out

    rmse_runs, rmse_counts, rmse_sites = train_counts(timed_rmse,
                                                      "force_rmse")
    check_rmse_launches(rmse_counts, "timed")
    rmse = rmse_runs[0][0]
    if any(r != rmse for r, _ in rmse_runs):
        fail(f"train timed: repeated force_rmse calls differ: {rmse_runs}")
    rmse_cpu, f_err = check_force_rmse(model, params, arrays, rmse, "timed")
    device_profile(lambda: train_steps(model, params, arrays, cfg, 1),
                   "train", "one training step, timed run (2,048 atoms, "
                   "sel 64)", host_ops=True)
    device_profile(lambda: force_rmse(model, params, arrays, 32), "train",
                   "one force_rmse call, timed run (32 frames)")
    print(json.dumps({
        "phase": "train", "run": "timed", "route": TRAIN_ROUTE,
        "config": "paper_dpa1_config(ntypes=4, rcut=0.6, sel=64), "
                  "make_dataset(64, n_atoms=256, seed=0), split 0.15, "
                  "TrainConfig(batch_size=8, lr0=2e-3)",
        "atoms_per_step": tm["batch"] * tm["atoms"], "setup_ms": setup_ms,
        "ms_per_train_step_median_steps_2_10":
            statistics.median(s[3] for s in steps[2:11]),
        "ms_per_train_step_covers": "the batch selection and the step, "
                                    "synchronised at both ends",
        "ms_per_train_step": [s[3] for s in steps],
        "loss": [s[0] for s in steps], "grad_norm": [s[1] for s in steps],
        "first_step_card_vs_cpu": {"loss": [steps[0][0], cpu[0][0]],
                                   "grad_norm": [steps[0][1], cpu[0][1]],
                                   "grad_max_err_over_max": grad_err},
        "force_rmse_ms_median_of_3": statistics.median(
            ms for _, ms in rmse_runs),
        "force_rmse_frames": 32, "force_rmse": rmse,
        "force_rmse_cpu": rmse_cpu, "force_rmse_F_max_err_over_max": f_err,
        "peak_memory_MiB": peak / 2 ** 20,
        "peak_above_data_and_params_MiB": (peak - base) / 2 ** 20,
        "launches_per_train_step": _per(step_counts, n),
        "force_scatter_per_train_step_by_site": _per(step_sites, n),
        "launches_per_force_rmse": _per(rmse_counts, 3),
        "force_scatter_per_force_rmse_by_site": _per(rmse_sites, 3)}),
        flush=True)
    print(f"[train] {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"train_step": _per(step_counts, n),
            "force_rmse": _per(rmse_counts, 3), "train_run": counts}


# ---------------------------------------------------------------------------
# lm: gemma2-2b token serving
# ---------------------------------------------------------------------------

LM_ARCH = "gemma2-2b"
LM_BATCH, LM_PROMPT, LM_NEW = 4, 6_144, 32
LM_ROUNDS = 3
BF16_PEAK = 989e12        # H100 SXM dense bf16 tensor-core FLOP/s
# decode == forward at full width, bf16: both sides round every matmul
# output, norm and residual to bf16 (step 2^-8 = 3.9e-3), and cuBLAS sums a
# one-token product and a 6,175-token one in different orders, so single
# bf16 steps differ and travel through 26 layers; the gate is the CPU
# test's bf16 gate (tests/test_torch_lm.py), a few bf16 steps of the
# largest logit
LM_BF16_TOL = 6e-2


def flash_bound(q, k, causal, window, q_offset, dv=None):
    """Least time of one flash_attention call: its work by the kernel's own
    formula, the one the step accounting counts
    (``flash_attn.attention_flops_bytes``: 2 (D + DV) FLOPs per visible
    pair and q head, Q K^T and P V; q and o once and the K/V rows some
    query can see once), at the card's peak for the inputs' type (bf16
    tensor cores 989, fp32 67 TFLOP/s) and at the memory rate.  ``dv``: the
    value width (default D)."""
    from repro_torch.kernels import flash_attn
    b, hq, sq, d = q.shape
    flops, nbytes = flash_attn.attention_flops_bytes(
        b, hq, k.shape[1], sq, k.shape[2], d, d if dv is None else dv,
        q.element_size(), causal, window, q_offset)
    peak = BF16_PEAK if q.dtype == torch.bfloat16 else F32_PEAK
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_RATE * 1e3
    bound = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    return bound, flops


def serve_recording(cfg, params, tokens, new, keep):
    """``launch.serve.serve_tokens`` run eagerly (``graph=False``: every
    attention call is a Python call) with ``flash_attention`` and
    ``flash_decode`` swapped for recorders: the calls' (wrapper, Sq, Sk) in
    order, and the arguments of the calls whose index is in ``keep``.  The
    recorders still launch; their counts go back to the wrappers
    afterwards."""
    from repro_torch.kernels import flash_attn
    from repro_torch.launch.serve import serve_tokens
    originals = {name: getattr(flash_attn, name)
                 for name in ("flash_attention", "flash_decode")}
    calls, kept = [], {}

    def recorder(name):
        original = originals[name]

        def rec(*args):
            if len(calls) in keep:
                kept[len(calls)] = args
            calls.append((name, args[0].shape[2], args[1].shape[2]))
            return original(*args)

        rec.launches = 0
        return rec

    recs = {name: recorder(name) for name in originals}
    for name, rec in recs.items():
        setattr(flash_attn, name, rec)
    try:
        res = serve_tokens(cfg, params, tokens, new, graph=False)
    finally:
        for name, original in originals.items():
            original.launches += recs[name].launches
            setattr(flash_attn, name, original)
    return res, calls, kept


@torch.no_grad()
def check_flash(name, args):
    """A prefill call's kernel against its plain version on the call's
    arguments (bf16, and the same inputs in fp32), with times and bounds."""
    from repro_torch.kernels import flash_attn, ref
    q, k, v, causal, window, softcap, q_offset = args
    line = {"phase": "lm", "name": "flash_attention", "case": name,
            "q": list(q.shape), "k": list(k.shape), "causal": causal,
            "window": window, "softcap": softcap, "q_offset": q_offset}
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
        a = [t.to(dtype) for t in (q, k, v)]
        line.update(kernel_line(
            dtype, tol, name,
            lambda: flash_attn.flash_attention(*a, causal, window, softcap,
                                               q_offset),
            lambda: ref.attention_ref(*a, causal, window, softcap, q_offset),
            flash_bound(a[0], a[1], causal, window, q_offset)))
        del a
        torch.cuda.empty_cache()
    print(json.dumps(line), flush=True)
    return line


# The bf16 prefill kernel's sweep, at every (DK, DV) instance: (b, hq, hkv,
# sq, sk, causal, window, softcap, q_offset) with GQA groups 1, 2 and 6, Sq
# and Sk off the 64- and 128-row and -key tiles, and rows with no visible
# key (window 20 at q_offset 40 over 50 keys); a cache view besides
FLASH_SWEEP_CASES = (
    (2, 4, 4, 100, 100, True, 0, 0.0, 0),        # group 1
    (1, 8, 4, 130, 70, False, 0, 50.0, 0),       # group 2, Sk < Sq
    (1, 12, 2, 200, 333, True, 0, 0.0, 133),     # group 6, q_offset
    (2, 6, 1, 257, 257, True, 96, 50.0, 0),      # group 6, window, softcap
    (1, 4, 2, 64, 50, True, 20, 0.0, 40),        # rows with no visible key
)
# MLA's (192, 128) also at Sq 1 and 16 (the prefill kernel at every Sq)
FLASH_SWEEP_MLA = ((2, 8, 8, 1, 1, True, 0, 0.0, 0),
                   (2, 4, 4, 16, 40, True, 0, 50.0, 24))
# Row 6a's path shapes: (name, b, hq, hkv, sq, sk, d, dv, causal, window,
# softcap, lse), each at its path's softcap; whisper-medium's encoder is
# its self-attention over 1,500 frames
FLASH_PATHS = (
    ("deepseek-v3 MLA prefill", 2, 128, 128, 1024, 1024, 192, 128, True, 0,
     0.0, False),
    ("deepseek-v3 MLA at a (1, 4) mesh's heads", 2, 32, 32, 1024, 1024, 192,
     128, True, 0, 0.0, False),
    ("qwen2-1.5b training forward + lse", 4, 12, 2, 2048, 2048, 128, 128,
     True, 0, 0.0, True),
    ("gemma2-2b global prefill", 4, 8, 4, 6144, 6144, 256, 256, True, 0,
     50.0, False),
    ("gemma2-2b local prefill", 4, 8, 4, 6144, 6144, 256, 256, True, 4096,
     50.0, False),
    ("gemma2-2b training forward + lse", 4, 8, 4, 2048, 2048, 256, 256,
     True, 0, 50.0, True),
    ("whisper-medium encoder", 4, 16, 16, 1500, 1500, 64, 64, False, 0,
     0.0, False),
)


@torch.no_grad()
def flash_prefill_sweep():
    """The bf16 prefill kernel at every (DK, DV) instance against
    ``ref.attention_ref`` at the bf16 gate (atol 1e-2 x max|plain|), on
    ``FLASH_SWEEP_CASES`` (and MLA's at Sq 1 and 16) and on a cache view
    with strides: rows with no visible key exactly 0 with an LSE of -inf;
    a repeat bit for bit; the call with the LSE giving the serving call's
    bits, its LSE against ``attention_lse_ref`` (atol 1e-4 x max(|lse|,
    1))."""
    from repro_torch.kernels import flash_attn, ref
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 31)
    rnd = lambda *s: torch.randn(*s, device=DEVICE, generator=gen).to(
        torch.bfloat16)
    errs, n = {}, 0
    for d, dv in flash_attn.QK_V_DIMS:
        cases = FLASH_SWEEP_CASES + (FLASH_SWEEP_MLA if dv != d else ())
        for case in cases + (None,):
            if case is None:    # a cache of 512 rows sliced to its first 300
                b, hq, hkv, sq, sk = 2, 8, 4, 96, 300
                causal, window, cap, off = True, 64, 50.0, 204
                k = rnd(b, hkv, 512, d)[:, :, :sk]
                v = rnd(b, hkv, 512, dv)[:, :, :sk]
            else:
                b, hq, hkv, sq, sk, causal, window, cap, off = case
                k, v = rnd(b, hkv, sk, d), rnd(b, hkv, sk, dv)
            q = rnd(b, hq, sq, d)
            args = (causal, window, cap, off)
            tag = f"({d}, {dv}) q {tuple(q.shape)} k {tuple(k.shape)} {args}"
            out = flash_attn.flash_attention(q, k, v, *args)
            want = ref.attention_ref(q, k, v, *args).float()
            err = check(f"flash prefill sweep {tag}", out.float(), want,
                        atol=1e-2 * float(want.abs().max()))
            errs[str((d, dv))] = max(errs.get(str((d, dv)), 0.0), err)
            if not torch.equal(out, flash_attn.flash_attention(q, k, v,
                                                               *args)):
                fail(f"flash prefill sweep {tag}: a repeat differs")
            out_l, lse = flash_attn.flash_attention(q, k, v, *args,
                                                    return_lse=True)
            if not torch.equal(out, out_l):
                fail(f"flash prefill sweep {tag}: the LSE call's bits differ")
            vis = ref.attention_visible(sq, sk, causal, window, off,
                                        DEVICE).any(1)
            want_lse = ref.attention_lse_ref(q, k, *args)
            if bool(out[:, :, ~vis].any()) or not bool(
                    (lse[:, :, ~vis] == float("-inf")).all()):
                fail(f"flash prefill sweep {tag}: a row with no visible key "
                     "is not 0 with lse -inf")
            check(f"flash prefill sweep {tag} lse", lse[:, :, vis],
                  want_lse[:, :, vis],
                  atol=1e-4 * max(1.0, float(want_lse[:, :, vis].abs().max())))
            n += 1
    line = {"phase": "lm", "check": "flash prefill sweep (bf16)", "cases": n,
            "max_abs_err_by_instance": errs, "tol": "atol 1e-2*max|plain|",
            "repeat_bitwise": True, "lse_call_bitwise": True}
    print(json.dumps(line), flush=True)
    return line


@torch.no_grad()
def flash_path_times(paths=FLASH_PATHS):
    """Row 6a's path shapes (``paths``), bf16, random inputs: the
    kernel as its path calls it (with the LSE where the path asks), the
    kernel at softcap 0, SDPA at softcap 0 (GQA; causal, or a boolean
    causal + window mask; no LSE) and the bound (the visible pairs'
    operations at the bf16 peak or the bytes, the LSE's included, at the
    memory rate); the kernel at softcap 0 held to SDPA at the bf16 gate."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attn, ref
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 37)
    rnd = lambda *s: torch.randn(*s, device=DEVICE, generator=gen).to(
        torch.bfloat16)
    lines = []
    for (name, b, hq, hkv, sq, sk, d, dv, causal, window, cap,
         lse) in paths:
        q, k, v = rnd(b, hq, sq, d), rnd(b, hkv, sk, d), rnd(b, hkv, sk, dv)
        kw = ({"attn_mask": ref.attention_visible(sq, sk, True, window, 0,
                                                  DEVICE)}
              if window else {"is_causal": causal})

        def kern(c):
            return lambda: flash_attn.flash_attention(q, k, v, causal, window,
                                                      c, 0, return_lse=lse)

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, enable_gqa=True,
                                                  **kw)

        got, want = kern(0.0)(), sdpa().float()
        err = check(f"{name} vs sdpa (softcap 0)",
                    (got[0] if lse else got).float(), want,
                    atol=1e-2 * float(want.abs().max()))
        del got, want
        flops, nbytes = flash_attn.attention_flops_bytes(
            b, hq, hkv, sq, sk, d, dv, 2, causal, window, 0, lse)
        t_ops, t_bytes = flops / BF16_PEAK * 1e3, nbytes / HBM_RATE * 1e3
        line = {"phase": "lm", "name": "flash_attention", "case": name,
                "q": [b, hq, sq, d], "kv": [b, hkv, sk, dv],
                "causal": causal, "window": window, "softcap": cap,
                "lse": lse, "max_err_vs_sdpa": err,
                "kernel_ms": time_ms(kern(cap)),
                "softcap0_kernel_ms": time_ms(kern(0.0)),
                "sdpa_ms": time_ms(sdpa), "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        line["softcap0_over_sdpa"] = line["softcap0_kernel_ms"] / line["sdpa_ms"]
        line["bound_share"] = line["bound_ms"] / line["kernel_ms"]
        print(json.dumps(line), flush=True)
        lines.append(line)
        del q, k, v, kw
        torch.cuda.empty_cache()
    return lines


def kernel_line(dtype, tol, name, kern, plain, bound):
    """One call's kernel against its plain version (atol tol x max|plain|),
    a repeat bit for bit, both timed, beside the bound."""
    got, want = kern(), plain()
    scale = float(want.float().abs().max())
    err = check(f"{name} {dtype}", got.float(), want.float(),
                atol=tol * scale)
    if not torch.equal(got, kern()):
        fail(f"{name} {dtype}: a repeat differs")
    del got, want
    tag = "bf16" if dtype == torch.bfloat16 else "fp32"
    (bound_ms, bound_by), flops = bound
    return {f"{tag}_max_err": err, f"{tag}_tol": f"atol {tol}*max|plain|",
            f"{tag}_kernel_ms": time_ms(kern), f"{tag}_plain_ms": time_ms(plain),
            f"{tag}_bound_ms": bound_ms, f"{tag}_bound_by": bound_by,
            f"{tag}_visible_pair_flops": flops}


@torch.no_grad()
def check_decode(name, args):
    """A decode call's kernel (``flash_decode`` over the whole cache, the
    position a device tensor) against its plain version on the call's
    arguments (bf16, and the same inputs in fp32), with times and bounds
    (the bytes of the K/V rows the query sees)."""
    from repro_torch.kernels import flash_attn, ref
    q, kc, vc, pos, window, softcap = args
    p = int(pos)
    line = {"phase": "lm", "name": "flash_decode", "case": name,
            "q": list(q.shape), "k_cache": list(kc.shape), "pos": p,
            "window": window, "softcap": softcap}
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
        a = [t.to(dtype) for t in (q, kc, vc)]
        line.update(kernel_line(
            dtype, tol, name,
            lambda: flash_attn.flash_decode(*a, pos, window, softcap),
            lambda: ref.decode_ref(*a, p, window, softcap),
            flash_bound(a[0], a[1][:, :, :p + 1], True, window, p)))
        del a
        torch.cuda.empty_cache()
    print(json.dumps(line), flush=True)
    return line


@torch.no_grad()
def check_decode_lengths(args):
    """The decode kernel at lengths 1, 63, 64, 65 and S_max of the last
    step's cache (bf16, the global and the local layer's window): against
    the plain version at the bf16 gate, a repeat bit for bit, one split
    count (the grid) at every length; at the short lengths most splits,
    and so whole CTAs, see no key."""
    from repro_torch.kernels import flash_attn, ref
    q, kc, vc, _, _, softcap = args
    b, hkv, s_max = kc.shape[0], kc.shape[1], kc.shape[2]
    splits = flash_attn.decode_splits(
        b, hkv, s_max, torch.cuda.get_device_properties(0).multi_processor_count)
    seen, rows = [], []
    real = flash_attn.decode_splits
    flash_attn.decode_splits = lambda *a: seen.append(real(*a)) or seen[-1]
    try:
        for length in (1, 63, 64, 65, s_max):
            for window in (0, 4096):
                pos = torch.tensor(length - 1, device=DEVICE)
                got = flash_attn.flash_decode(q, kc, vc, pos, window, softcap)
                want = ref.decode_ref(q, kc, vc, length - 1, window, softcap)
                err = check(f"flash_decode length {length} window {window}",
                            got.float(), want.float(),
                            atol=1e-2 * float(want.float().abs().max()))
                if not torch.equal(got, flash_attn.flash_decode(
                        q, kc, vc, pos, window, softcap)):
                    fail(f"flash_decode length {length}: a repeat differs")
                ranges = ref.decode_split_ranges(1, length, length - 1, True,
                                                 window, splits)
                rows.append({"length": length, "window": window,
                             "max_abs_err": err,
                             "splits_without_key": sum(k1 <= k0
                                                       for k0, k1 in ranges)})
    finally:
        flash_attn.decode_splits = real
    if set(seen) != {splits}:
        fail(f"flash_decode: split counts {sorted(set(seen))} across "
             f"lengths, expected {splits} at every length")
    print(json.dumps({"phase": "lm", "check": "flash_decode hard lengths",
                      "splits": splits, "ctas": splits * b * hkv,
                      "tol": "atol 1e-2*max|plain|", "cases": rows}),
          flush=True)


@torch.no_grad()
def sdpa_yardstick(name, args):
    """One PyTorch call beside the kernel, both at softcap 0 (with softcap
    50 no single PyTorch call computes the function), on the call's q, k
    and v: SDPA with GQA; causal at the global prefill, a boolean causal +
    window mask at the local prefill, and at decode (the kernel over the
    whole cache) the keys the query sees, unmasked."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attn, ref
    if len(args) == 6:                       # flash_decode's arguments
        q, k, v, pos, window, _ = args
        q_offset = int(pos)
        lo = max(0, q_offset - window + 1) if window > 0 else 0
        kw, lk, lv = {}, k[:, :, lo:q_offset + 1], v[:, :, lo:q_offset + 1]
        bound_k = k[:, :, :q_offset + 1]

        def kern():
            return flash_attn.flash_decode(q, k, v, pos, window, 0.0)
    else:
        q, k, v, causal, window, _, q_offset = args
        sq, sk = q.shape[2], k.shape[2]
        if not causal or sq == 1 or q_offset:
            fail(f"sdpa yardstick {name}: expected a causal prefill call")
        if not window:
            kw = {"is_causal": True}
        else:
            kw = {"attn_mask": ref.attention_visible(sq, sk, True, window, 0,
                                                     q.device)}
        lk, lv, bound_k = k, v, k

        def kern():
            return flash_attn.flash_attention(q, k, v, True, window, 0.0, 0)

    def lib():
        return F.scaled_dot_product_attention(q, lk, lv, enable_gqa=True, **kw)

    got, want = kern(), lib()
    err = check(f"{name} vs sdpa (softcap 0)", got.float(),
                want.float(), atol=1e-2 * float(want.float().abs().max()))
    del got, want
    line = {"phase": "lm", "name": "flash_decode" if len(args) == 6
            else "flash_attention", "case":
            f"{name}, softcap 0, vs scaled_dot_product_attention",
            "max_err_vs_sdpa": err, "kernel_ms": time_ms(kern),
            "sdpa_ms": time_ms(lib),
            "bound_ms": flash_bound(q, bound_k, True, window, q_offset)[0][0]}
    line["kernel_over_sdpa"] = line["kernel_ms"] / line["sdpa_ms"]
    if len(args) == 6:
        # decode: SDPA in fp32 too, on fp32 copies, checked against the
        # kernel once; the fp32 kernel's time and bound are check_decode's
        # (the kernels line's fp32_ms_by_call, fp32_bound_ms_by_call)
        q32, k32, v32 = (t.float() for t in (q, k, v))
        lk32, lv32 = k32[:, :, lo:q_offset + 1], v32[:, :, lo:q_offset + 1]

        def lib32():
            return F.scaled_dot_product_attention(q32, lk32, lv32,
                                                  enable_gqa=True)

        want = lib32()
        line["fp32_max_err_vs_sdpa"] = check(
            f"{name} vs sdpa (softcap 0, fp32)",
            flash_attn.flash_decode(q32, k32, v32, pos, window, 0.0), want,
            atol=1e-4 * float(want.abs().max()))
        line["fp32_sdpa_ms"] = time_ms(lib32)
        del q32, k32, v32, lk32, lv32, want
    print(json.dumps(line), flush=True)
    torch.cuda.empty_cache()
    return line


def lm_request_counts(res, n, steps, what):
    """The launches of one graphed request (counts reset before it): n
    prefill calls of ``flash_attention``; n ``flash_decode`` calls captured
    per decode step, replayed ``steps`` times after one eager warm-up
    step; no DP kernel."""
    from repro_torch import kernels
    counts = kernels.launch_counts()
    if (res.get("graph_launches") != {"flash_decode": n}
            or counts["flash_attention"] != n
            or counts["flash_decode"] != n * (steps + 1)
            or any(c for k, c in counts.items()
                   if k not in ("flash_attention", "flash_decode"))):
        fail(f"{what}: launches {counts}, captured per replay "
             f"{res.get('graph_launches')}; expected {n} flash_attention per "
             f"prefill and {n} flash_decode per decode step ({steps} "
             "replays + 1 warm-up step)")
    return counts


def phase_lm():
    """gemma2-2b at full width (26 layers, d_model 2304, vocab 256000,
    bf16, random weights from the port's initialiser), 4 prompts of 6,144
    random token ids and 32 greedy new tokens, through the port's
    ``launch/serve.py``: the decode steps replay a CUDA graph, and run
    eagerly for the recording, the bitwise comparison and the timing."""
    from repro_torch import kernels
    from repro_torch.configs import get_arch, param_count
    from repro_torch.launch.serve import serve_tokens
    from repro_torch.lm import model as LM
    cfg = get_arch(LM_ARCH)
    n = cfg.n_layers
    t0 = time.perf_counter()
    params = LM.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED), device=DEVICE)
    torch.cuda.synchronize()
    print(json.dumps({"phase": "lm", "arch": cfg.name,
                      "params": param_count(cfg)[0],
                      "param_MiB": torch.cuda.memory_allocated() / 2 ** 20,
                      "init_s": time.perf_counter() - t0}), flush=True)
    rng = np.random.default_rng(SEED + 7)
    tokens = torch.tensor(rng.integers(0, cfg.vocab, (LM_BATCH, LM_PROMPT)),
                          device=DEVICE)
    steps = LM_NEW - 1
    last = n * steps            # first decode call of the last decode step
    keep = {0, 1, last, last + 1}

    # -- one eager request, every attention call recorded
    kernels.reset_launch_counts()
    res_eager, calls, kept = serve_recording(cfg, params, tokens, LM_NEW,
                                             keep)
    counts = kernels.launch_counts()
    prefill_calls = sum(1 for w, sq, _ in calls
                        if w == "flash_attention" and sq == LM_PROMPT)
    decode_calls = sum(1 for w, sq, sk in calls if w == "flash_decode"
                       and sq == 1 and sk == LM_PROMPT + LM_NEW)
    if (counts["flash_attention"] != n or counts["flash_decode"] != n * steps
            or prefill_calls != n or decode_calls != n * steps
            or len(calls) != n * LM_NEW):
        fail(f"lm eager: launches {counts}, prefill calls {prefill_calls}, "
             f"decode calls {decode_calls}; expected {n} per prefill and "
             f"{n} per decode step")
    if kept[0][4] != cfg.window or kept[1][4] != 0 or \
            int(kept[last][3]) != LM_PROMPT + steps - 1 or \
            kept[last][4] != cfg.window or kept[last + 1][4] != 0:
        fail("lm: recorded calls are not the expected layers and positions")

    # -- the main path: a request whose decode steps replay a CUDA graph
    kernels.reset_launch_counts()
    res = serve_tokens(cfg, params, tokens, LM_NEW)
    counts = lm_request_counts(res, n, steps, "lm graphed request")
    per_step = res["graph_launches"]["flash_decode"]
    out = res["tokens"]
    if tuple(out.shape) != (LM_BATCH, LM_NEW) or not all(
            bool(torch.isfinite(lg).all()) for lg in res["logits"]):
        fail("lm: non-finite logits or wrong token shape")
    same_logits = all(torch.equal(a, b) for a, b in
                      zip(res["logits"], res_eager["logits"]))
    if not torch.equal(out, res_eager["tokens"]) or not same_logits:
        fail("lm: the graphed decode differs from the eager one")
    print(json.dumps({"phase": "lm", "request": "first (graphed)",
                      "launches": counts,
                      "flash_attention_per_prefill": prefill_calls,
                      "flash_decode_per_decode_step": decode_calls // steps,
                      "captured_per_replay": res["graph_launches"],
                      "graph_equals_eager_bitwise": True,
                      "prefill_ms": res["prefill_s"] * 1e3,
                      "capture_ms": res["capture_s"] * 1e3,
                      "decode_ms_per_step": res["decode_s"] / steps * 1e3,
                      "eager_decode_ms_per_step_recorded":
                          res_eager["decode_s"] / steps * 1e3,
                      "greedy_tokens_batch0": out[0].tolist()}), flush=True)
    del res_eager
    torch.cuda.empty_cache()

    # -- the kernels against their plain versions on the path's tensors
    rows = {"prefill_local": check_flash("prefill local layer", kept[0]),
            "prefill_global": check_flash("prefill global layer", kept[1]),
            "decode_local": check_decode("last decode step, local layer",
                                         kept[last]),
            "decode_global": check_decode("last decode step, global layer",
                                          kept[last + 1])}
    calls = {"prefill_local": kept[0], "prefill_global": kept[1],
             "decode_local": kept[last], "decode_global": kept[last + 1]}
    rows["sdpa"] = {c: sdpa_yardstick(c, a) for c, a in calls.items()}
    check_decode_lengths(kept[last + 1])
    rows["prefill_sweep"] = flash_prefill_sweep()
    rows["prefill_paths"] = flash_path_times()
    del calls, kept
    torch.cuda.empty_cache()

    # -- decode == forward at full width (batch rows 0-1: the full logits
    #    of 4 rows would not fit beside the model)
    fed = torch.cat([tokens, out[:, :-1]], 1)[:2]
    with torch.no_grad():
        full, _ = LM.forward(params, cfg, fed)
    errs = {}
    want = LM.final_softcap(cfg, res["logits"][0][:2])
    cases = [("prefill last logits (softcapped)", want, LM_PROMPT - 1),
             ("decode step 0", res["logits"][1][:2], LM_PROMPT),
             (f"decode step {steps - 1}", res["logits"][steps][:2],
              LM_PROMPT + steps - 1)]
    for name, got, pos in cases:
        ref_logits = full[:, pos].float()
        errs[name] = check(f"lm decode == forward, {name}", got.float(),
                           ref_logits,
                           atol=LM_BF16_TOL * float(ref_logits.abs().max()))
    agree = float((full[:, LM_PROMPT - 1:].argmax(-1) == out[:2]).float().mean())
    print(json.dumps({"phase": "lm", "check": "decode == forward",
                      "decode": "graphed", "rows": 2, "max_abs_err": errs,
                      "max_abs_logit": float(full[:, LM_PROMPT - 1:].float().abs().max()),
                      "tol": f"atol {LM_BF16_TOL}*max|forward logits|",
                      "greedy_token_agreement": agree}), flush=True)
    del full, res
    torch.cuda.empty_cache()

    # -- card against CPU at a reduced width, fp32 (the card's decode
    #    graphed)
    small = cfg.reduced(n_layers=4, d_model=256, d_ff=512, vocab=1024)
    p_cpu = LM.init_params(small, torch.Generator().manual_seed(SEED),
                           device="cpu")
    p_gpu = _tree(p_cpu, lambda t: t.to(DEVICE))
    tok = torch.tensor(rng.integers(0, small.vocab, (2, 80)))
    r_cpu = serve_tokens(small, p_cpu, tok, 8)
    kernels.reset_launch_counts()
    r_gpu = serve_tokens(small, p_gpu, tok.to(DEVICE), 8)
    lm_request_counts(r_gpu, 4, 7, "lm reduced")
    err = 0.0
    for i, (a, b) in enumerate(zip(r_gpu["logits"], r_cpu["logits"])):
        err = max(err, check(f"lm card vs cpu step {i}", a.cpu(), b,
                             atol=1e-4 * float(b.abs().max())))
    if not torch.equal(r_gpu["tokens"].cpu(), r_cpu["tokens"]):
        fail("lm reduced: greedy tokens differ between card and CPU")
    print(json.dumps({"phase": "lm", "check": "card vs cpu", "config":
                      "gemma2-2b reduced(n_layers=4, d_model=256, d_ff=512,"
                      " vocab=1024), fp32, batch 2, prompt 80, 8 new; the "
                      "card's decode graphed",
                      "max_abs_err": err, "tol": "atol 1e-4*max|logits|"}),
          flush=True)

    # -- request rounds, graphed and eager in turns
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = {"graph": [], "eager": []}
    for i in range(LM_ROUNDS):
        for mode in ("graph", "eager"):
            r = serve_tokens(cfg, params, tokens, LM_NEW,
                             graph=mode == "graph")
            if not torch.equal(r["tokens"], out):
                fail(f"lm round {i} ({mode}): greedy tokens differ from "
                     "the first request")
            times[mode].append({"prefill_ms": r["prefill_s"] * 1e3,
                                "decode_ms_per_step": r["decode_s"] / steps * 1e3,
                                "capture_ms": r.get("capture_s", 0.0) * 1e3})
            del r
    med = lambda mode, key: statistics.median(t[key] for t in times[mode])
    pre = med("graph", "prefill_ms")
    dec = med("graph", "decode_ms_per_step")
    summary = {"phase": "lm", "arch": cfg.name, "batch": LM_BATCH,
               "prompt": LM_PROMPT, "new": LM_NEW, "rounds": times,
               "prefill_ms_median": pre, "decode_ms_per_step_median": dec,
               "capture_ms_median": med("graph", "capture_ms"),
               "eager_decode_ms_per_step_median":
                   med("eager", "decode_ms_per_step"),
               "eager_prefill_ms_median": med("eager", "prefill_ms"),
               "decode_tok_per_s": LM_BATCH / dec * 1e3,
               "eager_decode_tok_per_s":
                   LM_BATCH / med("eager", "decode_ms_per_step") * 1e3,
               "prefill_tok_per_s": LM_BATCH * LM_PROMPT / pre * 1e3,
               "decode_ms_is": "host clock of the decode loop: the graph's "
                               "replays (capture apart) or the eager steps",
               "max_memory_allocated_MiB":
                   torch.cuda.max_memory_allocated() / 2 ** 20}
    print(json.dumps(summary), flush=True)
    profile_lm(cfg, params, tokens)
    del params
    torch.cuda.empty_cache()
    launches = {"flash_attention": {"launches": counts["flash_attention"],
                                    "launches_per_prefill": prefill_calls},
                "flash_decode": {"launches": counts["flash_decode"],
                                 "launches_per_decode_step": per_step,
                                 "launches_eager_request": decode_calls}}
    return summary, rows, launches


# ---------------------------------------------------------------------------
# lm_archs: the other mixers at full width
# ---------------------------------------------------------------------------

# (arch, layers run (None: all), batch, prompt, new tokens); each at its
# published width, depth cut where one card cannot hold the model
LM_ARCHS = (
    ("deepseek-v3-671b", 4, 2, 1024, 8),       # 3 dense MLA + 1 MoE MLA, MTP
    ("jamba-1.5-large-398b", 2, 2, 2048, 8),   # mamba/dense, mamba/MoE
    ("rwkv6-3b", None, 4, 2048, 16),
    ("whisper-medium", None, 4, 448, 16),      # 24 + 24 layers, 1500 frames
)
# card == CPU: reduced widths whose heads the kernel has instances for
# (hd 64; MLA's (192, 128)), fp32
LM_ARCH_SMALL = dict(n_layers=4, d_model=256, d_ff=512, vocab=1024)
LM_ARCH_SMALL_MLA = dict(qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128)
MLA_DIMS = (192, 128)


def n_params(tree):
    if isinstance(tree, dict):
        return sum(n_params(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(n_params(v) for v in tree)
    return tree.numel()


def record_first_mla_call(fn):
    """``fn()`` with ``flash_attention`` swapped for a recorder that keeps
    the arguments of its first call with MLA's (D, DV); the recorder still
    launches, and its count goes back to the wrapper."""
    from repro_torch.kernels import flash_attn
    original = flash_attn.flash_attention
    kept = []

    def rec(q, k, v, *rest):
        if not kept and (q.shape[3], v.shape[3]) == MLA_DIMS:
            kept.append((q, k, v, *rest))
        return original(q, k, v, *rest)

    rec.launches = 0
    flash_attn.flash_attention = rec
    try:
        out = fn()
    finally:
        original.launches += rec.launches
        flash_attn.flash_attention = original
    return out, kept[0] if kept else None


@torch.no_grad()
def check_mla_instance(args, phase="lm_archs",
                       case="MLA (192, 128) instance, deepseek-v3 prefill, "
                            "layer 0"):
    """The (192, 128) instance against its plain version on the first MLA
    prefill call's q, k, v (bf16, and the same inputs in fp32) at the
    existing gates, a repeat bit for bit, times beside the bound, and SDPA
    beside it (PyTorch's SDPA takes a value width other than the query's).
    """
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attn, ref
    q, k, v, causal, window, softcap, q_offset = args
    line = {"phase": phase, "name": "flash_attention", "case": case,
            "q": list(q.shape), "k": list(k.shape), "v": list(v.shape),
            "causal": causal}
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
        a = [t.to(dtype) for t in (q, k, v)]
        line.update(kernel_line(
            dtype, tol, "flash_attention MLA",
            lambda: flash_attn.flash_attention(*a, causal, window, softcap,
                                               q_offset),
            lambda: ref.attention_ref(*a, causal, window, softcap, q_offset),
            flash_bound(a[0], a[1], causal, window, q_offset, a[2].shape[3])))
        del a
        torch.cuda.empty_cache()

    def lib():
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal)

    want = lib().float()
    line["library_max_err"] = check(
        "MLA instance vs sdpa", flash_attn.flash_attention(
            q, k, v, causal, window, softcap, q_offset).float(),
        want, atol=1e-2 * float(want.abs().max()))
    line["library_ms"] = time_ms(lib)
    q32, k32, v32 = (t.float() for t in (q, k, v))

    def lib32():
        return F.scaled_dot_product_attention(q32, k32, v32, is_causal=causal)

    want = lib32()
    line["fp32_library_max_err"] = check(
        "MLA instance vs sdpa (fp32)", flash_attn.flash_attention(
            q32, k32, v32, causal, window, softcap, q_offset),
        want, atol=1e-4 * float(want.abs().max()))
    line["fp32_library_ms"] = time_ms(lib32)
    del q32, k32, v32, want
    torch.cuda.empty_cache()
    print(json.dumps(line), flush=True)
    return line


def launches_now():
    from repro_torch import kernels
    return {k: n for k, n in kernels.launch_counts().items() if n}


def lm_arch_request(cfg, params, tokens, new, ctx, graph):
    from repro_torch.launch.serve import serve_tokens
    r = serve_tokens(cfg, params, tokens, new, graph=graph, context=ctx)
    if not all(bool(torch.isfinite(lg).all()) for lg in r["logits"]):
        fail(f"lm_archs {cfg.name}: non-finite logits")
    return r


def record_routing(fn):
    """``fn()`` with ``lm.layers.moe_route`` recording every MoE call's
    router scores (T, E) and chosen experts (T, k), in call order."""
    from repro_torch.lm import layers as L
    original, calls = L.moe_route, []

    def rec(p, xf, cfg):
        out = original(p, xf, cfg)
        logits = xf.to(torch.float32) @ p["router"]
        scores = (torch.sigmoid(logits) if cfg.router_scores == "sigmoid"
                  else torch.softmax(logits, -1))
        calls.append((scores, out[1]))
        return out

    L.moe_route = rec
    try:
        return fn(), calls
    finally:
        L.moe_route = original


def routing_flips(cfg, prompt, steps, req_calls, fwd_calls):
    """Per (row, step) the MoE layers whose expert set differs between the
    request (its prefill's call at step 0, then one call per decode step)
    and ``forward`` at the same position; the score noise delta (max
    |score difference| over every compared token and expert); and for
    each flip the forward's own margin, max score of the experts only it
    chose minus min score of those only the request chose, which a flip
    caused by the noise keeps <= 2 delta."""
    n_moe = sum(spec.mlp == "moe" for spec in cfg.layer_specs())
    b = req_calls[0][0].shape[0] // prompt
    total = fwd_calls[0][0].shape[0] // b
    flips, delta = {}, 0.0
    for layer in range(n_moe):
        f_sc, f_top = fwd_calls[layer]
        for i in range(steps + 1):
            r_sc, r_top = req_calls[layer if i == 0 else n_moe * i + layer]
            for row in range(b):
                ri = row * prompt + prompt - 1 if i == 0 else row
                fi = row * total + prompt - 1 + i
                delta = max(delta, float((r_sc[ri] - f_sc[fi]).abs().max()))
                rs, fs = set(r_top[ri].tolist()), set(f_top[fi].tolist())
                if rs != fs:
                    only_f, only_r = sorted(fs - rs), sorted(rs - fs)
                    margin = float(f_sc[fi, only_f].max() - f_sc[fi, only_r].min())
                    flips.setdefault((row, i), []).append(
                        {"layer": layer, "forward_only": only_f,
                         "request_only": only_r, "forward_margin": margin})
    return flips, delta


def decode_vs_forward(cfg, params, tokens, ctx, res, what, routing=None):
    """The request's prefill and decode logits against ``forward`` over the
    prompt and the fed tokens: max |err| per step and the max |logit|.
    With ``routing`` (the request's MoE calls, recorded eagerly), the
    (row, step) positions whose experts differ from the forward's in some
    MoE layer are listed and kept out of the max: a flip between experts
    whose scores lie within the bf16 noise of the two computations moves
    that token's logits by more than the gate, and says nothing of the
    rest."""
    from repro_torch.lm import model as LM
    prompt = tokens.shape[1]
    steps = len(res["logits"]) - 1
    fed = torch.cat([tokens, res["tokens"][:, :-1]], 1)
    with torch.no_grad():
        (full, _), fwd_calls = record_routing(
            lambda: LM.forward(params, cfg, fed, ctx))
    want = full[:, prompt - 1:].float()
    scale = float(want.abs().max())
    err = torch.stack([(LM.final_softcap(cfg, lg).float() - want[:, i])
                       .abs().amax(-1) for i, lg in enumerate(res["logits"])],
                      1)                                      # (B, steps + 1)
    out = {"what": what, "max_abs_logit": scale, "tol": LM_BF16_TOL * scale,
           "greedy_token_agreement":
               float((want.argmax(-1) == res["tokens"]).float().mean())}
    if routing is not None:
        flips, delta = routing_flips(cfg, prompt, steps, routing, fwd_calls)
        keep = torch.ones_like(err, dtype=torch.bool)
        for row, i in flips:
            keep[row, i] = False
        out.update({"routing_score_noise": delta,
                    "routing_flips": [{"row": r, "step": i,
                                       "max_abs_err": float(err[r, i]),
                                       "layers": v}
                                      for (r, i), v in sorted(flips.items())],
                    "positions": err.numel(),
                    "positions_gated": int(keep.sum())})
        err = torch.where(keep, err, torch.zeros_like(err))
    out.update(max_abs_err=float(err.max()),
               per_step=err.amax(0).tolist())
    del full, want
    torch.cuda.empty_cache()
    return out


def lm_arch_card_vs_cpu(name):
    """The same port on the card (decode graphed) and on the CPU, at a
    reduced fp32 width whose heads the kernel has instances for: every
    step's logits at the CPU tests' fp32 gate, the tokens equal."""
    import dataclasses as dc
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import context_stub, serve_tokens
    from repro_torch.lm import model as LM
    over = dict(LM_ARCH_SMALL)
    if get_arch(name).mla:
        over.update(LM_ARCH_SMALL_MLA)
    small = get_arch(name).reduced(**over)
    p_cpu = LM.init_params(small, torch.Generator().manual_seed(SEED),
                           device="cpu")
    p_gpu = _tree(p_cpu, lambda t: t.to(DEVICE))
    rng = np.random.default_rng(SEED + 12)
    tok = torch.tensor(rng.integers(0, small.vocab, (2, 40)))
    ctx = context_stub(small, 2, rng, "cpu")
    r_cpu = serve_tokens(small, p_cpu, tok, 8, context=ctx)
    kernels.reset_launch_counts()
    r_gpu = serve_tokens(small, p_gpu, tok.to(DEVICE), 8,
                         context=None if ctx is None else ctx.to(DEVICE))
    launches = launches_now()
    err = 0.0
    for i, (a, b) in enumerate(zip(r_gpu["logits"], r_cpu["logits"])):
        err = max(err, check(f"lm_archs {name} card vs cpu step {i}", a.cpu(),
                             b, atol=1e-4 * float(b.abs().max())))
    if not torch.equal(r_gpu["tokens"].cpu(), r_cpu["tokens"]):
        fail(f"lm_archs {name} reduced: greedy tokens differ, card and CPU")
    full = dc.asdict(get_arch(name))
    cut = {k: v for k, v in dc.asdict(small).items()
           if v != full[k] and k != "name"}
    return {"config_changes": cut, "batch": 2, "prompt": 40,
            "new": 8, "max_abs_err": err, "tol": "atol 1e-4*max|cpu logits|",
            "launches_card": launches}


def lm_arch(name, layers, batch, prompt, new):
    """One architecture at full width: init, the launches of one prefill,
    the main path (a graphed request) against an eager one bit for bit, a
    second timed pair, decode == forward, card == CPU (reduced), and for
    deepseek the MLA instance against its plain version."""
    import dataclasses as dc
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import context_stub
    from repro_torch.lm import model as LM
    from repro_torch.lm.serve_lib import make_prefill
    cfg = get_arch(name)
    if layers is not None:
        cfg = dc.replace(cfg, n_layers=layers)
    steps = new - 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = LM.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED), device=DEVICE)
    torch.cuda.synchronize()
    line = {"phase": "lm_archs", "arch": name, "layers": cfg.n_layers,
            "depth_cut": (f"{cfg.n_layers} of {get_arch(name).n_layers} "
                          "layers" if layers is not None else "none"),
            "params": n_params(params),
            "param_MiB": torch.cuda.memory_allocated() / 2 ** 20,
            "init_s": time.perf_counter() - t0, "batch": batch,
            "prompt": prompt, "new": new, "dtype": cfg.dtype}
    rng = np.random.default_rng(SEED + 11)
    tokens = torch.tensor(rng.integers(0, cfg.vocab, (batch, prompt)),
                          device=DEVICE)
    ctx = context_stub(cfg, batch, rng, DEVICE)
    if ctx is not None:
        line["context"] = list(ctx.shape)

    # -- one prefill's launches (a request of one token: the prefill only)
    kernels.reset_launch_counts()
    _, mla_args = record_first_mla_call(
        lambda: lm_arch_request(cfg, params, tokens, 1, ctx, False))
    per_prefill = launches_now()

    # -- the main path: a request whose decode steps replay a CUDA graph
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    res = lm_arch_request(cfg, params, tokens, new, ctx, None)
    serve_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    counts = kernels.launch_counts()
    per_step = res["graph_launches"]
    want = {k: per_prefill.get(k, 0) + (steps + 1) * per_step.get(k, 0)
            for k in counts}
    if counts != want:
        fail(f"lm_archs {name}: launches {counts}, expected {want} (a "
             f"prefill's {per_prefill}, {per_step} per decode step over "
             f"{steps} replays and the warm-up step)")
    if name.startswith(("deepseek", "whisper")) and \
            not per_prefill.get("flash_attention"):
        fail(f"lm_archs {name}: the prefill launched no flash_attention")

    # -- an eager request: the same tokens and logits, bit for bit
    eager = lm_arch_request(cfg, params, tokens, new, ctx, False)
    same = torch.equal(res["tokens"], eager["tokens"]) and all(
        torch.equal(a, b) for a, b in zip(res["logits"], eager["logits"]))
    if not same:
        fail(f"lm_archs {name}: the graphed decode differs from the eager one")
    timed = {"graph": lm_arch_request(cfg, params, tokens, new, ctx, None),
             "eager": lm_arch_request(cfg, params, tokens, new, ctx, False)}
    line.update({
        "launches_per_prefill": per_prefill,
        "launches_per_decode_step": per_step,
        "graph_equals_eager_bitwise": same,
        "prefill_ms": [r["prefill_s"] * 1e3 for r in (res, eager,
                                                      *timed.values())],
        "decode_ms_per_step_graphed": [r["decode_s"] / steps * 1e3
                                       for r in (res, timed["graph"])],
        "decode_ms_per_step_eager": [r["decode_s"] / steps * 1e3
                                     for r in (eager, timed["eager"])],
        "capture_ms": [r["capture_s"] * 1e3 for r in (res, timed["graph"])],
        "serve_peak_MiB": serve_peak,
        "greedy_tokens_batch0": res["tokens"][0].tolist()})
    del eager, timed
    torch.cuda.empty_cache()
    pre = make_prefill(cfg, max_len=prompt + new)
    device_profile(lambda: pre(params, tokens, ctx), "lm_archs_profile",
                   f"{name}: one prefill")

    # -- decode == forward (no-drop capacity for MoE: at the published 1.25
    #    the prefill drops tokens that a decode step does not)
    checks = [decode_vs_forward(cfg, params, tokens, ctx, res,
                                f"capacity {cfg.capacity_factor}")]
    if cfg.n_experts:
        # no drop; the eager request (graphed == eager above) records the
        # routing of its prefill and of each decode step
        cfg8 = dc.replace(cfg, capacity_factor=8.0)
        res8, routing = record_routing(
            lambda: lm_arch_request(cfg8, params, tokens, new, ctx, False))
        checks[0]["gated"] = False
        checks.append(decode_vs_forward(cfg8, params, tokens, ctx, res8,
                                        "capacity 8.0 (no drop)", routing))
        del res8, routing
    line["decode_vs_forward"] = checks
    for c in checks:
        c.setdefault("gated", True)
        bad = [f for f in c.get("routing_flips", ())
               if any(v["forward_margin"] > 2 * c["routing_score_noise"]
                      for v in f["layers"])]
        if c["gated"] and (c["max_abs_err"] > c["tol"] or bad):
            print(json.dumps(line), flush=True)
            fail(f"lm_archs {name} decode == forward ({c['what']}): max err "
                 f"{c['max_abs_err']:.4g} (tol {c['tol']:.4g}); routing "
                 f"flips beyond the score noise: {bad}")
    if cfg.mtp:
        with torch.no_grad():
            _, hidden, _ = LM.forward(params, cfg, tokens, ctx,
                                      return_hidden=True)
            kernels.reset_launch_counts()
            mtp = LM.mtp_logits(params, cfg, hidden[:, :-1], tokens[:, 1:])
        if tuple(mtp.shape) != (batch, prompt - 1, cfg.vocab) or \
                not bool(torch.isfinite(mtp).all()):
            fail(f"lm_archs {name}: mtp_logits {tuple(mtp.shape)}, finite "
                 f"{bool(torch.isfinite(mtp).all())}")
        line["mtp_logits"] = {"shape": list(mtp.shape), "finite": True,
                              "launches": launches_now()}
        del hidden, mtp
    line["peak_MiB"] = torch.cuda.max_memory_allocated() / 2 ** 20
    mla = check_mla_instance(mla_args) if mla_args is not None else None
    if cfg.mla and mla is None:
        fail(f"lm_archs {name}: no MLA call with (D, DV) = {MLA_DIMS}")
    del params, res, mla_args
    torch.cuda.empty_cache()
    line["card_vs_cpu"] = lm_arch_card_vs_cpu(name)
    print(json.dumps(line), flush=True)
    return line, mla


def phase_lm_archs():
    """deepseek-v3 (4 layers and MTP), jamba (2 layers), rwkv6-3b and
    whisper-medium at their published widths, bf16, random weights from the
    port's initialiser, one at a time (parameters freed before the next)."""
    t0 = time.perf_counter()
    lines, mla = {}, None
    for spec in LM_ARCHS:
        lines[spec[0]], m = lm_arch(*spec)
        mla = mla or m
    print(json.dumps({"phase": "lm_archs", "s": time.perf_counter() - t0}),
          flush=True)
    return lines, mla


# ---------------------------------------------------------------------------
# lm_train: LM training through launch/train.py at full width
# ---------------------------------------------------------------------------

LM_TRAIN_ARCH = "qwen2-1.5b"
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 4, 2_048, 12
LM_TRAIN_REMAT_LAYERS = 4          # (c): remat full == none at full width
LM_TRAIN_ATTN = ("qwen2-1.5b", "gemma2-2b")   # (a): their attention shapes
# (a)'s gates: fp32 the CPU tests' 1e-4 x max; bf16 1e-2 x max on the
# output (the kernel rounds P to bf16) and 2e-2 x max on dq/dk/dv (the
# backward's rowsum(dO o) reads that output)
LM_TRAIN_TOL = {torch.bfloat16: (1e-2, 2e-2), torch.float32: (1e-4, 1e-4)}
LM_TRAIN_SMALL = dict(n_layers=4, d_model=256, d_ff=512, vocab=1024)


def attn_train_bound(q, k, dv, causal, window, backward):
    """Least time of the attention's forward (Q K^T and P V: 2 (D + DV) per
    visible pair and q head; q, k, v in, o and the fp32 LSE out) or its
    backward (S again, dV, dP, dQ, dK: 2 (3 D + 2 DV); q, k, v, o, dO and
    the LSE in, dq, dk, dv out) at the inputs' type's peak, against those
    bytes at the memory rate: (ms, bound_by), flops."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    pos = np.arange(sq, dtype=np.int64)
    hi = np.minimum(sk - 1, pos) if causal else np.full(sq, sk - 1)
    lo = np.maximum(0, pos - window + 1) if window > 0 else np.zeros(sq, np.int64)
    pairs = int(np.clip(hi - lo + 1, 0, None).sum()) * b * hq
    el = q.element_size()
    qo = b * hq * sq * (d + dv) * el + b * hq * sq * 4           # q, o, lse
    kv = b * hkv * sk * (d + dv) * el
    if backward:
        flops = 2 * (3 * d + 2 * dv) * pairs
        nbytes = 2 * (qo + kv) + b * hq * sq * dv * el           # + dO
    else:
        flops = 2 * (d + dv) * pairs
        nbytes = qo + kv
    peak = BF16_PEAK if q.dtype == torch.bfloat16 else F32_PEAK
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_RATE * 1e3
    return ((t_ops, "operations") if t_ops >= t_bytes
            else (t_bytes, "bytes")), flops


def lm_train_attention(arch):
    """(a) The attention of ``arch``'s training step (its first layer's
    mixer: gemma2's local layer, window and softcap) at B x S: the autograd
    Function against plain autograd through ``attention_ref``, a repeat
    bit for bit, the kernel with the LSE against the serving call bit for
    bit; times (median of 10, L2 flushed): the forward with the LSE, the
    plain backward, the Function's forward + backward, plain autograd, and
    beside them at softcap 0 the Function and SDPA forward + backward, and
    the kernel's and SDPA's forwards alone."""
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attn, ops, ref
    cfg = get_arch(arch)
    b, s = LM_TRAIN_BATCH, LM_TRAIN_SEQ
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    window = cfg.window if cfg.local_global_pattern else 0
    args = (True, window, cfg.attn_softcap, 0)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 21)
    base = [torch.randn(shape, generator=gen, device=DEVICE)
            for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d),
                          (b, hq, s, d))]
    line = {"phase": "lm_train", "check": "attention forward + backward",
            "arch": arch, "q": [b, hq, s, d], "k": [b, hkv, s, d],
            "causal": True, "window": window, "softcap": cfg.attn_softcap}
    for dtype, (tol_o, tol_g) in LM_TRAIN_TOL.items():
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        q, k, v = (t.to(dtype).requires_grad_() for t in base[:3])
        do = base[3].to(dtype)

        def route(fn, a=args):
            def run():
                out = fn(q, k, v, *a)
                grads = torch.autograd.grad(out, (q, k, v), do)
                return (out.detach(), *grads)
            return run

        fn_route, plain_route = route(ops.attention_op), route(ref.attention_ref)
        got, want = fn_route(), plain_route()
        errs = {}
        for name, a, w, tol in zip(("out", "dq", "dk", "dv"), got, want,
                                   (tol_o, tol_g, tol_g, tol_g)):
            errs[name] = check(f"lm_train {arch} {tag} Function vs plain "
                               f"autograd, {name}", a.float(), w.float(),
                               atol=tol * float(w.float().abs().max()))
        if not all(torch.equal(a, b_) for a, b_ in zip(got, fn_route())):
            fail(f"lm_train {arch} {tag}: a repeat of the Function differs")
        del got, want
        qd, kd, vd = q.detach(), k.detach(), v.detach()
        with torch.no_grad():
            out, lse = flash_attn.flash_attention(qd, kd, vd, *args,
                                                  return_lse=True)
            if not torch.equal(out, flash_attn.flash_attention(qd, kd, vd,
                                                               *args)):
                fail(f"lm_train {arch} {tag}: the kernel with the LSE gives "
                     "other output bits than the serving call")
        (fb_ms, fb_by), fwd_flops = attn_train_bound(qd, kd, d, True, window,
                                                     False)
        (bb_ms, bb_by), bwd_flops = attn_train_bound(qd, kd, d, True, window,
                                                     True)
        line.update({
            f"{tag}_max_abs_err": errs,
            f"{tag}_tol": f"out atol {tol_o}*max|plain|, grads atol "
                          f"{tol_g}*max|plain|",
            f"{tag}_lse_call_equals_serving_call_bitwise": True,
            f"{tag}_forward_ms": time_ms(lambda: flash_attn.flash_attention(
                qd, kd, vd, *args, return_lse=True)),
            f"{tag}_plain_backward_ms": time_ms(
                lambda: ref.attention_bwd_ref(qd, kd, vd, out, lse, do,
                                              *args)),
            f"{tag}_function_fwd_bwd_ms": time_ms(fn_route),
            f"{tag}_plain_autograd_ms": time_ms(plain_route),
            f"{tag}_forward_bound_ms": fb_ms, f"{tag}_forward_bound_by": fb_by,
            f"{tag}_backward_bound_ms": bb_ms,
            f"{tag}_backward_bound_by": bb_by,
            f"{tag}_forward_flops": fwd_flops,
            f"{tag}_backward_flops": bwd_flops})
        if dtype == torch.bfloat16:
            # SDPA computes the function at softcap 0 only; gemma2's window
            # (4,096) covers the whole 2,048-token sequence
            if window and window < s:
                fail("lm_train: the SDPA yardstick assumes no window inside "
                     "the sequence")
            a0 = (True, window, 0.0, 0)
            sdpa = route(lambda q, k, v, *a: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
            g0, w0 = route(ops.attention_op, a0)(), sdpa()
            errs0 = max(check(f"lm_train {arch} bf16 softcap 0 vs sdpa, {n}",
                              a.float(), w.float(),
                              atol=tol_g * float(w.float().abs().max()))
                        for n, a, w in zip("odqkv", g0, w0))
            del g0, w0
            line.update({
                "bf16_softcap0_function_fwd_bwd_ms":
                    time_ms(route(ops.attention_op, a0)),
                "bf16_sdpa_fwd_bwd_ms": time_ms(sdpa),
                "bf16_softcap0_max_err_vs_sdpa": errs0,
                # the forwards alone: the kernel with the LSE at softcap 0
                # beside SDPA's forward (the library call for the forward)
                "bf16_softcap0_forward_ms": time_ms(
                    lambda: flash_attn.flash_attention(
                        qd, kd, vd, *a0, return_lse=True)),
                "bf16_sdpa_forward_ms": time_ms(
                    lambda: F.scaled_dot_product_attention(
                        qd, kd, vd, is_causal=True, enable_gqa=True))})
        del q, k, v, do, out, lse, qd, kd, vd
        torch.cuda.empty_cache()
    print(json.dumps(line), flush=True)
    return line


def lm_train_grads(cfg, params, batch, remat):
    """Loss, metrics and gradient leaves of ``cfg``'s training loss."""
    from repro_torch.lm import train_lib as TL
    from repro_torch.optim.adam import tree_leaves, tree_map
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = TL.make_loss_fn(cfg, TL.TrainHParams(remat=remat))(
        leaves, batch)
    flat = tree_leaves(leaves)
    grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def lm_train_run():
    """(b) qwen2-1.5b at full width through ``launch.train.main`` (B 4 x
    2,048, Adam, ``remat="full"``, random weights, 12 steps): each step
    synchronised and timed on the host clock with its launches counted
    (``train_lib.make_train_step`` wrapped); the last one under
    ``torch.profiler``, so the median is of steps 2-11."""
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.launch import train as TRN
    from repro_torch.lm import train_lib as TL
    real, rec = TL.make_train_step, []

    def timed(cfg, hp, mesh=None):
        step, opt = real(cfg, hp, mesh)

        def run(params, opt_state, batch):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            if len(rec) == LM_TRAIN_STEPS - 1:
                out = []
                device_profile(lambda: out.append(step(params, opt_state,
                                                       batch)),
                               "lm_train_profile",
                               f"one {LM_TRAIN_ARCH} train step (B "
                               f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ})",
                               host_ops=True)
                res = out[0]
            else:
                res = step(params, opt_state, batch)
            torch.cuda.synchronize()
            rec.append({"ms": (time.perf_counter() - t0) * 1e3,
                        "launches": {k: n for k, n in
                                     kernels.launch_counts().items() if n},
                        "loss": float(res[2]["loss"]),
                        "grad_norm": float(res[2]["grad_norm"])})
            return res

        return run, opt

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    TL.make_train_step = timed
    t0 = time.perf_counter()
    try:
        last = TRN.main(["--arch", LM_TRAIN_ARCH, "--batch",
                         str(LM_TRAIN_BATCH), "--seq", str(LM_TRAIN_SEQ),
                         "--steps", str(LM_TRAIN_STEPS), "--device", DEVICE])
    finally:
        TL.make_train_step = real
    wall = time.perf_counter() - t0
    n = get_arch(LM_TRAIN_ARCH).n_layers
    for i, r in enumerate(rec):
        if r["launches"] != {"flash_attention": 2 * n}:
            fail(f"lm_train step {i}: launches {r['launches']}, expected "
                 f"{2 * n} flash_attention (forward and recomputed) and no "
                 "other kernel")
        if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])):
            fail(f"lm_train step {i}: non-finite loss or gradient norm")
    ms = statistics.median(r["ms"] for r in rec[1:LM_TRAIN_STEPS - 1])
    line = {"phase": "lm_train", "arch": LM_TRAIN_ARCH,
            "entry": "launch.train.main", "batch": LM_TRAIN_BATCH,
            "seq": LM_TRAIN_SEQ, "steps": LM_TRAIN_STEPS,
            "optimizer": "adam", "remat": "full", "dtype": "bfloat16",
            "ms_per_step_median_steps_2_11": ms,
            "ms_by_step": [r["ms"] for r in rec],
            "tokens_per_s": LM_TRAIN_BATCH * LM_TRAIN_SEQ / ms * 1e3,
            "loss_by_step": [r["loss"] for r in rec],
            "last_metrics": last,
            "launches_per_step": rec[1]["launches"],
            "peak_MiB": torch.cuda.max_memory_allocated() / 2 ** 20,
            "run_s_with_init": wall,
            "ms_is": "host clock around each synchronised step (the "
                     "launcher's batch draw and copy outside it)"}
    print(json.dumps(line), flush=True)
    torch.cuda.empty_cache()
    return line


def lm_train_remat():
    """(c) ``remat="full"`` == ``"none"`` bit for bit at full width, cut to
    4 layers: the loss, the metrics and every gradient leaf."""
    import dataclasses as dc
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import make_batch
    from repro_torch.lm import model as LM
    cfg = dc.replace(get_arch(LM_TRAIN_ARCH), n_layers=LM_TRAIN_REMAT_LAYERS)
    params = LM.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    batch = make_batch(cfg, 0, LM_TRAIN_BATCH, LM_TRAIN_SEQ, DEVICE)
    out = {}
    for remat in ("none", "full"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out[remat] = lm_train_grads(cfg, params, batch, remat)
        torch.cuda.synchronize()
        out[remat] += (torch.cuda.max_memory_allocated() / 2 ** 20,)
    (l0, m0, g0, p0), (l1, m1, g1, p1) = out["none"], out["full"]
    if not (torch.equal(l0, l1) and all(torch.equal(m0[k], m1[k]) for k in m0)
            and all(torch.equal(a, b) for a, b in zip(g0, g1))):
        fail("lm_train: remat full and none give other bits at full width")
    line = {"phase": "lm_train", "check": "remat full == none",
            "arch": LM_TRAIN_ARCH, "layers": LM_TRAIN_REMAT_LAYERS,
            "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ,
            "loss_and_every_gradient_bitwise": True, "loss": float(l0),
            "peak_MiB_remat_none": p0, "peak_MiB_remat_full": p1}
    print(json.dumps(line), flush=True)
    del params, out
    torch.cuda.empty_cache()
    return line


def lm_train_card_vs_cpu(name):
    """(d) ``name`` at the reduced width (fp32, B 2 x 64): two train steps
    on the card against the port on the CPU from the same parameters and
    batches, at the CPU tests' gates: the metrics within 1e-4 x |cpu|;
    Adam's first moment after each step leaf by leaf within 1e-4 x max|cpu
    leaf|; the parameters after step 1 within 1e-4 x max|cpu leaf| plus
    what that gradient gate allows Adam's first step (-lr g / (|g| +
    eps)) to make of it."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import make_batch
    from repro_torch.lm import model as LM
    from repro_torch.lm import train_lib as TL
    from repro_torch.optim.adam import tree_leaves
    over = dict(LM_TRAIN_SMALL)
    if name == "llama-3.2-vision-90b":
        over["n_layers"] = 5          # its cross-attention layer (every 5th)
    if get_arch(name).mla:
        over.update(LM_ARCH_SMALL_MLA)
    cfg = get_arch(name).reduced(**over)
    params = LM.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    hp = TL.TrainHParams()
    rec = {}
    for dev in ("cpu", DEVICE):
        step, opt = TL.make_train_step(cfg, hp)
        p = _tree(params, lambda t: t.to(dev))
        st = opt.init(p)
        rec[dev] = []
        for i in range(2):
            p, st, m = step(p, st, make_batch(cfg, i, 2, 64, dev))
            rec[dev].append(({k: float(v) for k, v in m.items()},
                             [t.cpu() for t in tree_leaves(st["m"])],
                             [t.cpu() for t in tree_leaves(p)]))
    err_m, err_g, err_p, excused = 0.0, 0.0, 0.0, 0
    for i, (c, g) in enumerate(zip(rec["cpu"], rec[DEVICE])):
        for key, want in c[0].items():
            e = abs(g[0][key] - want)
            if e > 1e-4 * abs(want):
                fail(f"lm_train {name} card vs cpu step {i}: {key} "
                     f"{g[0][key]} vs {want}")
            err_m = max(err_m, e / max(abs(want), 1e-30))
        for a, b in zip(g[1], c[1]):
            err_g = max(err_g, check(f"lm_train {name} card vs cpu step {i} "
                                     "first moment", a, b,
                                     atol=1e-4 * float(b.abs().max())))
    for got, want, m1 in zip(rec[DEVICE][0][2], rec["cpu"][0][2],
                             rec["cpu"][0][1]):
        gabs = m1.double().abs() / 0.1             # |clipped g|, 1 - b1
        d = 1e-4 * float(gabs.max())
        amp = hp.lr * d * 1e-8 / ((gabs - d).clamp_min(0) + 1e-8) ** 2
        err = (got.double() - want.double()).abs()
        gate = 1e-4 * float(want.abs().max())
        if bool((err > gate + amp).any()):
            fail(f"lm_train {name} card vs cpu: parameters after step 1 "
                 f"off by {float(err.max()):.3e}")
        excused += int((err > gate).sum())
        err_p = max(err_p, float(err.max()))
    return {"max_rel_err_metrics": err_m, "max_abs_err_first_moment": err_g,
            "max_abs_err_params_step1": err_p,
            "param_entries_inside_adam_noise_floor_only": excused}


def lm_train_restart():
    """(e) ``launch.train`` on the card at its reduced config (B 2 x 64,
    12 steps, a checkpoint every 4): interrupted at step 6 (exit 42) and
    resumed from step 4, the last metrics and the final checkpoint equal
    to the uninterrupted run's bit for bit."""
    import tempfile
    from repro_torch.ckpt import latest_step_dir, load_pytree
    from repro_torch.launch import train as TRN
    args = ["--reduced", "--steps", "12", "--ckpt-every", "4", "--batch",
            "2", "--seq", "64", "--device", DEVICE]
    with tempfile.TemporaryDirectory() as tmp:
        a = TRN.main(args + ["--ckpt-dir", f"{tmp}/a"])
        try:
            TRN.main(args + ["--ckpt-dir", f"{tmp}/b", "--simulate-failure",
                             "6"])
            fail("lm_train restart: --simulate-failure 6 did not exit")
        except SystemExit as e:
            if e.code != 42:
                fail(f"lm_train restart: exit {e.code}, expected 42")
        b = TRN.main(args + ["--ckpt-dir", f"{tmp}/b"])
        pa = load_pytree(latest_step_dir(f"{tmp}/a"))
        pb = load_pytree(latest_step_dir(f"{tmp}/b"))
    flat_a, flat_b = [], []
    _tree(pa, flat_a.append)
    _tree(pb, flat_b.append)
    if a != b or len(flat_a) != len(flat_b) or not all(
            np.array_equal(x, y) for x, y in zip(flat_a, flat_b)):
        fail("lm_train restart: the resumed run differs from the "
             "uninterrupted one")
    line = {"phase": "lm_train", "check": "restart on the card",
            "config": "qwen2-1.5b --reduced (d_model 256, 4 layers, vocab "
                      "512), B 2 x 64, 12 steps, checkpoint every 4, "
                      "killed at 6",
            "last_metrics_bitwise": True, "final_checkpoint_bitwise": True,
            "leaves": len(flat_a), "last_loss": a["loss"]}
    print(json.dumps(line), flush=True)
    return line


def phase_lm_train():
    """LM training on the card: (a) the attention's Function at qwen2's and
    gemma2's shapes, (b) qwen2-1.5b at full width through
    ``launch/train.py`` (the main path), (c) remat full == none at full
    width (4 layers), (d) every registry arch at the reduced width card ==
    CPU, (e) the launcher's restart bit for bit.  Returns the attention
    lines, the launches per train step and (b)'s line."""
    from repro_torch.configs import ARCHS
    t0 = time.perf_counter()
    attn = {a: lm_train_attention(a) for a in LM_TRAIN_ATTN}
    run = lm_train_run()
    lm_train_remat()
    vs_cpu = {name: lm_train_card_vs_cpu(name) for name in sorted(ARCHS)}
    print(json.dumps({"phase": "lm_train", "check": "card vs cpu, every "
                      "registry arch, 2 train steps", "config":
                      "reduced(n_layers=4 (vision 5), d_model=256, d_ff=512,"
                      " vocab=1024; MLA 128 + 64, 128), fp32, B 2 x 64",
                      "tol": "metrics 1e-4*|cpu|; first moments atol "
                             "1e-4*max|leaf|; params after step 1 atol "
                             "1e-4*max|leaf| + lr d eps/((|g|-d)+ + eps)^2",
                      "archs": vs_cpu}), flush=True)
    lm_train_restart()
    print(json.dumps({"phase": "lm_train", "s": time.perf_counter() - t0}),
          flush=True)
    return attn, run["launches_per_step"], run


# ---------------------------------------------------------------------------
# roofline: the step accounting held against the card
# ---------------------------------------------------------------------------

def meta_like(tree):
    """Empty tensors on the ``meta`` device shaped like ``tree``'s."""
    return _tree(tree, lambda t: torch.empty_like(t, device="meta"))


def count_on_both(what, fn, args, meta_args, positions=None):
    """``roofline.count_step`` of one call on ``meta`` and on the card:
    the two counts must be equal, FLOPs by op, bytes, the live-bytes peak
    and each kernel's formula.  Returns the card's count and outputs, the
    meta outputs and the card's peak memory above what was allocated before
    the step (``torch.cuda.max_memory_allocated``)."""
    from repro_torch.launch.roofline import count_step
    t0 = time.perf_counter()
    meta, meta_out = count_step(fn, *meta_args, positions=positions)
    meta_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    card, out = count_step(fn, *args, positions=positions)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    a, b = meta.to_dict(), card.to_dict()
    if a != b:
        diff = {k: (a[k], b[k]) for k in a if a[k] != b[k]}
        fail(f"roofline {what}: the meta and card counts differ: {diff}")
    return card, out, meta_out, {"count_s_meta": meta_s,
                                 "count_s_card": card_s,
                                 "peak_above_inputs_bytes": peak - base,
                                 "max_memory_allocated_bytes": peak}


def roofline_line(what, count, ms, model_flops, mem, smi, **extra):
    """One cell's shares of the card (datasheet rates) at its measured
    ``ms``: model FLOPs (``mfu``) and counted FLOPs (``hfu``) over the bf16
    peak, counted bytes over 3.35 TB/s, and the lower bound's share."""
    from repro_torch.launch.roofline import roofline_terms
    sec = ms / 1e3
    terms = roofline_terms(count.flops, count.bytes, 0.0)
    line = {"phase": "roofline", "cell": what, "device": smi,
            "ms": ms, "model_flops": model_flops,
            "counted_flops": count.flops,
            "aten_flops_by_op": count.flops_by_op,
            "kernels": count.kernels, "counted_bytes": count.bytes,
            "bytes_by_op": count.bytes_by_op,
            "mfu": model_flops / sec / BF16_PEAK,
            "hfu": count.flops / sec / BF16_PEAK,
            "bytes_share": count.bytes / sec / HBM_RATE,
            "lower_bound_ms": terms["step_lower_bound_s"] * 1e3,
            "bound_by": terms["dominant"],
            "lower_bound_share": terms["step_lower_bound_s"] / sec,
            "live_peak_bytes": count.live_peak_bytes,
            **mem, "meta_equals_card": True,
            "rates": "H100 SXM5 datasheet: bf16 989 TFLOP/s, 3.35 TB/s",
            **extra}
    print(json.dumps(line), flush=True)
    return line


def lm_serving_times(cfg, params, tokens):
    """Prefill and graphed decode ms (medians of LM_ROUNDS graphed requests
    after one warm-up request), for the phase run alone."""
    from repro_torch.launch.serve import serve_tokens
    serve_tokens(cfg, params, tokens, LM_NEW)
    rounds = [serve_tokens(cfg, params, tokens, LM_NEW)
              for _ in range(LM_ROUNDS)]
    return {"prefill_ms_median": statistics.median(
                r["prefill_s"] * 1e3 for r in rounds),
            "decode_ms_per_step_median": statistics.median(
                r["decode_s"] / (LM_NEW - 1) * 1e3 for r in rounds)}


def phase_roofline(smi, train_line=None, lm_summary=None):
    """The step accounting (``launch/roofline.py::count_step``) against the
    card: (a) one qwen2-1.5b training step (the ``lm_train`` phase's
    config: B 4 x 2,048, Adam, ``remat="full"``) and (b) one gemma2-2b
    prefill (the ``lm`` phase's: B 4 x 6,144 into a 6,176-token cache) and
    one eager decode step at the last decode position of the ``lm``
    phase's request, each counted on ``meta`` and on the card, the counts
    equal; then the shares of the card at the times the ``lm_train`` and
    ``lm`` phases measured (run alone: measured here, 12 training steps
    and LM_ROUNDS graphed requests)."""
    from repro_torch.configs import get_arch, param_count
    from repro_torch.launch.train import make_batch
    from repro_torch.lm import model as LM
    from repro_torch.lm import train_lib as TL
    from repro_torch.lm.serve_lib import make_prefill, make_serve_step
    t_phase = time.perf_counter()
    if train_line is None:
        train_line = lm_train_run()
    cfg = get_arch(LM_TRAIN_ARCH)
    n_active = param_count(cfg)[1]
    hp = TL.TrainHParams(optimizer="adam")
    step, opt = TL.make_train_step(cfg, hp)
    params = LM.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    state = opt.init(params)
    batch = make_batch(cfg, 0, LM_TRAIN_BATCH, LM_TRAIN_SEQ, DEVICE)
    m_params = meta_like(params)
    count, _, _, mem = count_on_both(
        "train", step, (params, state, batch),
        (m_params, opt.init(m_params), meta_like(batch)))
    lines = {"train": roofline_line(
        f"{LM_TRAIN_ARCH} train step, B {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}, "
        "adam, remat full", count,
        train_line["ms_per_step_median_steps_2_11"],
        6.0 * n_active * LM_TRAIN_BATCH * LM_TRAIN_SEQ, mem, smi,
        ms_is="lm_train's ms_per_step_median_steps_2_11",
        lm_train_peak_MiB=train_line["peak_MiB"])}
    del params, state, batch, count
    torch.cuda.empty_cache()

    cfg = get_arch(LM_ARCH)
    n_active = param_count(cfg)[1]
    params = LM.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    tokens = torch.tensor(np.random.default_rng(SEED + 7).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT)), device=DEVICE)
    if lm_summary is None:
        lm_summary = lm_serving_times(cfg, params, tokens)
    m_params = meta_like(params)
    prefill = make_prefill(cfg, max_len=LM_PROMPT + LM_NEW)
    count, (logits, cache), (_, m_cache), mem = count_on_both(
        "prefill", prefill, (params, tokens), (m_params, meta_like(tokens)))
    # the prefill projects only the last position onto the vocabulary:
    # 2 N D less the LM head's 2 V d at the other S - 1 positions per row
    unprojected = 2.0 * cfg.vocab * cfg.d_model * LM_BATCH * (LM_PROMPT - 1)
    lines["prefill"] = roofline_line(
        f"{LM_ARCH} prefill, B {LM_BATCH} x {LM_PROMPT}", count,
        lm_summary["prefill_ms_median"],
        2.0 * n_active * LM_BATCH * LM_PROMPT - unprojected, mem, smi,
        ms_is="lm's prefill_ms_median (graphed requests)",
        model_flops_is="2 N D less the LM head at the B (S - 1) positions "
                       "the prefill does not project",
        model_flops_2nd=2.0 * n_active * LM_BATCH * LM_PROMPT)
    pos = LM_PROMPT + LM_NEW - 2            # the last decode step's
    tok = logits[:, -1:].argmax(-1)
    serve = make_serve_step(cfg)
    count, _, _, mem = count_on_both(
        "decode", serve,
        (params, cache, tok, torch.tensor(pos, device=DEVICE)),
        (m_params, m_cache, meta_like(tok),
         torch.empty((), dtype=torch.int64, device="meta")), positions=pos)
    lines["decode"] = roofline_line(
        f"{LM_ARCH} decode step, B {LM_BATCH}, position {pos}", count,
        lm_summary["decode_ms_per_step_median"],
        2.0 * n_active * LM_BATCH, mem, smi,
        ms_is="lm's decode_ms_per_step_median (graphed steps; counted "
              "eagerly: the graph launches what the eager step launches)")
    del params, cache, logits
    torch.cuda.empty_cache()
    print(json.dumps({"phase": "roofline",
                      "s": time.perf_counter() - t_phase}), flush=True)
    return lines


# ---------------------------------------------------------------------------
# lm_mesh: the LM over a ("data", "model") process mesh
# ---------------------------------------------------------------------------

LM_MESH_DIR = Path(__file__).resolve().parent / "build" / "lm_mesh"
LM_MESH_GROUP_S = 120     # seconds a rendezvous or collective may wait
LM_MESH_CHILD_S = 600     # seconds a group of child processes may take
LM_MESH_STEPS = 2         # training steps compared per case
LM_MESH_GLOO_LAYERS = 4   # the two gloo processes sharing the card: layers
LM_MESH_QWEN_PROMPT = 2_048   # qwen2-1.5b's decode cases on four cards
# the routing gate of a mesh serve against no mesh: the score noise may be
# at most 8 bf16 steps of a score at 1 (the sigmoid router's scores lie in
# (0, 1); ~3x what deepseek-v3 gave on four cards), and at most this share
# of the (row, step) positions may have an MoE layer choose other experts
LM_MESH_SCORE_NOISE_MAX = 8 * 2.0 ** -8
LM_MESH_FLIP_SHARE = 0.25
# the extended decode kernel's cases: (name, Hq, Hkv, D, S_max, pos, window,
# softcap), the cache cut into 4 slices of S_max / 4 rows (kv_base = j x
# S_max / 4): at gemma2-2b's (global, and a window ending inside a slice)
# and qwen2-1.5b's head widths; the last slice lies wholly past pos
LM_MESH_SLICES = (("gemma2-2b", 8, 4, 256, 6_176, 4_000, 0, 50.0),
                  ("gemma2-2b window 2000", 8, 4, 256, 6_176, 4_000, 2_000,
                   50.0),
                  ("qwen2-1.5b", 12, 2, 128, 2_080, 1_500, 0, 0.0))
# the long-context decode: qwen2-1.5b at B 1 over long_500k's 524,288
# positions (the reference's dry run lays such a cache's sequence over
# "data"), LM_MESH_LONG_STEPS greedy steps into its last positions; and the
# slice instance at the slices a (4, 1) and a (2, 2) mesh give one process
# (its KV heads: 2, or 1 over "model"), B 1: (name, Hq, Hkv, D, S_max, pos,
# window, softcap, slices, batch)
LM_MESH_LONG = 524_288
LM_MESH_LONG_STEPS = 8
LM_MESH_LONG_SLICES = (
    ("qwen2-1.5b long_500k (4, 1)", 12, 2, 128, LM_MESH_LONG,
     LM_MESH_LONG - LM_MESH_LONG_STEPS, 0, 0.0, 4, 1),
    ("qwen2-1.5b long_500k (2, 2)", 6, 1, 128, LM_MESH_LONG,
     LM_MESH_LONG - LM_MESH_LONG_STEPS, 0, 0.0, 2, 1))


def lm_mesh_comm(fn):
    """``fn()`` once under ``CommDebugMode`` and ``torch.profiler``: its
    result, the collectives by kind (counts) and their ms by kind (NCCL
    kernels' device time; gloo's host time of the ``c10d``/``gloo`` ops,
    which on CUDA tensors includes the host copies)."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.profiler import ProfilerActivity, profile
    kinds = ("allreduce", "allgather", "reducescatter", "broadcast",
             "alltoall")
    mode = CommDebugMode()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with mode:
            out = fn()
        torch.cuda.synchronize()
    counts = {}
    for op, n in mode.get_comm_counts().items():
        name = str(op).split(".")[-1].replace("_", "")
        kind = next((k for k in kinds if k in name), name)
        counts[kind] = counts.get(kind, 0) + n
    ms = {}
    for ev in prof.events():
        name = ev.name.lower().replace("_", "")
        kind = next((k for k in kinds if k in name), None)
        if kind is None:
            continue
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if "nccl" in name:
                ms[kind] = ms.get(kind, 0.0) + ev.time_range.elapsed_us() / 1e3
        elif name.startswith(("c10d::", "gloo:")):
            ms[kind] = ms.get(kind, 0.0) + ev.time_range.elapsed_us() / 1e3
    return out, counts, ms


def lm_mesh_cfg(arch, layers=None):
    from repro_torch.configs import get_arch
    cfg = get_arch(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


@torch.no_grad()
def check_decode_slices(smi, cases=LM_MESH_SLICES):
    """The decode kernel's slice instance (``flash_decode(...,
    kv_base=j * S / n, return_lse=True)``) against its plain version
    (``ref.decode_ref``) on the card, bf16 and fp32, at each case
    (``LM_MESH_SLICES``: B 4, 4 slices; or the case's slices and batch):
    each slice's O at the flash gates (atol 1e-2 / 1e-4 x max|plain|), its
    LSE within 1e-3 where finite and -inf exactly where the plain
    version's is (a slice with no visible key: O = 0, no NaN), a repeat bit
    for bit, and the slices merged by their LSE against the kernel over
    the whole cache.  The slice with the most visible keys timed beside
    its plain version, its bound (the slice's bytes, ``decode_work``) and
    SDPA on the same keys (at softcap 0: the yardstick where the case's
    softcap is not, with the kernel's time at softcap 0 beside it)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attn, ref
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    rows = []
    for name, hq, hkv, d, s, pos, window, cap, *rest in cases:
        n_sl, b = rest or (4, 4)
        base32 = [torch.randn(shape, generator=g, device=DEVICE)
                  for shape in ((b, hq, 1, d), (b, hkv, s, d), (b, hkv, s, d))]
        sl, p = s // n_sl, torch.tensor(pos, device=DEVICE)
        for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
            q, k, v = (t.to(dtype) for t in base32)
            tag = "bf16" if dtype == torch.bfloat16 else "fp32"
            outs, lses, errs, empty, vis = [], [], [], [], []
            for j in range(n_sl):
                kj, vj = k[:, :, j * sl:(j + 1) * sl], v[:, :, j * sl:(j + 1) * sl]
                o, lse = flash_attn.flash_decode(q, kj, vj, p, window, cap,
                                                 kv_base=j * sl,
                                                 return_lse=True)
                po, plse = ref.decode_ref(q, kj, vj, pos, window, cap,
                                          j * sl, True)
                what = f"decode slice {name} {tag} {j}"
                errs.append(check(what, o.float(), po.float(),
                                  atol=tol * float(po.float().abs().max())))
                inf = torch.isneginf(plse)
                if not torch.equal(torch.isneginf(lse), inf):
                    fail(f"{what}: -inf log-sum-exps differ from the plain "
                         "version's")
                if bool((~inf).any()):
                    check(f"{what} lse", lse[~inf], plse[~inf], atol=1e-3)
                again = flash_attn.flash_decode(q, kj, vj, p, window, cap,
                                                kv_base=j * sl,
                                                return_lse=True)
                if not (torch.equal(again[0], o) and torch.equal(again[1],
                                                                 lse)):
                    fail(f"{what}: a repeat differs")
                if bool(inf.all()):
                    empty.append(j)
                lo = max(j * sl, pos - window + 1 if window else 0)
                vis.append(max(0, min((j + 1) * sl, pos + 1) - lo))
                outs.append(o.float())
                lses.append(lse)
            if (n_sl - 1) * sl > pos and n_sl - 1 not in empty:
                fail(f"decode slices {name}: the slice past pos saw a key")
            lse = torch.stack(lses)
            w = torch.exp(lse - lse.amax(0))[..., None]
            merged = (w * torch.stack(outs)).sum(0) / w.sum(0)
            whole = flash_attn.flash_decode(q, k, v, p, window, cap).float()
            merge_err = check(f"decode slices {name} {tag} merged", merged,
                              whole, atol=tol * float(whole.abs().max()))
            j = int(np.argmax(vis))
            kj, vj = k[:, :, j * sl:(j + 1) * sl], v[:, :, j * sl:(j + 1) * sl]
            flops, nbytes = flash_attn.decode_work(
                q, kj, vj, p, window, cap, kv_base=j * sl, return_lse=True,
                positions=pos)
            peak = BF16_PEAK if dtype == torch.bfloat16 else F32_PEAK
            t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_RATE * 1e3
            line = {"phase": "lm_mesh", "name": "flash_decode",
                    "instance": "slice: kv_base, return_lse", "case": name,
                    "dtype": tag, "device": smi, "q": list(q.shape),
                    "k_slice": list(kj.shape), "pos": pos, "window": window,
                    "softcap": cap, "empty_slices": empty,
                    "visible_keys_by_slice": vis, "timed_slice": j,
                    "max_abs_err": max(errs), "merged_max_abs_err": merge_err,
                    "tol": f"atol {tol}*max|plain|; lse atol 1e-3",
                    "ms": time_ms(lambda: flash_attn.flash_decode(
                        q, kj, vj, p, window, cap, kv_base=j * sl,
                        return_lse=True)),
                    "plain_ms": time_ms(lambda: ref.decode_ref(
                        q, kj, vj, pos, window, cap, j * sl, True)),
                    "bound_ms": max(t_ops, t_bytes),
                    "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                    "library_ms": None}
            lo = max(j * sl, pos - window + 1 if window else 0) - j * sl
            hi = min(sl, pos + 1 - j * sl)
            lk, lv = kj[:, :, lo:hi], vj[:, :, lo:hi]
            lib = lambda: F.scaled_dot_product_attention(
                q, lk, lv, enable_gqa=True)
            check(f"decode slice {name} {tag} vs sdpa (softcap 0)",
                  flash_attn.flash_decode(q, kj, vj, p, window, 0.0,
                                          kv_base=j * sl).float(),
                  lib().float(), atol=tol * float(
                      lib().float().abs().max()))
            line["library_ms"] = time_ms(lib)
            line["library_is"] = ("scaled_dot_product_attention on the "
                                  "slice's visible keys (O only, no LSE)")
            if cap != 0.0:
                line["library_is"] += (f"; at softcap 0, the case's softcap "
                                       f"{cap} has no PyTorch call")
                line["softcap0_ms"] = time_ms(lambda: flash_attn.flash_decode(
                    q, kj, vj, p, window, 0.0, kv_base=j * sl,
                    return_lse=True))
            print(json.dumps(line), flush=True)
            rows.append(line)
        del base32, q, k, v
        torch.cuda.empty_cache()
    return rows


def lm_mesh_train(cfg, params, batch, mesh, steps, optimizer="adam"):
    """``steps`` training steps (Adam, or ``optimizer``; ``remat="full"``)
    over ``mesh`` (None: no mesh), each synchronised and timed: per step
    the loss and grad_norm (whole tensors), the ms; the final parameters
    and state, the step, the batch as the step takes it, the kernels'
    launches and the peak memory."""
    from repro_torch import kernels
    from repro_torch.lm import sharding as S
    from repro_torch.lm import train_lib as TL
    step, opt = TL.make_train_step(cfg, TL.TrainHParams(optimizer=optimizer),
                                   mesh=mesh)
    state, b = opt.init(params), batch
    if mesh is not None:
        state = S.distribute_opt_state(state, S.params_shardings(params,
                                                                 mesh), mesh)
        params = S.distribute_params(params, mesh)
        b = S.distribute_batch(batch, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    rec = []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, state, m = step(params, state, b)
        torch.cuda.synchronize()
        rec.append({"ms": (time.perf_counter() - t0) * 1e3,
                    "loss": S.gather(m["loss"]),
                    "grad_norm": S.gather(m["grad_norm"])})
    return {"rec": rec, "params": params, "state": state, "step": step,
            "batch": b,
            "launches": {k: n for k, n in kernels.launch_counts().items()
                         if n},
            "peak_MiB": torch.cuda.max_memory_allocated() / 2 ** 20}


@torch.no_grad()
def lm_mesh_serve(cfg, params, tokens, new, mesh, forced=None, context=None):
    """A prefill of ``tokens`` (and ``context``) and ``new - 1`` decode
    steps over ``mesh`` (None: no mesh), eager, greedy (or fed
    ``forced``'s tokens), each synchronised and timed: the logits (whole),
    the tokens, the prefill's and the decode steps' ms, the launches, the
    cache and the serve step (a capacity of one more step, for a counted
    step after)."""
    from repro_torch import kernels
    from repro_torch.lm import serve_lib as SL
    from repro_torch.lm import sharding as S
    s = tokens.shape[1]
    pre = SL.make_prefill(cfg, max_len=s + new, mesh=mesh)
    dec = SL.make_serve_step(cfg, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    last, cache = pre(params, tokens, context)
    logits = [S.gather(last)]
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    toks = [logits[-1].argmax(-1)]
    ms = []
    for i in range(new - 1):
        nxt = toks[-1] if forced is None else forced[:, i:i + 1]
        t0 = time.perf_counter()
        lg, cache = dec(params, cache, nxt, s + i)
        logits.append(S.gather(lg))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        toks.append(logits[-1].argmax(-1))
    return {"logits": logits, "tokens": torch.cat(toks, 1),
            "prefill_ms": prefill_ms, "decode_ms": ms, "cache": cache,
            "step": dec,
            "launches": {k: n for k, n in kernels.launch_counts().items()
                         if n},
            "peak_MiB": torch.cuda.max_memory_allocated() / 2 ** 20}


def same_tree_bits(a, b) -> bool:
    from repro_torch.lm import sharding as S
    la, lb = S.leaves_with_paths(a), S.leaves_with_paths(b)
    return all(pa == pb and torch.equal(x, y)
               for (pa, x), (pb, y) in zip(la, lb))


def long_cache(cfg, device):
    """``cfg``'s cache at B 1 x LM_MESH_LONG (~15 GB bf16 for qwen2-1.5b),
    its keys and values at every position before the last
    LM_MESH_LONG_STEPS drawn from a seed (N(0, 1), in place, layer by
    layer: the same values on every card)."""
    from repro_torch.lm import serve_lib as SL
    from repro_torch.lm import sharding as S
    cache = SL.init_cache(cfg, 1, LM_MESH_LONG, device)
    g = torch.Generator(device=device).manual_seed(SEED + 13)
    n = LM_MESH_LONG - LM_MESH_LONG_STEPS
    for path, t in S.leaves_with_paths(cache):
        if path.split("/")[-1] in ("k", "v"):
            for layer in (t if path.startswith("pattern") else [t]):
                layer[:, :, :n].normal_(generator=g)
    return cache


@torch.no_grad()
def lm_mesh_long_decode(cfg, params, cache, mesh, forced=None):
    """LM_MESH_LONG_STEPS greedy decode steps of B 1 into ``cache``'s last
    positions over ``mesh`` (None: no mesh), eager, from a seeded first
    token (fed ``forced``'s tokens after it where given), each
    synchronised and timed: the logits (whole), the tokens, the ms, the
    launches, the peak memory and the step."""
    from repro_torch import kernels
    from repro_torch.lm import serve_lib as SL
    from repro_torch.lm import sharding as S
    dev = mesh.device if mesh is not None else DEVICE
    step = SL.make_serve_step(cfg, mesh=mesh)
    pos0 = LM_MESH_LONG - LM_MESH_LONG_STEPS
    nxt = torch.tensor([[int(np.random.default_rng(SEED + 14).integers(
        0, cfg.vocab))]], device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    logits, toks, ms = [], [], []
    for i in range(LM_MESH_LONG_STEPS):
        t0 = time.perf_counter()
        lg, cache = step(params, cache, nxt, pos0 + i)
        logits.append(S.gather(lg))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        toks.append(logits[-1].argmax(-1))
        nxt = toks[-1] if forced is None else forced[:, i:i + 1]
    return {"logits": logits, "tokens": torch.cat(toks, 1), "ms": ms,
            "step": step, "first": nxt,
            "launches": {k: n for k, n in kernels.launch_counts().items()
                         if n},
            "peak_MiB": torch.cuda.max_memory_allocated() / 2 ** 20}


def lm_mesh_one_card_adam8bit(mesh, smi):
    """(1, 1): qwen2-1.5b's training step with ``adam8bit`` (B 2 x 1,024,
    2 steps) against no mesh, bit for bit: loss, grad_norm, every
    parameter and every state leaf (``q``, ``s``, ``v16``, the small
    leaves' fp32 ``m``, ``count``).  Returns the mesh run's launches."""
    from repro_torch.launch.train import make_batch
    from repro_torch.lm import model as LM
    from repro_torch.lm import sharding as S
    cfg = lm_mesh_cfg(LM_TRAIN_ARCH)
    params = LM.init_params(cfg, torch.Generator(
        device=DEVICE).manual_seed(SEED), device=DEVICE)
    batch = make_batch(cfg, 0, *LM_MESH_TRAIN, DEVICE)
    ref = lm_mesh_train(cfg, params, batch, None, LM_MESH_STEPS, "adam8bit")
    got = lm_mesh_train(cfg, params, batch, mesh, LM_MESH_STEPS, "adam8bit")
    del params
    same = (all(torch.equal(a[k], b[k]) for a, b in zip(got["rec"],
                                                        ref["rec"])
                for k in ("loss", "grad_norm"))
            and same_tree_bits(S.gather(got["params"]), ref["params"])
            and same_tree_bits(S.gather(got["state"]), ref["state"]))
    if not same:
        fail("lm_mesh (1, 1) adam8bit training: the DTensor route differs "
             "from no mesh")
    n_q = sum(p.endswith("/q") for p, _ in S.leaves_with_paths(ref["state"]))
    line = {"phase": "lm_mesh", "case": "nccl_1x1", "what": "train adam8bit",
            "arch": cfg.name, "layers": cfg.n_layers, "device": smi,
            "batch": LM_MESH_TRAIN[0], "seq": LM_MESH_TRAIN[1],
            "bitwise_equal_no_mesh": True,
            "state_leaves_compared": "q, s, v16, m, count",
            "quantized_leaves": n_q,
            "loss_by_step": [float(r["loss"]) for r in got["rec"]],
            "ms_by_step": [r["ms"] for r in got["rec"]],
            "no_mesh_ms_by_step": [r["ms"] for r in ref["rec"]],
            "launches_per_step": {k: n // LM_MESH_STEPS for k, n in
                                  got["launches"].items()},
            "peak_MiB": got["peak_MiB"], "no_mesh_peak_MiB": ref["peak_MiB"],
            "ms_is": "host clock around each synchronised step; the first "
                     "step includes its warm-up"}
    print(json.dumps(line), flush=True)
    launches = got["launches"]
    del got, ref
    torch.cuda.empty_cache()
    return launches


def lm_mesh_one_card_long(mesh, smi):
    """(1, 1): qwen2-1.5b at B 1 decoding into long_500k's cache (524,288
    positions, seeded) with ``distribute_cache(..., long_context=True)``
    against no mesh, bit for bit (every step's logits, the 8 tokens).  On
    one card "data" has size 1, so the batch divides over it and the
    layout is the plain one: this shows the path is wired, not the
    sequence split.  Returns the mesh run's launches."""
    from repro_torch.lm import model as LM
    from repro_torch.lm import sharding as S
    cfg = lm_mesh_cfg(LM_TRAIN_ARCH)
    params = LM.init_params(cfg, torch.Generator(
        device=DEVICE).manual_seed(SEED), device=DEVICE)
    t0 = time.perf_counter()
    cache = long_cache(cfg, DEVICE)
    fill_s = time.perf_counter() - t0
    cache_mib = sum(t.numel() * t.element_size()
                    for _, t in S.leaves_with_paths(cache)) / 2 ** 20
    dcache = S.distribute_cache(cache, mesh, long_context=True)
    dparams = S.distribute_params(params, mesh)
    got = lm_mesh_long_decode(cfg, dparams, dcache, mesh)
    _, counts, comm_ms = lm_mesh_comm(lambda: got["step"](
        dparams, dcache, got["first"], LM_MESH_LONG - 1))
    del dcache, dparams
    torch.cuda.empty_cache()
    ref = lm_mesh_long_decode(cfg, params, cache, None)
    del cache, params
    torch.cuda.empty_cache()
    if not (torch.equal(got["tokens"], ref["tokens"]) and all(
            torch.equal(a, b) for a, b in zip(got["logits"],
                                              ref["logits"]))):
        fail("lm_mesh (1, 1) long-context decode: the DTensor route differs "
             "from no mesh")
    line = {"phase": "lm_mesh", "case": "nccl_1x1", "what": "long decode",
            "arch": cfg.name, "layers": cfg.n_layers, "device": smi,
            "batch": 1, "cache_positions": LM_MESH_LONG,
            "cache_MiB": cache_mib, "fill_s": fill_s,
            "steps": LM_MESH_LONG_STEPS, "long_context": True,
            "data_axis": 1, "bitwise_equal_no_mesh": True,
            "decode_ms_per_step_median": statistics.median(got["ms"]),
            "no_mesh_decode_ms_per_step_median": statistics.median(ref["ms"]),
            "launches_per_step": {k: n // LM_MESH_LONG_STEPS for k, n in
                                  got["launches"].items()},
            "collectives_per_decode_step": counts, "collective_ms": comm_ms,
            "peak_MiB": got["peak_MiB"], "no_mesh_peak_MiB": ref["peak_MiB"],
            "ms_is": "host clock around each synchronised eager step"}
    print(json.dumps(line), flush=True)
    return got["launches"]


def lm_mesh_one_card(smi):
    """(1, 1): one process through an NCCL group, the DTensor route against
    no mesh, bit for bit: qwen2-1.5b's training step at full width (B 4 x
    2,048, ``remat="full"``, Adam; loss, grad_norm and every parameter
    after 2 steps) and gemma2-2b's prefill (B 4 x 6,144) and 31 greedy
    decode steps (the prefill logits, the 32 tokens, every step's logits),
    both eager; then every other architecture the lm_archs phase serves
    (:func:`lm_mesh_archs_one_card`).  The mesh runs are the phase's main
    path: every count is reset before each and read after."""
    import torch.distributed as dist
    from repro_torch.launch.train import make_batch
    from repro_torch.lm import make_lm_mesh
    from repro_torch.lm import model as LM
    from repro_torch.lm import sharding as S
    out = {"launches": {}}
    dist.init_process_group(
        "nccl", init_method=f"file://{LM_MESH_DIR / 'one.rendezvous'}",
        rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=LM_MESH_GROUP_S))
    try:
        mesh = make_lm_mesh(1, 1, device=DEVICE)
        # -- training
        cfg = lm_mesh_cfg(LM_TRAIN_ARCH)
        params = LM.init_params(cfg, torch.Generator(
            device=DEVICE).manual_seed(SEED), device=DEVICE)
        batch = make_batch(cfg, 0, LM_TRAIN_BATCH, LM_TRAIN_SEQ, DEVICE)
        ref = lm_mesh_train(cfg, params, batch, None, LM_MESH_STEPS)
        ref.pop("state")
        got = lm_mesh_train(cfg, params, batch, mesh, LM_MESH_STEPS)
        del params
        out["launches"]["train"] = got["launches"]
        same = (all(torch.equal(a[k], b[k]) for a, b in zip(got["rec"],
                                                            ref["rec"])
                    for k in ("loss", "grad_norm"))
                and same_tree_bits(S.gather(got["params"]), ref["params"]))
        if not same:
            fail("lm_mesh (1, 1) training: the DTensor route differs from "
                 "no mesh")
        _, counts, comm_ms = lm_mesh_comm(lambda: got["step"](
            got["params"], got["state"], got["batch"]))
        line = {"phase": "lm_mesh", "case": "nccl_1x1", "what": "train",
                "arch": cfg.name, "layers": cfg.n_layers, "device": smi,
                "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ,
                "bitwise_equal_no_mesh": True,
                "loss_by_step": [float(r["loss"]) for r in got["rec"]],
                "ms_by_step": [r["ms"] for r in got["rec"]],
                "no_mesh_ms_by_step": [r["ms"] for r in ref["rec"]],
                "tokens_per_s": LM_TRAIN_BATCH * LM_TRAIN_SEQ
                / got["rec"][-1]["ms"] * 1e3,
                "launches_per_step": {k: n // LM_MESH_STEPS for k, n in
                                      got["launches"].items()},
                "collectives_per_step": counts, "collective_ms": comm_ms,
                "peak_MiB": got["peak_MiB"],
                "no_mesh_peak_MiB": ref["peak_MiB"],
                "ms_is": "host clock around each synchronised step; the "
                         "first step includes its warm-up"}
        print(json.dumps(line), flush=True)
        out["train"] = line
        del got, ref
        torch.cuda.empty_cache()
        # -- serving
        cfg = lm_mesh_cfg(LM_ARCH)
        params = LM.init_params(cfg, torch.Generator(
            device=DEVICE).manual_seed(SEED), device=DEVICE)
        rng = np.random.default_rng(SEED + 7)
        tokens = torch.tensor(rng.integers(0, cfg.vocab,
                                           (LM_BATCH, LM_PROMPT)),
                              device=DEVICE)
        ref = lm_mesh_serve(cfg, params, tokens, LM_NEW, None)
        ref.pop("cache")
        dparams = S.distribute_params(params, mesh)
        del params
        got = lm_mesh_serve(cfg, dparams, tokens, LM_NEW, mesh)
        out["launches"]["serve"] = got["launches"]
        if not (torch.equal(got["tokens"], ref["tokens"]) and all(
                torch.equal(a, b) for a, b in zip(got["logits"],
                                                  ref["logits"]))):
            fail("lm_mesh (1, 1) serving: the DTensor route differs from "
                 "no mesh")
        nxt = got["tokens"][:, -1:]
        _, counts, comm_ms = lm_mesh_comm(lambda: got["step"](
            dparams, got["cache"], nxt, LM_PROMPT + LM_NEW - 1))
        line = {"phase": "lm_mesh", "case": "nccl_1x1", "what": "serve",
                "arch": cfg.name, "layers": cfg.n_layers, "device": smi,
                "batch": LM_BATCH, "prompt": LM_PROMPT, "new": LM_NEW,
                "bitwise_equal_no_mesh": True,
                "prefill_ms": got["prefill_ms"],
                "no_mesh_prefill_ms": ref["prefill_ms"],
                "decode_ms_per_step_median": statistics.median(
                    got["decode_ms"]),
                "no_mesh_decode_ms_per_step_median": statistics.median(
                    ref["decode_ms"]),
                "decode_tokens_per_s": LM_BATCH / statistics.median(
                    got["decode_ms"]) * 1e3,
                "launches": got["launches"],
                "collectives_per_decode_step": counts,
                "collective_ms": comm_ms, "peak_MiB": got["peak_MiB"],
                "no_mesh_peak_MiB": ref["peak_MiB"],
                "ms_is": "host clock around the synchronised prefill and "
                         "each eager decode step"}
        print(json.dumps(line), flush=True)
        out["serve"] = line
        del got, ref, dparams
        torch.cuda.empty_cache()
        out["launches"]["train_adam8bit"] = lm_mesh_one_card_adam8bit(mesh,
                                                                      smi)
        out["launches"]["long_context_decode"] = lm_mesh_one_card_long(mesh,
                                                                       smi)
        archs, out["mla"] = lm_mesh_archs_one_card(mesh, smi)
        out["launches"].update(archs)
    finally:
        dist.destroy_process_group()
    return out


# the other architectures at (1, 1), bit for bit against no mesh, at their
# published widths and the lm_archs phase's depths, batches and prompts
# (LM_ARCHS): a prefill and LM_MESH_DECODE greedy decode steps each, and two
# training steps (B x S LM_MESH_TRAIN) at the deepest cut of that depth
# whose training state fits LM_MESH_TRAIN_SHARE of the card's memory, at
# LM_MESH_TRAIN_BYTES a parameter: the bf16 weights and gradient, Adam's
# fp32 m and v twice (the update builds the new ones beside the old) and
# its fp32 temporaries of a stacked leaf (rwkv6-3b at its 32 layers, 3.1 G
# parameters, ran out of the card's 80 GB in Adam's update; at 24 layers,
# 0.7 of the card, it peaked at 71 GB alone and ran out after the other
# phases, whose freed blocks leave ~10 GB reserved)
LM_MESH_DECODE = 32
LM_MESH_TRAIN = (2, 1_024)
LM_MESH_TRAIN_SHARE = 0.6
LM_MESH_TRAIN_BYTES = 24
LM_MESH_MP = 4            # the MLA instance's local heads: 128 / this


def distribute_in_place(params, mesh):
    """``params`` laid out over ``mesh`` leaf by leaf, each whole leaf
    dropped as soon as its block is cut: one copy of the weights at a time
    (``sharding.distribute`` clones the block)."""
    from repro_torch.lm import sharding as S
    specs = dict(S.leaves_with_paths(S.params_shardings(params, mesh)))

    def walk(tree, prefix):
        for k in (sorted(tree) if isinstance(tree, dict) else
                  range(len(tree))):
            if isinstance(tree[k], (dict, list)):
                walk(tree[k], f"{prefix}{k}/")
            else:
                whole, tree[k] = tree[k], None
                tree[k] = S.distribute(whole, specs[f"{prefix}{k}"], mesh)
                del whole

    walk(params, "")
    return params


def lm_mesh_arch_train(cfg, mesh, smi, **about):
    """Two training steps of ``cfg`` with no mesh, then over the (1, 1)
    ``mesh`` from the same seed: loss, grad_norm and every parameter bit
    for bit.  The reference's final parameters wait on the host; the mesh
    run builds its optimizer state on the distributed weights.  ``about``
    goes into the printed line."""
    from repro_torch import kernels
    from repro_torch.launch.train import make_batch
    from repro_torch.lm import model as LM
    from repro_torch.lm import sharding as S
    from repro_torch.lm import train_lib as TL
    gen = lambda: torch.Generator(device=DEVICE).manual_seed(SEED)
    torch.cuda.empty_cache()
    batch = make_batch(cfg, 0, *LM_MESH_TRAIN, DEVICE)
    ref = lm_mesh_train(cfg, LM.init_params(cfg, gen(), device=DEVICE),
                        batch, None, LM_MESH_STEPS)
    want = {p: t.cpu() for p, t in S.leaves_with_paths(ref.pop("params"))}
    ref.pop("state")
    torch.cuda.empty_cache()
    dparams = distribute_in_place(LM.init_params(cfg, gen(), device=DEVICE),
                                  mesh)
    dt = S.dt_api()
    step, opt = TL.make_train_step(cfg, TL.TrainHParams(), mesh=mesh)
    state = opt.init(dparams)
    state["count"] = S.from_local(state["count"], mesh,
                                  (dt.Replicate(), dt.Replicate()))
    b = S.distribute_batch(batch, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    rec = []
    for _ in range(LM_MESH_STEPS):
        t0 = time.perf_counter()
        dparams, state, m = step(dparams, state, b)
        torch.cuda.synchronize()
        rec.append({"ms": (time.perf_counter() - t0) * 1e3,
                    "loss": S.gather(m["loss"]),
                    "grad_norm": S.gather(m["grad_norm"])})
    launches = launches_now()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    same = all(torch.equal(a[k], r[k]) for a, r in zip(rec, ref["rec"])
               for k in ("loss", "grad_norm")) and all(
        torch.equal(t.to_local().cpu(), want[p])
        for p, t in S.leaves_with_paths(dparams))
    if not same:
        fail(f"lm_mesh (1, 1) {cfg.name} training: the DTensor route "
             "differs from no mesh")
    line = {"phase": "lm_mesh", "case": "nccl_1x1", "what": "train",
            "arch": cfg.name, "layers": cfg.n_layers, "device": smi,
            "batch": LM_MESH_TRAIN[0], "seq": LM_MESH_TRAIN[1],
            "bitwise_equal_no_mesh": True,
            "loss_by_step": [float(r["loss"]) for r in rec],
            "ms_by_step": [r["ms"] for r in rec],
            "no_mesh_ms_by_step": [r["ms"] for r in ref["rec"]],
            "launches_per_step": {k: n // LM_MESH_STEPS
                                  for k, n in launches.items()},
            "peak_MiB": peak, "no_mesh_peak_MiB": ref["peak_MiB"],
            "ms_is": "host clock around each synchronised step; the first "
                     "step includes its warm-up", **about}
    print(json.dumps(line), flush=True)
    del dparams, state, b, want, ref
    torch.cuda.empty_cache()
    return line, launches


def lm_mesh_arch_serve(cfg, batch, prompt, mesh, smi):
    """A prefill and ``LM_MESH_DECODE`` greedy decode steps of ``cfg``
    with no mesh, then over the (1, 1) ``mesh`` on the same weights
    (distributed in place after the reference: one copy): the prefill
    logits, the tokens and every step's logits bit for bit.  Returns the
    line, the mesh run's launches and, for MLA, its first (192, 128)
    attention call's arguments."""
    from repro_torch.launch.serve import context_stub
    from repro_torch.lm import model as LM
    params = LM.init_params(cfg, torch.Generator(
        device=DEVICE).manual_seed(SEED), device=DEVICE)
    rng = np.random.default_rng(SEED + 13)
    tokens = torch.tensor(rng.integers(0, cfg.vocab, (batch, prompt)),
                          device=DEVICE)
    ctx = context_stub(cfg, batch, rng, DEVICE)
    new = LM_MESH_DECODE + 1
    ref = lm_mesh_serve(cfg, params, tokens, new, None, context=ctx)
    ref.pop("cache")
    torch.cuda.empty_cache()
    params = distribute_in_place(params, mesh)
    got, mla = record_first_mla_call(lambda: lm_mesh_serve(
        cfg, params, tokens, new, mesh, context=ctx))
    # the recorder took the wrapper's count while it ran: read it after
    got["launches"] = launches_now()
    if not (torch.equal(got["tokens"], ref["tokens"]) and all(
            torch.equal(a, b) for a, b in zip(got["logits"],
                                              ref["logits"]))):
        fail(f"lm_mesh (1, 1) {cfg.name} serving: the DTensor route "
             "differs from no mesh")
    if not all(bool(torch.isfinite(lg).all()) for lg in got["logits"]):
        fail(f"lm_mesh (1, 1) {cfg.name} serving: non-finite logits")
    line = {"phase": "lm_mesh", "case": "nccl_1x1", "what": "serve",
            "arch": cfg.name, "layers": cfg.n_layers, "device": smi,
            "batch": batch, "prompt": prompt, "decode_steps": new - 1,
            "context": None if ctx is None else list(ctx.shape),
            "bitwise_equal_no_mesh": True,
            "prefill_ms": got["prefill_ms"],
            "no_mesh_prefill_ms": ref["prefill_ms"],
            "decode_ms_per_step_median": statistics.median(
                got["decode_ms"]),
            "no_mesh_decode_ms_per_step_median": statistics.median(
                ref["decode_ms"]),
            "launches": got["launches"], "peak_MiB": got["peak_MiB"],
            "no_mesh_peak_MiB": ref["peak_MiB"],
            "ms_is": "host clock around the synchronised prefill and each "
                     "eager decode step"}
    print(json.dumps(line), flush=True)
    del got, ref, params
    torch.cuda.empty_cache()
    return line, line["launches"], mla


def lm_mesh_archs_one_card(mesh, smi):
    """deepseek-v3 (4 layers, MTP), jamba (2 layers), rwkv6-3b and
    whisper-medium over the (1, 1) ``mesh`` against no mesh, bit for bit:
    serving each, training where it fits (a line for each left out, with
    its bytes); then the MLA instance at the local heads of a ``(1,
    LM_MESH_MP)`` mesh (128 / 4 heads: the first prefill call's q, k, v
    cut to heads 0-31) against its plain version, timed beside its bound
    and SDPA.  Returns the launches by run and the MLA line."""
    from repro_torch.lm import model as LM
    from repro_torch.lm import sharding as S
    launches, mla, total = {}, None, torch.cuda.get_device_properties(
        0).total_memory
    for name, layers, batch, prompt, _ in LM_ARCHS:
        cfg = lm_mesh_cfg(name, layers)
        _, got, args = lm_mesh_arch_serve(cfg, batch, prompt, mesh, smi)
        launches[f"serve {name}"] = got
        if args is not None and mla is None:
            q, k, v, *rest = args
            h = slice(0, q.shape[1] // LM_MESH_MP)
            mla = check_mla_instance(
                (q[:, h], k[:, h], v[:, h], *rest), phase="lm_mesh",
                case=f"MLA (192, 128) instance at the local heads of a (1, "
                     f"{LM_MESH_MP}) mesh: deepseek-v3 prefill, layer 0, "
                     f"heads 0-{h.stop - 1}")
            del q, k, v, args
            torch.cuda.empty_cache()
        need = {}
        for depth in range(cfg.n_layers, 0, -1):
            n = sum(t.numel() for _, t in S.leaves_with_paths(
                LM.init_params(dataclasses.replace(cfg, n_layers=depth),
                               torch.Generator(), device="meta")))
            need[depth] = LM_MESH_TRAIN_BYTES * n
            if need[depth] <= LM_MESH_TRAIN_SHARE * total:
                break
        reckoned = {"bytes_by_depth": need, "card_bytes": total,
                    "bytes_per_parameter": LM_MESH_TRAIN_BYTES,
                    "share": LM_MESH_TRAIN_SHARE}
        if need[depth] > LM_MESH_TRAIN_SHARE * total:
            print(json.dumps({
                "phase": "lm_mesh", "case": "nccl_1x1", "what": "train",
                "arch": name, "ran": False, **reckoned,
                "why": "no depth's training state fits the card (the "
                       "embeddings, and MTP's layer, alone exceed it)"}),
                flush=True)
            continue
        _, launches[f"train {name}"] = lm_mesh_arch_train(
            dataclasses.replace(cfg, n_layers=depth), mesh, smi,
            depth_cut=f"{depth} of {cfg.n_layers} layers", **reckoned)
    if mla is None:
        fail("lm_mesh: no MLA call with (D, DV) = (192, 128)")
    return launches, mla


def lm_mesh_probe(mesh, say):
    """The collectives DTensor issues here, once each on a small tensor on
    the mesh's device over its "model" axis, each named (``say``) before
    it runs: a child that dies in one names it last."""
    from repro_torch.lm import sharding as S
    dt = S.dt_api()
    x = torch.ones((4, 4), device=mesh.device)
    cases = (("all_reduce (sum)", (dt.Partial(),), (dt.Replicate(),)),
             ("all_reduce (max)", (dt.Partial("max"),), (dt.Replicate(),)),
             ("all_gather_into_tensor", (dt.Shard(0),), (dt.Replicate(),)),
             ("reduce_scatter_tensor", (dt.Partial(),), (dt.Shard(0),)))
    for name, src, dst in cases:
        say(name)
        S.from_local(x, mesh, (dt.Replicate(),) + src).redistribute(
            mesh.device_mesh, (dt.Replicate(),) + dst).to_local()
        torch.cuda.synchronize()


def lm_mesh_child(task_path, rank):
    """One process of an ``lm_mesh`` group (``chip_smoke.py
    --lm-mesh-child TASK RANK``): joins the group through ``file://``
    rendezvous, builds the task's ``LMMesh`` on its card and runs the
    task's jobs; saves each job's results beside ``TASK``."""
    import torch.distributed as dist
    from repro_torch.launch.train import make_batch
    from repro_torch.lm import layers as LL
    from repro_torch.lm import make_lm_mesh
    from repro_torch.lm import model as LM
    from repro_torch.lm import sharding as S
    task = torch.load(task_path, weights_only=False)
    dev = torch.device(DEVICE, task["devices"][rank]) if DEVICE == "cuda" \
        else torch.device(DEVICE)
    torch.cuda.set_device(dev)

    def say(what):
        print(f"[probe] {what}", flush=True)

    say("init_process_group")
    dist.init_process_group(
        task["backend"], init_method=f"file://{task['rendezvous']}",
        rank=rank, world_size=task["world"],
        timeout=datetime.timedelta(seconds=LM_MESH_GROUP_S))
    try:
        out = {}
        for job in task["jobs"]:
            say("make_lm_mesh")
            mesh = make_lm_mesh(*job["layout"], device=dev,
                                backend=task["backend"])
            res = {"coords": mesh.coords, "layout": job["layout"]}
            if task.get("probe"):
                lm_mesh_probe(mesh, say)
                out[job["name"]] = res
                continue
            cfg = lm_mesh_cfg(job["arch"], job.get("layers"))
            params = LM.init_params(cfg, torch.Generator(
                device=dev).manual_seed(SEED), device=dev)
            if job["kind"] == "train":
                batch = make_batch(cfg, 0, *job.get(
                    "batch_seq", (LM_TRAIN_BATCH, LM_TRAIN_SEQ)), dev)
                got = lm_mesh_train(cfg, params, batch, mesh, LM_MESH_STEPS,
                                    job.get("optimizer", "adam"))
                _, counts, ms = lm_mesh_comm(lambda: got["step"](
                    got["params"], got["state"], got["batch"]))
                res.update(loss=[float(r["loss"]) for r in got["rec"]],
                           grad_norm=[float(r["grad_norm"])
                                      for r in got["rec"]],
                           ms=[r["ms"] for r in got["rec"]],
                           launches=got["launches"], peak_MiB=got["peak_MiB"],
                           collectives_per_step=counts, collective_ms=ms)
            elif job["kind"] == "long":
                res.update(lm_mesh_child_long(cfg, params, mesh, job, dev))
                del params
            else:
                ref = torch.load(job["ref"], weights_only=False)
                tokens = ref["prompt"].to(dev)
                S.set_expert_2d(job.get("expert_2d", False))
                dparams = S.distribute_params(params, mesh)
                del params
                LL.set_flash_decode(job.get("flash", False))
                LL.set_gqa_repeat(job.get("repeat", False))
                try:
                    got, calls = record_routing(lambda: lm_mesh_serve(
                        cfg, dparams, tokens, LM_NEW, mesh,
                        forced=ref["tokens"][:, :-1].to(dev)))
                    nxt = ref["tokens"][:, -1:].to(dev)
                    _, counts, ms = lm_mesh_comm(lambda: got["step"](
                        dparams, got["cache"], nxt,
                        tokens.shape[1] + LM_NEW - 1))
                finally:
                    LL.set_flash_decode(False)
                    LL.set_gqa_repeat(False)
                    S.set_expert_2d(False)
                flips, noise = serve_flips(
                    cfg, ref["routing"], [(sc.cpu(), top.cpu())
                                          for sc, top in calls],
                    tokens.shape[1])
                bad = [f for f in flips if f["margin"] > 2 * noise]
                if bad:
                    fail(f"lm_mesh {job['name']}: routing flips beyond the "
                         f"score noise {noise:.3g}: {bad}")
                if noise > LM_MESH_SCORE_NOISE_MAX:
                    fail(f"lm_mesh {job['name']}: router score noise "
                         f"{noise:.3g} > {LM_MESH_SCORE_NOISE_MAX:.3g}")
                n_pos = len(ref["logits"]) * ref["logits"][0].shape[0]
                flipped = {(f["row"], f["step"]) for f in flips}
                if len(flipped) > LM_MESH_FLIP_SHARE * n_pos:
                    fail(f"lm_mesh {job['name']}: {len(flipped)} of {n_pos} "
                         f"positions chose other experts (at most "
                         f"{LM_MESH_FLIP_SHARE:.0%})")
                errs = []
                for i, (a, b) in enumerate(zip(got["logits"],
                                               ref["logits"])):
                    b = b.to(dev).float()
                    keep = [r for r in range(b.shape[0])
                            if (r, i) not in {(f["row"], f["step"])
                                              for f in flips}]
                    errs.append(check(f"lm_mesh {job['name']} logits {i}",
                                      a.float()[keep], b[keep],
                                      atol=LM_BF16_TOL * float(
                                          b.abs().max())) if keep else None)
                res.update(max_abs_err_by_step=errs, routing_flips=flips,
                           routing_score_noise=noise,
                           greedy_agree=float((got["tokens"].cpu()
                                               == ref["tokens"]).float()
                                              .mean()),
                           prefill_ms=got["prefill_ms"],
                           decode_ms=got["decode_ms"],
                           launches=got["launches"], peak_MiB=got["peak_MiB"],
                           collectives_per_decode_step=counts,
                           collective_ms=ms)
                del got, dparams
            out[job["name"]] = res
            torch.cuda.empty_cache()
        torch.save(out, f"{task_path}.out{rank}")
    finally:
        dist.destroy_process_group()
    return 0


def lm_mesh_child_long(cfg, params, mesh, job, dev):
    """A child's long-context job: the seeded long_500k cache laid out by
    ``distribute_cache(..., long_context=True)`` (the sequence over
    "data": the batch of 1 does not divide there), the decode steps fed
    the no-mesh tokens, each step's logits against the no-mesh ones, and
    the collectives of one step beside those of the same step over the
    plain layout (the sequence whole on every process of "data"): no
    cache all-gather, the merge's all-reduces."""
    from repro_torch.lm import serve_lib as SL
    from repro_torch.lm import sharding as S
    ref = torch.load(job["ref"], weights_only=False)
    dparams = S.distribute_params(params, mesh)
    cache = long_cache(cfg, dev)
    dcache = S.distribute_cache(cache, mesh, long_context=True)
    del cache
    torch.cuda.empty_cache()
    placements = {p: [str(x) for x in t.placements]
                  for p, t in S.leaves_with_paths(dcache)
                  if p.split("/")[-1] == "k"}
    got = lm_mesh_long_decode(cfg, dparams, dcache, mesh,
                              forced=ref["tokens"].to(dev))
    nxt, pos = ref["tokens"][:, -1:].to(dev), LM_MESH_LONG - 1
    _, counts, ms = lm_mesh_comm(lambda: got["step"](dparams, dcache, nxt,
                                                     pos))
    local_mib = sum(t.to_local().numel() * t.to_local().element_size()
                    for _, t in S.leaves_with_paths(dcache)) / 2 ** 20
    del dcache
    torch.cuda.empty_cache()
    plain = SL.init_cache_mesh(cfg, 1, LM_MESH_LONG, mesh)
    _, plain_counts, _ = lm_mesh_comm(lambda: got["step"](dparams, plain,
                                                          nxt, pos))
    del plain
    errs = [check(f"lm_mesh {job['name']} logits {i}", a.float(),
                  b.to(dev).float(), atol=LM_BF16_TOL * float(
                      b.float().abs().max()))
            for i, (a, b) in enumerate(zip(got["logits"], ref["logits"]))]
    return {"tokens": got["tokens"].cpu(), "max_abs_err_by_step": errs,
            "decode_ms": got["ms"], "launches": got["launches"],
            "peak_MiB": got["peak_MiB"], "cache_block_MiB": local_mib,
            "k_placements": placements,
            "collectives_per_decode_step": counts,
            "plain_layout_collectives": plain_counts, "collective_ms": ms}


def lm_mesh_spawn(case, world, backend, devices, jobs, probe=False):
    """Start ``world`` child processes of this script on ``devices`` and
    wait for all; any child's failure, or a group still running after
    ``LM_MESH_CHILD_S`` seconds, kills every child and fails the phase.
    With ``probe`` the children only build each job's mesh and run each
    collective once (:func:`lm_mesh_probe`); a child that fails or dies
    there does not fail the phase: the step it named last (and how it
    ended) is returned, or None when all passed."""
    task = LM_MESH_DIR / f"{case}{'_probe' if probe else ''}.pt"
    torch.save({"world": world, "backend": backend, "devices": devices,
                "jobs": jobs, "probe": probe,
                "rendezvous": str(LM_MESH_DIR / f"{task.stem}.rendezvous")},
               task)
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               "--lm-mesh-child", str(task), str(r)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    deadline = time.perf_counter() + LM_MESH_CHILD_S
    logs = {}
    try:
        for r, p in enumerate(procs):
            logs[r] = p.communicate(
                timeout=max(deadline - time.perf_counter(), 1.0))[0]
    except subprocess.TimeoutExpired:
        fail(f"lm_mesh {case}: the {world} processes did not finish in "
             f"{LM_MESH_CHILD_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            if probe:
                steps = [ln[8:] for ln in logs[r].splitlines()
                         if ln.startswith("[probe] ")]
                last = steps[-1] if steps else "before the first step"
                err = [ln for ln in logs[r].splitlines()
                       if "Error" in ln or "error" in ln][-1:]
                return (f"process {r} exited {p.returncode} in {last}"
                        + (f" ({err[0].strip()[:200]})" if err else ""))
            fail(f"lm_mesh {case}: process {r} exited {p.returncode}:\n"
                 f"{logs[r][-6000:]}")
    if probe:
        return None
    return [torch.load(f"{task}.out{r}", weights_only=False)
            for r in range(world)]


def serve_flips(cfg, ref_calls, got_calls, prompt):
    """The (row, step) positions of two requests fed the same tokens (the
    reference's and a mesh run's, their MoE calls recorded in order: the
    prefill's, then each decode step's) where some MoE layer chose other
    experts for the token whose logits the step gives; the score noise
    (max |score difference| over those tokens); for each flip the
    reference's margin (its least score among the experts only it chose
    against the largest among those only the mesh run chose), which a
    flip between experts whose scores lie within the noise keeps <= 2 x
    noise.  The logits gate leaves the flipped positions out."""
    n_moe = sum(spec.mlp == "moe" for spec in cfg.layer_specs())
    if not n_moe:
        return [], 0.0
    flips, noise = [], 0.0
    b = ref_calls[-1][0].shape[0]               # a decode call: B tokens
    for c, ((r_sc, r_top), (g_sc, g_top)) in enumerate(zip(ref_calls,
                                                           got_calls)):
        step = 0 if c < n_moe else (c - n_moe) // n_moe + 1
        for row in range(b):
            t = row * prompt + prompt - 1 if step == 0 else row
            noise = max(noise, float((r_sc[t] - g_sc[t]).abs().max()))
            rs, gs = set(r_top[t].tolist()), set(g_top[t].tolist())
            if rs != gs:
                flips.append({"row": row, "step": step,
                              "layer": c % n_moe,
                              "margin": float(r_sc[t, sorted(rs - gs)].min()
                                              - r_sc[t, sorted(gs - rs)]
                                              .max())})
    return flips, noise


def lm_mesh_ref_key(job):
    return (job["kind"], job["arch"], job.get("layers"), job.get("batch"),
            job.get("optimizer"), job.get("batch_seq"))


def lm_mesh_refs(jobs):
    """The no-mesh references of the children's jobs on this card, at the
    jobs' depths: a training job's loss and grad_norm by step, a serving
    job's prompt, greedy tokens and logits (saved for the children)."""
    from repro_torch.launch.train import make_batch
    from repro_torch.lm import model as LM
    refs = {}
    for job in jobs:
        key = lm_mesh_ref_key(job)
        if key in refs:
            job["ref"] = refs[key].get("path")
            continue
        cfg = lm_mesh_cfg(job["arch"], job.get("layers"))
        params = LM.init_params(cfg, torch.Generator(
            device=DEVICE).manual_seed(SEED), device=DEVICE)
        if job["kind"] == "long":
            cache = long_cache(cfg, DEVICE)
            got = lm_mesh_long_decode(cfg, params, cache, None)
            del cache
            path = LM_MESH_DIR / f"ref_long_{job['arch']}.pt"
            torch.save({"tokens": got["tokens"].cpu(),
                        "logits": [lg.cpu() for lg in got["logits"]],
                        "ms": got["ms"], "peak_MiB": got["peak_MiB"]}, path)
            refs[key] = {"path": str(path), "ms": got["ms"],
                         "peak_MiB": got["peak_MiB"]}
            job["ref"] = str(path)
        elif job["kind"] == "train":
            batch = make_batch(cfg, 0, *job.get(
                "batch_seq", (LM_TRAIN_BATCH, LM_TRAIN_SEQ)), DEVICE)
            got = lm_mesh_train(cfg, params, batch, None, LM_MESH_STEPS,
                                job.get("optimizer", "adam"))
            refs[key] = {"loss": [float(r["loss"]) for r in got["rec"]],
                         "grad_norm": [float(r["grad_norm"])
                                       for r in got["rec"]]}
        else:
            b, s = job["batch"], job["prompt"]
            rng = np.random.default_rng(SEED + 7)
            tokens = torch.tensor(rng.integers(0, cfg.vocab, (b, s)),
                                  device=DEVICE)
            got, calls = record_routing(lambda: lm_mesh_serve(
                cfg, params, tokens, LM_NEW, None))
            path = LM_MESH_DIR / (f"ref_{job['arch']}_{job.get('layers')}"
                                  f"_{b}.pt")
            torch.save({"prompt": tokens.cpu(),
                        "tokens": got["tokens"].cpu(),
                        "logits": [lg.cpu() for lg in got["logits"]],
                        "routing": [(sc.cpu(), top.cpu())
                                    for sc, top in calls]}, path)
            refs[key] = {"path": str(path)}
            job["ref"] = str(path)
        del got, params
        torch.cuda.empty_cache()
    return refs


def lm_mesh_report(case, jobs, outs, refs, smi, backend):
    """One line per job: every process's numbers, the processes' agreement
    and the gates against no mesh (training: loss and grad_norm at the
    bf16 gate of ``lm_train``; serving: each step's logits at the bf16
    gate, fed the reference's greedy tokens)."""
    for job in jobs:
        res = [o[job["name"]] for o in outs]
        line = {"phase": "lm_mesh", "case": case, "job": job["name"],
                "backend": backend, "layout": job["layout"],
                "arch": job["arch"], "layers": job.get("layers") or "all",
                "device": smi}
        if job["kind"] == "long":
            ref = torch.load(job["ref"], weights_only=False)
            n_attn = lm_mesh_cfg(job["arch"], job.get("layers")).n_layers
            for r in res:
                for i, (a, b) in enumerate(zip(r["tokens"][0].tolist(),
                                               ref["tokens"][0].tolist())):
                    top = ref["logits"][i][0, -1].float().topk(2).values
                    margin = float(top[0] - top[1])
                    if a != b and margin > 2 * r["max_abs_err_by_step"][i]:
                        fail(f"lm_mesh {case} {job['name']}: token {i} "
                             f"{a} vs no mesh {b} (margin {margin:.3g})")
                got, plain = (r["collectives_per_decode_step"],
                              r["plain_layout_collectives"])
                if got.get("allgather", 0) != plain.get("allgather", 0):
                    fail(f"lm_mesh {case} {job['name']}: {got} all-gathers "
                         f"against the plain layout's {plain}: a cache "
                         "gathered")
                if got.get("allreduce", 0) != plain.get("allreduce", 0) \
                        + 3 * n_attn:
                    fail(f"lm_mesh {case} {job['name']}: {got} all-reduces "
                         f"against the plain layout's {plain} + 3 a layer")
            line.update(
                batch=1, cache_positions=LM_MESH_LONG,
                steps=LM_MESH_LONG_STEPS, long_context=True,
                k_placements=res[0]["k_placements"],
                tokens_equal_no_mesh=all(torch.equal(r["tokens"],
                                                     ref["tokens"])
                                         for r in res),
                max_abs_err=max(e for r in res
                                for e in r["max_abs_err_by_step"]),
                gate=f"atol {LM_BF16_TOL}*max|no-mesh logits| per step, fed "
                     "the no-mesh greedy tokens; a token may differ only "
                     "where the no-mesh top-2 margin is within 2 x the "
                     "step's error",
                decode_ms_per_step_median_by_process=[
                    statistics.median(r["decode_ms"]) for r in res],
                no_mesh_decode_ms_per_step_median=statistics.median(
                    ref["ms"]),
                peak_MiB_by_process=[r["peak_MiB"] for r in res],
                no_mesh_peak_MiB=ref["peak_MiB"],
                cache_block_MiB_by_process=[r["cache_block_MiB"]
                                            for r in res],
                collectives_per_decode_step=res[0][
                    "collectives_per_decode_step"],
                plain_layout_collectives=res[0]["plain_layout_collectives"],
                collective_ms_by_process=[r["collective_ms"] for r in res],
                launches_by_process=[r["launches"] for r in res])
        elif job["kind"] == "train":
            ref = refs[lm_mesh_ref_key(job)]
            rtol = LM_TRAIN_TOL[torch.bfloat16][1]
            for r in res:
                if r["loss"] != res[0]["loss"] or \
                        r["grad_norm"] != res[0]["grad_norm"]:
                    fail(f"lm_mesh {case} {job['name']}: the processes' "
                         "metrics differ")
                for k in ("loss", "grad_norm"):
                    for a, b in zip(r[k], ref[k]):
                        if not abs(a - b) <= rtol * abs(b):
                            fail(f"lm_mesh {case} {job['name']}: {k} {a} "
                                 f"vs no mesh {b} (rtol {rtol})")
            line.update(loss=res[0]["loss"], no_mesh_loss=ref["loss"],
                        grad_norm=res[0]["grad_norm"],
                        no_mesh_grad_norm=ref["grad_norm"],
                        optimizer=job.get("optimizer", "adam"),
                        batch_seq=job.get("batch_seq", (LM_TRAIN_BATCH,
                                                        LM_TRAIN_SEQ)),
                        ms_by_step_by_process=[r["ms"] for r in res],
                        tokens_per_s=math.prod(job.get(
                            "batch_seq", (LM_TRAIN_BATCH, LM_TRAIN_SEQ)))
                        / max(r["ms"][-1] for r in res) * 1e3,
                        peak_MiB_by_process=[r["peak_MiB"] for r in res],
                        collectives_per_step=res[0]["collectives_per_step"],
                        collective_ms_by_process=[r["collective_ms"]
                                                  for r in res],
                        launches_by_process=[r["launches"] for r in res],
                        gate=f"rtol {rtol} (bf16)")
        else:
            line.update(
                knobs={"FLASH_DECODE": job.get("flash", False),
                       "GQA_REPEAT": job.get("repeat", False),
                       "EXPERT_2D": job.get("expert_2d", False)},
                batch=job["batch"], prompt=job["prompt"], new=LM_NEW,
                max_abs_err=max(e for r in res
                                for e in r["max_abs_err_by_step"]
                                if e is not None),
                routing_flips=res[0]["routing_flips"],
                routing_score_noise=max(r["routing_score_noise"]
                                        for r in res),
                gate=f"atol {LM_BF16_TOL}*max|no-mesh logits| per step, "
                     "fed the no-mesh greedy tokens",
                greedy_agree_by_process=[r["greedy_agree"] for r in res],
                prefill_ms_by_process=[r["prefill_ms"] for r in res],
                decode_ms_per_step_median_by_process=[
                    statistics.median(r["decode_ms"]) for r in res],
                decode_tokens_per_s=job["batch"] / max(
                    statistics.median(r["decode_ms"]) for r in res) * 1e3,
                peak_MiB_by_process=[r["peak_MiB"] for r in res],
                collectives_per_decode_step=res[0][
                    "collectives_per_decode_step"],
                collective_ms_by_process=[r["collective_ms"] for r in res],
                launches_by_process=[r["launches"] for r in res])
        print(json.dumps(line), flush=True)


def lm_mesh_rows(res):
    """The kernels line's ``lm_mesh`` keys by wrapper: the main path's
    launches (the (1, 1) mesh's training steps and requests, by run); for
    ``flash_attention``, the MLA instance at a (1, 4) mesh's local heads;
    for ``flash_decode``, its slice instance's numbers (bf16 at
    qwen2-1.5b's widths, softcap 0, where SDPA computes the function;
    every case beside)."""
    rows = {name: {"launches_lm_mesh": {
        what: counts.get(name, 0) for what, counts in res["launches"].items()}}
        for name in ("flash_attention", "flash_decode")}
    main = next(r for r in res["slices"] if r["dtype"] == "bf16"
                and r["softcap"] == 0.0)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    mla = res["mla"]
    rows["flash_attention"]["lm_mesh_mla_local_heads"] = {
        "shape": f"q/k {mla['q']}, v {mla['v']}, bf16, causal (deepseek-v3 "
                 "prefill, layer 0, the heads of one process of a (1, 4) "
                 "mesh)",
        "max_abs_err": mla["bf16_max_err"],
        "fp32_max_abs_err": mla["fp32_max_err"],
        "ms": mla["bf16_kernel_ms"], "fp32_ms": mla["fp32_kernel_ms"],
        "plain_ms": mla["bf16_plain_ms"],
        "fp32_plain_ms": mla["fp32_plain_ms"],
        "bound_ms": mla["bf16_bound_ms"], "bound_by": mla["bf16_bound_by"],
        "fp32_bound_ms": mla["fp32_bound_ms"],
        "library_ms": mla["library_ms"],
        "fp32_library_ms": mla["fp32_library_ms"]}
    rows["flash_decode"]["lm_mesh_slice_instance"] = {
        "shape": f"{main['case']}: q {main['q']}, k/v slice "
                 f"{main['k_slice']} (1 of 4), pos {main['pos']}, bf16",
        **{k: main[k] for k in keys},
        "by_case": [{k: r[k] for k in ("case", "dtype", "empty_slices")
                     + keys} for r in res["slices"]]}
    rows["flash_decode"]["lm_mesh_long_slices"] = [
        {k: r[k] for k in ("case", "dtype", "q", "k_slice", "pos") + keys}
        for r in res["long_slices"]]
    return rows


def phase_lm_mesh(smi):
    """The LM over a ``("data", "model")`` process mesh (``lm.make_lm_mesh``,
    DTensor placements from ``lm/sharding.py``): (a) the decode kernel's
    slice instance (``kv_base``, LSE) against its plain version, also at
    the long-context slices (131,072 and 262,144 keys); (b) a ``(1, 1)``
    NCCL mesh, bit for bit against no mesh, the phase's main path
    (qwen2-1.5b training with Adam and with ``adam8bit``, its long-context
    decode at B 1 over long_500k's 524,288 positions, gemma2-2b serving;
    deepseek-v3, jamba, rwkv6-3b and whisper-medium serving, rwkv6 and
    whisper training; published widths), with the MLA instance at a (1, 4)
    mesh's local heads; (c)
    two gloo processes sharing this card as ``(1, 2)`` (every collective
    DTensor issues through gloo on CUDA tensors), 4 layers of each at full
    width, against no mesh at the same depth; (d) with 4 cards, NCCL one
    card a process: ``(2, 2)`` training and serving at full depth, and
    ``(1, 4)`` qwen2-1.5b decode (Hkv 2 < 4: the cache sharded by its
    sequence) with FLASH_DECODE off and on and with GQA_REPEAT, and
    deepseek-v3 (4 layers) serving at ``(2, 2)`` with EXPERT_2D off and on,
    at ``(1, 4)`` (MLA's absorbed decode over a latent cache sharded by
    its sequence) and at ``(2, 2)`` with a batch of 1 (replicated over
    "data"), qwen2-1.5b's ``adam8bit`` training at ``(2, 2)`` and its
    long-context decode at ``(2, 2)`` and ``(4, 1)`` (the cache's sequence
    over "data"), else a line saying why not.  Returns the main path's
    launches, the slice rows and the MLA line."""
    import shutil
    t_phase = time.perf_counter()
    shutil.rmtree(LM_MESH_DIR, ignore_errors=True)
    LM_MESH_DIR.mkdir(parents=True)
    slices = check_decode_slices(smi)
    long_slices = check_decode_slices(smi, LM_MESH_LONG_SLICES)
    one = lm_mesh_one_card(smi)
    launches = {}
    for part in one["launches"].values():
        for k, n in part.items():
            launches[k] = launches.get(k, 0) + n
    for name in ("flash_attention", "flash_decode"):
        if not launches.get(name):
            fail(f"lm_mesh: the main path launched no {name}")
    card = torch.cuda.current_device()
    gl = LM_MESH_GLOO_LAYERS
    jobs = [{"name": "train", "kind": "train", "arch": LM_TRAIN_ARCH,
             "layers": gl, "layout": (1, 2)},
            {"name": "serve", "kind": "serve", "arch": LM_ARCH, "layers": gl,
             "layout": (1, 2), "batch": LM_BATCH, "prompt": LM_PROMPT}]
    refused = lm_mesh_spawn("gloo_1x2", 2, "gloo", [card, card], jobs[:1],
                            probe=True)
    if refused:
        print(json.dumps({
            "phase": "lm_mesh", "case": "gloo_1x2", "ran": False,
            "device": smi,
            "why": "gloo does not carry a collective DTensor issues on CUDA "
                   f"tensors: {refused}"}), flush=True)
    else:
        refs = lm_mesh_refs(jobs)
        outs = lm_mesh_spawn("gloo_1x2", 2, "gloo", [card, card], jobs)
        lm_mesh_report("gloo_1x2", jobs, outs, refs, smi, "gloo")
    n_cards = torch.cuda.device_count()
    if n_cards >= 4:
        q = {"kind": "serve", "arch": LM_TRAIN_ARCH, "layout": (1, 4),
             "batch": LM_BATCH, "prompt": LM_MESH_QWEN_PROMPT}
        jobs = [{"name": "train", "kind": "train", "arch": LM_TRAIN_ARCH,
                 "layout": (2, 2)},
                {"name": "serve", "kind": "serve", "arch": LM_ARCH,
                 "layout": (2, 2), "batch": LM_BATCH, "prompt": LM_PROMPT},
                dict(q, name="decode_1x4"),
                dict(q, name="decode_1x4_flash", flash=True),
                dict(q, name="decode_1x4_repeat", repeat=True)]
        ds = {"kind": "serve", "arch": "deepseek-v3-671b", "layers": 4,
              "batch": 2, "prompt": 1_024}
        jobs += [dict(ds, name="deepseek_2x2", layout=(2, 2)),
                 dict(ds, name="deepseek_2x2_expert_2d", layout=(2, 2),
                      expert_2d=True),
                 dict(ds, name="deepseek_mla_decode_1x4", layout=(1, 4)),
                 dict(ds, name="deepseek_2x2_b1", layout=(2, 2), batch=1),
                 {"name": "train_adam8bit_2x2", "kind": "train",
                  "arch": LM_TRAIN_ARCH, "layout": (2, 2),
                  "optimizer": "adam8bit", "batch_seq": LM_MESH_TRAIN}]
        jobs += [{"name": f"long_decode_{a}x{b}", "kind": "long",
                  "arch": LM_TRAIN_ARCH, "layout": (a, b)}
                 for a, b in ((2, 2), (4, 1))]
        refs = lm_mesh_refs(jobs)
        torch.cuda.empty_cache()
        outs = lm_mesh_spawn("nccl_4_cards", 4, "nccl", [0, 1, 2, 3], jobs)
        lm_mesh_report("nccl_4_cards", jobs, outs, refs, smi, "nccl")
        print(json.dumps({
            "phase": "lm_mesh", "case": "nccl_4_cards",
            "job": "long_decode jamba-1.5-large-398b", "ran": False,
            "why": "jamba's first attention layer is layer 8 of 72; 8 "
                   "layers carry ~77 GB of MoE weights, which each process "
                   "draws whole before its block is cut: more than a "
                   "card holds"}), flush=True)
    else:
        print(json.dumps({
            "phase": "lm_mesh", "case": "nccl_4_cards", "ran": False,
            "why": f"{n_cards} CUDA device(s) here: the (2, 2) and (1, 4) "
                   "layouts over NCCL take one card a process"}), flush=True)
    shutil.rmtree(LM_MESH_DIR, ignore_errors=True)
    print(json.dumps({"phase": "lm_mesh", "device": smi,
                      "s": time.perf_counter() - t_phase}), flush=True)
    return {"launches": one["launches"], "slices": slices,
            "long_slices": long_slices, "mla": one["mla"]}


def device_profile(fn, phase, what, host_ops=False):
    """``fn()`` under ``torch.profiler``: device time by kernel and the
    device's idle share of the wall time; with ``host_ops`` also the
    PyTorch ops by host time (self, ms) beside their device time.  Returns
    {kernel name: device ms}."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return profile_report(prof, wall_ms, phase, what, host_ops)


def profile_report(prof, wall_ms, phase, what, host_ops=False):
    """Print the device time by kernel of a finished ``torch.profiler``
    run and the device's idle share of ``wall_ms``; returns {kernel name:
    device ms}."""
    kern, n_kernels = {}, 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kern[ev.name] = kern.get(ev.name, 0.0) + \
                ev.time_range.elapsed_us() / 1e3
            n_kernels += 1
    rows = sorted(((ms, k) for k, ms in kern.items()), reverse=True)
    busy = sum(ms for ms, _ in rows)
    line = {"phase": phase, "what": what, "wall_ms_profiled": wall_ms,
            "device_kernels": n_kernels,
            "device_busy_ms": busy if rows else "not measured",
            "idle_share": 1 - busy / wall_ms if rows else "not measured",
            "top": [{"name": k[:90], "ms": ms} for ms, k in rows[:12]]}
    if host_ops:
        ops = []
        for ev in prof.key_averages():
            dev_us = getattr(ev, "device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "cuda_time_total", 0.0)
            ops.append({"op": ev.key[:60], "count": ev.count,
                        "host_self_ms": ev.self_cpu_time_total / 1e3,
                        "device_ms": dev_us / 1e3})
        ops.sort(key=lambda o: -o["host_self_ms"])
        line["host_ops"] = ops[:20]
    print(json.dumps(line), flush=True)
    return kern


def profile_lm(cfg, params, tokens):
    """One prefill, then 4 decode steps replayed from a CUDA graph (captured
    before the profiled window) and 4 eager decode steps, each under
    ``torch.profiler``, the decode steps with the host's ops by time."""
    from repro_torch.launch.serve import DecodeGraph
    from repro_torch.lm.serve_lib import make_prefill, make_serve_step
    s = tokens.shape[1]
    prefill, step = make_prefill(cfg, max_len=s + 9), make_serve_step(cfg)
    out = {}

    def run_prefill():
        out["logits"], out["cache"] = prefill(params, tokens)

    device_profile(run_prefill, "lm_profile", "one prefill")
    graph = DecodeGraph(cfg, params, out["cache"],
                        out["logits"][:, -1:].argmax(-1), s)

    def run_graphed():
        for _ in range(4):
            graph.replay()

    def run_eager():
        tok = graph.tok.clone()
        for i in range(4):
            logits, _ = step(params, out["cache"], tok, s + 4 + i)
            tok = logits.argmax(-1)

    kern = device_profile(run_graphed, "lm_profile",
                          "4 decode steps replayed from the CUDA graph",
                          host_ops=True)
    if not any("flash_decode" in k for k in kern):
        fail("lm_profile: no flash_decode kernel in the graphed steps' trace")
    device_profile(run_eager, "lm_profile", "4 eager decode steps",
                   host_ops=True)


def profile_request(prov, pos, phase="profile"):
    """One more evaluate-only request under ``torch.profiler``; fails if
    PyTorch's indexing backward ran (the force scatter replaces it)."""
    from repro_torch.backend import ForceRequest
    x = torch.tensor(pos, device=DEVICE)
    kern = device_profile(lambda: prov.compute(ForceRequest(positions=x)),
                          phase, "one evaluate-only request")
    if not kern:
        fail(f"{phase}: the profiler recorded no device time")
    if any("indexing_backward" in k for k in kern):
        fail(f"{phase}: an evaluate ran PyTorch's indexing backward")


T0 = time.perf_counter()


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC}/repro_torch not found", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ["--dd-procs-child"]:
        return dd_procs_child(sys.argv[2], int(sys.argv[3]))
    if sys.argv[1:2] == ["--lm-mesh-child"]:
        return lm_mesh_child(sys.argv[2], int(sys.argv[3]))
    if sys.argv[1:2] == ["--serve-procs-child"]:
        return serve_procs_child(sys.argv[2], int(sys.argv[3]))
    from repro_torch.dp import DPModel, paper_dpa1_config
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    logs = build.build("nbr_attn", "cell_filter", "flash_attn",
                       "force_scatter")                         # together
    print(f"[build] nvcc: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        entry = "?"
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line.strip()
            elif "registers" in line or "spill" in line:
                print(f"[build] {name} {entry}: {line.strip()}", flush=True)

    if sys.argv[1:] == ["--phase", "lm"]:
        phase_lm()
        print("[lm] every check passed (lm phase alone)", flush=True)
        return 0
    if sys.argv[1:] == ["--phase", "lm_archs"]:
        phase_lm_archs()
        print("[lm_archs] every check passed (lm_archs phase alone)",
              flush=True)
        return 0
    if sys.argv[1:] == ["--phase", "lm_train"]:
        phase_lm_train()
        print("[lm_train] every check passed (lm_train phase alone)",
              flush=True)
        return 0
    if sys.argv[1:] == ["--phase", "lm_mesh"]:
        res = phase_lm_mesh(smi)
        print(json.dumps({"lm_mesh_kernels": lm_mesh_rows(res)}), flush=True)
        print("[lm_mesh] every check passed (lm_mesh phase alone)",
              flush=True)
        return 0
    if sys.argv[1:] == ["--phase", "roofline"]:
        phase_roofline(smi)
        print("[roofline] every check passed (roofline phase alone)",
              flush=True)
        return 0
    if sys.argv[1:] == ["--phase", "train"]:
        phase_train()
        print("[train] every check passed (train phase alone)", flush=True)
        return 0
    from repro_torch.kernels import nbr_attn
    print(json.dumps({"attention_max_K_at_M128": {
        "forward_and_backward_force_path": nbr_attn.max_k(128),
        "backward_param_grads_shared_memory": nbr_attn.max_k(128, True),
        "backward_param_grads_device_workspace": nbr_attn.max_k(128, True,
                                                                True),
        "port_limit": nbr_attn.MAX_K}}), flush=True)

    model = DPModel(paper_dpa1_config(ntypes=4, rcut=0.6, sel=64),
                    device=DEVICE)
    params = model.init_params(torch.Generator().manual_seed(SEED))
    if sys.argv[1:] == ["--phase", "md"]:
        phase_md(model, params)
        print("[md] every check passed (md phase alone)", flush=True)
        return 0
    if sys.argv[1:] == ["--phase", "guard"]:
        phase_guard(model, params)
        print("[guard] every check passed (guard phase alone)", flush=True)
        return 0
    if sys.argv[1:] == ["--phase", "ensemble"]:
        phase_ensemble(model, params)
        print("[ensemble] every check passed (ensemble phase alone)",
              flush=True)
        return 0
    if sys.argv[1:] == ["--phase", "serve"]:
        phase_serve(model, params)
        print("[serve] every check passed (serve phase alone)", flush=True)
        return 0
    if sys.argv[1:] == ["--phase", "serve_procs"]:
        per = phase_serve_procs(model, params, smi)
        print(json.dumps({"serve_procs_launches_per_dispatch": per}),
              flush=True)
        print("[serve_procs] every check passed (serve_procs phase alone)",
              flush=True)
        return 0
    if sys.argv[1:] == ["--phase", "dd_procs"]:
        phase_dd_procs(model, params, smi)
        print("[dd_procs] every check passed (dd_procs phase alone)",
              flush=True)
        return 0
    if sys.argv[1:] == ["--phase", "ensemble_procs"]:
        phase_ensemble_procs(model, params, smi)
        print("[ensemble_procs] every check passed (ensemble_procs phase "
              "alone)", flush=True)
        return 0
    phase_kernels(model, params, 0.0)            # single_domain_forces, K = 64
    kres = phase_kernels(model, params, SKIN, main=True)  # the provider's K
    # K = 128: the MD cutoff (r_c = 0.8, ~64 neighbours) with sel 128, where
    # the backward runs its device-workspace instance
    model_md = DPModel(paper_dpa1_config(ntypes=4, rcut=0.8, sel=128),
                       device=DEVICE)
    phase_kernels(model_md,
                  model_md.init_params(torch.Generator().manual_seed(SEED)),
                  0.0)
    del model_md
    if sys.argv[1:] == ["--phase", "kernels"]:
        print("[kernels] every check passed (kernels phase alone)", flush=True)
        return 0
    phase_parity(model, params)
    phase_any_width()
    counts_sd = phase_requests(model, params)
    cf_row, counts, per_call, dd_scatter = phase_dd(model, params)
    kres["cell_filter"] = cf_row
    procs_launches = phase_dd_procs(model, params, smi)
    md_sd, md_dd, md_pairs = phase_md(model, params)
    guard_sd, guard_dd = phase_guard(model, params)
    ens = phase_ensemble(model, params)
    torch.cuda.empty_cache()
    ens_procs_launches = phase_ensemble_procs(model, params, smi)
    torch.cuda.empty_cache()
    serve_launches = phase_serve(model, params)
    torch.cuda.empty_cache()
    serve_procs_launches = phase_serve_procs(model, params, smi)
    del model, params
    torch.cuda.empty_cache()
    train_launches = phase_train()
    torch.cuda.empty_cache()
    lm_summary, lm_rows, lm_launches = phase_lm()
    torch.cuda.empty_cache()
    arch_lines, mla = phase_lm_archs()
    torch.cuda.empty_cache()
    lm_train_attn, lm_train_launches, lm_train_line = phase_lm_train()
    torch.cuda.empty_cache()
    mesh_rows = lm_mesh_rows(phase_lm_mesh(smi))
    torch.cuda.empty_cache()
    phase_roofline(smi, lm_train_line, lm_summary)
    arch_launches = {
        kind: {name: line[f"launches_per_{kind}"]
               for name, line in arch_lines.items()}
        for kind in ("prefill", "decode_step")}

    def new_launches(name):
        return {"launches_per_batched_force_call":
                    ens["batched_force_call"][name],
                "launches_per_ensemble_step": ens["ensemble_step"][name],
                "launches_per_served_dispatch": serve_launches[name],
                "launches_per_served_dispatch_over_processes":
                    serve_procs_launches.get(name, 0),
                "launches_per_overlap_evaluation":
                    ens["overlap_evaluation"][name],
                "launches_per_lm_train_step": lm_train_launches.get(name, 0)}

    rows = []
    for name in DP_KERNELS:
        r = kres[name]
        route, source = PORT_SOURCES[name]
        rows.append({"name": name, "route": route, "source": source,
                     "replaces": TPU_SOURCES[name], "launches": counts[name],
                     "launches_per_force_call": per_call[name],
                     "launches_single_domain": counts_sd[name],
                     "launches_per_md_step": md_sd[name],
                     "launches_per_md_step_dd": md_dd[name],
                     "launches_guarded_md": guard_sd[name],
                     "launches_guarded_md_dd": guard_dd[name],
                     "launches_per_train_step":
                         train_launches["train_step"][name],
                     "launches_per_force_rmse":
                         train_launches["force_rmse"][name],
                     "launches_train_run": train_launches["train_run"][name],
                     **new_launches(name),
                     "launches_md_run_dd_procs": {
                         case: [c[name] for c in per_proc]
                         for case, per_proc in procs_launches.items()},
                     "launches_remd_run_ensemble_procs": {
                         case: [c[name] for c in per_proc]
                         for case, per_proc in ens_procs_launches.items()},
                     "K": r.get("K"), "max_abs_err": r["max_err"],
                     "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r.get("library_ms")})
        if name == "force_scatter":
            keys = ("reverse_list_ms", "kernel_with_list_ms",
                    "bound_with_list_ms", "library_own_index_ms",
                    "plain_list_ms")
            rows[-1].update({key: r[key] for key in keys})
            common = ("rows", "K", "kernel_ms", "bound_ms", "plain_ms",
                      "library_ms", "reverse_list_ms", "kernel_with_list_ms",
                      "bound_with_list_ms", "plain_list_ms")
            rows[-1]["dd_evaluate"] = {
                key: dd_scatter["gather_backward"][key]
                for key in common + ("library_own_index_ms",)}
            rows[-1]["dd_force_reduction"] = {
                key: dd_scatter["force_reduction"][key] for key in common}
            rows[-1]["md_pairs"] = md_pairs
    sdpa = lm_rows["sdpa"]
    for name, calls in (("flash_attention", ("prefill_local", "prefill_global")),
                        ("flash_decode", ("decode_local", "decode_global"))):
        main_call = lm_rows[calls[1]]       # the global layer's call
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attn.cu",
            "replaces": "src/repro/kernels/flash_attn.py:27",
            **lm_launches[name],
            "launches_per_md_step": md_sd[name],
            "launches_per_md_step_dd": md_dd[name],
            "launches_guarded_md": guard_sd[name],
            "launches_guarded_md_dd": guard_dd[name],
            "launches_per_train_step": train_launches["train_step"][name],
            "launches_per_force_rmse": train_launches["force_rmse"][name],
            **new_launches(name),
            "shape": ("prefill, global layer: q (4, 8, 6144, 256), k/v "
                      "(4, 4, 6144, 256), bf16, causal, softcap 50"
                      if name == "flash_attention" else
                      "decode, last step, global layer: q (4, 8, 1, 256), "
                      "k/v cache (4, 4, 6176, 256), pos 6174, bf16, "
                      "softcap 50"),
            "max_abs_err": max(lm_rows[c]["bf16_max_err"] for c in calls),
            "ms": main_call["bf16_kernel_ms"],
            "plain_ms": main_call["bf16_plain_ms"],
            "bound_ms": main_call["bf16_bound_ms"],
            "bound_by": main_call["bf16_bound_by"],
            # SDPA computes the function at softcap 0 only (beside the
            # kernel at softcap 0, softcap0_kernel_ms_by_call); at the
            # prefill the kernel's own call has softcap 50 and no library
            # counterpart
            "library_ms": (sdpa[calls[1]]["sdpa_ms"]
                           if name == "flash_decode" else None),
            "softcap0_kernel_ms_by_call": {c: sdpa[c]["kernel_ms"]
                                           for c in calls},
            "library_ms_by_call": {c: sdpa[c]["sdpa_ms"] for c in calls},
            "fp32_library_ms_by_call": {c: sdpa[c]["fp32_sdpa_ms"]
                                        for c in calls
                                        if "fp32_sdpa_ms" in sdpa[c]},
            "fp32_bound_ms_by_call": {c: lm_rows[c]["fp32_bound_ms"]
                                      for c in calls},
            "ms_by_call": {c: lm_rows[c]["bf16_kernel_ms"] for c in calls},
            "fp32_ms_by_call": {c: lm_rows[c]["fp32_kernel_ms"]
                                for c in calls},
            "bound_ms_by_call": {c: lm_rows[c]["bf16_bound_ms"]
                                 for c in calls},
            # the lm_archs phase: launches by architecture (0 where its
            # path has no attention or its decode is plain)
            "launches_per_prefill_lm_archs": {
                a: n.get(name, 0) for a, n in arch_launches["prefill"].items()},
            "launches_per_decode_step_lm_archs": {
                a: n.get(name, 0)
                for a, n in arch_launches["decode_step"].items()}})
        rows[-1].update(mesh_rows[name])
        if name == "flash_attention":
            rows[-1]["lm_train"] = {
                "route": "forward: this kernel with the row log-sum-exp "
                         "(return_lse); backward: plain PyTorch "
                         "(ref.attention_bwd_ref), no kernel yet",
                **{arch: {k: v for k, v in line.items()
                          if k not in ("phase", "check", "arch")}
                   for arch, line in lm_train_attn.items()}}
            # the bf16 prefill at every row 6a path shape (kernel, at
            # softcap 0, SDPA at softcap 0, bound) and its edge sweep
            rows[-1]["prefill_paths"] = [
                {k: line[k] for k in ("case", "q", "kv", "softcap", "lse",
                                      "kernel_ms", "softcap0_kernel_ms",
                                      "sdpa_ms", "bound_ms", "bound_by")}
                for line in lm_rows["prefill_paths"]]
            rows[-1]["prefill_sweep"] = {
                k: lm_rows["prefill_sweep"][k]
                for k in ("cases", "max_abs_err_by_instance", "tol")}
            rows[-1]["mla_instance"] = {
                "shape": "q/k (2, 128, 1024, 192), v (2, 128, 1024, 128), "
                         "bf16, causal (deepseek-v3 prefill, layer 0)",
                "launches_per_prefill": arch_launches["prefill"][
                    "deepseek-v3-671b"].get(name, 0),
                "max_abs_err": mla["bf16_max_err"],
                "fp32_max_abs_err": mla["fp32_max_err"],
                "ms": mla["bf16_kernel_ms"], "fp32_ms": mla["fp32_kernel_ms"],
                "plain_ms": mla["bf16_plain_ms"],
                "fp32_plain_ms": mla["fp32_plain_ms"],
                "bound_ms": mla["bf16_bound_ms"],
                "bound_by": mla["bf16_bound_by"],
                "fp32_bound_ms": mla["fp32_bound_ms"],
                "library_ms": mla["library_ms"],
                "fp32_library_ms": mla["fp32_library_ms"]}
    print(json.dumps({"kernels": rows}), flush=True)
    print(f"[chip_smoke] {time.perf_counter() - T0:.1f} s in all", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
