"""One process of ``tests/test_torch_lm_mesh.py``'s gloo group on the CPU.

    python tests/lm_mesh_worker.py TASK RANK

``TASK.group`` (world size, rendezvous file, timeout) is there when the
process starts: it joins the group through ``file://`` rendezvous while
the test draws the weights, then waits for ``TASK``, a ``torch.save``d
dict (the narrow configurations and their weights, the batch, the
prompts, the flash-decoding cases) that the test moves into place when
it is whole.  It builds the ``(2, 2)`` and ``(1, 4)``
``("data", "model")`` meshes (``lm.make_lm_mesh``), and at each runs the
LM's training step (Adam, and ``adam8bit``: its update alone on a given
state and gradients, and two steps), prefill and greedy decode over
DTensors (``lm/sharding.py``), with the ``FLASH_DECODE`` and
``GQA_REPEAT`` knobs off and on; at ``(2, 2)`` and ``(4, 1)`` it serves
a batch of 1 with the long-context cache layout (the sequence over
"data"), at ``(2, 2)`` also a one-KV-head model with its K/V's
sequence alone over "data".  It saves its local blocks, the gathered results and the
collectives of a decode step to ``TASK.out<RANK>`` for the test to hold
against one process, JAX and the other processes.  Imports no JAX.  The
test imports :func:`train`, :func:`serve` and :func:`adam8bit_update`
for its own runs with no mesh and over a ``(1, 1)`` mesh.
"""
import dataclasses
import datetime
import logging
import os
import sys
import time

import torch
import torch.distributed as dist

from repro_torch.lm import layers as L
from repro_torch.lm import make_lm_mesh
from repro_torch.lm import serve_lib as SL
from repro_torch.lm import sharding as S
from repro_torch.lm import train_lib as TT
from repro_torch.optim import adam8bit

LAYOUTS = ((2, 2), (1, 4))
# the long-context layout: the serving batch of 1 does not divide over
# "data", so the cache's sequence lies there
LONG_LAYOUTS = ((2, 2), (4, 1))
# (FLASH_DECODE, GQA_REPEAT) by layout: each knob off and on at each;
# both on where they act (the (1, 4) cache lies sharded by its sequence)
KNOBS = {(2, 2): ((False, False), (True, False), (False, True)),
         (1, 4): ((False, False), (True, False), (False, True),
                  (True, True))}


def local_blocks(tree):
    """Each DTensor leaf's block on this process, by path."""
    return {path: t.to_local().clone()
            for path, t in S.leaves_with_paths(tree)}


def train(cfg, params, batch, mesh, steps=2, optimizer="adam"):
    """``steps`` training steps from ``params``: per step the metrics, the
    whole parameters and Adam's first moment (gathered over a mesh: the
    moment after the last step only); over a mesh also the local blocks of
    the initial state and the batch and of the final state."""
    step, opt = TT.make_train_step(cfg, TT.TrainHParams(optimizer=optimizer),
                                   mesh=mesh)
    state, b = opt.init(params), batch
    out = {"metrics": [], "params": [], "m": []}
    p = params
    if mesh is not None:
        p = S.distribute_params(params, mesh)
        state = S.distribute_opt_state(state, S.params_shardings(params,
                                                                 mesh), mesh)
        b = S.distribute_batch(batch, mesh)
        out["blocks0"] = {"params": local_blocks(p), "batch": local_blocks(b)}
    for _ in range(steps):
        p, state, metrics = step(p, state, b)
        out["metrics"].append(S.gather(metrics))
        out["params"].append(S.gather(p))
        if mesh is None or len(out["params"]) == steps:
            out["m"].append(S.gather(state["m"]))
    if mesh is not None:
        out["blocks"] = {"params": local_blocks(p), "opt": local_blocks(state)}
    return out


def adam8bit_update(a8, params, mesh):
    """One ``adam8bit`` update (``min_size`` ``a8["min_size"]``) of the
    state ``a8["state"]`` by the gradients ``a8["grads"]``, over ``mesh``
    (None: no mesh): the updates and the new state (gathered), and over a
    mesh this process's blocks of the new state."""
    opt = adam8bit(a8["lr"], weight_decay=a8["weight_decay"],
                   min_size=a8["min_size"])
    p, g, st = params, a8["grads"], a8["state"]
    if mesh is not None:
        specs = S.params_shardings(params, mesh)
        p = S.distribute_params(params, mesh)
        g = S.distribute_tree(g, specs, mesh)
        st = S.distribute_opt_state(st, specs, mesh)
    u, new = opt.update(g, st, p)
    out = {"updates": S.gather(u), "state": S.gather(new)}
    if mesh is not None:
        out["blocks"] = local_blocks(new)
    return out


def seq_over_data(cache, mesh, names):
    """A whole cache laid out by ``distribute_cache(..., long_context=True)``
    except its leaves named in ``names`` (K/V (B, Hkv, S, hd), MLA's
    ckv/k_rope (B, S, r)), whose sequence alone lies over "data": no
    heads and no sequence over "model".  ``cache_spec`` gives that layout
    where "model" divides neither the KV heads nor S_max and "data"
    divides S_max, which no mesh of 4 processes offers."""
    spec_of = dict(S.leaves_with_paths(
        S.cache_shardings(cache, mesh, long_context=True)))

    def spec(path, t):
        if path.split("/")[-1] not in names:
            return spec_of[path]
        out = [None] * t.dim()
        out[-2] = "data"
        return S.P(*out)

    return S.distribute_tree(cache, S.map_with_paths(spec, cache), mesh)


def relayout(cache, mesh, long_context):
    """The prefill's ``cache`` laid out again: ``long_context`` True by
    ``distribute_cache(..., long_context=True)``, a tuple of leaf names by
    :func:`seq_over_data`; False keeps it."""
    if not long_context:
        return cache
    if long_context is True:
        return S.distribute_cache(S.gather(cache), mesh, long_context=True)
    return seq_over_data(S.gather(cache), mesh, long_context)


def mqa(cfg, params):
    """A configuration and weights with one KV head (the first of each
    layer's): a cache whose heads "model" does not divide."""
    cut = lambda path, t: (t[..., :1, :] if path.split("/")[-1] in
                           ("wk", "wv", "bk", "bv") else t)
    return (dataclasses.replace(cfg, n_kv_heads=1),
            S.map_with_paths(cut, params))


def serve(cfg, params, prompt, max_len, new, mesh, long_context=False,
          collect=False):
    """Prefill ``prompt`` and ``new`` greedy decode steps: the tokens, the
    logits (prefill's and each step's, gathered) and the final cache
    (gathered; over a mesh also this process's blocks); the prefill's
    cache laid out again before the decode where ``long_context`` says
    (:func:`relayout`); with ``collect`` the collectives of the first
    decode step (:func:`comm_counts`)."""
    from torch.distributed.tensor.debug import CommDebugMode
    pre = SL.make_prefill(cfg, max_len=max_len, mesh=mesh)
    dec = SL.make_serve_step(cfg, mesh=mesh)
    if mesh is not None:
        params = S.distribute_params(params, mesh)
    last, cache = pre(params, prompt)
    cache = relayout(cache, mesh, long_context)
    logits, tokens = [S.gather(last)], []
    nxt = logits[-1].argmax(-1)
    mode = None
    for i in range(new):
        if collect and i == 0:
            mode = CommDebugMode()
            with mode:
                lg, cache = dec(params, cache, nxt, prompt.shape[1])
        else:
            lg, cache = dec(params, cache, nxt, prompt.shape[1] + i)
        logits.append(S.gather(lg))
        nxt = logits[-1].argmax(-1)
        tokens.append(nxt)
    out = {"tokens": torch.cat(tokens, 1), "logits": logits,
           "cache": S.gather(cache)}
    if mesh is not None:
        out["cache_blocks"] = local_blocks(cache)
    if mode is not None:
        out["collectives"] = comm_counts(mode)
    return out


def comm_counts(mode) -> dict:
    """A ``CommDebugMode``'s collectives, by kind."""
    counts = {}
    for op, n in mode.get_comm_counts().items():
        name = str(op).split(".")[-1]
        for kind in ("all_gather", "reduce_scatter", "all_reduce",
                     "all_to_all", "broadcast"):
            if kind in name:
                counts[kind] = counts.get(kind, 0) + n
    return counts


def step_collectives(cfg, p, prompt, max_len, mesh, long_context=False):
    """The collectives (``CommDebugMode``, by kind) of one decode step
    after a prefill of ``prompt``, ``p`` laid out over ``mesh`` (the cache
    laid out again with ``long_context``)."""
    from torch.distributed.tensor.debug import CommDebugMode
    last, cache = SL.make_prefill(cfg, max_len, mesh)(p, prompt)
    cache = relayout(cache, mesh, long_context)
    nxt = S.gather(last).argmax(-1)
    mode = CommDebugMode()
    with mode:
        SL.make_serve_step(cfg, mesh=mesh)(p, cache, nxt, prompt.shape[1])
    return comm_counts(mode)


def decode_collectives(cfg, params, prompt, max_len, mesh) -> dict:
    """The collectives of one decode step, by kind, with ``FLASH_DECODE``
    off and on."""
    p = S.distribute_params(params, mesh)
    out = {}
    for flash in (False, True):
        L.set_flash_decode(flash)
        try:
            out[flash] = step_collectives(cfg, p, prompt, max_len, mesh)
        finally:
            L.set_flash_decode(False)
    return out


def long_context_runs(task, mesh) -> dict:
    """The batch of 1 served with the long-context cache layout, and the
    collectives of one decode step with it and without it (the cache's
    sequence whole on every process of "data"); at ``(2, 2)`` also the
    :func:`mqa` model served with its K/V's sequence alone over "data"
    (whole heads), ``GQA_REPEAT`` off and on."""
    a = task["archs"]["qwen2"]
    prompt = a["prompt"][:1]
    p = S.distribute_params(a["params"], mesh)
    out = {"serve": serve(a["cfg"], a["params"], prompt, task["long_len"],
                          task["new"], mesh, long_context=True, collect=True)}
    out["collectives"] = {False: step_collectives(
        a["cfg"], p, prompt, task["long_len"], mesh),
        True: out["serve"].pop("collectives")}
    if tuple(mesh.axis_sizes) == (2, 2):
        cfg1, p1 = mqa(a["cfg"], a["params"])
        out["whole_heads"] = {}
        for repeat in (False, True):
            L.set_gqa_repeat(repeat)
            try:
                out["whole_heads"][repeat] = serve(
                    cfg1, p1, prompt, task["long_len"], task["new"], mesh,
                    long_context=("k", "v"))
            finally:
                L.set_gqa_repeat(False)
    return out


def flash_cases(task, mesh) -> list:
    """``layers.flash_decode_sharded`` on this process's slice of each
    case's cache (the sequence over "model")."""
    run = S.MeshRun(mesh, task["flash"][0]["q"].shape[0])
    out = []
    for case in task["flash"]:
        q, k, v = (torch.tensor(case[n]) for n in ("q", "k", "v"))
        s_loc = k.shape[2] // run.mp
        base = run.mi * s_loc
        out.append(L.flash_decode_sharded(
            q, k[:, :, base:base + s_loc].contiguous(),
            v[:, :, base:base + s_loc].contiguous(), torch.tensor(case["pos"]),
            case["window"], case["softcap"], run, base))
    return out


def layout_runs(task, mesh) -> dict:
    out = {}
    for arch, a in task["archs"].items():
        cfg, params = a["cfg"], a["params"]
        res = {"train": train(cfg, params, task["batch"], mesh),
               "adamw": train(cfg, params, task["batch"], mesh, steps=1,
                              optimizer="adamw")["params"][-1]}
        if arch == "qwen2":
            res["adam8bit"] = train(cfg, params, task["batch"], mesh,
                                    optimizer="adam8bit")
            res["adam8bit_update"] = adam8bit_update(task["a8"], params,
                                                     mesh)
        for flash, repeat in KNOBS[tuple(mesh.axis_sizes)]:
            L.set_flash_decode(flash)
            L.set_gqa_repeat(repeat)
            try:
                res[("serve", flash, repeat)] = serve(
                    cfg, params, a["prompt"], a["max_len"], task["new"], mesh)
            finally:
                L.set_flash_decode(False)
                L.set_gqa_repeat(False)
        if mesh.shape["model"] == 4:
            res["collectives"] = decode_collectives(
                cfg, params, a["prompt"], a["max_len"], mesh)
        out[arch] = res
    return out


def main(task_path: str, rank: int) -> None:
    torch.set_num_threads(1)
    # DTensor warns of every two-axis reduction; the results say enough
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    group = torch.load(f"{task_path}.group", weights_only=False)
    timeout = group["timeout_s"]
    dist.init_process_group(
        "gloo", init_method=f"file://{group['rendezvous']}", rank=rank,
        world_size=group["world"],
        timeout=datetime.timedelta(seconds=timeout))
    try:
        deadline = time.monotonic() + timeout
        while not os.path.exists(task_path):
            if time.monotonic() > deadline:
                raise TimeoutError(f"no task at {task_path} in {timeout} s")
            time.sleep(0.02)
        task = torch.load(task_path, weights_only=False)
        out = {}
        for shape in LAYOUTS:
            mesh = make_lm_mesh(*shape, device="cpu", timeout_s=timeout)
            res = {"coords": mesh.coords, "shape": mesh.shape,
                   "backend": mesh.backend, "size": mesh.size}
            res.update(layout_runs(task, mesh))
            if shape == (1, 4):
                res["flash"] = flash_cases(task, mesh)
            out[shape] = res
        for shape in LONG_LAYOUTS:
            mesh = make_lm_mesh(*shape, device="cpu", timeout_s=timeout)
            out[("long", shape)] = {"coords": mesh.coords,
                                    **long_context_runs(task, mesh)}
        torch.save(out, f"{task_path}.out{rank}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
