"""One process of ``tests/test_torch_lm_mesh.py``'s gloo group on the CPU.

    python tests/lm_mesh_worker.py TASK RANK

``TASK.group`` (world size, rendezvous file, timeout) is there when the
process starts: it joins the group through ``file://`` rendezvous while
the test draws the weights, then waits for ``TASK``, a ``torch.save``d
dict (the narrow configurations and their weights, the batch, the
prompts, the flash-decoding cases) that the test moves into place when
it is whole.  It builds the ``(2, 2)`` and ``(1, 4)``
``("data", "model")`` meshes (``lm.make_lm_mesh``), and at each runs the
LM's training step, prefill and greedy decode over DTensors
(``lm/sharding.py``), with the ``FLASH_DECODE`` and ``GQA_REPEAT`` knobs
off and on; it saves its local blocks, the gathered results and the
collectives of a decode step to ``TASK.out<RANK>`` for the test to hold
against one process, JAX and the other processes.  Imports no JAX.  The
test imports :func:`train` and :func:`serve` for its own runs with no
mesh and over a ``(1, 1)`` mesh.
"""
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

LAYOUTS = ((2, 2), (1, 4))
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


def serve(cfg, params, prompt, max_len, new, mesh):
    """Prefill ``prompt`` and ``new`` greedy decode steps: the tokens, the
    logits (prefill's and each step's, gathered) and the final cache
    (gathered; over a mesh also this process's blocks)."""
    pre = SL.make_prefill(cfg, max_len=max_len, mesh=mesh)
    dec = SL.make_serve_step(cfg, mesh=mesh)
    if mesh is not None:
        params = S.distribute_params(params, mesh)
    last, cache = pre(params, prompt)
    logits, tokens = [S.gather(last)], []
    nxt = logits[-1].argmax(-1)
    for i in range(new):
        lg, cache = dec(params, cache, nxt, prompt.shape[1] + i)
        logits.append(S.gather(lg))
        nxt = logits[-1].argmax(-1)
        tokens.append(nxt)
    out = {"tokens": torch.cat(tokens, 1), "logits": logits,
           "cache": S.gather(cache)}
    if mesh is not None:
        out["cache_blocks"] = local_blocks(cache)
    return out


def decode_collectives(cfg, params, prompt, max_len, mesh) -> dict:
    """The collectives of one decode step (``CommDebugMode``), by kind,
    with ``FLASH_DECODE`` off and on."""
    from torch.distributed.tensor.debug import CommDebugMode
    p = S.distribute_params(params, mesh)
    dec = SL.make_serve_step(cfg, mesh=mesh)
    out = {}
    for flash in (False, True):
        L.set_flash_decode(flash)
        try:
            last, cache = SL.make_prefill(cfg, max_len, mesh)(p, prompt)
            nxt = S.gather(last).argmax(-1)
            mode = CommDebugMode()
            with mode:
                dec(p, cache, nxt, prompt.shape[1])
        finally:
            L.set_flash_decode(False)
        counts = {}
        for op, n in mode.get_comm_counts().items():
            name = str(op).split(".")[-1]
            for kind in ("all_gather", "reduce_scatter", "all_reduce",
                         "all_to_all", "broadcast"):
                if kind in name:
                    counts[kind] = counts.get(kind, 0) + n
        out[flash] = counts
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


def _error(fn) -> str:
    try:
        fn()
    except (NotImplementedError, ValueError, RuntimeError) as exc:
        return f"{type(exc).__name__}: {exc}"
    return ""


def refusals(task, mesh) -> dict:
    """What stays out over a mesh of more than one device."""
    out = {}
    cfg = task["archs"]["qwen2"]["cfg"]
    out["adam8bit"] = [_error(lambda: TT.make_train_step(
        cfg, TT.TrainHParams(optimizer="adam8bit"), mesh=mesh))]
    return out


def layout_runs(task, mesh) -> dict:
    out = {}
    for arch, a in task["archs"].items():
        cfg, params = a["cfg"], a["params"]
        res = {"train": train(cfg, params, task["batch"], mesh),
               "adamw": train(cfg, params, task["batch"], mesh, steps=1,
                              optimizer="adamw")["params"][-1]}
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
            else:
                res["errors"] = refusals(task, mesh)
            out[shape] = res
        torch.save(out, f"{task_path}.out{rank}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
