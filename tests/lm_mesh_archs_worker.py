"""One process of ``tests/test_torch_lm_mesh_archs.py``'s gloo group on
the CPU.

    python tests/lm_mesh_archs_worker.py TASK RANK

``TASK.group`` (world size, rendezvous file, timeout, the number of
parts) is there when the process starts: it joins the group through
``file://`` rendezvous while the test draws the weights, then takes the
task's parts in turn, ``TASK.0``, ``TASK.1``, ..., each a
``torch.save``d dict of one architecture's jobs that the test moves into
place when it is whole (the test draws the next architecture's weights
while the processes run this one's).  For each job (an
architecture at a ``("data", "model")`` layout, ``EXPERT_2D`` off or on)
it runs two Adam training steps (``remat="none"``; not for a
``serve_only`` job), a prefill and greedy
decode steps over DTensors (``lm/sharding.py``; the prefill's cache laid
out again in the long-context layout, or with the sequence of the leaves
it names alone over "data", where the job says), where asked then the
collectives of one MLA or Mamba decode mixer (``CommDebugMode``), and for
an MoE architecture ``layers.moe_mesh`` on a given normed stream with
the routing it used recorded.  It saves its local
blocks, the gathered results and the records to ``TASK.out<RANK>`` for
the test to hold against one process, JAX and the other processes.
Imports no JAX.  The test imports :func:`train`, :func:`serve` and
:func:`moe_case` for its own runs with no mesh and over a ``(1, 1)``
mesh.
"""
import datetime
import importlib
import logging
import os
import sys
import time

import torch
import torch.distributed as dist

from lm_mesh_worker import relayout
from repro_torch.lm import layers as L
from repro_torch.lm import make_lm_mesh
from repro_torch.lm import model as M
from repro_torch.lm import serve_lib as SL
from repro_torch.lm import sharding as S
from repro_torch.lm import train_lib as TT


def local_blocks(tree):
    """Each leaf's block on this process (the whole tensor with no mesh),
    by path: the test puts the processes' blocks together by JAX's
    layouts, so the processes gather nothing for it."""
    return {path: (t.to_local() if S.is_dtensor(t) else t).clone()
            for path, t in S.leaves_with_paths(tree)}


def train(cfg, params, batch, mesh, steps=2, optimizer="adam",
          remat="none"):
    """``steps`` training steps from ``params``: per step the metrics
    (gathered), this process's blocks of the parameters and of Adam's
    first moment; over a mesh also the blocks of the initial parameters
    and batch and of the final optimizer state."""
    step, opt = TT.make_train_step(
        cfg, TT.TrainHParams(optimizer=optimizer, remat=remat), mesh=mesh)
    state, b, p = opt.init(params), batch, params
    out = {"metrics": [], "params": [], "m": []}
    if mesh is not None:
        p = S.distribute_params(params, mesh)
        state = S.distribute_opt_state(state, S.params_shardings(params,
                                                                 mesh), mesh)
        b = S.distribute_batch(batch, mesh)
        out["blocks0"] = {"params": local_blocks(p), "batch": local_blocks(b)}
    for _ in range(steps):
        p, state, metrics = step(p, state, b)
        out["metrics"].append(S.gather(metrics))
        out["params"].append(local_blocks(p))
        out["m"].append(local_blocks(state["m"]))
    if mesh is not None:
        out["opt"] = local_blocks(state)
    return out


def serve(cfg, params, prompt, max_len, new, mesh, context=None,
          collectives=None, long_context=False):
    """Prefill ``prompt`` (with ``context``) and ``new`` greedy decode
    steps: the tokens, the logits (prefill's and each step's, gathered)
    and this process's blocks of the final cache; with ``collectives``
    (a mixer) also those of that mixer's next decode step
    (:func:`mixer_collectives`)."""
    pre = SL.make_prefill(cfg, max_len=max_len, mesh=mesh)
    dec = SL.make_serve_step(cfg, mesh=mesh)
    if mesh is not None:
        params = S.distribute_params(params, mesh)
    last, cache = pre(params, prompt, context)
    cache = relayout(cache, mesh, long_context)
    logits, tokens = [S.gather(last)], []
    nxt = logits[-1].argmax(-1)
    for i in range(new):
        lg, cache = dec(params, cache, nxt, prompt.shape[1] + i)
        logits.append(S.gather(lg))
        nxt = logits[-1].argmax(-1)
        tokens.append(nxt)
    out = {"tokens": torch.cat(tokens, 1), "logits": logits,
           "cache": local_blocks(cache)}
    if collectives:
        out["collectives"] = mixer_collectives(
            cfg, params, cache, prompt.shape[0], prompt.shape[1] + new, mesh,
            collectives)
    return out


def moe_layer_params(cfg, params):
    """The first MoE layer's ``mlp`` parameters (a layer's view of the
    stacked pattern where it lies there)."""
    prefix_n, n_steps, pattern = cfg.scan_pattern()
    specs = cfg.layer_specs()
    for i in range(prefix_n):
        if specs[i].mlp == "moe":
            return params["prefix"][i]["mlp"]
    j = next(j for j, sp in enumerate(pattern) if sp.mlp == "moe")
    return M.unstack(params["pattern"][j], n_steps)[0]["mlp"]


def moe_case(cfg, params, h, mesh):
    """``layers.moe_mesh`` (``moe_layer`` with no mesh) on the normed
    stream ``h`` (B, S, D): the output and aux loss (gathered) and the
    routing of the call, recorded from ``layers.moe_route``: (topi, pos,
    keep)."""
    calls, original = [], L.moe_route

    def record(p, xf, c):
        out = original(p, xf, c)
        calls.append(tuple(t.clone() for t in out[1:4]))
        return out

    L.moe_route = record
    try:
        with torch.no_grad():
            if mesh is None:
                out, aux = L.moe_layer(moe_layer_params(cfg, params), h, cfg,
                                       cfg.act)
            else:
                p = moe_layer_params(cfg, S.distribute_params(params, mesh))
                run = S.MeshRun(mesh, h.shape[0])
                x = S.activation_constraint(run.batch(h), mesh)
                out, aux = L.moe_mesh(p, x, cfg, run, cfg.act)
                out, aux = S.gather(out), S.gather(aux)
    finally:
        L.moe_route = original
    assert len(calls) == 1, len(calls)
    return {"out": out, "aux": aux, "routing": calls[0]}


def mixer_collectives(cfg, params, cache, batch, pos, mesh, mixer) -> dict:
    """The collectives (``CommDebugMode``, by kind) of the first ``mixer``
    layer's decode form alone at ``pos``, on DTensor ``params`` and
    ``cache`` (a copy of that layer's block: the cache stays as it was)
    for a batch of ``batch``."""
    from torch.distributed.tensor.debug import CommDebugMode
    run = S.MeshRun(mesh, batch)
    layouts = L.cache_layouts(cache, run)
    i, (layer_p, spec) = next((i, ls) for i, ls in enumerate(
        SL._mesh_layers(params, cfg)) if ls[1].mixer == mixer)
    c = {k: t.clone() for k, t in SL._local_layers(cache, cfg)[i].items()}
    dt = S.dt_api()
    h = S.from_local(torch.ones((run.rows.stop - run.rows.start, 1,
                                 cfg.d_model)), mesh,
                     (run.bp, dt.Replicate()))
    pos = L.decode_position(pos, h.device)
    mode = CommDebugMode()
    with torch.no_grad(), mode:
        if mixer == "mla":
            L.mla_decode_mesh(layer_p["mixer"], h, cfg, spec, c, pos, run,
                              layouts["mla"])
        else:
            L.mamba_decode_mesh(layer_p["mixer"], h, cfg, c, pos, run)
    counts = {}
    for op, n in mode.get_comm_counts().items():
        name = str(op).split(".")[-1]
        for kind in ("all_gather", "reduce_scatter", "all_reduce",
                     "all_to_all", "broadcast"):
            if kind in name:
                counts[kind] = counts.get(kind, 0) + n
    return counts


def run_job(job, mesh, new) -> dict:
    cfg, params = job["cfg"], job["params"]
    S.set_expert_2d(job["expert_2d"])
    try:
        res = {} if job.get("serve_only") else {
            "train": train(cfg, params, job["batch"], mesh)}
        res["serve"] = serve(cfg, params, job["prompt"], job["max_len"], new,
                             mesh, job["context"], job["collectives"],
                             job.get("long_context", False))
        if job.get("moe_h") is not None:
            res["moe"] = moe_case(cfg, params, job["moe_h"], mesh)
    finally:
        S.set_expert_2d(False)
    return res


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
        # what the first training step would import, while the test is
        # still drawing the weights
        for name in ("torch._dynamo", "torch.distributed.tensor"):
            importlib.import_module(name)
        meshes, out = {}, {"coords": {}}
        for part in range(group["parts"]):
            path = f"{task_path}.{part}"
            deadline = time.monotonic() + timeout
            while not os.path.exists(path):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"no task at {path} in {timeout} s")
                time.sleep(0.02)
            task = torch.load(path, weights_only=False)
            for job in task["jobs"]:
                layout = job["layout"]
                if layout not in meshes:
                    meshes[layout] = make_lm_mesh(*layout, device="cpu",
                                                  timeout_s=timeout)
                    out["coords"][layout] = meshes[layout].coords
                out[job["name"]] = run_job(job, meshes[layout], task["new"])
        torch.save(out, f"{task_path}.out{rank}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
