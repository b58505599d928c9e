"""Every registry LM over a ``("data", "model")`` process mesh: MoE (with
``EXPERT_2D``), MLA, MTP, Mamba, RWKV6 and its channel mix,
cross-attention, whisper's encoder and the modality stubs, trained,
prefilled and decoded over an ``LMMesh`` (``lm/sharding.py``'s
``MeshRun``; ``layers``' ``*_mesh`` functions): 4 gloo processes on the CPU
(``tests/lm_mesh_archs_worker.py``, ``file://`` rendezvous under
``tmp_path``, one intra-op thread a process) in one spawn, for the narrow
fp32 ``reduced`` configurations of deepseek-v3 (MLA, sigmoid router, a
shared expert, ``first_dense`` 1, MTP), jamba (8 layers: 7 Mamba, 1
attention, MoE every 2), rwkv6-3b, whisper-medium (a 2-layer encoder,
cross layers), llama-3.2-vision (``cross_attn_every=2``: a cross layer in
2 layers) and llama4-scout (top-1 and a shared expert); d_model 64 (jamba
32: its scans are the file's costliest), d_ff 128, vocab 128; the MoE
capacity factor 1.0, at which pairs drop; weights
from the JAX PRNG through ``bridge.lm_params_to_torch``.  Every
architecture at ``(2, 2)``; deepseek-v3, jamba and rwkv6 at ``(1, 4)``;
the MoE architectures also at ``(2, 2)`` with ``EXPERT_2D``.

* Layouts: every process's block of every parameter, Adam moment, batch
  (the context included) and cache leaf equals JAX's ``NamedSharding(mesh,
  spec).devices_indices_map(shape)`` at its coordinates, exactly (JAX's
  rules on shapes, nothing compiled, ``EXPERT_2D`` set alike).
* MoE routing: ``moe_mesh`` on one normed stream routes the whole batch:
  its expert ids, slot positions and keeps equal JAX's (the reference's
  ``moe_layer`` lines) exactly; some pairs drop, and the first data
  shard routed alone keeps other pairs; the output within 1e-5 x max of
  one process (1e-4 x max of JAX), the aux loss within 1e-6 relative.
* Training, two Adam steps (``remat="none"``, as JAX's): loss (the aux
  and MTP terms included) and grad_norm within 1e-4 relative, and the
  parameters put together from the blocks within
  ``tests/test_torch_lm_train.py``'s gate, of one process with no mesh and
  of JAX's ``make_train_step``; every process holds the same bits of every
  value it shares with another.
* Serving, prefill and 8 greedy decode steps: the tokens equal one
  process's and JAX's, the logits and the cache within 1e-5 x max of one
  process, the logits within 1e-4 x max of JAX.
* Serving a batch of 1, which "data" does not divide (replicated there),
  for deepseek-v3 at ``(2, 2)`` and llama4-scout at ``(2, 2)`` with
  ``EXPERT_2D``: the same gates as the serving above.
* A ``(1, 1)`` mesh through a group of this process alone equals no mesh
  bit for bit: two Adam steps with ``remat="full"`` (against no mesh's
  ``"none"``: the recomputation repeats the forward's operations), one
  AdamW step, the prefill, the decode steps, the cache.
* Collectives (``CommDebugMode``) of one decode step of an MLA mixer and
  of a Mamba mixer at ``(1, 4)``.
* The long-context cache layout: deepseek-v3's first prompt row served
  at ``(2, 2)`` (where the layout is the plain one of the batch of 1
  above, whose serve stands for it) and ``(4, 1)`` with
  ``long_context=True`` (the cache blocks of JAX's
  ``cache_shardings(long_context=True)``, the serving gates above); at
  ``(1, 1)`` the layout is the plain one.  The same
  row with MLA's latent cache's sequence alone over "data" (laid out by
  hand), within 1e-5 x max of one process.
* Refusals: a ``MeshLayout`` of more than one device names its item.

One spawn of 4 processes, each waiting at most 300 s in a rendezvous or
collective, the spawn at most 600 s in all (deadlines for a hang: alone
the file takes ~80 s); the JAX side in one subprocess per architecture
(one XLA thread each) beside them.
"""
import dataclasses
import datetime
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import lm_mesh_archs_worker as W
from conftest import run_in_subprocess
from repro.configs import ARCHS
from repro.lm import model as JM
from repro.lm import sharding as JSH
from repro_torch import bridge
from repro_torch.launch.mesh import MeshLayout
from repro_torch.lm import make_lm_mesh
from repro_torch.lm import serve_lib as SL
from repro_torch.lm import sharding as S
from repro_torch.lm import train_lib as TT

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("lm_mesh_archs_worker.py")
WORLD, SPAWN_S, GROUP_S = 4, 600, 300
TOL, LR, B1, B2, EPS = 1e-4, 3e-4, 0.9, 0.999, 1e-8
NARROW = dict(n_layers=2, d_model=64, d_ff=128, vocab=128)
CAPACITY = 1.0          # the MoE capacity factor: pairs drop
# key -> (registry arch, PRNG seed, overrides, [(layout, EXPERT_2D)])
ARCH = {
    "deepseek": ("deepseek-v3-671b", 0, {},
                 [((2, 2), False), ((1, 4), False), ((2, 2), True)]),
    "jamba": ("jamba-1.5-large-398b", 1, {"d_model": 32},
              [((2, 2), False), ((1, 4), False)]),
    "rwkv6": ("rwkv6-3b", 2, {}, [((2, 2), False), ((1, 4), False)]),
    "whisper": ("whisper-medium", 3, {}, [((2, 2), False)]),
    "vision": ("llama-3.2-vision-90b", 4, {"cross_attn_every": 2},
               [((2, 2), False)]),
    "llama4": ("llama4-scout-17b-a16e", 5, {},
               [((2, 2), False), ((2, 2), True)]),
}
TRAIN_B, TRAIN_S, SERVE_B, PROMPT, MAX_LEN, NEW = 4, 16, 2, 12, 24, 8
# the decode mixers whose collectives are recorded at (1, 4)
COLLECTIVES = {"deepseek": "mla", "jamba": "mamba"}
# serving a batch of ODD_B, which does not divide over "data" (so it is
# replicated there): key -> [(layout, EXPERT_2D)]
ODD_B = 1
ODD = {"deepseek": [((2, 2), False)], "llama4": [((2, 2), True)]}


def job_name(key, layout, e2d):
    return f"{key} {layout[0]}x{layout[1]}" + (" expert_2d" if e2d else "")


JOBS = [(key, layout, e2d) for key, (_, _, _, lays) in ARCH.items()
        for layout, e2d in lays]
JOB_IDS = [job_name(*j) for j in JOBS]
ODD_JOBS = [(key, layout, e2d) for key, lays in ODD.items()
            for layout, e2d in lays]
# serving the ODD_B rows with the long-context cache layout (the sequence
# over "data" where "model" leaves it: MLA's latent cache lies over "model"
# wherever S divides, as it does here, so only the batch replication is
# new for MLA): key -> layouts
LONG = {"deepseek": [(2, 2), (4, 1)]}
LONG_JOBS = [(key, layout) for key, lays in LONG.items() for layout in lays]
# MLA's latent cache with its sequence alone over "data" (laid out by
# hand: cache_spec gives it where "model" does not divide S_max and "data"
# does, which no mesh of 4 processes offers)
MLA_LEAVES = ("ckv", "k_rope")


def _long_is_odd(key, layout) -> bool:
    """Whether the long-context layout is an ODD job's plain one: a batch
    that "data" does not divide, and MLA's cache over "model" where S_max
    divides (deepseek-v3 at (2, 2)); the ODD job's serve stands for it."""
    return (layout, False) in ODD.get(key, ())


def long_name(key, layout, by_hand=False):
    return (f"{key} {layout[0]}x{layout[1]} long"
            + (" seq over data" if by_hand else ""))


def odd_name(key, layout, e2d):
    return f"{job_name(key, layout, e2d)} B{ODD_B}"


MOE = [k for k in ARCH if ARCHS[ARCH[k][0]].n_experts]


def jax_cfg(key):
    name, _, over, _ = ARCH[key]
    cfg = ARCHS[name].reduced(**dict(NARROW, **over))
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=CAPACITY)
    return cfg


JAX_CODE = r"""
import dataclasses
import json
import os
# one XLA thread and LLVM's quick code generation (XLA's own passes
# still run): the subprocess shares the machine with the workers, and
# compiling is most of its work
os.environ["XLA_FLAGS"] += (" --xla_backend_optimization_level=0"
                            " --xla_cpu_multi_thread_eigen=false"
                            " intra_op_parallelism_threads=1")
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import ARCHS
from repro.lm import layers as JL, model as JM, serve_lib as JS
from repro.lm import sharding as JSH, train_lib as JT
import time
IN, PARAMS, OUT, KEY, ARCH, NARROW, CAPACITY, NEW, MAX_LEN, WAIT, LONG = {args}
data = np.load(IN)
out, layouts = {{}}, {{}}
name, seed, over, lays = ARCH
cfg = ARCHS[name].reduced(**dict(NARROW, **over))
if cfg.n_experts:
    cfg = dataclasses.replace(cfg, capacity_factor=CAPACITY)
ctx = data.get("context_" + KEY)
sctx = data.get("serve_context_" + KEY)


def path_str(path):
    return "/".join(JSH._path_str(p) for p in path)


def paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(path_str(path), leaf) for path, leaf in flat]


# the weights the test drew (JM.init_params at PRNGKey(seed)), by path
deadline = time.monotonic() + WAIT
while not os.path.exists(PARAMS):
    assert time.monotonic() < deadline, f"no weights at {{PARAMS}}"
    time.sleep(0.05)
drawn = np.load(PARAMS)
params = jax.tree_util.tree_map_with_path(
    lambda path, _: jnp.asarray(drawn[path_str(path)]),
    jax.eval_shape(lambda k: JM.init_params(k, cfg),
                   jax.random.PRNGKey(seed)))


def blocks(shape, sharding, mesh):
    m = sharding.devices_indices_map(tuple(shape))
    got = {{}}
    for d in range(mesh.devices.shape[0]):
        for j in range(mesh.devices.shape[1]):
            got[f"{{d}},{{j}}"] = [[s.indices(n)[0], s.indices(n)[1]]
                                  for s, n in zip(m[mesh.devices[d, j]],
                                                  shape)]
    return got


p_shapes = jax.eval_shape(lambda: params)
opt = JT.make_optimizer(JT.TrainHParams())
o_shapes = jax.eval_shape(opt.init, p_shapes)
c_shapes = JS.abstract_cache(cfg, data["prompt_" + KEY].shape[0], MAX_LEN)
batch = {{"tokens": data["tokens"], "labels": data["labels"]}}
if ctx is not None:
    batch["context"] = ctx
for shape, e2d in lays:
    JSH.set_expert_2d(e2d)
    mesh = jax.make_mesh(tuple(shape), ("data", "model"))
    p_sh = JSH.params_shardings(p_shapes, mesh)
    trees = {{"params": (p_shapes, p_sh),
             "opt": (o_shapes, JT.opt_state_shardings(o_shapes, p_sh, mesh)),
             "batch": (batch, {{k: v.sharding for k, v in JT.batch_specs(
                 cfg, data["tokens"].shape[1], data["tokens"].shape[0],
                 mesh).items()}}),
             "cache": (c_shapes, JSH.cache_shardings(c_shapes, mesh))}}
    lay = {{}}
    for what, (tree, shard) in trees.items():
        sh = dict(paths(shard))
        lay[what] = {{p: blocks(np.shape(x), sh[p], mesh)
                     for p, x in paths(tree)}}
    layouts[f"{{shape[0]}},{{shape[1]}},{{e2d}}"] = lay
    JSH.set_expert_2d(False)
# the long-context cache layout of the prompt's first row
c1 = JS.abstract_cache(cfg, 1, MAX_LEN)
for shape in LONG:
    mesh = jax.make_mesh(tuple(shape), ("data", "model"))
    sh = dict(paths(JSH.cache_shardings(c1, mesh, long_context=True)))
    layouts[f"long {{shape[0]}},{{shape[1]}}"] = {{
        "cache": {{p: blocks(np.shape(x), sh[p], mesh)
                  for p, x in paths(c1)}}}}
# two training steps with no mesh
step, opt = JT.make_train_step(cfg, JT.TrainHParams(remat="none"))
step = jax.jit(step)
p, st = params, opt.init(params)
jb = {{k: jnp.asarray(v) for k, v in batch.items()}}
for i in range(2):
    p, st, m = step(p, st, jb)
    for k, v in m.items():
        out[f"{{k}} {{i}}"] = np.asarray(v)
    for path, x in paths(p):
        out[f"params {{i}} {{path}}"] = np.asarray(x)
    for path, x in paths(st["m"]):
        out[f"m {{i}} {{path}}"] = np.asarray(x)
# prefill and greedy decode
pre = jax.jit(JS.make_prefill(cfg, max_len=MAX_LEN, remat="none"))
dec = jax.jit(JS.make_serve_step(cfg))
args = [params, jnp.asarray(data["prompt_" + KEY])]
if sctx is not None:
    args.append(jnp.asarray(sctx))
lg, cache = pre(*args)
out["logits 0"] = np.asarray(lg)
nxt = jnp.argmax(lg, -1)
toks = []
prompt = data["prompt_" + KEY].shape[1]
for i in range(NEW):
    lg, cache = dec(params, cache, nxt, prompt + i)
    out[f"logits {{i + 1}}"] = np.asarray(lg)
    nxt = jnp.argmax(lg, -1)
    toks.append(np.asarray(nxt))
out["tokens"] = np.concatenate(toks, 1)
# the prompt's first ODD_B rows alone, where the test serves them
odd = data.get("prompt_odd_" + KEY)
if odd is not None:
    lg, cache = pre(params, jnp.asarray(odd))
    out["odd logits 0"] = np.asarray(lg)
    nxt, toks = jnp.argmax(lg, -1), []
    for i in range(NEW):
        lg, cache = dec(params, cache, nxt, prompt + i)
        out[f"odd logits {{i + 1}}"] = np.asarray(lg)
        nxt = jnp.argmax(lg, -1)
        toks.append(np.asarray(nxt))
    out["odd tokens"] = np.concatenate(toks, 1)
# the first MoE layer on the normed stream moe_h: the reference's routing
# lines (moe_layer's, from the router logits to the positions), its output
if cfg.n_experts:
    prefix_n, n_steps, pattern = cfg.scan_pattern()
    specs = cfg.layer_specs()
    i = next((i for i in range(prefix_n) if specs[i].mlp == "moe"), None)
    if i is not None:
        mp = params["prefix"][i]["mlp"]
    else:
        j = next(j for j, sp in enumerate(pattern) if sp.mlp == "moe")
        mp = jax.tree.map(lambda a: a[0], params["pattern"][j]["mlp"])
    x = jnp.asarray(data["moe_h_" + KEY])

    @jax.jit
    def moe(mp, x):
        o, aux = JL.moe_layer(mp, x, cfg, cfg.act)
        t = x.shape[0] * x.shape[1]
        e, k = cfg.n_experts, cfg.top_k
        logits = x.reshape(t, -1).astype(jnp.float32) @ mp["router"]
        scores = (jax.nn.sigmoid(logits) if cfg.router_scores == "sigmoid"
                  else jax.nn.softmax(logits, -1))
        _, topi = jax.lax.top_k(scores, k)
        capacity = max(int(t * k / e * cfg.capacity_factor), 4)
        pos_list, keep_list = [], []
        counts = jnp.zeros((e,), jnp.int32)
        for j in range(k):
            onehot = jax.nn.one_hot(topi[:, j], e, dtype=jnp.int32)
            pos_j = counts[topi[:, j]] + (jnp.cumsum(onehot, 0) - onehot)[
                jnp.arange(t), topi[:, j]]
            counts = counts + onehot.sum(0)
            keep_list.append(pos_j < capacity)
            pos_list.append(jnp.minimum(pos_j, capacity - 1))
        return o, aux, topi, jnp.stack(pos_list, 1), jnp.stack(keep_list, 1)

    for name, v in zip(("out", "aux", "topi", "pos", "keep"), moe(mp, x)):
        out["moe " + name] = np.asarray(v)
np.savez(OUT, **out)
print(json.dumps(layouts))
"""


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, tol, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _context_len(cfg):
    if cfg.enc_dec:
        return cfg.n_audio_frames
    return cfg.n_image_tokens if cfg.cross_attn_every else 0


def _inputs():
    """The batch, the prompts, the contexts and the MoE streams, from one
    seeded generator."""
    rng = np.random.default_rng(7)
    tok = rng.integers(0, NARROW["vocab"], (TRAIN_B, TRAIN_S + 1)
                       ).astype(np.int32)
    arrays = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    for key in ARCH:
        cfg = jax_cfg(key)
        arrays["prompt_" + key] = rng.integers(
            0, NARROW["vocab"], (SERVE_B, PROMPT)).astype(np.int32)
        t = _context_len(cfg)
        if t:
            for b, name in ((TRAIN_B, "context_"), (SERVE_B,
                                                    "serve_context_")):
                arrays[name + key] = rng.normal(
                    0, 1, (b, t, cfg.d_model)).astype(np.float32)
        if cfg.n_experts:
            arrays["moe_h_" + key] = rng.normal(
                0, 1, (TRAIN_B, TRAIN_S, cfg.d_model)).astype(np.float32)
    for key in ODD:
        arrays["prompt_odd_" + key] = arrays["prompt_" + key][:ODD_B]
    return arrays


def _arch(key, arrays, tmp):
    """``key``'s configuration, weights (JAX's initialiser, jitted with
    LLVM's quick code generation: a third of the CPU of an eager draw or of
    the default compile; saved by path for the JAX side to load) and
    inputs."""
    name, seed, _, _ = ARCH[key]
    jcfg = jax_cfg(key)
    rng = jax.random.PRNGKey(seed)
    init = jax.jit(JM.init_params, static_argnums=1).lower(rng, jcfg).compile(
        {"xla_backend_optimization_level": 0})
    jparams = jax.device_get(init(rng))
    flat, _ = jax.tree_util.tree_flatten_with_path(jparams)
    np.savez(tmp / f"params_{key}.part.npz",
             **{"/".join(JSH._path_str(p) for p in path): np.asarray(x)
                for path, x in flat})
    os.replace(tmp / f"params_{key}.part.npz", tmp / f"params_{key}.npz")
    t = lambda k: (torch.tensor(arrays[k + key]) if k + key in arrays
                   else None)
    batch = {k: torch.tensor(arrays[k]) for k in ("tokens", "labels")}
    if t("context_") is not None:
        batch["context"] = t("context_")
    return {"cfg": bridge.arch_config_to_torch(jcfg),
            "params": bridge.lm_params_to_torch(jparams, device="cpu"),
            "batch": batch, "prompt": t("prompt_"),
            "context": t("serve_context_"), "moe_h": t("moe_h_")}


def _start(tmp: Path):
    """Start the workers on the group's file (``task.pt.group``); they join
    the group and wait for ``task.pt.0``, ``task.pt.1``, ... in turn, one
    architecture's jobs each (:func:`_publish`)."""
    path = tmp / "task.pt"
    torch.save({"world": WORLD, "rendezvous": str(tmp / "rendezvous"),
                "timeout_s": GROUP_S, "parts": len(ARCH)}, f"{path}.group")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    return path, [subprocess.Popen([sys.executable, str(WORKER), str(path),
                                    str(r)], env=env, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
                  for r in range(WORLD)]


def _publish(task: dict, path: str) -> None:
    """A part of the workers' task, moved into place whole."""
    torch.save(task, f"{path}.tmp")
    os.replace(f"{path}.tmp", path)


def _jobs(key, a) -> list:
    """``key``'s jobs for the workers: its layouts, the MoE case where it
    has MoE, the collectives of a decode mixer at ``(1, 4)``; then its
    serving of ``ODD_B`` rows alone (``ODD``)."""
    return [{"name": job_name(key, layout, e2d), "layout": layout,
             "expert_2d": e2d, "cfg": a["cfg"], "params": a["params"],
             "batch": a["batch"], "prompt": a["prompt"],
             "context": a["context"], "max_len": MAX_LEN,
             "moe_h": a["moe_h"],
             "collectives": COLLECTIVES.get(key) if layout == (1, 4)
             else None}
            for layout, e2d in ARCH[key][3]] + [
        {"name": odd_name(key, layout, e2d), "layout": layout,
         "expert_2d": e2d, "serve_only": True, "cfg": a["cfg"],
         "params": a["params"], "prompt": a["prompt"][:ODD_B],
         "context": None, "max_len": MAX_LEN, "collectives": None}
        for layout, e2d in ODD.get(key, ())] + [
        {"name": long_name(key, layout), "layout": layout,
         "expert_2d": False, "serve_only": True, "long_context": True,
         "cfg": a["cfg"], "params": a["params"],
         "prompt": a["prompt"][:ODD_B], "context": None, "max_len": MAX_LEN,
         "collectives": None}
        for layout in LONG.get(key, ()) if not _long_is_odd(key, layout)
    ] + [
        {"name": long_name(key, layout, True), "layout": layout,
         "expert_2d": False, "serve_only": True, "long_context": MLA_LEAVES,
         "cfg": a["cfg"], "params": a["params"],
         "prompt": a["prompt"][:ODD_B], "context": None, "max_len": MAX_LEN,
         "collectives": None}
        for layout in LONG.get(key, ())]


def _join(path: Path, procs: list, deadline: float) -> list:
    """Every worker's results; any failure, or a worker still running at
    ``deadline``, kills them all and fails the test."""
    logs = {}
    try:
        for r, p in enumerate(procs):
            logs[r] = p.communicate(
                timeout=max(deadline - time.monotonic(), 1))[0]
    except subprocess.TimeoutExpired:
        pytest.fail(f"the {len(procs)} processes did not finish in "
                    f"{SPAWN_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"process {r}:\n{logs[r][-4000:]}"
    return [torch.load(f"{path}.out{r}", weights_only=False)
            for r in range(len(procs))]


def _error(fn) -> str:
    try:
        fn()
    except (NotImplementedError, ValueError, RuntimeError) as exc:
        return f"{type(exc).__name__}: {exc}"
    return ""


def _one_process(key, a, mesh=None):
    """``key``'s runs in this process: no mesh, or over ``mesh`` (the
    Adam steps with ``remat="full"``)."""
    cfg, params = a["cfg"], a["params"]
    out = {"train": W.train(cfg, params, a["batch"], mesh,
                            remat="none" if mesh is None else "full"),
           "serve": W.serve(cfg, params, a["prompt"], MAX_LEN, NEW, mesh,
                            a["context"]),
           "adamw": W.train(cfg, params, a["batch"], mesh, 1,
                            "adamw")["params"][-1]}
    if mesh is None:
        if a["moe_h"] is not None:
            out["moe"] = W.moe_case(cfg, params, a["moe_h"], None)
            rows = slice(0, TRAIN_B // 2)        # the (2, 2) data shard 0
            out["moe_shard0"] = W.moe_case(cfg, params, a["moe_h"][rows],
                                           None)
        if key in ODD or key in LONG:
            out["odd"] = W.serve(cfg, params, a["prompt"][:ODD_B], MAX_LEN,
                                 NEW, None)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The workers' results, this process's with no mesh and over a
    ``(1, 1)`` mesh, JAX's (layouts, training, serving, MoE routing) and
    the refusals that need no group of four."""
    tmp = tmp_path_factory.mktemp("lm_mesh_archs")
    arrays = _inputs()
    np.savez(tmp / "inputs.npz", **arrays)
    jax_out = {}

    def jax_side(key):
        args = repr((str(tmp / "inputs.npz"), str(tmp / f"params_{key}.npz"),
                     str(tmp / f"jax_{key}.npz"), key, ARCH[key], NARROW,
                     CAPACITY, NEW, MAX_LEN, SPAWN_S,
                     [list(s) for s in LONG.get(key, ())]))
        jax_out[key] = run_in_subprocess(
            JAX_CODE.format(args=args), n_devices=4, timeout=SPAWN_S)

    threads = [threading.Thread(target=jax_side, args=(key,)) for key in ARCH]
    for thread in threads:
        thread.start()
    t0 = time.monotonic()
    path, workers = _start(tmp)
    threads_before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        archs = {}
        for i, key in enumerate(ARCH):
            archs[key] = _arch(key, arrays, tmp)
            _publish({"new": NEW, "jobs": _jobs(key, archs[key])},
                     f"{path}.{i}")
        one = {key: _one_process(key, a) for key, a in archs.items()}
        cfg = archs["deepseek"]["cfg"]
        two = MeshLayout((2, 1), ("data", "model"))
        errors = {"layout": [
            _error(lambda: SL.make_prefill(cfg, mesh=two)),
            _error(lambda: SL.make_serve_step(cfg, mesh=two)),
            _error(lambda: TT.make_train_step(cfg, TT.TrainHParams(),
                                              mesh=two))]}
        dist.init_process_group(
            "gloo", init_method=f"file://{tmp / 'rendezvous1'}", rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=GROUP_S))
        try:
            mesh = make_lm_mesh(1, 1, device="cpu", timeout_s=GROUP_S)
            unit = {key: _one_process(key, a, mesh)
                    for key, a in archs.items()}
            # at (1, 1) "data" divides every batch: the long-context layout
            # is the plain one
            cache = SL.abstract_cache(cfg, ODD_B, MAX_LEN)
            cache = S.map_with_paths(
                lambda _, t: torch.randn(t.shape).to(t.dtype), cache)
            unit["long_context_cache"] = [
                {p: (t.placements, t.to_local()) for p, t in
                 S.leaves_with_paths(S.distribute_cache(cache, mesh, lc))}
                for lc in (False, True)]
        finally:
            dist.destroy_process_group()
    finally:
        torch.set_num_threads(threads_before)
        for thread in threads:
            thread.join()
    procs = _join(path, workers, t0 + SPAWN_S)
    layouts, jx = {}, {}
    for key in ARCH:
        layouts[key] = json.loads(jax_out[key].strip().splitlines()[-1])
        jx[key] = dict(np.load(tmp / f"jax_{key}.npz"))
    whole = {job_name(*job): _whole(procs, job, layouts) for job in JOBS}
    return {"procs": procs, "whole": whole, "one": one, "unit": unit,
            "errors": errors, "archs": archs, "arrays": arrays,
            "jax_layouts": layouts, "jax": jx}


def _coords(res, layout):
    return ",".join(str(c) for c in res["coords"][layout])


def _slices(where) -> tuple:
    return tuple(slice(a, b) for a, b in where)


def _assemble(procs, layout, lay, get) -> dict:
    """Whole tensors, by path, from every process's blocks (``get(res)``)
    put at the slices JAX's layout ``lay`` gives its coordinates; NaN
    where no process wrote."""
    out = {}
    for res in procs:
        c = _coords(res, layout)
        for path, b in get(res).items():
            if path not in out:
                shape = [max(w[d][1] for w in lay[path].values())
                         for d in range(b.dim())]
                out[path] = torch.full(shape, float("nan"), dtype=b.dtype)
            out[path][_slices(lay[path][c])] = b
    return out


def _whole(procs, job, layouts) -> dict:
    """A job's trained parameters and first moments (by step) and the
    final cache, put together from the blocks."""
    name, (key, layout, e2d) = job_name(*job), job
    lay = layouts[key][f"{layout[0]},{layout[1]},{e2d}"]
    m_lay = {p[2:]: v for p, v in lay["opt"].items() if p.startswith("m/")}
    part = lambda what, i: lambda res: res[name]["train"][what][i]
    out = {"params": [_assemble(procs, layout, lay["params"],
                                part("params", i)) for i in range(2)],
           "m": [_assemble(procs, layout, m_lay, part("m", i))
                 for i in range(2)],
           "cache": _assemble(procs, layout, lay["cache"],
                              lambda res: res[name]["serve"]["cache"])}
    return out


def _check_blocks(blocks, jax_blocks, coords, what, whole=None):
    """The blocks by path: the paths and each block's shape JAX's, its
    values ``whole``'s slice where given."""
    assert sorted(blocks) == sorted(jax_blocks), what
    for path, local in blocks.items():
        sl = _slices(jax_blocks[path][coords])
        want = torch.empty([b - a for a, b in jax_blocks[path][coords]])
        assert tuple(local.shape) == tuple(want.shape), (what, path)
        if whole is not None:
            assert torch.equal(local, whole[path][sl]), (what, path)


def test_reduced_stacks_cover_the_slice(run):
    """The narrow configurations hold every mixer and channel mixer of the
    slice: MLA, Mamba, attention, RWKV6 and its channel mix, a cross layer
    in each context model, MoE after a dense layer, MTP."""
    mixers, mlps = set(), set()
    for key, a in run["archs"].items():
        specs = a["cfg"].layer_specs()
        mixers |= {sp.mixer for sp in specs}
        mlps |= {(sp.mlp, a["cfg"].family == "ssm") for sp in specs}
        if key in ("whisper", "vision"):
            assert any(sp.mixer == "cross" for sp in specs), key
    assert mixers == {"mla", "mamba", "attn", "rwkv", "cross"}
    assert mlps == {("dense", False), ("moe", False), ("dense", True)}
    ds = run["archs"]["deepseek"]["cfg"]
    assert ds.mtp and ds.first_dense == 1 and ds.n_shared_experts
    assert ds.router_scores == "sigmoid"
    jamba = run["archs"]["jamba"]["cfg"]
    assert jamba.n_layers == 8 and jamba.moe_every == 2
    assert run["archs"]["llama4"]["cfg"].top_k == 1
    assert run["archs"]["whisper"]["cfg"].n_enc_layers == 2


@pytest.mark.parametrize("job", JOBS, ids=JOB_IDS)
def test_blocks_equal_jax_devices_indices_map(run, job):
    """Every process's block of every parameter, Adam moment, batch and
    context, and cache leaf is the slice JAX's sharding gives its mesh
    coordinates (``EXPERT_2D`` set alike on both sides)."""
    key, layout, e2d = job
    lay = run["jax_layouts"][key][f"{layout[0]},{layout[1]},{e2d}"]
    a = run["archs"][key]
    seen = set()
    for res in run["procs"]:
        r = res[job_name(*job)]
        c = _coords(res, layout)
        seen.add(c)
        tr = r["train"]
        _check_blocks(tr["blocks0"]["params"], lay["params"], c, "params",
                      dict(S.leaves_with_paths(a["params"])))
        _check_blocks(tr["blocks0"]["batch"], lay["batch"], c, "batch",
                      a["batch"])
        _check_blocks(tr["params"][-1], lay["params"], c, "trained params")
        _check_blocks(tr["opt"], lay["opt"], c, "adam state")
        _check_blocks(r["serve"]["cache"], lay["cache"], c, "cache")
    assert len(seen) == 4
    # the blocks cover every leaf (the slices' values: the tests below)
    whole = run["whole"][job_name(*job)]
    for tree in (whole["params"][-1], whole["m"][-1], whole["cache"]):
        assert not any(bool(t.isnan().any()) for t in tree.values())


def _param_gate(got, want, ms, what):
    """``tests/test_torch_lm_train.py``'s gate carried through the steps:
    1e-4 x max|leaf| plus what a gradient off by d = 1e-4 x max|g| lets
    each of Adam's updates make of it (g each step's gradient, from the
    reference's first moments ``ms``).  The first update is -lr g / (|g| +
    eps): up to lr d eps / ((|g| - d)+ + eps)^2, that file's term.  The
    second is -lr mhat / (sqrt(vhat) + eps), with mhat and sqrt(vhat) each
    moved by at most d: up to lr d (1 + |u|) / ((sqrt(vhat) - d)+ + eps),
    u the reference's update (large only where |g| is small beside d).
    The first step's gradients themselves are held by
    :func:`_moment_gate` (the second starts from parameters that differ
    within this gate, and Mamba's gradient moves by more than 1e-4 x max
    from there)."""
    want = np.asarray(want, np.float64)
    tol = TOL * np.abs(want).max()
    gs, prev = [], 0.0
    for i, m in enumerate(ms):
        m = np.asarray(m, np.float64)
        gs.append((m - B1 * prev) / (1 - B1))
        d = TOL * max(np.abs(g).max() for g in gs)
        if i == 0:
            amp = EPS * d / (np.maximum(np.abs(gs[0]) - d, 0.0) + EPS) ** 2
        else:
            v = sum((1 - B2) * B2 ** (i - j) * g * g for j, g in enumerate(gs))
            root = np.sqrt(v / (1 - B2 ** (i + 1)))
            u = m / (1 - B1 ** (i + 1)) / (root + EPS)
            amp = d * (1 + np.abs(u)) / (np.maximum(root - d, 0.0) + EPS)
        tol = tol + LR * amp
        prev = m
    err = np.abs(_np(got).astype(np.float64) - want)
    assert (err <= tol).all(), (what, float(err.max()))


def _moment_gate(got, want, what):
    """Adam's first moment, (1 - b1) times the running clipped gradient,
    within 1e-4 x max|leaf|, ``tests/test_torch_lm_train.py``'s gradient
    gate."""
    _close(got, want, TOL, what)


def _metric_keys(cfg):
    return ("loss", "grad_norm", "ce") + (("aux",) if cfg.n_experts else ()) \
        + (("mtp",) if cfg.mtp else ())


@pytest.mark.parametrize("job", JOBS, ids=JOB_IDS)
def test_training_matches_one_process(run, job):
    key = job[0]
    want = run["one"][key]["train"]
    cfg = run["archs"][key]["cfg"]
    whole = run["whole"][job_name(*job)]
    for res in run["procs"]:
        got = res[job_name(*job)]["train"]
        for i in range(2):
            for k in _metric_keys(cfg):
                w = float(want["metrics"][i][k])
                assert abs(float(got["metrics"][i][k]) - w) <= TOL * abs(w), \
                    (job, i, k)
    for i in range(2):
        for path, w in want["params"][i].items():
            if i == 0:
                _moment_gate(whole["m"][i][path], want["m"][i][path],
                             f"{job} step {i} m {path}")
            _param_gate(whole["params"][i][path], _np(w),
                        [_np(m[path]) for m in want["m"][:i + 1]],
                        f"{job} step {i} {path}")


@pytest.mark.parametrize("job", JOBS, ids=JOB_IDS)
def test_training_matches_jax(run, job):
    key = job[0]
    jx = run["jax"][key]
    whole = run["whole"][job_name(*job)]
    for res in run["procs"]:
        got = res[job_name(*job)]["train"]
        for i in range(2):
            for k in _metric_keys(run["archs"][key]["cfg"]):
                w = float(jx[f"{k} {i}"])
                assert abs(float(got["metrics"][i][k]) - w) <= TOL * abs(w), \
                    (job, i, k)
    for i in range(2):
        for path, g in whole["params"][i].items():
            if i == 0:
                _moment_gate(whole["m"][i][path], jx[f"m {i} {path}"],
                             f"{job} step {i} m {path} vs JAX")
            _param_gate(g, jx[f"params {i} {path}"],
                        [jx[f"m {j} {path}"] for j in range(i + 1)],
                        f"{job} step {i} {path} vs JAX")


@pytest.mark.parametrize("job", JOBS, ids=JOB_IDS)
def test_processes_share_the_same_bits(run, job):
    """Metrics, gathered results and every block of the trained parameters
    and the cache that two processes both hold are the same bits on
    each."""
    name, (key, layout, e2d) = job_name(*job), job
    first = run["procs"][0][name]
    for res in run["procs"][1:]:
        r = res[name]
        for a, b in zip(first["train"]["metrics"], r["train"]["metrics"]):
            assert all(torch.equal(a[k], b[k]) for k in a)
        assert torch.equal(first["serve"]["tokens"], r["serve"]["tokens"])
        assert all(torch.equal(a, b) for a, b in zip(first["serve"]["logits"],
                                                     r["serve"]["logits"]))
    slices = run["jax_layouts"][key][f"{layout[0]},{layout[1]},{e2d}"]
    held = {}
    for res in run["procs"]:
        for what, blocks in (("params", res[name]["train"]["params"][-1]),
                             ("cache", res[name]["serve"]["cache"])):
            for path, t in blocks.items():
                where = (what, path, json.dumps(slices[what][path][
                    _coords(res, layout)]))
                if where in held:
                    assert torch.equal(held[where], t), where
                held[where] = t


@pytest.mark.parametrize("key", sorted(ARCH))
def test_one_by_one_mesh_equals_no_mesh_bitwise(run, key):
    got, want = run["unit"][key], run["one"][key]
    assert got["adamw"].keys() == want["adamw"].keys()
    assert all(torch.equal(got["adamw"][p], want["adamw"][p])
               for p in want["adamw"])
    for i in range(2):
        assert all(torch.equal(got["train"]["metrics"][i][k],
                               want["train"]["metrics"][i][k])
                   for k in want["train"]["metrics"][i])
        for what in ("params", "m"):
            a, b = got["train"][what][i], want["train"][what][i]
            assert a.keys() == b.keys()
            assert all(torch.equal(a[p], b[p]) for p in b), (key, i, what)
    g, w = got["serve"], want["serve"]
    assert torch.equal(g["tokens"], w["tokens"])
    assert all(torch.equal(a, b) for a, b in zip(g["logits"], w["logits"]))
    assert g["cache"].keys() == w["cache"].keys()
    for p in w["cache"]:
        assert torch.equal(g["cache"][p], w["cache"][p]), (key, p)


@pytest.mark.parametrize("job", JOBS, ids=JOB_IDS)
def test_serving_matches_one_process_and_jax(run, job):
    key = job[0]
    want, jx = run["one"][key]["serve"], run["jax"][key]
    for res in run["procs"]:
        got = res[job_name(*job)]["serve"]
        assert torch.equal(got["tokens"], want["tokens"]), job
        assert np.array_equal(got["tokens"].numpy(), jx["tokens"]), job
        for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
            _close(g, w, 1e-5, f"{job} logits {i}")
            _close(g, jx[f"logits {i}"], TOL, f"{job} logits {i} vs JAX")
    cache = run["whole"][job_name(*job)]["cache"]
    assert cache.keys() == want["cache"].keys()
    for p, w in want["cache"].items():
        _close(cache[p], w, 1e-5, f"{job} cache {p}")


@pytest.mark.parametrize("job", ODD_JOBS, ids=[odd_name(*j) for j in ODD_JOBS])
def test_serving_a_batch_replicated_over_data(run, job):
    """A batch of ``ODD_B`` rows, which "data" does not divide, lies whole
    on every data index: the MoE layers combine all its rows on each
    (with ``EXPERT_2D`` too).  Prefill and greedy decode: the tokens equal
    one process's and JAX's, the logits within 1e-5 x max of one process
    and 1e-4 x max of JAX, the same bits on every process."""
    key, layout, _ = job
    assert ODD_B % layout[0], "the batch divides over data"
    want, jx = run["one"][key]["odd"], run["jax"][key]
    first = run["procs"][0][odd_name(*job)]["serve"]
    for res in run["procs"]:
        got = res[odd_name(*job)]["serve"]
        assert got["tokens"].shape == (ODD_B, NEW), job
        assert torch.equal(got["tokens"], want["tokens"]), job
        assert np.array_equal(got["tokens"].numpy(), jx["odd tokens"]), job
        for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
            _close(g, w, 1e-5, f"{job} logits {i}")
            _close(g, jx[f"odd logits {i}"], TOL, f"{job} logits {i} vs JAX")
            assert torch.equal(g, first["logits"][i]), (job, i)


@pytest.mark.parametrize("job", [j for j in JOBS if j[0] in MOE],
                         ids=[job_name(*j) for j in JOBS if j[0] in MOE])
def test_moe_routes_the_whole_batch(run, job):
    """``moe_mesh`` routes every token of the batch as the reference's
    ``moe_layer`` does: expert ids, slot positions and keeps equal JAX's,
    some pairs drop, and routing the first data shard alone keeps other
    pairs (what a per-shard router would do)."""
    key = job[0]
    jx, one = run["jax"][key], run["one"][key]
    topi, pos, keep = (jx[f"moe {n}"] for n in ("topi", "pos", "keep"))
    assert not keep.all(), "no pair drops: the case does not test drops"
    shard = one["moe_shard0"]["routing"][2].numpy()
    assert not np.array_equal(shard, keep[:shard.shape[0]]), \
        "the first data shard alone keeps the same pairs"
    for res in run["procs"]:
        got = res[job_name(*job)]["moe"]
        for g, w in zip(got["routing"], (topi, pos, keep)):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=str(job))
        _close(got["out"], one["moe"]["out"], 1e-5, f"{job} moe out")
        _close(got["out"], jx["moe out"], TOL, f"{job} moe out vs JAX")
        for w in (float(one["moe"]["aux"]), float(jx["moe aux"])):
            assert abs(float(got["aux"]) - w) <= 1e-6 * abs(w), job


def test_decode_collectives_of_mla_and_mamba(run):
    """One decode step of one mixer at (1, 4).  MLA (4 heads, one a
    process; the latent cache sharded by its sequence): one all-gather of
    every head's absorbed query, the log-sum-exp merge's three
    all-reduces and the output projection's one, no gather of the cache.
    Mamba (Di over "model"): the all-gather of ``w_in`` (its x and z
    halves; ``w_dt`` has no "model" rule), the all-reduce of B, C and dt's
    low rank and the output projection's."""
    for res in run["procs"]:
        mla = res[job_name("deepseek", (1, 4), False)]["serve"]["collectives"]
        assert mla == {"all_gather": 1, "all_reduce": 4}, mla
        mamba = res[job_name("jamba", (1, 4), False)]["serve"]["collectives"]
        assert mamba == {"all_gather": 1, "all_reduce": 2}, mamba


def test_refusals_name_their_item(run):
    err = run["errors"]
    for msg in err["layout"]:
        assert msg.startswith("NotImplementedError"), msg
        assert "MeshLayout of 2 devices" in msg and "item 14" in msg


def test_one_by_one_long_context_layout_is_the_plain_one(run):
    plain, long = run["unit"]["long_context_cache"]
    assert plain.keys() == long.keys()
    for p, (pl, t) in plain.items():
        assert long[p][0] == pl and torch.equal(long[p][1], t), p


@pytest.mark.parametrize("job", LONG_JOBS,
                         ids=[long_name(*j) for j in LONG_JOBS])
def test_serving_with_the_long_context_layout(run, job):
    """The first prompt row served with ``long_context=True``: every
    process's cache block has JAX's ``cache_shardings(long_context=True)``
    slice's shape, the blocks put together at those slices give one
    process's cache within 1e-5 x max, and the tokens equal one process's
    and JAX's, the logits within 1e-5 x max of one process and 1e-4 x max
    of JAX.  Where that layout is an ODD job's plain one (deepseek-v3 at
    ``(2, 2)``: MLA's cache over "model", the batch replicated), that
    job's serve is read."""
    key, layout = job
    name = (odd_name(key, layout, False) if _long_is_odd(key, layout)
            else long_name(*job))
    lay = run["jax_layouts"][key][f"long {layout[0]},{layout[1]}"]["cache"]
    want, jx = run["one"][key]["odd"], run["jax"][key]
    for res in run["procs"]:
        got = res[name]["serve"]
        c = _coords(res, layout)
        for p, b in got["cache"].items():
            assert tuple(b.shape) == tuple(hi - lo for lo, hi in lay[p][c]), p
        assert torch.equal(got["tokens"], want["tokens"]), job
        assert np.array_equal(got["tokens"].numpy(), jx["odd tokens"]), job
        for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
            _close(g, w, 1e-5, f"{job} logits {i}")
            _close(g, jx[f"odd logits {i}"], TOL, f"{job} logits {i} vs JAX")
    cache = _assemble(run["procs"], layout, lay,
                      lambda res: res[name]["serve"]["cache"])
    for p, w in want["cache"].items():
        _close(cache[p], w, 1e-5, f"{job} cache {p}")


def _seq_over_data(lay, layout, names) -> dict:
    """JAX's layout ``lay`` with the sequence (the second-last dim) of the
    leaves named in ``names`` alone over "data", every other dim whole."""
    out = {}
    for p, where in lay.items():
        if p.split("/")[-1] not in names:
            out[p] = where
            continue
        whole = [(0, max(w[d][1] for w in where.values()))
                 for d in range(len(next(iter(where.values()))))]
        n = whole[-2][1] // layout[0]
        out[p] = {c: whole[:-2] + [(int(c.split(",")[0]) * n,
                                    (int(c.split(",")[0]) + 1) * n)]
                  + whole[-1:] for c in where}
    return out


@pytest.mark.parametrize("job", LONG_JOBS,
                         ids=[long_name(*j, True) for j in LONG_JOBS])
def test_serving_mla_with_its_sequence_over_data(run, job):
    """The first prompt row served with MLA's latent cache's sequence
    alone over "data" (nothing over "model"; the absorbed decode scores
    this process's heads against its slice and merges the slices over
    "data"): each process holds its data index's S_max / data positions,
    the blocks put together give one process's cache within 1e-5 x max,
    the tokens equal one process's and the logits are within 1e-5 x max
    of one process's."""
    key, layout = job
    name = long_name(*job, True)
    lay = _seq_over_data(
        run["jax_layouts"][key][f"long {layout[0]},{layout[1]}"]["cache"],
        layout, MLA_LEAVES)
    want = run["one"][key]["odd"]
    for res in run["procs"]:
        got = res[name]["serve"]
        c = _coords(res, layout)
        seen = set()
        for p, b in got["cache"].items():
            assert tuple(b.shape) == tuple(hi - lo for lo, hi in lay[p][c]), p
            seen.add(p.split("/")[-1])
        assert set(MLA_LEAVES) <= seen
        assert torch.equal(got["tokens"], want["tokens"]), job
        for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
            _close(g, w, 1e-5, f"{job} logits {i}")
    cache = _assemble(run["procs"], layout, lay,
                      lambda res: res[name]["serve"]["cache"])
    for p, w in want["cache"].items():
        _close(cache[p], w, 1e-5, f"{job} cache {p}")
