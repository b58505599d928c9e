"""The LM over a ``("data", "model")`` process mesh (``lm.make_lm_mesh``,
``lm/sharding.py``'s specs as DTensor placements, ``make_train_step``,
``make_prefill`` and ``make_serve_step`` over an ``LMMesh``; the
``GQA_REPEAT`` and ``FLASH_DECODE`` knobs; the decode kernel's plain
version over a cache slice): 4 gloo processes on the CPU
(``tests/lm_mesh_worker.py``, ``file://`` rendezvous under ``tmp_path``,
one intra-op thread a process) at the ``(2, 2)`` and ``(1, 4)`` layouts in
one spawn, for two narrow fp32 registry configurations, 2 layers, d_model
64, d_ff 128, vocab 128: qwen2-like (Hq 4, Hkv 2, QKV bias, tied
embeddings) and gemma2-like (a local layer of window 32 and a global one,
attention softcap 50, final softcap 30), weights from the JAX PRNG through
``bridge.lm_params_to_torch``.

* Layouts: every process's block of every parameter, Adam moment, batch
  and cache leaf equals JAX's ``NamedSharding(mesh, spec).
  devices_indices_map(shape)`` at its coordinates (JAX's own rules, in one
  subprocess with 4 forced host devices), exactly.
* Training, two Adam steps (and one AdamW step) at each layout: loss and
  grad_norm within 1e-4 relative, and the gathered parameters within
  ``tests/test_torch_lm_train.py``'s gate (1e-4 x max|leaf| plus Adam's
  amplification of the gradient gate where a gradient is rounding noise),
  of one process with no mesh and of JAX's ``make_train_step``; every
  process holds the same bits of every value it shares with another.
* A ``(1, 1)`` mesh through a group of this process alone equals no mesh
  bit for bit: the training step, the prefill logits and cache, 8 decode
  steps.
* Serving, prefill and 8 greedy decode steps at each layout with
  ``FLASH_DECODE`` and ``GQA_REPEAT`` each off and on (and both on at
  ``(1, 4)``, where they act): the tokens
  equal one process's and JAX's (with its ``GQA_REPEAT`` set alike), the
  logits and the cache within 1e-5 x max of one process, the logits within
  1e-4 x max of JAX; gemma2's 36-token prompt runs its local layer's
  window past a whole cache slice.
* ``flash_decode_sharded`` at ``(1, 4)`` within 1e-5 relative of JAX's
  ``_flash_decode_sharded`` on its ``(1, 4)`` mesh (slices wholly past the
  position and a window ending inside a slice among them).
* Collectives (``CommDebugMode``) of one decode step at ``(1, 4)``, L = 2
  layers: with ``FLASH_DECODE`` on, L all-gathers (q's heads) and 1 + 5 L
  all-reduces (the embedding; per layer the three of the merge, the
  output projection, the MLP) and no gather of a cache; off, 4 L
  all-gathers (per layer the K and V caches and the replicated
  attention's wq and wo) and 1 + L all-reduces.
* The plain decode with ``kv_base`` and ``return_lse``: 4 slices merged by
  their log-sum-exp equal the whole cache's ``decode_ref``.
* ``adam8bit`` (qwen2-like): one update (``min_size`` 64: the norms'
  and biases' one padded block, which "data" does not divide, replicated;
  the larger leaves' blocks over "data") on JAX's state after one update,
  bridged, and seeded gradients, at each layout: the gathered ``q``,
  ``s``, ``v16``, ``m`` and ``count`` equal one process's bit for bit and
  JAX's as ``tests/test_torch_train.py::_state_equal`` holds them, the
  updates bit for bit and within 1e-6 x max of JAX's; every process's
  block of every state leaf is JAX's ``devices_indices_map`` slice.  Two
  training steps (``min_size`` 4,096) within the Adam gates of one
  process and of JAX (the gate's gradient estimate from the dequantized
  first moments).
* The long-context cache layout (qwen2-like, a batch of 1, a 64-key
  cache) at ``(2, 2)`` (KV heads over "model", the sequence over "data")
  and ``(4, 1)`` (the sequence over "data" in slices of 16): every
  process's cache block is JAX's ``cache_shardings(long_context=True)``
  slice; the prefill and 8 greedy decode steps give one process's and
  JAX's tokens, logits within 1e-5 x max of one process and 1e-4 x max of
  JAX (the first row of JAX's serve of the prompts); a decode step issues the all-gathers of the same step with the
  sequence whole (no gather of a cache) and three all-reduces more per
  layer (the merge over "data").  A one-KV-head variant at ``(2, 2)``
  with its K/V's sequence alone over "data" (whole heads, laid out by
  hand: no 4-process mesh has "model" dividing neither the heads nor
  S_max), ``GQA_REPEAT`` off and on: within 1e-5 x max of one process.
* Refusals: a ``MeshLayout`` of more than one device; ``make_lm_mesh``
  without a group, with the wrong world size, and on CUDA without a card
  (the other architectures run over a mesh:
  ``tests/test_torch_lm_mesh_archs.py``).

One spawn of 4 processes; each waits at most 60 s in a rendezvous or
collective and the spawn at most 300 s in all (a hang guard).  The JAX
side runs in two subprocesses (one per configuration) beside them, on
one XLA thread each.
"""
import datetime
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import lm_mesh_worker as W
from conftest import run_in_subprocess
from test_torch_train import _state_equal
from repro.configs import ARCHS
from repro.lm import model as JM
from repro.optim import adam8bit as jadam8bit
from repro_torch import bridge
from repro_torch.kernels import ref
from repro_torch.launch.mesh import MeshLayout
from repro_torch.lm import make_lm_mesh
from repro_torch.lm import serve_lib as SL
from repro_torch.lm import sharding as S
from repro_torch.lm import train_lib as TT
from repro_torch.optim.adam import _dequantize

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("lm_mesh_worker.py")
WORLD, SPAWN_S, GROUP_S = 4, 300, 60
TOL, LR, B1 = 1e-4, 3e-4, 0.9
NARROW = dict(n_layers=2, d_model=64, d_ff=128, vocab=128)
# key -> (registry arch, PRNG seed, prompt length, cache length)
ARCH = {"qwen2": ("qwen2-1.5b", 0, 12, 24),
        "gemma2": ("gemma2-2b", 1, 36, 48)}
TRAIN_B, TRAIN_S, SERVE_B, NEW = 4, 16, 2, 8
WD = 0.1                  # TrainHParams' weight decay
A8_MIN = 64               # the adam8bit update's min_size
LONG_LEN = 64             # the long-context cache's S_max
LAYOUTS = W.LAYOUTS
LONG_LAYOUTS = W.LONG_LAYOUTS
KNOBS = W.KNOBS
# flash-decoding cases: (B, Hq, Hkv, S, hd), pos, window, softcap; the
# (1, 4) mesh cuts S into slices of 8
FLASH = [((2, 4, 2, 32, 16), 21, 0, 0.0), ((2, 4, 2, 32, 16), 30, 9, 50.0),
         ((2, 4, 2, 32, 16), 5, 0, 0.0)]

JAX_CODE = r"""
import json
import os
# one XLA thread: the subprocess shares the machine with the workers
os.environ["XLA_FLAGS"] += (" --xla_cpu_multi_thread_eigen=false"
                            " intra_op_parallelism_threads=1")
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.configs import ARCHS
from repro.lm import layers as JL, model as JM, serve_lib as JS
from repro.lm import sharding as JSH, train_lib as JT
IN, OUT, ARCH, NARROW, LAYOUTS, NEW, FLASH, A8_MIN, LONG_LEN, LONG = {args}
from repro.optim import adam8bit
data = np.load(IN)
out, layouts = {{}}, {{}}


def paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(JSH._path_str(p) for p in path), leaf)
            for path, leaf in flat]


def blocks(shape, sharding, mesh):
    m = sharding.devices_indices_map(tuple(shape))
    got = {{}}
    for d in range(mesh.devices.shape[0]):
        for j in range(mesh.devices.shape[1]):
            got[f"{{d}},{{j}}"] = [[s.indices(n)[0], s.indices(n)[1]]
                                  for s, n in zip(m[mesh.devices[d, j]],
                                                  shape)]
    return got


for key, (name, seed, prompt, max_len) in ARCH.items():
    cfg = ARCHS[name].reduced(**NARROW)
    params = JM.init_params(jax.random.PRNGKey(seed), cfg)
    p_shapes = jax.eval_shape(lambda: params)
    opt = JT.make_optimizer(JT.TrainHParams())
    o_shapes = jax.eval_shape(opt.init, p_shapes)
    o8_shapes = jax.eval_shape(adam8bit(3e-4, weight_decay=0.1,
                                        min_size=A8_MIN).init, p_shapes)
    c_shapes = JS.abstract_cache(cfg, data["prompt_" + key].shape[0],
                                 max_len)
    for shape in LAYOUTS:
        mesh = jax.make_mesh(tuple(shape), ("data", "model"))
        p_sh = JSH.params_shardings(p_shapes, mesh)
        trees = {{"params": (p_shapes, p_sh),
                 "opt": (o_shapes, JT.opt_state_shardings(o_shapes, p_sh,
                                                          mesh)),
                 "opt8": (o8_shapes, JT.opt_state_shardings(o8_shapes,
                                                            p_sh, mesh)),
                 "batch": ({{"tokens": data["tokens"],
                            "labels": data["labels"]}},
                           {{k: v.sharding for k, v in JT.batch_specs(
                               cfg, data["tokens"].shape[1],
                               data["tokens"].shape[0], mesh).items()}}),
                 "cache": (c_shapes, JSH.cache_shardings(c_shapes, mesh))}}
        lay = {{}}
        for what, (tree, shard) in trees.items():
            sh = dict(paths(shard))
            lay[what] = {{p: blocks(np.shape(x), sh[p], mesh)
                         for p, x in paths(tree)}}
        layouts[f"{{key}} {{shape[0]}},{{shape[1]}}"] = lay
    c1 = JS.abstract_cache(cfg, 1, LONG_LEN)
    for shape in LONG:
        mesh = jax.make_mesh(tuple(shape), ("data", "model"))
        sh = dict(paths(JSH.cache_shardings(c1, mesh, long_context=True)))
        layouts[f"{{key}} long {{shape[0]}},{{shape[1]}}"] = {{
            "cache": {{p: blocks(np.shape(x), sh[p], mesh)
                      for p, x in paths(c1)}}}}
    # two training steps with no mesh
    step, opt = JT.make_train_step(cfg, JT.TrainHParams(remat="none"))
    step = jax.jit(step)
    batch = {{"tokens": jnp.asarray(data["tokens"]),
             "labels": jnp.asarray(data["labels"])}}
    p, st = params, opt.init(params)
    for i in range(2):
        p, st, m = step(p, st, batch)
        out[f"{{key}} loss {{i}}"] = np.asarray(m["loss"])
        out[f"{{key}} grad_norm {{i}}"] = np.asarray(m["grad_norm"])
        for path, x in paths(p):
            out[f"{{key}} params {{i}} {{path}}"] = np.asarray(x)
        for path, x in paths(st["m"]):
            out[f"{{key}} m {{i}} {{path}}"] = np.asarray(x)
    if key == "qwen2":
        # two adam8bit steps
        step8, _ = JT.make_train_step(cfg, JT.TrainHParams(
            remat="none", optimizer="adam8bit"))
        step8 = jax.jit(step8)
        p = params
        st = JT.make_optimizer(JT.TrainHParams(optimizer="adam8bit")).init(p)
        for i in range(2):
            p, st, m = step8(p, st, batch)
            out[f"a8 loss {{i}}"] = np.asarray(m["loss"])
            out[f"a8 grad_norm {{i}}"] = np.asarray(m["grad_norm"])
            for path, x in paths(p):
                out[f"a8 params {{i}} {{path}}"] = np.asarray(x)
    # prefill and greedy decode, GQA_REPEAT off and on
    for repeat in (False, True):
        JL.set_gqa_repeat(repeat)
        pre = jax.jit(JS.make_prefill(cfg, max_len=max_len, remat="none"))
        dec = jax.jit(JS.make_serve_step(cfg))
        lg, cache = pre(params, jnp.asarray(data["prompt_" + key]))
        out[f"{{key}} {{repeat}} logits 0"] = np.asarray(lg)
        nxt = jnp.argmax(lg, -1)
        toks = []
        for i in range(NEW):
            lg, cache = dec(params, cache, nxt, prompt + i)
            out[f"{{key}} {{repeat}} logits {{i + 1}}"] = np.asarray(lg)
            nxt = jnp.argmax(lg, -1)
            toks.append(np.asarray(nxt))
        out[f"{{key}} {{repeat}} tokens"] = np.concatenate(toks, 1)
    JL.set_gqa_repeat(False)
# distributed flash decoding on a (1, 4) mesh
mesh = jax.make_mesh((1, 4), ("data", "model"))
fns, i = {{}}, 0
while FLASH and f"flash_q {{i}}" in data:
    q, k, v = (jnp.asarray(data[f"flash_{{n}} {{i}}"]) for n in "qkv")
    pos, window, cap = data[f"flash_args {{i}}"]
    args = (int(window), float(cap))
    if args not in fns:
        fns[args] = jax.jit(lambda q, k, v, p, a=args:
                            JL._flash_decode_sharded(q, k, v, p, *a))
    with mesh:
        o = fns[args](q, k, v, jnp.asarray(int(pos)))
    out[f"flash {{i}}"] = np.asarray(o)
    i += 1
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


def _arch(key):
    name, seed, prompt, max_len = ARCH[key]
    jcfg = ARCHS[name].reduced(**NARROW)
    jparams = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    return {"cfg": bridge.arch_config_to_torch(jcfg),
            "params": bridge.lm_params_to_torch(jax.device_get(jparams),
                                                device="cpu"),
            "prompt_len": prompt, "max_len": max_len}


def _inputs():
    rng = np.random.default_rng(3)
    tok = rng.integers(0, NARROW["vocab"], (TRAIN_B, TRAIN_S + 1)
                       ).astype(np.int32)
    arrays = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    for key, (_, _, prompt, _) in ARCH.items():
        arrays["prompt_" + key] = rng.integers(
            0, NARROW["vocab"], (SERVE_B, prompt)).astype(np.int32)
    for i, (shape, pos, window, cap) in enumerate(FLASH):
        b, hq, hkv, s, hd = shape
        arrays[f"flash_q {i}"] = rng.normal(0, 1, (b, hq, 1, hd)
                                            ).astype(np.float32)
        for n in "kv":
            arrays[f"flash_{n} {i}"] = rng.normal(0, 1, (b, hkv, s, hd)
                                                  ).astype(np.float32)
        arrays[f"flash_args {i}"] = np.array([pos, window, cap], np.float64)
    return arrays


def _start(tmp: Path):
    """Start the workers on the group's file (``task.pt.group``); they join
    the group and wait for ``task.pt`` (:func:`_publish`)."""
    path = tmp / "task.pt"
    torch.save({"world": WORLD, "rendezvous": str(tmp / "rendezvous"),
                "timeout_s": GROUP_S}, f"{path}.group")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    return path, [subprocess.Popen([sys.executable, str(WORKER), str(path),
                                    str(r)], env=env, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
                  for r in range(WORLD)]


def _publish(task: dict, path: Path) -> None:
    """The workers' task, moved into place whole."""
    torch.save(task, f"{path}.part")
    os.replace(f"{path}.part", path)


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


def _one_process(archs, batch, a8):
    out = {}
    for key, a in archs.items():
        cfg, params = a["cfg"], a["params"]
        prompt = torch.tensor(batch["prompt_" + key])
        out[key] = {"train": W.train(cfg, params, _tbatch(batch), None),
                    "adamw": W.train(cfg, params, _tbatch(batch), None, 1,
                                     "adamw")["params"][-1],
                    "serve": W.serve(cfg, params, prompt, a["max_len"], NEW,
                                     None)}
        if key == "qwen2":
            out[key].update(
                adam8bit=W.train(cfg, params, _tbatch(batch), None,
                                 optimizer="adam8bit"),
                adam8bit_update=W.adam8bit_update(a8, params, None),
                long=W.serve(cfg, params, prompt[:1], LONG_LEN, NEW, None),
                long_mqa=W.serve(*W.mqa(cfg, params), prompt[:1], LONG_LEN,
                                 NEW, None))
    return out


def _adam8bit_inputs(params):
    """JAX's adam8bit (``min_size`` A8_MIN) after one update by seeded
    gradients, bridged, the next seeded gradients, and JAX's second
    update from there (its updates and state, as numpy)."""
    rng = np.random.default_rng(5)
    grads = [S.map_with_paths(lambda _, t: torch.tensor(rng.normal(
        0, 1e-2, tuple(t.shape)).astype(np.float32)).to(t.dtype), params)
        for _ in range(2)]
    to_jax = lambda tree: S.map_with_paths(
        lambda _, t: jnp.asarray(t.float().numpy()).astype(
            jnp.dtype(str(t.dtype).split(".")[-1])), tree)
    jp = to_jax(params)
    opt = jadam8bit(LR, weight_decay=WD, min_size=A8_MIN)
    update = jax.jit(opt.update)
    _, st1 = update(to_jax(grads[0]), jax.jit(opt.init)(jp), jp)
    u2, st2 = update(to_jax(grads[1]), st1, jp)
    a8 = {"state": bridge.opt_state_to_torch(jax.device_get(st1), "cpu"),
          "grads": grads[1], "min_size": A8_MIN, "lr": LR,
          "weight_decay": WD}
    return a8, jax.device_get((u2, st2))


def _tbatch(arrays):
    return {k: torch.tensor(arrays[k]) for k in ("tokens", "labels")}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The workers' results, this process's with no mesh and over a
    ``(1, 1)`` mesh, JAX's (layouts, training, serving, flash decoding)
    and the refusals that need no group of four."""
    tmp = tmp_path_factory.mktemp("lm_mesh")
    arrays = _inputs()
    np.savez(tmp / "inputs.npz", **arrays)
    # JAX from the start, one subprocess per architecture (each draws its
    # own weights from the same keys; the first also runs the flash
    # decoding cases), the workers as soon as the weights are here; this
    # process's own runs on one thread (restored after)
    jax_out = {}

    def jax_side(key, flash):
        args = repr((str(tmp / "inputs.npz"), str(tmp / f"jax_{key}.npz"),
                     {key: ARCH[key]}, NARROW, [list(s) for s in LAYOUTS],
                     NEW, flash, A8_MIN, LONG_LEN,
                     [list(s) for s in LONG_LAYOUTS]))
        jax_out[key] = run_in_subprocess(
            JAX_CODE.format(args=args), n_devices=4, timeout=SPAWN_S)

    threads = [threading.Thread(target=jax_side, args=(key, i == 0))
               for i, key in enumerate(ARCH)]
    for thread in threads:
        thread.start()
    t0 = time.monotonic()
    path, workers = _start(tmp)
    threads_before = torch.get_num_threads()
    torch.set_num_threads(1)
    archs = {key: _arch(key) for key in ARCH}
    a8, a8_jax = _adam8bit_inputs(archs["qwen2"]["params"])
    task = {"new": NEW, "batch": _tbatch(arrays), "a8": a8,
            "long_len": LONG_LEN,
            "archs": {key: {"cfg": a["cfg"], "params": a["params"],
                            "prompt": torch.tensor(arrays["prompt_" + key]),
                            "max_len": a["max_len"]}
                      for key, a in archs.items()},
            "flash": [{"q": arrays[f"flash_q {i}"],
                       "k": arrays[f"flash_k {i}"],
                       "v": arrays[f"flash_v {i}"], "pos": pos,
                       "window": window, "softcap": cap}
                      for i, (_, pos, window, cap) in enumerate(FLASH)]}
    _publish(task, path)
    try:
        one = _one_process(archs, arrays, a8)
        errors = {"no_group": _error(lambda: make_lm_mesh(1, 1,
                                                          device="cpu"))}
        two = MeshLayout((2, 1), ("data", "model"))
        cfg = archs["qwen2"]["cfg"]
        errors["layout"] = [
            _error(lambda: SL.make_prefill(cfg, mesh=two)),
            _error(lambda: SL.make_serve_step(cfg, mesh=two)),
            _error(lambda: TT.make_train_step(cfg, TT.TrainHParams(),
                                              mesh=two))]
        dist.init_process_group(
            "gloo", init_method=f"file://{tmp / 'rendezvous1'}", rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=GROUP_S))
        try:
            errors["world"] = _error(lambda: make_lm_mesh(2, 2,
                                                          device="cpu"))
            errors["cuda"] = (_error(lambda: make_lm_mesh(1, 1))
                              if not torch.cuda.is_available() else None)
            mesh = make_lm_mesh(1, 1, device="cpu", timeout_s=GROUP_S)
            unit = {"mesh": (mesh.shape, mesh.size, mesh.coords,
                             mesh.backend, str(mesh.device))}
            for key, a in archs.items():
                prompt = torch.tensor(arrays["prompt_" + key])
                unit[key] = {
                    "train": W.train(a["cfg"], a["params"], _tbatch(arrays),
                                     mesh),
                    "serve": W.serve(a["cfg"], a["params"], prompt,
                                     a["max_len"], NEW, mesh)}
        finally:
            dist.destroy_process_group()
    finally:
        torch.set_num_threads(threads_before)
        for thread in threads:
            thread.join()
    procs = _join(path, workers, t0 + SPAWN_S)
    layouts, jx = {}, {}
    for key in ARCH:
        layouts.update(json.loads(jax_out[key].strip().splitlines()[-1]))
        jx.update(np.load(tmp / f"jax_{key}.npz"))
    return {"procs": procs, "one": one, "unit": unit, "errors": errors,
            "archs": archs, "arrays": arrays, "jax_layouts": layouts,
            "jax": jx, "a8_jax": a8_jax}


def _coords(res):
    return ",".join(str(c) for c in res["coords"])


def _check_blocks(blocks, whole, jax_blocks, coords, what):
    assert sorted(blocks) == sorted(jax_blocks), what
    for path, local in blocks.items():
        sl = tuple(slice(a, b) for a, b in jax_blocks[path][coords])
        want = whole[path][sl] if isinstance(whole[path], torch.Tensor) \
            else torch.tensor(np.asarray(whole[path])[sl])
        assert tuple(local.shape) == tuple(want.shape), (what, path)
        assert torch.equal(local, want), (what, path)


@pytest.mark.parametrize("shape", LAYOUTS, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("key", sorted(ARCH))
def test_blocks_equal_jax_devices_indices_map(run, key, shape):
    """Every process's block of every parameter, Adam moment, batch and
    cache leaf is the slice JAX's sharding gives its mesh coordinates."""
    lay = run["jax_layouts"][f"{key} {shape[0]},{shape[1]}"]
    params = dict(S.leaves_with_paths(run["archs"][key]["params"]))
    batch = {k: torch.tensor(run["arrays"][k]) for k in ("tokens", "labels")}
    seen = set()
    for res in run["procs"]:
        r = res[shape]
        assert r["size"] == 4 and r["backend"] == "gloo"
        assert r["shape"] == {"data": shape[0], "model": shape[1]}
        c = _coords(r)
        seen.add(c)
        tr, sv = r[key]["train"], r[key][("serve", False, False)]
        _check_blocks(tr["blocks0"]["params"], params, lay["params"], c,
                      "params")
        _check_blocks(tr["blocks0"]["batch"], batch, lay["batch"], c,
                      "batch")
        last = dict(S.leaves_with_paths(tr["params"][-1]))
        _check_blocks(tr["blocks"]["params"], last, lay["params"], c,
                      "trained params")
        opt = {f"m/{p}": t for p, t in S.leaves_with_paths(tr["m"][-1])}
        got = {p: t for p, t in tr["blocks"]["opt"].items()
               if p.startswith("m/")}
        _check_blocks(got, opt, {p: v for p, v in lay["opt"].items()
                                 if p.startswith("m/")}, c, "adam m")
        assert {p for p in tr["blocks"]["opt"]} == set(lay["opt"])
        cache = dict(S.leaves_with_paths(sv["cache"]))
        _check_blocks(sv["cache_blocks"], cache, lay["cache"], c, "cache")
    assert len(seen) == 4


def _param_gate(got, want, ms, what):
    """``tests/test_torch_lm_train.py``'s gate over the steps: 1e-4 x
    max|leaf| plus, element by element, each step's Adam amplification of
    a gradient off by 1e-4 x max|g| (the step's gradient g from the
    reference's first moments)."""
    want = np.asarray(want, np.float64)
    tol = TOL * np.abs(want).max()
    prev = 0.0
    for m in ms:
        m = np.asarray(m, np.float64)
        g = np.abs(m - B1 * prev) / (1 - B1)
        d = TOL * g.max()
        tol = tol + LR * d * 1e-8 / (np.maximum(g - d, 0.0) + 1e-8) ** 2
        prev = m
    err = np.abs(_np(got).astype(np.float64) - want)
    assert (err <= tol).all(), (what, float(err.max()))


@pytest.mark.parametrize("shape", LAYOUTS, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("key", sorted(ARCH))
def test_training_matches_one_process(run, key, shape):
    want = run["one"][key]["train"]
    for res in run["procs"]:
        got = res[shape][key]["train"]
        for i in range(2):
            for k in ("loss", "grad_norm", "ce"):
                w = float(want["metrics"][i][k])
                assert abs(float(got["metrics"][i][k]) - w) <= TOL * abs(w), \
                    (key, shape, i, k)
            ms = [dict(S.leaves_with_paths(m)) for m in want["m"][:i + 1]]
            for path, w in S.leaves_with_paths(want["params"][i]):
                _param_gate(dict(S.leaves_with_paths(got["params"][i]))[path],
                            _np(w), [_np(m[path]) for m in ms],
                            f"{key} {shape} step {i} {path}")
        adamw = dict(S.leaves_with_paths(run["one"][key]["adamw"]))
        first = dict(S.leaves_with_paths(want["m"][0]))
        for path, g in S.leaves_with_paths(res[shape][key]["adamw"]):
            _param_gate(g, _np(adamw[path]), [_np(first[path])],
                        f"{key} {shape} adamw {path}")


@pytest.mark.parametrize("shape", LAYOUTS, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("key", sorted(ARCH))
def test_training_matches_jax(run, key, shape):
    jx = run["jax"]
    for res in run["procs"]:
        got = res[shape][key]["train"]
        for i in range(2):
            for k in ("loss", "grad_norm"):
                w = float(jx[f"{key} {k} {i}"])
                assert abs(float(got["metrics"][i][k]) - w) <= TOL * abs(w), \
                    (key, shape, i, k)
            for path, g in S.leaves_with_paths(got["params"][i]):
                _param_gate(g, jx[f"{key} params {i} {path}"],
                            [jx[f"{key} m {j} {path}"] for j in range(i + 1)],
                            f"{key} {shape} step {i} {path} vs JAX")


@pytest.mark.parametrize("shape", LAYOUTS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_processes_share_the_same_bits(run, shape):
    """Metrics, gathered results and every block two processes both hold
    are the same bits on each."""
    first = run["procs"][0][shape]
    for res in run["procs"][1:]:
        r = res[shape]
        for key in ARCH:
            for a, b in zip(first[key]["train"]["metrics"],
                            r[key]["train"]["metrics"]):
                assert all(torch.equal(a[k], b[k]) for k in a)
            for knobs in KNOBS[shape]:
                x, y = first[key][("serve", *knobs)], r[key][("serve",
                                                              *knobs)]
                assert torch.equal(x["tokens"], y["tokens"])
                assert all(torch.equal(a, b)
                           for a, b in zip(x["logits"], y["logits"]))
    # blocks of the same slice on two processes: the same bits
    lay = run["jax_layouts"]
    for key in ARCH:
        slices = lay[f"{key} {shape[0]},{shape[1]}"]["params"]
        held = {}
        for res in run["procs"]:
            r = res[shape]
            for path, t in r[key]["train"]["blocks"]["params"].items():
                where = (path, json.dumps(slices[path][_coords(r)]))
                if where in held:
                    assert torch.equal(held[where], t), where
                held[where] = t


@pytest.mark.parametrize("key", sorted(ARCH))
def test_one_by_one_mesh_equals_no_mesh_bitwise(run, key):
    unit, one = run["unit"], run["one"][key]
    assert unit["mesh"] == ({"data": 1, "model": 1}, 1, (0, 0), "gloo",
                            "cpu")
    got, want = unit[key]["train"], one["train"]
    for i in range(2):
        assert all(torch.equal(got["metrics"][i][k], want["metrics"][i][k])
                   for k in want["metrics"][i])
        for (p, a), (_, b) in zip(S.leaves_with_paths(got["params"][i]),
                                  S.leaves_with_paths(want["params"][i])):
            assert torch.equal(a, b), (key, i, p)
    got, want = unit[key]["serve"], one["serve"]
    assert torch.equal(got["tokens"], want["tokens"])
    assert all(torch.equal(a, b) for a, b in zip(got["logits"],
                                                 want["logits"]))
    for (p, a), (_, b) in zip(S.leaves_with_paths(got["cache"]),
                              S.leaves_with_paths(want["cache"])):
        assert torch.equal(a, b), (key, p)


@pytest.mark.parametrize(
    "shape,knobs", [(shape, k) for shape in LAYOUTS for k in KNOBS[shape]],
    ids=lambda v: f"flash{int(v[0])}-repeat{int(v[1])}"
    if isinstance(v[0], bool) else f"{v[0]}x{v[1]}")
@pytest.mark.parametrize("key", sorted(ARCH))
def test_serving_matches_one_process_and_jax(run, key, shape, knobs):
    want = run["one"][key]["serve"]
    jx = run["jax"]
    repeat = knobs[1]
    for res in run["procs"]:
        got = res[shape][key][("serve", *knobs)]
        assert torch.equal(got["tokens"], want["tokens"]), (key, shape)
        assert np.array_equal(got["tokens"].numpy(),
                              jx[f"{key} {repeat} tokens"])
        for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
            _close(g, w, 1e-5, f"{key} {shape} {knobs} logits {i}")
            _close(g, jx[f"{key} {repeat} logits {i}"], TOL,
                   f"{key} {shape} {knobs} logits {i} vs JAX")
        for (p, g), (_, w) in zip(S.leaves_with_paths(got["cache"]),
                                  S.leaves_with_paths(want["cache"])):
            _close(g, w, 1e-5, f"{key} {shape} {knobs} cache {p}")


@pytest.mark.parametrize("case", range(len(FLASH)))
def test_flash_decode_sharded_matches_jax(run, case):
    want = run["jax"][f"flash {case}"]
    for res in run["procs"]:
        got = _np(res[(1, 4)]["flash"][case])
        assert np.isfinite(got).all()
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 1e-5, (case, err)


@pytest.mark.parametrize("key", sorted(ARCH))
def test_flash_decode_gathers_no_cache(run, key):
    """One decode step at (1, 4), L = 2: FLASH_DECODE on issues L
    all-gathers (q's heads) and 1 + 5 L all-reduces; off, 4 L all-gathers
    (the K and V caches among them) and 1 + L all-reduces."""
    n = NARROW["n_layers"]
    for res in run["procs"]:
        got = res[(1, 4)][key]["collectives"]
        assert got[True] == {"all_gather": n, "all_reduce": 1 + 5 * n}, got
        assert got[False] == {"all_gather": 4 * n, "all_reduce": 1 + n}, got


def _same_tree(a, b) -> bool:
    la, lb = list(S.leaves_with_paths(a)), list(S.leaves_with_paths(b))
    return len(la) == len(lb) and all(
        pa == pb and x.dtype == y.dtype and torch.equal(x, y)
        for (pa, x), (pb, y) in zip(la, lb))


@pytest.mark.parametrize("shape", LAYOUTS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_adam8bit_update_equals_one_process_and_jax(run, shape):
    want = run["one"]["qwen2"]["adam8bit_update"]
    ju, jst = run["a8_jax"]
    leaves = dict(S.leaves_with_paths(want["state"]))
    # the case holds both kinds of quantized leaf: blocks over "data",
    # and one padded block replicated (a sharded bias's)
    assert any(p.endswith("/q") and t.shape[0] == 1 for p, t in
               leaves.items())
    assert any(p.endswith("/q") and t.shape[0] % 2 == 0 for p, t in
               leaves.items())
    for res in run["procs"]:
        got = res[shape]["qwen2"]["adam8bit_update"]
        assert _same_tree(got["state"], want["state"])
        assert _same_tree(got["updates"], want["updates"])
        _state_equal(got["state"], jst)
        for (p, g), w in zip(S.leaves_with_paths(got["updates"]),
                             jax.tree_util.tree_leaves(ju)):
            _close(g, np.asarray(w), 1e-6, f"adam8bit update {p}")


@pytest.mark.parametrize("shape", LAYOUTS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_adam8bit_blocks_equal_jax_devices_indices_map(run, shape):
    lay = run["jax_layouts"][f"qwen2 {shape[0]},{shape[1]}"]["opt8"]
    whole = dict(S.leaves_with_paths(
        run["one"]["qwen2"]["adam8bit_update"]["state"]))
    for res in run["procs"]:
        r = res[shape]
        _check_blocks(r["qwen2"]["adam8bit_update"]["blocks"], whole, lay,
                      _coords(r), "adam8bit state")


def _first_moments(state_m, params) -> dict:
    """adam8bit's first moments by parameter path (dequantized blocks)."""
    shapes = {p: t.shape for p, t in S.leaves_with_paths(params)}
    return {path: slot["m"] if "m" in slot else _dequantize(
        slot["q"], slot["s"], shapes[path])
        for path, slot in _slots(state_m)}


def _slots(state_m, prefix=""):
    """(parameter path, slot) of an adam8bit moment tree (a slot: a dict
    of tensors, ``q``/``s``, ``v16`` or ``m``)."""
    if isinstance(state_m, dict) and all(isinstance(v, torch.Tensor)
                                         for v in state_m.values()):
        yield prefix[:-1], state_m
        return
    items = (state_m.items() if isinstance(state_m, dict)
             else enumerate(state_m))
    for k, v in items:
        yield from _slots(v, f"{prefix}{k}/")


@pytest.mark.parametrize("shape", LAYOUTS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_adam8bit_training_matches_one_process_and_jax(run, shape):
    ref = run["one"]["qwen2"]["adam8bit"]
    jx = run["jax"]
    ms = [_first_moments(m, ref["params"][0]) for m in ref["m"]]
    for res in run["procs"]:
        got = res[shape]["qwen2"]["adam8bit"]
        for i in range(2):
            for k in ("loss", "grad_norm"):
                for w in (float(ref["metrics"][i][k]),
                          float(jx[f"a8 {k} {i}"])):
                    assert abs(float(got["metrics"][i][k]) - w) <= \
                        TOL * abs(w), (shape, i, k)
            for path, g in S.leaves_with_paths(got["params"][i]):
                for want, what in (
                        (dict(S.leaves_with_paths(ref["params"][i]))[path],
                         "one process"),
                        (jx[f"a8 params {i} {path}"], "JAX")):
                    _param_gate(g, _np(want), [_np(m[path])
                                               for m in ms[:i + 1]],
                                f"adam8bit {shape} step {i} {path} vs "
                                f"{what}")


@pytest.mark.parametrize("shape", LONG_LAYOUTS,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_long_context_cache_blocks_equal_jax(run, shape):
    lay = run["jax_layouts"][f"qwen2 long {shape[0]},{shape[1]}"]["cache"]
    seen = set()
    for res in run["procs"]:
        r = res[("long", shape)]
        c = ",".join(str(x) for x in r["coords"])
        seen.add(c)
        whole = dict(S.leaves_with_paths(r["serve"]["cache"]))
        _check_blocks(r["serve"]["cache_blocks"], whole, lay, c,
                      "long-context cache")
        # the sequence lies over "data": each process holds S / data keys
        k = next(t for p, t in r["serve"]["cache_blocks"].items()
                 if p.endswith("/k"))
        assert k.shape[-2] == LONG_LEN // shape[0]
    assert len(seen) == 4


@pytest.mark.parametrize("shape", LONG_LAYOUTS,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_long_context_decode_matches_one_process_and_jax(run, shape):
    """JAX's reference is the first row of its serve of the prompts (its
    own cache length; a row's tokens and logits do not depend on the
    other row's or on the masked keys past them)."""
    want = run["one"]["qwen2"]["long"]
    jx = run["jax"]
    for res in run["procs"]:
        got = res[("long", shape)]["serve"]
        assert torch.equal(got["tokens"], want["tokens"])
        assert np.array_equal(got["tokens"].numpy(),
                              jx["qwen2 False tokens"][:1])
        for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
            _close(g, w, 1e-5, f"long {shape} logits {i}")
            _close(g, jx[f"qwen2 False logits {i}"][:1], TOL,
                   f"long {shape} logits {i} vs JAX")
        for (p, g), (_, w) in zip(S.leaves_with_paths(got["cache"]),
                                  S.leaves_with_paths(want["cache"])):
            _close(g, w, 1e-5, f"long {shape} cache {p}")


@pytest.mark.parametrize("repeat", (False, True),
                         ids=("replicated", "gqa_repeat"))
def test_long_context_whole_heads_decode_matches_one_process(run, repeat):
    """One KV head at ``(2, 2)``, its K/V's sequence alone over "data"
    (every head on every process, nothing over "model"), ``GQA_REPEAT``
    off and on: every process holds its data index's LONG_LEN / 2 keys of
    the one-process cache within 1e-5 x max, the tokens equal one
    process's, the logits within 1e-5 x max."""
    want = run["one"]["qwen2"]["long_mqa"]
    whole = dict(S.leaves_with_paths(want["cache"]))
    n = LONG_LEN // 2
    for res in run["procs"]:
        r = res[("long", (2, 2))]
        got = r["whole_heads"][repeat]
        assert torch.equal(got["tokens"], want["tokens"])
        for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
            _close(g, w, 1e-5, f"whole heads {repeat} logits {i}")
        d = r["coords"][0]
        kv = {p: b for p, b in got["cache_blocks"].items()
              if p.split("/")[-1] in ("k", "v")}
        assert kv
        for p, b in kv.items():
            assert b.shape[-3] == 1 and b.shape[-2] == n, (p, b.shape)
            _close(b, whole[p][..., d * n:(d + 1) * n, :], 1e-5,
                   f"whole heads {repeat} cache {p}")


@pytest.mark.parametrize("shape", LONG_LAYOUTS,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_long_context_decode_gathers_no_cache(run, shape):
    """One decode step, L = 2 attention layers: the long-context layout
    issues the all-gathers of the same step over a cache whose sequence
    is whole on every process of "data" (no gather of a cache) and 3 L
    all-reduces more (the merge over "data")."""
    n = NARROW["n_layers"]
    for res in run["procs"]:
        plain, long = (res[("long", shape)]["collectives"][lc]
                       for lc in (False, True))
        assert long.get("all_gather", 0) == plain.get("all_gather", 0), \
            (plain, long)
        assert long["all_reduce"] == plain.get("all_reduce", 0) + 3 * n, \
            (plain, long)


def test_mesh_refusals_without_devices(run):
    err = run["errors"]
    assert "init_process_group first" in err["no_group"]
    assert "needs 4 processes" in err["world"]
    if err["cuda"] is not None:
        assert "device='cpu'" in err["cuda"]
    for msg in err["layout"]:
        assert msg.startswith("NotImplementedError"), msg
        assert "MeshLayout of 2 devices" in msg and "item 14" in msg


# (pos, window, softcap, dtype): 4 slices of 16 keys of a 64-key cache
SLICE_CASES = [(37, 0, 0.0, torch.float32), (37, 10, 50.0, torch.float32),
               (10, 0, 0.0, torch.float32), (63, 5, 0.0, torch.float32),
               (40, 20, 30.0, torch.bfloat16)]


@pytest.mark.parametrize("case", SLICE_CASES,
                         ids=lambda c: f"pos{c[0]}-w{c[1]}-cap{int(c[2])}-"
                                       f"{str(c[3]).split('.')[-1]}")
def test_decode_slices_merge_to_the_whole_cache(case):
    """``decode_ref`` over 4 slices of a cache (``kv_base``), merged by
    their log-sum-exp, equals it over the whole cache; a slice wholly past
    ``pos`` (or before the window) gives O = 0 and LSE = -inf."""
    pos, window, cap, dtype = case
    g = torch.Generator().manual_seed(pos)
    q = torch.randn(2, 4, 1, 32, generator=g).to(dtype)
    k, v = (torch.randn(2, 2, 64, 32, generator=g).to(dtype)
            for _ in range(2))
    whole = ref.decode_ref(q, k, v, torch.tensor(pos), window, cap)
    outs, lses = [], []
    for i in range(4):
        o, lse = ref.decode_ref(q, k[:, :, 16 * i:16 * (i + 1)],
                                v[:, :, 16 * i:16 * (i + 1)],
                                torch.tensor(pos), window, cap,
                                kv_base=16 * i, return_lse=True)
        assert o.dtype == dtype and lse.dtype == torch.float32
        assert bool(torch.isfinite(o).all())
        lo = max(0, pos - window + 1) if window else 0
        if 16 * i > pos or 16 * (i + 1) <= lo:
            assert bool(torch.isneginf(lse).all()) and not o.any()
        else:
            assert bool(torch.isfinite(lse).all())
        outs.append(o.float())
        lses.append(lse)
    lse = torch.stack(lses)
    w = torch.exp(lse - lse.amax(0))[..., None]
    merged = (w * torch.stack(outs)).sum(0) / w.sum(0)
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    _close(merged, whole, tol, f"merged {case}")
