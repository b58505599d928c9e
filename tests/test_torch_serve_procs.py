"""DP force serving over a process mesh (``pipeline_executor_factory(...,
mesh_for=...)``, ``ForceServer`` on process 0, ``follow_dispatches`` on
the others): 4 gloo processes on the CPU as a ``(2, 2)`` ``(replica x
dd)`` mesh (``tests/serve_procs_worker.py``, ``file://`` rendezvous under
``tmp_path``, one intra-op thread a process), a batch bucket of 4
requests x 4 DD ranks on ``tests/test_torch_ensemble_procs.py``'s 160-atom
system and narrow DPA-1 (params from the JAX PRNG through ``bridge``).

* Served E/F within the DP gate (E rtol 1e-5, F atol 1e-4 x max|F|) of
  the virtual route (``pipeline_executor_factory`` with 4 virtual ranks)
  on the same padded dispatch, and each request within 1e-4 of JAX
  ``single_domain_forces``; overflow and batch diagnostics exact.
* Every process computes the same bits of every dispatch (the warm-up's
  too): process 0's kept outputs equal each follower's.
* A ``(1, 1)`` mesh through a group of this process alone serves the
  same batch bit for bit as the virtual route.
* An expired deadline and a ``serve_fail`` fail only their own request,
  before any broadcast (the followers see four dispatches: the warm-up,
  the batch, the request after the fault and ``evaluate_direct``), and
  the next request is served; ``stop()`` releases the followers.
* A server left idle for longer than the followers' header timeout
  (4 s; a keep-alive header every 0.5 s) serves the next request with
  the bits it gave that request before.
* A failure after the broadcast (process 3's executor raises) is raised
  on every process: the request ``ok=False``, ``stop()`` and ``submit``
  raise ``ServeGroupBroken`` on process 0, every follower's loop raises.
* A mesh whose replica shards do not divide the batch bucket is refused
  on every process.
* ``stop()`` on a ``(1, 1)`` server whose dispatch fails after its
  broadcast, 1 s after ``stop`` gave up waiting for the worker, raises
  ``ServeGroupBroken``.

One spawn of 4 processes; each waits at most 60 s in a rendezvous or
collective and the spawn at most 120 s in all.
"""
import datetime
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import ddinfer as jdd
from repro.dp import DPConfig as JConfig
from repro.dp import DPModel as JModel
from repro.dp import DescriptorConfig as JDesc
from repro_torch import bridge
from repro_torch.backend import ForceRequest
from repro_torch.core import ddinfer as tdd
from repro_torch.dp import DPModel
from repro_torch.ensemble import make_ensemble_mesh
from repro_torch.serve import (ForceServer, ServeConfig,
                               pipeline_executor_factory)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("serve_procs_worker.py")
WORLD, RANKS, BUCKET = 4, 4, 4
SPAWN_S, GROUP_S = 120, 60
RCUT, SEL = 0.6, 48
_rng = np.random.default_rng(7)
N, L = 160, 3.5
BOX = np.array([L, L, L], np.float32)
POS = _rng.uniform(0, L, (N, 3)).astype(np.float32)
TYPES = _rng.integers(0, 4, N).astype(np.int32)
# the requests: the system itself and offsets of 2e-3 nm
XS = np.stack([POS] + [np.mod(POS + np.random.default_rng(10 + r).normal(
    0, 2e-3, POS.shape), L) for r in range(1, BUCKET)]).astype(np.float32)


def _jax_model():
    desc = JDesc(kind="dpa1", rcut=RCUT, rcut_smth=0.3, sel=SEL, ntypes=4,
                 neuron=(8, 16), axis_neuron=4, attn_layers=1,
                 attn_hidden=32)
    return JModel(JConfig(descriptor=desc, fitting_neuron=(24, 24)))


def _config():
    return tdd.suggest_config(N, BOX, RANKS, RCUT, nbr_capacity=SEL,
                              slack=2.5, force_mode="ghost_reduce",
                              coords=POS)


def _start(task: dict, tmp: Path):
    path = tmp / "task.pt"
    torch.save(task, path)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    return path, [subprocess.Popen([sys.executable, str(WORKER), str(path),
                                    str(r)], env=env, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
                  for r in range(task["world"])]


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


def _request(r):
    return ForceRequest(positions=torch.tensor(XS[r]), box=torch.tensor(BOX),
                        types=torch.tensor(TYPES), tenant=f"t{r}")


def _stop_during_a_failing_dispatch(model, params, cfg) -> dict:
    """A (1, 1) server whose dispatch fails after its broadcast, 1 s in,
    while ``stop`` has stopped waiting for the worker: what ``stop`` and
    the request give."""
    factory = pipeline_executor_factory(
        model, BOX, TYPES, lambda nb, ranks: cfg,
        mesh_for=lambda b: make_ensemble_mesh(1, RANKS, device="cpu"))

    def failing(nb, b):
        def fn(*args):
            time.sleep(1.0)
            raise RuntimeError("injected after the broadcast")
        fn.pipeline = None
        return fn

    factory.pipeline_fn = failing
    server = ForceServer(model, params, ServeConfig(
        atom_buckets=(N,), batch_buckets=(BUCKET,), batch_window_s=0.0,
        nbr_capacity=SEL), executor_factory=factory)
    fut = server.submit(_request(0))
    time.sleep(0.2)
    out = {"stop": ""}
    try:
        server.stop(drain_timeout_s=0.05)
    except Exception as exc:  # noqa: BLE001 — recorded for the test
        out["stop"] = f"{type(exc).__name__}: {exc}"
    out["result"] = fut.result(60.0)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The workers' results, the virtual route's dispatches, JAX's
    single-domain E/F per request and this process's (1, 1) server."""
    tmp = tmp_path_factory.mktemp("serve_procs")
    jm = _jax_model()
    jparams = jm.init_params(jax.random.PRNGKey(0))
    model = DPModel(bridge.config_to_torch(jm.cfg), device="cpu")
    params = bridge.params_to_torch(jax.device_get(jparams), device="cpu")
    cfg = _config()
    task = {"world": WORLD, "rendezvous": str(tmp / "rendezvous"),
            "timeout_s": GROUP_S, "model_cfg": model.cfg, "params": params,
            "pos": XS, "types": TYPES, "box": BOX, "cfg": cfg}
    t0 = time.monotonic()
    path, workers = _start(task, tmp)
    # the virtual route on each dispatch's padded rows: the batch, and one
    # request padded with copies of itself
    virtual = pipeline_executor_factory(model, BOX, TYPES,
                                        lambda nb, ranks: cfg,
                                        ranks_for=lambda b: RANKS)(N, BUCKET)
    ones = torch.ones(BUCKET, N)
    with torch.no_grad():
        ref = {"batch": virtual(params, torch.tensor(XS), None, ones, None)}
        for r in (2, 3):
            one = torch.tensor(XS[r]).expand(BUCKET, N, 3).contiguous()
            ref[r] = virtual(params, one, None, ones, None)
    # (1, 1): a group of this process alone
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp / 'rendezvous1'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=GROUP_S))
    try:
        factory = pipeline_executor_factory(
            model, BOX, TYPES, lambda nb, ranks: cfg,
            mesh_for=lambda b: make_ensemble_mesh(1, RANKS, device="cpu"))
        server = ForceServer(model, params, ServeConfig(
            atom_buckets=(N,), batch_buckets=(BUCKET,), batch_window_s=0.5,
            nbr_capacity=SEL), executor_factory=factory)
        try:
            futs = [server.submit(_request(r)) for r in range(BUCKET)]
            unit = [f.result(60.0) for f in futs]
        finally:
            server.stop()
        late_failure = _stop_during_a_failing_dispatch(model, params, cfg)
    finally:
        dist.destroy_process_group()
    sdf = jax.jit(lambda p, c: jdd.single_domain_forces(
        jm, p, c, jnp.asarray(TYPES), BOX, 64))
    jax_ef = [tuple(np.asarray(a) for a in sdf(jparams, jnp.asarray(x)))
              for x in XS]
    procs = _join(path, workers, t0 + SPAWN_S)
    return {"procs": procs, "ref": ref, "unit": unit, "sdf": jax_ef,
            "late_failure": late_failure}


def _dp_gate(e, f, e0, f0):
    np.testing.assert_allclose(float(e), float(e0), rtol=1e-5)
    np.testing.assert_allclose(f.numpy(), f0.numpy(), rtol=0,
                               atol=1e-4 * float(f0.abs().max()))


def test_mesh_is_two_by_two_on_every_process(run):
    for out in run["procs"]:
        assert out["mesh"] == (("replica", 2), ("dd", RANKS))


def test_served_batch_within_the_dp_gate_of_virtual_and_jax(run):
    served = run["procs"][0]["served"]
    e0, f0, _ = run["ref"]["batch"]
    for r, res in enumerate(served["batch"]):
        assert res["ok"], res["error"]
        _dp_gate(res["energy"], res["forces"], e0[r], f0[r])
        e_ref, f_ref = run["sdf"][r]
        np.testing.assert_allclose(float(res["energy"]), float(e_ref),
                                   rtol=1e-5)
        np.testing.assert_allclose(res["forces"].numpy(), f_ref, rtol=0,
                                   atol=1e-4)


def test_diagnostics_exact(run):
    served = run["procs"][0]["served"]
    for res in served["batch"]:
        assert res["diagnostics"] == {"n_bucket": N, "batch_bucket": BUCKET,
                                      "batch_size": BUCKET,
                                      "overflow": False}
    for key in ("after", "direct"):
        assert served[key]["diagnostics"] == {
            "n_bucket": N, "batch_bucket": BUCKET, "batch_size": 1,
            "overflow": False}
    assert not bool(run["ref"]["batch"][2].any())


def test_every_process_computes_the_same_bits(run):
    """Process 0's kept dispatches equal each follower's: the warm-up
    (op 2), the batch, the request after the fault, ``evaluate_direct``
    and the request after the idle spell (op 1); the faulted and the
    expired request reached no process, nor did a keep-alive."""
    kept = run["procs"][0]["served"]["kept"]
    assert [(op, nb, b) for op, nb, b, *_ in kept] == \
        [(2, N, BUCKET)] + [(1, N, BUCKET)] * 4
    for out in run["procs"][1:]:
        assert len(out["kept"]) == len(kept)
        for a, b in zip(out["kept"], kept):
            assert a[:3] == b[:3]
            assert all(torch.equal(x, y) for x, y in zip(a[3:], b[3:]))


def test_one_by_one_mesh_serves_the_virtual_bits(run):
    e0, f0, ovf0 = run["ref"]["batch"]
    for r, res in enumerate(run["unit"]):
        assert res.ok and res.diagnostics["batch_size"] == BUCKET
        assert torch.equal(res.energy, e0[r])
        assert torch.equal(res.forces, f0[r])
        assert res.diagnostics["overflow"] == bool(ovf0[r])


def test_degradation_touches_only_its_request(run):
    served = run["procs"][0]["served"]
    assert not served["late"]["ok"]
    assert "deadline" in served["late"]["error"]
    assert not served["failed"]["ok"]
    assert "injected" in served["failed"]["error"]
    assert served["fired"] == [True]
    for key, r in (("after", 2), ("direct", 3)):
        res = served[key]
        assert res["ok"], res["error"]
        e0, f0, _ = run["ref"][r]
        _dp_gate(res["energy"], res["forces"], e0[0], f0[0])
    m = served["metrics"]
    assert m["late"] == (0, 0, 1) and m["fail"] == (0, 1, 0)
    assert m["after"] == (1, 0, 0)
    assert all(m[f"t{r}"] == (1, 0, 0) for r in range(BUCKET))


def test_an_idle_server_keeps_its_followers(run):
    """The followers give up on a header after 4 s; after 5 s idle the
    request is served, with the bits the same request got before."""
    served = run["procs"][0]["served"]
    res, before = served["idle"], served["after"]
    assert res["ok"], res["error"]
    assert torch.equal(res["energy"], before["energy"])
    assert torch.equal(res["forces"], before["forces"])
    assert served["metrics"]["idle"] == (1, 0, 0)


def test_a_failure_after_the_broadcast_raises_everywhere(run):
    p0 = run["procs"][0]["broken"]
    assert not p0["result"]["ok"]
    assert "after its broadcast" in p0["result"]["error"]
    assert p0["stop"].startswith("ServeGroupBroken")
    assert p0["submit"].startswith("ServeGroupBroken")
    assert "injected after the broadcast" in \
        run["procs"][3]["broken"]["follow"]
    for out in run["procs"][1:3]:
        assert out["broken"]["follow"], "a follower's loop did not raise"


def test_stop_raises_for_a_dispatch_that_fails_after_it_gave_up(run):
    """``stop`` waits for a dispatch still in flight over the mesh after
    its drain timeout, and raises when that dispatch fails."""
    out = run["late_failure"]
    assert out["stop"].startswith("ServeGroupBroken"), out["stop"]
    assert "injected after the broadcast" in out["stop"]
    assert not out["result"].ok


def test_a_mesh_that_does_not_divide_the_bucket_is_refused(run):
    for out in run["procs"]:
        assert out["refused"].startswith("ValueError")
        assert "2 replica shards, which do not divide the batch bucket 1" \
            in out["refused"]
