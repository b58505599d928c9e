"""One process of ``tests/test_torch_serve_procs.py``'s gloo group on the
CPU.

    python tests/serve_procs_worker.py TASK RANK

``TASK`` is a ``torch.save``d dict written by the test (world size,
rendezvous file, model, params, the requests' positions, the DD
configuration); the process joins the group through ``file://``
rendezvous and builds a ``pipeline_executor_factory`` over a ``(2, 2)``
``(replica x dd)`` mesh (``ensemble.make_ensemble_mesh``) for the batch
bucket of 4.  Process 0 runs a ``ForceServer`` over it (a warm-up, one
batch of 4, an expired deadline, a ``serve_fail``, a request after it,
``evaluate_direct``, an idle spell longer than the followers' header
timeout, the request after the fault again, ``stop``); the others run
``follow_dispatches``.  A
second server then breaks after a broadcast (process 3's executor
raises), and every process records what it raised.  The results go to
``TASK.out<RANK>`` for the test.  Imports no JAX.
"""
import datetime
import sys
import time

import torch
import torch.distributed as dist

from repro_torch.backend import ForceRequest
from repro_torch.dp import DPModel
from repro_torch.ensemble import make_ensemble_mesh
from repro_torch.health import FaultPlan, FaultSpec
from repro_torch.serve import (ForceServer, ServeConfig, follow_dispatches,
                               pipeline_executor_factory)

SHARDS, RANKS, BUCKET = 2, 4, 4
# a follower waits FOLLOW_S for each header (process 0 sends a keep-alive
# header after an eighth of it idle); process 0 once idles IDLE_S
FOLLOW_S, IDLE_S = 4.0, 5.0


def _error(fn) -> str:
    """The type and message of the error ``fn()`` raises ("" if none)."""
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 — recorded for the test
        return f"{type(exc).__name__}: {exc}"
    return ""


def factory_for(task, model, timeout):
    def mesh_for(b):
        return make_ensemble_mesh(SHARDS, RANKS, device="cpu",
                                  timeout=timeout)
    return pipeline_executor_factory(
        model, task["box"], task["types"], lambda nb, ranks: task["cfg"],
        mesh_for=mesh_for,
        follow_timeout=datetime.timedelta(seconds=FOLLOW_S))


def request(task, r, **kw):
    return ForceRequest(positions=torch.tensor(task["pos"][r]),
                        box=torch.tensor(task["box"]),
                        types=torch.tensor(task["types"]), **kw)


def result(res) -> dict:
    return {"ok": res.ok, "error": res.error, "energy": res.energy,
            "forces": res.forces, "diagnostics": {
                k: v for k, v in res.diagnostics.items() if k != "latency_s"}}


def serve(task, model, params, factory) -> dict:
    """Process 0: the server's sequence of requests (see the module)."""
    n = len(task["types"])
    plan = FaultPlan([FaultSpec("serve_fail", nth=2)])
    factory.kept = []
    server = ForceServer(model, params, ServeConfig(
        atom_buckets=(n,), batch_buckets=(BUCKET,), batch_window_s=0.5,
        nbr_capacity=task["cfg"].nbr_capacity), executor_factory=factory,
        fault_plan=plan)
    out = {}
    try:
        server.warmup()
        futs = [server.submit(request(task, r, tenant=f"t{r}"))
                for r in range(BUCKET)]
        out["batch"] = [result(f.result(60.0)) for f in futs]
        late = request(task, 0, tenant="late",
                       deadline=time.monotonic() - 1.0)
        out["late"] = result(server.submit(late).result(60.0))
        out["failed"] = result(server.compute(request(task, 1,
                                                      tenant="fail")))
        out["after"] = result(server.compute(request(task, 2,
                                                     tenant="after")))
        out["direct"] = result(server.evaluate_direct(request(task, 3)))
        time.sleep(IDLE_S)
        out["idle"] = result(server.compute(request(task, 2, tenant="idle")))
        out["fired"] = [s.fired for s in plan.faults]
    finally:
        server.stop()
    out["kept"] = factory.kept
    out["metrics"] = {t: (m["completed"], m["errors"], m["timeouts"])
                      for t, m in server.metrics.snapshot().items()}
    return out


def broken(task, model, params, factory, rank) -> dict:
    """A second server whose dispatch fails after its broadcast: process
    3's executor raises there; what each process then raises."""
    out = {}
    if rank == 0:
        server = ForceServer(model, params, ServeConfig(
            atom_buckets=(len(task["types"]),), batch_buckets=(BUCKET,),
            batch_window_s=0.0, nbr_capacity=task["cfg"].nbr_capacity),
            executor_factory=factory)
        res = server.compute(request(task, 0, tenant="broken"))
        out["result"] = result(res)
        out["stop"] = _error(server.stop)
        out["submit"] = _error(lambda: server.submit(request(task, 1)))
        return out
    if rank == 3:
        real = factory.pipeline_fn

        def failing(nb, b):
            def fn(*args):
                raise RuntimeError("injected after the broadcast")
            real(nb, b)
            return fn

        factory.pipeline_fn = failing
    out["follow"] = _error(lambda: follow_dispatches(factory, params,
                                                     (BUCKET,)))
    return out


def main(task_path: str, rank: int) -> None:
    torch.set_num_threads(1)
    task = torch.load(task_path, weights_only=False)
    timeout = datetime.timedelta(seconds=task["timeout_s"])
    dist.init_process_group(
        "gloo", init_method=f"file://{task['rendezvous']}", rank=rank,
        world_size=task["world"], timeout=timeout)
    model = DPModel(task["model_cfg"], device="cpu")
    params = task["params"]
    out = {}
    try:
        # a mesh of 2 replica shards for the batch bucket of 1 is refused
        # on every process, before any server starts
        out["refused"] = _error(lambda: factory_for(
            task, model, timeout).prepare((1,)))
        factory = factory_for(task, model, timeout)
        if rank == 0:
            out["served"] = serve(task, model, params, factory)
        else:
            out["kept"] = follow_dispatches(factory, params, (BUCKET,),
                                            keep=True)
        out["mesh"] = tuple(factory.meshes[BUCKET].shape.items())
        out["broken"] = broken(task, model, params,
                               factory_for(task, model, timeout), rank)
        torch.save(out, f"{task_path}.out{rank}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
