"""The port's force serving (``repro_torch.serve``, ``launch/serve.py
--backend force``) on the CPU, the cases of ``tests/test_serve.py``:

* protocol conformance of the local, batched and remote providers; bucket
  choice; ``pad_group``'s layout, exactly;
* padded-bucket parity: a heterogeneous 3-request batch padded to a batch
  bucket of 4 against JAX ``single_domain_forces`` per request (E rtol
  1e-5, F atol 1e-5 x max|F|), padding atoms and the all-padding row
  exactly zero; the same dispatch reaches the model once;
* the server: concurrent tenants, an expired deadline, a full queue and a
  ``serve_fail`` each failing only their own request or batch, a
  ``serve_delay``, ``evaluate_direct`` and ``warmup``; the
  ``pipeline_executor_factory`` route at batch 2 x 4 virtual ranks, and
  its refusal of a process mesh whose replica shards do not divide the
  batch bucket (serving over processes: ``tests/test_torch_serve_procs.py``);
* acceptance: ``MDEngine`` through ``RemoteForceProvider`` == the local
  ``DeepmdForceProvider`` (forces, then a 10-step trajectory).

The reference's ``jax.pure_callback`` route has no counterpart (the port
runs eagerly).  Adds about 25 s to tier-1.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ddinfer import single_domain_forces as jsdf
from repro.dp import DPConfig as JConfig
from repro.dp import DPModel as JModel
from repro.dp import DescriptorConfig as JDesc
from repro_torch import bridge
from repro_torch.backend import (ForceBackend, ForceRequest,
                                 StatefulForceBackend)
from repro_torch.core import (DeepmdForceProvider, make_padded_batch_fn,
                              single_domain_forces, suggest_config)
from repro_torch.dp import DPModel
from repro_torch.ensemble import BatchedDeepmdProvider
from repro_torch.health import FaultPlan, FaultSpec
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.mesh import DDMesh, EnsembleMesh
from repro_torch.md import (EngineConfig, MDEngine, build_solvated_protein,
                            mark_nn_group)
from repro_torch.serve import (BucketingConfig, ForceServer,
                               RemoteForceProvider, ServeConfig,
                               ServerOverloaded, choose_bucket, pad_group,
                               pipeline_executor_factory)

torch.set_num_threads(1)

RNG = np.random.default_rng(7)


@pytest.fixture(scope="module")
def model_params():
    desc = JDesc(kind="dpa1", rcut=0.6, rcut_smth=0.3, sel=32, ntypes=4,
                 neuron=(8, 16), axis_neuron=4, attn_layers=1,
                 attn_hidden=16, attn_heads=2)
    jmodel = JModel(JConfig(descriptor=desc, fitting_neuron=(16, 16)))
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    model = DPModel(bridge.config_to_torch(jmodel.cfg), device="cpu")
    params = bridge.params_to_torch(jax.device_get(jparams), "cpu")
    return model, params, jmodel, jparams


def _random_request(n, box_l=2.5, tenant="t"):
    return ForceRequest(
        positions=torch.tensor(RNG.uniform(0, box_l, (n, 3)).astype(
            np.float32)),
        box=torch.full((3,), box_l),
        types=torch.tensor(RNG.integers(0, 4, n).astype(np.int32)),
        tenant=tenant)


# -- protocol conformance ---------------------------------------------------

def test_protocol_isinstance(model_params):
    model, params = model_params[:2]
    n = 24
    types = RNG.integers(0, 4, n).astype(np.int32)
    box = np.full(3, 2.5, np.float32)
    local = DeepmdForceProvider(model, params, np.arange(n), types, box, n,
                                nbr_capacity=48, device="cpu")
    assert isinstance(local, ForceBackend)
    assert isinstance(local, StatefulForceBackend)
    assert local.batched is False and local.host_side is False
    batched = BatchedDeepmdProvider(model, params, np.arange(n), types, box,
                                    n, n_replicas=2, nbr_capacity=48,
                                    device="cpu")
    assert isinstance(batched, ForceBackend) and batched.batched is True
    server = ForceServer(model, params, ServeConfig(
        atom_buckets=(32,), batch_buckets=(1, 2), nbr_capacity=48))
    try:
        remote = RemoteForceProvider(server, np.arange(n), types, box, n)
        assert isinstance(remote, ForceBackend)
        assert not isinstance(remote, StatefulForceBackend)
        assert remote.host_side is True and remote.stateful is False
    finally:
        server.stop()


# -- bucketing / padding ----------------------------------------------------

def test_choose_bucket():
    assert choose_bucket(1, (64, 128)) == 64
    assert choose_bucket(64, (64, 128)) == 64
    assert choose_bucket(65, (64, 128)) == 128
    with pytest.raises(ValueError):
        choose_bucket(129, (64, 128))
    with pytest.raises(ValueError):
        BucketingConfig(atom_buckets=(128, 64))


def test_pad_group_layout():
    reqs = [_random_request(24), _random_request(17)]
    coords, types, mask, box = pad_group(reqs, 32, (1, 2, 4))
    assert coords.shape == (2, 32, 3) and types.shape == (2, 32)
    np.testing.assert_array_equal(mask[0], [1.0] * 24 + [0.0] * 8)
    np.testing.assert_array_equal(mask[1], [1.0] * 17 + [0.0] * 15)
    np.testing.assert_array_equal(coords[0, :24], reqs[0].positions.numpy())
    np.testing.assert_array_equal(types[1, :17], reqs[1].types.numpy())
    assert (coords[0, 24:] == 0).all() and (types[0, 24:] == 0).all()
    np.testing.assert_array_equal(box, np.full((2, 3), 2.5, np.float32))


def test_padded_bucket_parity(model_params, monkeypatch):
    """A padded heterogeneous batch (3 requests in batch bucket 4) against
    JAX's per-request single-domain forces, in one model call."""
    model, params, jmodel, jparams = model_params
    reqs = [_random_request(24), _random_request(40), _random_request(64)]
    n_bucket, cap = 64, 48
    fn = make_padded_batch_fn(model, n_bucket, cap)
    coords, types, mask, box = pad_group(reqs, n_bucket, (1, 2, 4))
    assert coords.shape[0] == 4
    calls = []
    atomic_e = model._atomic_e
    monkeypatch.setattr(model, "_atomic_e",
                        lambda *a, **k: calls.append(1) or atomic_e(*a, **k))
    e, f, ovf = fn(params, *map(torch.tensor, (coords, types, mask, box)))
    assert len(calls) == 1 and not ovf.any()
    ref_fn = jax.jit(lambda c, t, b: jsdf(jmodel, jparams, c, t, b, cap))
    for i, req in enumerate(reqs):
        n = req.n_atoms
        e_ref, f_ref = ref_fn(jnp.asarray(req.positions.numpy()),
                              jnp.asarray(req.types.numpy()),
                              jnp.asarray(req.box.numpy()))
        scale = max(float(jnp.abs(f_ref).max()), 1e-8)
        np.testing.assert_allclose(float(e[i]), float(e_ref), rtol=1e-5,
                                   atol=1e-5 * max(abs(float(e_ref)), 1.0))
        np.testing.assert_allclose(f[i, :n].numpy(), np.asarray(f_ref),
                                   rtol=1e-5, atol=1e-5 * scale)
        if n < n_bucket:
            assert float(f[i, n:].abs().max()) == 0.0
    assert float(f[3].abs().max()) == 0.0 and bool(torch.isfinite(e[3]))


# -- server: batching, metrics, degradation ---------------------------------

def test_server_concurrent_tenants(model_params):
    model, params = model_params[:2]
    server = ForceServer(model, params, ServeConfig(
        atom_buckets=(32,), batch_buckets=(1, 2, 4), nbr_capacity=48,
        batch_window_s=0.005))
    try:
        server.warmup()
        ref = server.compute(_random_request(24))
        assert ref.ok
        results = {}

        def client(tid, n_req=4):
            results[tid] = [server.compute(_random_request(
                24, tenant=f"t{tid}")) for _ in range(n_req)]

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(r.ok for out in results.values() for r in out)
        snap = server.metrics.snapshot()
        for tid in range(3):
            s = snap[f"t{tid}"]
            assert s["submitted"] == s["completed"] == 4
            assert s["timeouts"] == s["errors"] == s["rejected"] == 0
            assert s["mean_latency_s"] > 0 and s["p99_latency_s"] > 0
        assert max(r.diagnostics["batch_size"]
                   for out in results.values() for r in out) >= 1
        totals = server.metrics.totals()
        assert totals["completed"] == 13 and totals["queue_depth"] == 0
    finally:
        server.stop()


def test_served_result_equals_direct_evaluation(model_params):
    """A request served in a batch of 2 against ``evaluate_direct`` on the
    same request (the B = 1 bucket), at the DP gate."""
    model, params = model_params[:2]
    server = ForceServer(model, params, ServeConfig(
        atom_buckets=(32, 64), batch_buckets=(1, 2), nbr_capacity=48,
        batch_window_s=0.2))
    try:
        reqs = [_random_request(24, tenant="a"), _random_request(30,
                                                                tenant="b")]
        futs = [server.submit(r) for r in reqs]
        got = [fut.result(30.0) for fut in futs]
        assert [g.diagnostics["batch_size"] for g in got] == [2, 2]
        for req, res in zip(reqs, got):
            direct = server.evaluate_direct(req)
            assert direct.diagnostics["batch_bucket"] == 1
            fmax = float(direct.forces.abs().max())
            np.testing.assert_allclose(float(res.energy),
                                       float(direct.energy), rtol=1e-5)
            np.testing.assert_allclose(res.forces.numpy(),
                                       direct.forces.numpy(), rtol=0,
                                       atol=1e-4 * fmax)
    finally:
        server.stop()


def test_server_deadline_and_backpressure(model_params):
    model, params = model_params[:2]
    server = ForceServer(model, params, ServeConfig(
        atom_buckets=(32,), batch_buckets=(1, 2), nbr_capacity=48,
        queue_bound=1, batch_window_s=0.001))
    try:
        server.compute(_random_request(8))
        # an expired deadline degrades to ok=False without wedging the server
        req = _random_request(8, tenant="late")
        req.deadline = time.monotonic() - 1.0
        res = server.submit(req).result(10.0)
        assert not res.ok and "deadline" in res.error
        assert server.metrics.tenant("late").timeouts == 1
        # stall the evaluator so the bounded queue fills -> ServerOverloaded
        real_fn = server._bucket_fn(32, 1)
        release = threading.Event()

        def slow_fn(*args):
            release.wait(10.0)
            return real_fn(*args)

        for b in server.config.batch_buckets:
            server._fns[(32, b)] = slow_fn
        futs = [server.submit(_random_request(8, tenant="burst"))]
        time.sleep(0.2)  # let the worker take it and block in slow_fn
        futs.append(server.submit(_random_request(8, tenant="burst")))
        with pytest.raises(ServerOverloaded):
            server.submit(_random_request(8, tenant="burst"))
        assert server.metrics.tenant("burst").rejected == 1
        release.set()
        assert all(f.result(20.0).ok for f in futs)
        # an oversized request is rejected per request, not fatally
        big = server.compute(_random_request(50, tenant="big"))
        assert not big.ok and "exceeds" in big.error
    finally:
        server.stop()


def test_serve_faults_fail_only_their_batch(model_params):
    """``serve_fail`` on the 2nd dispatch errors that batch's request only;
    ``serve_delay`` on the 3rd slows it and it still succeeds."""
    model, params = model_params[:2]
    plan = FaultPlan([FaultSpec("serve_fail", nth=2),
                      FaultSpec("serve_delay", nth=3, delay_s=0.05)])
    server = ForceServer(model, params, ServeConfig(
        atom_buckets=(32,), batch_buckets=(1,), nbr_capacity=48),
        fault_plan=plan)
    try:
        out = [server.compute(_random_request(16, tenant="f"))
               for _ in range(4)]
        assert [r.ok for r in out] == [True, False, True, True]
        assert "injected" in out[1].error
        assert all(s.fired for s in plan.faults)
        m = server.metrics.tenant("f")
        assert m.errors == 1 and m.completed == 3
        assert out[2].diagnostics["latency_s"] >= 0.05
    finally:
        server.stop()


def test_pipeline_executor_route(model_params):
    """``pipeline_executor_factory`` at batch 2 x 4 virtual ranks (one
    replica-batched ForcePipeline per bucket): two requests of the shared
    system against the single-domain forces."""
    model, params = model_params[:2]
    n, box_l = 96, 2.5
    box = np.full(3, box_l, np.float32)
    types = RNG.integers(0, 4, n).astype(np.int32)
    pos = [RNG.uniform(0, box_l, (n, 3)).astype(np.float32) for _ in range(2)]
    factory = pipeline_executor_factory(
        model, box, types,
        lambda nb, ranks: suggest_config(nb, box, ranks, 0.6,
                                         nbr_capacity=48, slack=2.5,
                                         force_mode="ghost_reduce",
                                         coords=pos[0]),
        ranks_for=lambda b: 4)
    server = ForceServer(model, params, ServeConfig(
        atom_buckets=(n,), batch_buckets=(2,), nbr_capacity=48,
        batch_window_s=0.2), executor_factory=factory)
    try:
        reqs = [ForceRequest(positions=torch.tensor(p), box=torch.tensor(box),
                             types=torch.tensor(types)) for p in pos]
        futs = [server.submit(r) for r in reqs]
        got = [fut.result(60.0) for fut in futs]
        pipe = server._fns[(n, 2)].pipeline
        assert pipe.n_replicas == 2 and pipe.cfg.n_ranks == 4
        for p, res in zip(pos, got):
            assert res.ok and res.diagnostics["batch_size"] == 2
            e_ref, f_ref = single_domain_forces(
                model, params, torch.tensor(p), torch.tensor(types),
                torch.tensor(box), 48)
            np.testing.assert_allclose(float(res.energy), float(e_ref),
                                       rtol=1e-5)
            np.testing.assert_allclose(res.forces.numpy(), f_ref.numpy(),
                                       rtol=0, atol=1e-4)
    finally:
        server.stop()
    # over a process mesh: a mesh whose replica shards do not divide its
    # batch bucket is refused when the server builds it (no group needed
    # to build this one by hand: the check comes first)
    three = EnsembleMesh(DDMesh(None, 1, 0, torch.device("cpu"), 4, "gloo"),
                         None, 3, 0, 0)
    over = pipeline_executor_factory(model, box, types, None,
                                     mesh_for=lambda b: three)
    with pytest.raises(ValueError, match="3 replica shards, which do not "
                                         "divide the batch bucket 2"):
        ForceServer(model, params, ServeConfig(atom_buckets=(n,),
                                               batch_buckets=(2,)),
                    executor_factory=over)
    with pytest.raises(ValueError, match="ranks_for and mesh_for"):
        pipeline_executor_factory(model, box, types, None,
                                  ranks_for=lambda b: 4,
                                  mesh_for=lambda b: three)


# -- acceptance: MDEngine through the served backend ------------------------

def test_engine_through_remote_matches_local(model_params):
    model, params = model_params[:2]
    system, pos, nn_idx = build_solvated_protein(
        6, water_per_protein_atom=2.0, device="cpu")
    system = mark_nn_group(system, nn_idx)
    local = DeepmdForceProvider(model, params, nn_idx, system.types,
                                system.box, system.n_atoms, nbr_capacity=48,
                                device="cpu")
    server = ForceServer(model, params, ServeConfig(
        atom_buckets=(32, 64), batch_buckets=(1, 2), nbr_capacity=48))
    try:
        remote = RemoteForceProvider(server, nn_idx, system.types,
                                     system.box, system.n_atoms,
                                     tenant="engine")
        res_l = local.compute(ForceRequest(positions=pos, box=system.box))
        res_r = remote.compute(ForceRequest(positions=pos, box=system.box))
        scale = max(float(res_l.forces.abs().max()), 1e-8)
        np.testing.assert_allclose(float(res_r.energy), float(res_l.energy),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res_r.forces.numpy(), res_l.forces.numpy(),
                                   rtol=1e-5, atol=1e-5 * scale)
        cfg = EngineConfig(cutoff=0.9, neighbor_capacity=96, dt=0.0005,
                           thermostat_t=200.0)
        eng_l = MDEngine(system, cfg, special_force=local)
        eng_r = MDEngine(system, cfg, special_force=remote)
        assert eng_r._host_special and not eng_l._host_special
        st_l = eng_l.run(eng_l.init_state(pos, 200.0), 10)
        st_r = eng_r.run(eng_r.init_state(pos, 200.0), 10)
        assert bool(torch.isfinite(st_r.positions).all())
        np.testing.assert_allclose(st_r.positions.numpy(),
                                   st_l.positions.numpy(), rtol=1e-5,
                                   atol=1e-5)
        m = server.metrics.tenant("engine")
        assert m.completed == m.submitted and m.errors == 0
    finally:
        server.stop()


def test_force_backend_entry_point_runs_on_cpu():
    res = launch_serve.main(["--backend", "force", "--device", "cpu",
                             "--reduced", "--clients", "2", "--steps", "2",
                             "--protein-atoms", "4"])
    assert res["totals"]["completed"] == res["totals"]["submitted"] == 4
    assert set(res["snapshot"]) == {"sim0", "sim1"}
