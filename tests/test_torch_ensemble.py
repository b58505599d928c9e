"""The port's ensemble subsystem (``repro_torch.ensemble``, ``launch/remd.py``)
on the CPU:

* against JAX: the exchange move given JAX's uniform draws (the Metropolis
  cases of ``tests/test_ensemble.py`` and a draw-dependent ladder over four
  attempts): the same ladders, velocities and statistics; the geometric
  ladder; ``EnsembleEngine`` with the DP special force and exchanges
  against JAX's engine from JAX's ``init_state``: positions within 1e-5 nm,
  on an equal-rung ladder and on an unequal one fed JAX's draws (the
  energies and parity of every attempt, the rescaled velocities, the
  counts, one attempt rejecting);
* inside the port, bit for bit: a batched run with exchange off == R
  independent ``MDEngine`` runs (classical, and with the stateful DP
  provider), step mode == scan, a ``replica=1`` fault recovered with only
  replica 1 tripped (``[0, 1, 0]``) and the fault-free bits;
* state round trips, per-replica exchange streams, checkpoint and restore,
  capacity growth, and ``launch/remd.py --device cpu``;
* 2 replicas x 4 virtual ranks: a rank fault on one replica recovered with
  only that replica tripped, on the fault-free bits.

The system is the 5-residue solvated protein (83 atoms, 20 DP atoms) with
the paper's DPA-1 at ``sel=32`` (the DD case: 64 residues, a narrow
DPA-1).  Adds about 80 s to tier-1 (JAX's two ensemble runs about 35 s
of it).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dp import DPModel as JModel
from repro.dp import paper_dpa1_config as jpaper
from repro.ensemble import BatchedDeepmdProvider as JBatched
from repro.ensemble import EnsembleConfig as JEnsConfig
from repro.ensemble import EnsembleEngine as JEnsemble
from repro.ensemble import ReplicaState as JReplicaState
from repro.ensemble import geometric_ladder as jladder
from repro.ensemble import make_exchange_fn as jexchange
from repro.md import EngineConfig as JConfig
from repro.md import build_solvated_protein as jbuild
from repro.md import mark_nn_group as jmark
from repro_torch import bridge
from repro_torch.core import DeepmdForceProvider
from repro_torch.dp import DPModel
from repro_torch.ensemble import (BatchedDeepmdProvider, EnsembleConfig,
                                  EnsembleEngine, ReplicaState,
                                  geometric_ladder, make_exchange_fn,
                                  replica_state, stack_states, velocity_scale)
from repro_torch.health import FaultPlan, FaultSpec, GuardConfig
from repro_torch.launch import remd
from repro_torch.md import EngineConfig, MDEngine

torch.set_num_threads(1)

_CFG = dict(cutoff=0.9, neighbor_capacity=96, dt=0.0005)
FIELDS = ("positions", "velocities", "forces", "step", "ladder")


def _same(a, b, fields=FIELDS):
    return all(torch.equal(getattr(a, k), getattr(b, k)) for k in fields)


# ---------------------------------------------------------------------------
# the exchange move against JAX's, given JAX's draws
# ---------------------------------------------------------------------------

def _jax_state(r, n=4, seed=0):
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(seed, seed + r))
    vel = jnp.asarray(np.random.default_rng(seed).uniform(
        0.5, 1.5, (r, n, 3)).astype(np.float32))
    return JReplicaState(
        positions=jnp.zeros((r, n, 3)), velocities=vel,
        forces=jnp.zeros((r, n, 3)), step=jnp.zeros(r, jnp.int32),
        rng=keys, ladder=jnp.arange(r, dtype=jnp.int32))


def _jax_uniforms(rng):
    """The draw each replica's stream gives at an attempt (the JAX move's
    own split-and-draw)."""
    keys = jax.vmap(jax.random.split)(rng)
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(k, ()))(
        keys[:, 1]))


def _port_state(js):
    r = js.positions.shape[0]
    return ReplicaState(
        positions=torch.tensor(np.asarray(js.positions)),
        velocities=torch.tensor(np.asarray(js.velocities)),
        forces=torch.tensor(np.asarray(js.forces)),
        step=torch.tensor(np.asarray(js.step)),
        rng=torch.stack([torch.Generator().manual_seed(k).get_state()
                         for k in range(r)]),
        ladder=torch.tensor(np.asarray(js.ladder)))


EXCHANGE_CASES = {
    # (temperature table, energies, attempts): tests/test_ensemble.py's
    # Metropolis cases, then a ladder whose accepts depend on the draws
    "equal_temps": ([300.0] * 4, [10.0, -5.0, 3.0, 7.0], 1),
    "enormous_penalty": ([10.0, 1000.0], [-1e4, 1e4], 1),
    "metropolis_sign": ([200.0, 400.0], [100.0, -100.0], 1),
    "streams": (list(jladder(300.0, 400.0, 3)), [5.0, 1.0, -3.0], 4),
    "draw_dependent": (list(jladder(300.0, 420.0, 4)),
                       [-20.0, -18.5, -19.0, -17.0], 6),
}


@pytest.mark.parametrize("case", sorted(EXCHANGE_CASES))
def test_exchange_matches_jax_given_its_draws(case):
    temps, energies, attempts = EXCHANGE_CASES[case]
    r = len(temps)
    jex, tex = jexchange(jnp.asarray(temps)), make_exchange_fn(temps)
    js = _jax_state(r, seed=11)
    ts = _port_state(js)
    e = jnp.asarray(energies, jnp.float32)
    for attempt in range(attempts):
        u = _jax_uniforms(js.rng)
        js, jstats = jex(js, e, jnp.int32(attempt % 2))
        ts, tstats = tex(ts, torch.tensor(energies), attempt % 2,
                         u=torch.tensor(u))
        np.testing.assert_array_equal(ts.ladder.numpy(), np.asarray(js.ladder))
        np.testing.assert_array_equal(ts.velocities.numpy(),
                                      np.asarray(js.velocities))
        assert tstats["attempted"] == int(jstats["attempted"])
        assert tstats["accepted"] == int(jstats["accepted"])
        for k in ("pair_attempts", "pair_accepts"):
            np.testing.assert_array_equal(tstats[k].numpy(),
                                          np.asarray(jstats[k]))
    assert sorted(ts.ladder.tolist()) == list(range(r))


def test_velocity_scale_is_correctly_rounded():
    # the exchange's rescale against np.sqrt (IEEE, as jnp.sqrt) bit for
    # bit, over ratios of ladder temperatures and seeded ratios near 1
    rng = np.random.default_rng(7)
    temps = rng.uniform(250.0, 700.0, 40).astype(np.float32)
    ratio = np.concatenate([
        (temps[:, None] / temps[None, :]).ravel(),
        rng.uniform(0.5, 2.0, 400).astype(np.float32)]).astype(np.float32)
    got = velocity_scale(torch.from_numpy(ratio))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.sqrt(ratio))


def test_geometric_ladder_equals_jax():
    for args in ((300.0, 600.0, 4), (300.0, 420.0, 5), (250.0, 250.0, 1)):
        assert geometric_ladder(*args) == jladder(*args)


def test_exchange_streams_advance_once_per_attempt():
    """The port's own draws: the same seeds give the same accept/reject
    sequence, and every replica's stream advances on every attempt, paired
    or not (R = 3: one replica sits out each attempt)."""
    ex = make_exchange_fn(geometric_ladder(300.0, 400.0, 3))
    e = torch.tensor([5.0, 1.0, -3.0])
    outs = []
    for _ in range(2):
        st = _port_state(_jax_state(3, seed=11))
        rngs = [st.rng]
        for attempt in range(4):
            st, _ = ex(st, e, attempt % 2)
            rngs.append(st.rng)
        outs.append((st.ladder, st.rng))
        for a, b in zip(rngs, rngs[1:]):
            assert all(not torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

LADDER = (300.0, 330.0, 365.0)
LADDER_STEPS = 16


@pytest.fixture(scope="module")
def small():
    """The JAX and port systems, models and params, and JAX's ensemble runs
    (DP special force, skin 0.08, exchange every 2 steps): on an equal-rung
    ladder, where every attempt swaps whatever the draws, and on the
    unequal ladder ``LADDER``, where JAX's engine records each attempt's
    energies, parity and per-replica uniform draws (7 of its 8 attempts
    accept: the ladder moves and one attempt rejects)."""
    system, pos, nn = jbuild(5, water_per_protein_atom=1.5)
    system = jmark(system, nn)
    model = JModel(jpaper(ntypes=4, rcut=0.6, sel=32))
    params = model.init_params(jax.random.PRNGKey(0))
    prov = JBatched(model, params, nn, system.types, system.box,
                    system.n_atoms, n_replicas=3, nbr_capacity=48, skin=0.08)
    eng = JEnsemble(system, JConfig(thermostat_t=300.0, **_CFG),
                    JEnsConfig(n_replicas=3, temps=(300.0,) * 3,
                               exchange_interval=2), special_force=prov)
    st0 = eng.init_state(pos)
    st = eng.run(st0, 8)
    ueng = JEnsemble(system, JConfig(thermostat_t=300.0, **_CFG),
                     JEnsConfig(n_replicas=3, temps=LADDER,
                                exchange_interval=2),
                     special_force=JBatched(model, params, nn, system.types,
                                            system.box, system.n_atoms,
                                            n_replicas=3, nbr_capacity=48,
                                            skin=0.08))
    attempts, jex_fn = [], ueng._exchange_fn

    def recorded(state, energies, parity):
        attempts.append((np.asarray(energies), int(parity),
                         _jax_uniforms(state.rng)))
        return jex_fn(state, energies, parity)

    ueng._exchange_fn = recorded
    ust0 = ueng.init_state(pos)
    ust = ueng.run(ust0, LADDER_STEPS)
    tsys = bridge.system_to_torch(jax.tree.map(np.asarray, system), "cpu")
    return {"nn": nn, "system": tsys,
            "pos": torch.tensor(np.asarray(pos)),
            "model": DPModel(bridge.config_to_torch(model.cfg), device="cpu"),
            "params": bridge.params_to_torch(jax.device_get(params), "cpu"),
            "jax": (jax.tree.map(np.asarray, st0),
                    jax.tree.map(np.asarray, st),
                    {k: eng.diagnostics[k] for k in
                     ("exchange_attempts", "exchange_accepts")}),
            "jax_ladder": (jax.tree.map(np.asarray, ust0),
                           jax.tree.map(np.asarray, ust), attempts,
                           {k: np.asarray(ueng.diagnostics[k]) for k in
                            ("exchange_attempts", "exchange_accepts",
                             "pair_attempts", "pair_accepts")})}


def _batched_provider(small, r, skin=0.08):
    s = small["system"]
    return BatchedDeepmdProvider(small["model"], small["params"], small["nn"],
                                 s.types, s.box, s.n_atoms, n_replicas=r,
                                 nbr_capacity=48, skin=skin, device="cpu")


def test_ensemble_matches_jax_engine(small):
    """The DP ensemble with exchanges, from JAX's init_state (positions,
    velocities, ladder; the streams are the port's), against JAX's run."""
    st0, want, diag = small["jax"]
    eng = EnsembleEngine(small["system"],
                         EngineConfig(thermostat_t=300.0, **_CFG),
                         EnsembleConfig(n_replicas=3, temps=(300.0,) * 3,
                                        exchange_interval=2),
                         special_force=_batched_provider(small, 3))
    start = ReplicaState(
        **{k: torch.tensor(getattr(st0, k)) for k in FIELDS},
        rng=torch.stack([torch.Generator().manual_seed(k).get_state()
                         for k in range(3)]))
    got = eng.run(start, 8)
    assert float(np.abs(got.positions.numpy() - want.positions).max()) <= 1e-5
    vmax = float(np.abs(want.velocities).max())
    assert float(np.abs(got.velocities.numpy()
                        - want.velocities).max()) <= 1e-5 * vmax
    np.testing.assert_array_equal(got.ladder.numpy(), want.ladder)
    assert got.step.tolist() == want.step.tolist() == [8] * 3
    assert {k: eng.diagnostics[k] for k in diag} == diag
    assert diag["exchange_attempts"] == diag["exchange_accepts"] == 4


def test_ensemble_exchanges_match_jax_engine_on_unequal_ladder(small):
    """The engine's exchange wiring against JAX's on an unequal ladder,
    given JAX's draws (fed through the exchange's ``u``): at every attempt
    the same parity and energies (rtol 1e-5 of the ~1e2-1e3 kJ/mol totals)
    and the same ladder after it; at the end positions within 1e-5 nm,
    velocities (rescaled toward each replica's rung) within 1e-5 x max|v|,
    and equal attempt, accept and per-pair counts (one attempt rejects)."""
    st0, want, attempts, diag = small["jax_ladder"]
    eng = EnsembleEngine(small["system"],
                         EngineConfig(thermostat_t=300.0, **_CFG),
                         EnsembleConfig(n_replicas=3, temps=LADDER,
                                        exchange_interval=2),
                         special_force=_batched_provider(small, 3))
    seen, ex = [], eng._exchange_fn

    def fed(state, energies, parity):
        e_j, parity_j, u = attempts[len(seen)]
        out = ex(state, energies, parity, u=torch.tensor(u))
        seen.append((energies, parity, parity_j, e_j, out[0].ladder))
        return out

    eng._exchange_fn = fed
    start = ReplicaState(
        **{k: torch.tensor(getattr(st0, k)) for k in FIELDS},
        rng=torch.stack([torch.Generator().manual_seed(k).get_state()
                         for k in range(3)]))
    got = eng.run(start, LADDER_STEPS)
    assert len(seen) == len(attempts) == LADDER_STEPS // 2
    ladders = [st0.ladder]
    for e, parity, parity_j, e_j, ladder in seen:
        assert parity == parity_j
        np.testing.assert_allclose(torch.as_tensor(e).numpy(), e_j,
                                   rtol=1e-5)
        ladders.append(ladder.numpy())
    assert len({tuple(x) for x in ladders}) > 1     # the ladder moved
    np.testing.assert_array_equal(got.ladder.numpy(), want.ladder)
    assert float(np.abs(got.positions.numpy() - want.positions).max()) <= 1e-5
    vmax = float(np.abs(want.velocities).max())
    assert float(np.abs(got.velocities.numpy()
                        - want.velocities).max()) <= 1e-5 * vmax
    for k, v in diag.items():
        np.testing.assert_array_equal(np.asarray(eng.diagnostics[k]), v)
    assert 0 < int(diag["exchange_accepts"]) < int(diag["exchange_attempts"])


def test_ensemble_matches_independent_runs_classical(small):
    """Exchange off: the batched run == 3 independent MDEngine runs (same
    seeds and temperatures), bit for bit."""
    system, pos = small["system"], small["pos"]
    temps = (250.0, 300.0, 350.0)
    ind = []
    for r, t in enumerate(temps):
        eng = MDEngine(system, EngineConfig(thermostat_t=t, **_CFG))
        ind.append(eng.run(eng.init_state(pos, t, seed=r), 10))
    eeng = EnsembleEngine(system, EngineConfig(thermostat_t=300.0, **_CFG),
                          EnsembleConfig(n_replicas=3, temps=temps))
    st = eeng.run(eeng.init_state(pos), 10)
    for r in range(3):
        assert _same(replica_state(st, r), ind[r], FIELDS[:4])


def test_ensemble_matches_independent_runs_dp(small):
    """Exchange off, the stateful DP provider (one batched model call for
    both replicas): == 2 independent runs with ``DeepmdForceProvider``,
    bit for bit."""
    system, pos = small["system"], small["pos"]
    temps = (250.0, 330.0)
    ind = []
    for r, t in enumerate(temps):
        prov = DeepmdForceProvider(small["model"], small["params"],
                                   small["nn"], system.types, system.box,
                                   system.n_atoms, nbr_capacity=48, skin=0.08,
                                   device="cpu")
        eng = MDEngine(system, EngineConfig(thermostat_t=t, **_CFG),
                       special_force=prov)
        ind.append(eng.run(eng.init_state(pos, t, seed=r), 8))
    eeng = EnsembleEngine(system, EngineConfig(thermostat_t=300.0, **_CFG),
                          EnsembleConfig(n_replicas=2, temps=temps),
                          special_force=_batched_provider(small, 2))
    st = eeng.run(eeng.init_state(pos), 8)
    for r in range(2):
        assert _same(replica_state(st, r), ind[r], FIELDS[:4])


def test_ensemble_step_mode_matches_scan(small):
    runs, seen = {}, {}
    for mode in ("scan", "step"):
        eeng = EnsembleEngine(
            small["system"],
            EngineConfig(thermostat_t=300.0, loop_mode=mode, **_CFG),
            EnsembleConfig(n_replicas=2, temps=(250.0, 330.0)),
            special_force=_batched_provider(small, 2))
        obs = []
        runs[mode] = eeng.run(eeng.init_state(small["pos"]), 8,
                              observe=lambda s, o: obs.append(o),
                              observe_every=4)
        seen[mode] = obs
    assert _same(runs["scan"], runs["step"])
    for mode in ("scan", "step"):
        assert seen[mode][-1]["e_special"].shape == (2,)
        assert seen[mode][-1]["temperature"].shape == (2,)


def test_masked_recovery_touches_only_the_faulted_replica(small):
    """An engine-level ``nan_force`` on replica 1: only replica 1 trips,
    the window rolls back and replays, and the ensemble ends on the
    fault-free run's bits."""
    ens = EnsembleConfig(n_replicas=3, temps=(200.0, 230.0, 260.0))

    def run_ens(**kw):
        eng = EnsembleEngine(small["system"], EngineConfig(**_CFG), ens, **kw)
        return eng, eng.run(eng.init_state(small["pos"]), 16)

    _, ref = run_ens()
    plan = FaultPlan([FaultSpec("nan_force", step=5, replica=1)])
    eng, out = run_ens(guard=GuardConfig(enabled=True), faults=plan)
    assert plan.faults[0].fired
    assert eng.diagnostics["replica_guard_trips"].tolist() == [0, 1, 0]
    assert eng.diagnostics["guard_trips"] == 1
    assert _same(ref, out)


def test_merge_rollback_selects_per_replica(small):
    eng = EnsembleEngine(small["system"], EngineConfig(**_CFG),
                         EnsembleConfig(n_replicas=3))
    a = eng.init_state(small["pos"], seeds=(0, 1, 2))
    b = eng.init_state(small["pos"], seeds=(3, 4, 5))
    m = eng._merge_rollback((a, None, torch.zeros(3)), (b, None,
                                                        torch.ones(3)),
                            np.array([False, True, False]))
    assert torch.equal(m[0].velocities[1], b.velocities[1])
    assert torch.equal(m[0].velocities[0], a.velocities[0])
    assert torch.equal(m[0].rng[2], a.rng[2])
    assert m[2].tolist() == [0.0, 1.0, 0.0]


def test_replica_state_stack_unstack(small):
    eng = MDEngine(small["system"], EngineConfig(thermostat_t=300.0, **_CFG))
    singles = [eng.init_state(small["pos"], 300.0, seed=r) for r in range(3)]
    st = stack_states(singles)
    assert st.n_replicas == 3 and st.ladder.tolist() == [0, 1, 2]
    for r in range(3):
        back = replica_state(st, r)
        assert _same(back, singles[r], FIELDS[:4])
        assert torch.equal(back.rng, singles[r].rng)
    eeng = EnsembleEngine(small["system"],
                          EngineConfig(thermostat_t=300.0, **_CFG),
                          EnsembleConfig(n_replicas=2, temps=(250.0, 300.0)))
    with pytest.raises(TypeError, match="per-replica"):
        eeng.init_state(small["pos"], 300.0)


def test_ensemble_checkpoint_restore(small, tmp_path):
    path = str(tmp_path / "ens_ck")
    ens = EnsembleConfig(n_replicas=2, temps=(280.0, 320.0),
                         exchange_interval=3)
    eeng = EnsembleEngine(
        small["system"], EngineConfig(thermostat_t=300.0, checkpoint_every=4,
                                      checkpoint_path=path, **_CFG), ens)
    st = eeng.run(eeng.init_state(small["pos"]), 8)
    restored = EnsembleEngine.restore(path, device="cpu")
    assert isinstance(restored, ReplicaState)
    assert _same(restored, st)
    assert torch.equal(restored.rng, st.rng)
    assert sorted(restored.ladder.tolist()) == [0, 1]


def test_ensemble_capacity_growth(small):
    """An undersized classical capacity grows and replays (per-replica
    overflow flags reduced on the host) instead of raising."""
    eeng = EnsembleEngine(
        small["system"], EngineConfig(cutoff=0.9, neighbor_capacity=2,
                                      dt=0.0005, thermostat_t=200.0),
        EnsembleConfig(n_replicas=2, temps=(200.0, 220.0)))
    st = eeng.run(eeng.init_state(small["pos"]), 4)
    assert bool(torch.isfinite(st.positions).all())
    assert eeng.diagnostics["capacity_growths"]
    assert eeng.config.neighbor_capacity > 2


def test_ensemble_smoke_with_exchange(small):
    """Near-equal rungs accept nearly every attempt."""
    ens = EnsembleConfig(n_replicas=2, temps=(300.0, 301.0),
                         exchange_interval=2)
    eeng = EnsembleEngine(small["system"],
                          EngineConfig(thermostat_t=300.0, **_CFG), ens,
                          special_force=_batched_provider(small, 2))
    st = eeng.run(eeng.init_state(small["pos"]), 8)
    d = eeng.diagnostics
    assert bool(torch.isfinite(st.positions).all())
    assert d["exchange_attempts"] >= 2
    assert d["exchange_accepts"] >= d["exchange_attempts"] - 1
    assert d["pair_attempts"].sum() == d["exchange_attempts"]


def test_ensemble_refuses_an_unbatched_special_force(small):
    s = small["system"]
    prov = DeepmdForceProvider(small["model"], small["params"], small["nn"],
                               s.types, s.box, s.n_atoms, nbr_capacity=48,
                               device="cpu")
    with pytest.raises(ValueError, match="leading replica axis"):
        EnsembleEngine(s, EngineConfig(**_CFG), EnsembleConfig(n_replicas=2),
                       special_force=prov)


def test_remd_entry_point_runs_on_cpu():
    state, eng = remd.main(["--device", "cpu", "--residues", "3",
                            "--replicas", "3", "--steps", "6",
                            "--exchange-interval", "3"], quiet=True)
    assert state.positions.shape[0] == 3
    assert bool(torch.isfinite(state.positions).all())
    assert sorted(state.ladder.tolist()) == [0, 1, 2]
    assert eng.diagnostics["exchange_attempts"] == 2


def test_remd_entry_point_dd_layout_on_cpu():
    """--ranks 4: the DP group through the replica-batched pipeline on a
    virtual (replica x rank) layout."""
    state, eng = remd.main(["--device", "cpu", "--residues", "4",
                            "--replicas", "2", "--ranks", "4", "--steps",
                            "2", "--exchange-interval", "2"], quiet=True)
    assert eng.special_force.pipeline.n_replicas == 2
    assert bool(torch.isfinite(state.positions).all())
    assert dataclasses.is_dataclass(state)


def test_dd_rank_fault_recovers_only_its_replica():
    """R = 2 x 4 virtual ranks: a ``nan_force`` on rank 2 of replica 1
    through the pipeline's fault hook trips only replica 1 and the
    ensemble ends on the fault-free bits.  The faulted replica's NaN
    coordinates make its assembly flag an overflow; the verdict judges a
    non-finite trajectory by its guard trip, not by growing capacities
    (which would double them up to the growth limit, the fault armed)."""
    from repro_torch.core import suggest_config
    from repro_torch.dp import DPConfig, DescriptorConfig
    from repro_torch.md import build_solvated_protein, mark_nn_group
    desc = DescriptorConfig(kind="dpa1", rcut=0.4, rcut_smth=0.2, sel=32,
                            ntypes=4, neuron=(8, 16), axis_neuron=4,
                            attn_layers=1, attn_hidden=16)
    model = DPModel(DPConfig(descriptor=desc, fitting_neuron=(16, 16)),
                    device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    system, pos, nn = build_solvated_protein(64, device="cpu")
    system = mark_nn_group(system, nn)
    box = system.box.numpy()
    dd = suggest_config(len(nn), box, 4, 0.4, nbr_capacity=32, skin=0.05,
                        coords=pos.numpy()[nn])
    runs = {}
    for name in ("clean", "faulted"):
        plan = FaultPlan([FaultSpec("nan_force", step=3, rank=2, replica=1)]
                         if name == "faulted" else [])
        prov = BatchedDeepmdProvider(model, params, nn, system.types, box,
                                     system.n_atoms, n_replicas=2,
                                     dd_config=dd, device="cpu",
                                     fault_hook=plan.pipeline_hook())
        eng = EnsembleEngine(system, EngineConfig(thermostat_t=300.0, **_CFG),
                             EnsembleConfig(n_replicas=2,
                                            temps=(300.0, 330.0)),
                             special_force=prov,
                             guard=GuardConfig(enabled=True), faults=plan)
        runs[name] = (eng.run(eng.init_state(pos), 4), eng, plan)
    (clean, _, _), (out, eng, plan) = runs["clean"], runs["faulted"]
    assert plan.faults[0].fired
    assert eng.diagnostics["replica_guard_trips"].tolist() == [0, 1]
    assert eng.diagnostics["special_growths"] == 0
    assert _same(clean, out)
