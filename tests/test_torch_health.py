"""Guarded execution in the port (``repro_torch.health``, the engine's
recovery paths), on the CPU: the counterparts of ``tests/test_health.py``
(serving and the ensemble aside).

* ``FaultSpec`` validation and ``FaultPlan``'s one-shot semantics, held
  against the reference's plan on the same specs and calls;
* bitwise, in both loop modes: guards on and quiet == unguarded; an
  engine-level ``nan_force`` recovers to the fault-free trajectory (no DP
  force, the DP provider on one domain, and 8 virtual ranks); a rank-3
  ``nan_force`` through the pipeline's ``fault_hook`` shows in
  ``rank_nonfinite[3]`` only and the 8-rank run recovers;
* the verdict table: an injected overflow replays without growth, a
  persistent trip and capacity exhaustion dump before raising, a tainted
  window start rolls back through the checkpointer, a rollback without one
  dumps;
* non-finite positions through every index the port derives from
  positions (the cell lists, the DD grid and binning, the assembly, PME):
  nothing raises, everything stays in range;
* the DD diagnostics (``rank_nonfinite`` included) against the reference's
  ``ForcePipeline`` on the 160-atom, 8-rank system of
  ``tests/parity_support.py`` (a subprocess with 8 host devices).

The 8-rank engine runs use a narrow DPA-1 (embedding (8, 16), 1 attention
layer x 32, fitting (24, 24)) so each step takes a fraction of a second.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from parity_support import SYSTEM_PRELUDE, run_json
from repro.dp import DPConfig as JConfig
from repro.dp import DPModel as JModel
from repro.dp import DescriptorConfig as JDesc
from repro.health import FaultPlan as JPlan
from repro.health import FaultSpec as JSpec
from repro_torch import bridge
from repro_torch.ckpt import AsyncCheckpointer, load_pytree
from repro_torch.core import DeepmdForceProvider, ForcePipeline, suggest_config
from repro_torch.core import ddinfer
from repro_torch.dp import DPConfig, DPModel, DescriptorConfig
from repro_torch.health import (FaultPlan, FaultSpec, GuardConfig,
                                GuardTripError, RECOVERY_POLICY,
                                WindowVerdict)
from repro_torch.md import (EngineConfig, MDEngine, build_neighbor_list,
                            build_solvated_protein, mark_nn_group)
from repro_torch.md import pme
from repro_torch.md.engine import state_tree
from repro_torch.obs import get_registry

torch.set_num_threads(1)

_CFG = dict(cutoff=0.9, neighbor_capacity=96, dt=0.0005, thermostat_t=200.0)
MODES = ("scan", "step")
NAN = float("nan")


def _narrow_desc(**kw):
    return dict(kind="dpa1", rcut=0.6, rcut_smth=0.3, ntypes=4,
                neuron=(8, 16), axis_neuron=4, attn_layers=1, attn_hidden=32,
                **kw)


@pytest.fixture(scope="module")
def md():
    system, pos, nn = build_solvated_protein(5, water_per_protein_atom=1.5,
                                             device="cpu")
    system = mark_nn_group(system, nn)
    model = DPModel(DPConfig(descriptor=DescriptorConfig(**_narrow_desc(
        sel=32)), fitting_neuron=(24, 24)), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    box = system.box.numpy()
    dd = suggest_config(len(nn), box, 8, 0.6, nbr_capacity=48, slack=2.5,
                        skin=0.04, force_mode="ghost_reduce",
                        coords=pos.numpy()[nn])

    def provider(kind, hook=None):
        if kind is None:
            return None
        if kind == "one domain":
            return DeepmdForceProvider(model, params, nn, system.types, box,
                                       system.n_atoms, nbr_capacity=48,
                                       skin=0.08, device="cpu")
        return DeepmdForceProvider(model, params, nn, system.types, box,
                                   system.n_atoms, dd_config=dd,
                                   device="cpu", fault_hook=hook)

    return {"system": system, "pos": pos, "provider": provider}


def _run(md, n_steps=12, mode="scan", special=None, hook=None, **kw):
    cfg = kw.pop("cfg", {})
    eng = MDEngine(md["system"], EngineConfig(**_CFG, loop_mode=mode, **cfg),
                   special_force=md["provider"](special, hook), **kw)
    return eng, eng.run(eng.init_state(md["pos"], 200.0, seed=1), n_steps)


def _same(a, b) -> bool:
    return all(torch.equal(getattr(a, k), getattr(b, k))
               for k in ("positions", "velocities", "forces", "step"))


# -- config + verdict surface ------------------------------------------------

@pytest.mark.parametrize("kw", [dict(kind="no_such_fault"),
                                dict(kind="nan_force"),
                                dict(kind="serve_fail"),
                                dict(kind="truncate_ckpt")],
                         ids=["unknown", "nan-no-step", "serve-no-nth",
                              "ckpt-no-nth"])
def test_spec_validation_as_reference(kw):
    with pytest.raises(ValueError) as ours:
        FaultSpec(**kw)
    with pytest.raises(ValueError) as theirs:
        JSpec(**kw)
    assert str(ours.value) == str(theirs.value)


def test_config_and_verdict_surface():
    with pytest.raises(ValueError):
        GuardConfig(max_rollbacks=0)
    with pytest.raises(ValueError):
        GuardConfig(dt_shrink=0.0)
    with pytest.raises(ValueError):
        WindowVerdict("no_such_verdict")
    with pytest.raises(TypeError):
        FaultPlan([object()])
    assert WindowVerdict("guard_trip").policy == "rollback_replay"
    assert set(RECOVERY_POLICY) == {"ok", "capacity_overflow", "guard_trip",
                                    "unrecoverable"}


def _specs(cls):
    return [cls("nan_force", step=3), cls("overflow_flag", step=4),
            cls("nan_force", step=7, rank=2), cls("truncate_ckpt", nth=2),
            cls("serve_delay", nth=1, delay_s=0.0), cls("serve_fail", nth=2)]


def test_fault_plan_bookkeeping_matches_reference(tmp_path):
    """The same specs and the same calls: the same fired/armed states,
    summaries, injection pattern and truncations."""
    ours, theirs = FaultPlan(_specs(FaultSpec)), JPlan(_specs(JSpec))
    f = torch.ones(4, 3)
    for step in (2, 3, 4):
        got_f, got_o = ours.apply_engine(torch.tensor(step, dtype=torch.int32),
                                          f, torch.zeros((), dtype=torch.bool))
        want_f, want_o = theirs.apply_engine(np.int32(step), np.ones((4, 3)),
                                             np.zeros((), bool))
        np.testing.assert_array_equal(torch.isnan(got_f).numpy(),
                                      np.isnan(np.asarray(want_f)))
        assert bool(got_o) == bool(want_o)
    for step0, k in ((0, 5), (5, 5), (10, 5)):
        assert ours.sync_window(step0, k) == theirs.sync_window(step0, k)
        assert ([s.armed for s in ours.faults]
                == [s.armed for s in theirs.faults])
    for plan in (ours, theirs):
        plan.sync_window(5, 5)
    fired = [ours.consume_in_window(0, 6), theirs.consume_in_window(0, 6)]
    assert [dataclasses.asdict(s) for s in fired[0]] == \
        [dataclasses.asdict(s) for s in fired[1]]
    for i, plan in enumerate((ours, theirs)):
        plan.before_bucket_eval()
        with pytest.raises(RuntimeError, match="injected"):
            plan.before_bucket_eval()
        for n in (1, 2):
            d = tmp_path / f"{i}_{n}"
            d.mkdir()
            (d / "shard_host0.npz").write_bytes(b"x" * 100)
            plan.after_checkpoint_save(str(d), n)
    sizes = [[os.path.getsize(tmp_path / f"{i}_{n}" / "shard_host0.npz")
              for n in (1, 2)] for i in (0, 1)]
    assert sizes[0] == sizes[1] == [100, 50]
    assert ours.summary() == theirs.summary()


def test_fault_plan_one_shot_semantics():
    plan = FaultPlan([FaultSpec("nan_force", step=3)])
    f = torch.ones(4, 3)
    ovf = torch.zeros((), dtype=torch.bool)
    f2, _ = plan.apply_engine(torch.tensor(3), f, ovf)
    assert bool(torch.isnan(f2).all())
    f2, _ = plan.apply_engine(torch.tensor(2), f, ovf)
    assert not bool(torch.isnan(f2).any())
    assert plan.consume_in_window(0, 10) == [plan.faults[0]]
    assert plan.faults[0].fired and not plan.pending()
    # fired specs contribute nothing: the seam is the identity again
    f3, ovf3 = plan.apply_engine(torch.tensor(3), f, ovf)
    assert f3 is f and ovf3 is ovf
    assert plan.summary()["fired"] == 1


def test_pipeline_hook_poisons_one_rank_while_armed():
    plan = FaultPlan([FaultSpec("nan_force", step=4, rank=1)])
    hook = plan.pipeline_hook()
    e, f = torch.zeros(3), torch.ones(3, 5, 3)
    assert hook(torch.arange(3), 0, e, f)[1] is f      # disarmed at first
    plan.sync_window(0, 8)
    bad = torch.isnan(hook(torch.arange(3), 0, e, f)[1])
    assert bad[1].all() and not bad[0].any() and not bad[2].any()
    plan.consume_in_window(0, 8)
    assert hook(torch.arange(3), 0, e, f)[1] is f


# -- bitwise contracts --------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_guard_enabled_quiet_is_bitwise_identical(md, mode):
    _, ref = _run(md, mode=mode)
    eng, out = _run(md, mode=mode, guard=GuardConfig(
        enabled=True, max_disp=1.0, temp_ceiling=1e6, energy_jump=1e9))
    assert _same(ref, out)
    assert eng.diagnostics["guard_trips"] == 0


@pytest.mark.parametrize("special", [None, "one domain"])
@pytest.mark.parametrize("mode", MODES)
def test_nan_fault_recovers_bitwise(md, mode, special):
    _, ref = _run(md, 24, mode, special)
    plan = FaultPlan([FaultSpec("nan_force", step=5)])
    trips0 = get_registry().counter("guard.trips").value
    recov0 = get_registry().counter("guard.recoveries").value
    eng, out = _run(md, 24, mode, special, guard=GuardConfig(enabled=True),
                    faults=plan)
    assert plan.faults[0].fired
    assert eng.diagnostics["guard_trips"] == 1
    assert eng.diagnostics["guard_rollbacks"] == 1
    assert eng.diagnostics["window_reruns"] == 1
    assert get_registry().counter("guard.trips").value == trips0 + 1
    assert get_registry().counter("guard.recoveries").value == recov0 + 1
    assert _same(ref, out)
    # the replay kept the original dt (transient-fault hypothesis)
    assert eng.config.dt == _CFG["dt"]


@pytest.mark.parametrize("mode", MODES)
def test_dd_nan_faults_recover_bitwise(md, mode):
    """8 virtual ranks: an engine-level and a rank-3 ``nan_force`` (the
    pipeline seam) inside a window each recover to the fault-free run."""
    _, ref = _run(md, 6, mode, "dd")
    plan = FaultPlan([FaultSpec("nan_force", step=2)])
    eng, out = _run(md, 6, mode, "dd", guard=GuardConfig(enabled=True),
                    faults=plan)
    assert plan.faults[0].fired and eng.diagnostics["guard_trips"] == 1
    assert _same(ref, out)
    plan = FaultPlan([FaultSpec("nan_force", step=2, rank=3)])
    eng, out = _run(md, 6, mode, "dd", hook=plan.pipeline_hook(),
                    guard=GuardConfig(enabled=True), faults=plan)
    assert plan.faults[0].fired and eng.diagnostics["guard_trips"] == 1
    assert _same(ref, out)


def test_dd_rank_fault_shows_in_its_rank_only(md):
    plan = FaultPlan([FaultSpec("nan_force", step=0, rank=3)])
    plan.sync_window(0, 8)
    prov = md["provider"]("dd", plan.pipeline_hook())
    pos = md["pos"]
    nn_pos = prov._to_model(pos)
    for fn in (lambda: prov._dist_fn(prov.params, nn_pos, prov.nn_types),
               lambda: prov._eval_fn(prov.params, nn_pos,
                                     prov.assemble(pos))):
        _, f, diag = fn()
        bad = diag["rank_nonfinite"].numpy()
        assert bad[3] == 3 * prov.pipeline.n_pad
        assert np.delete(bad, 3).sum() == 0
        assert bool(torch.isnan(f).any())
    plan.consume_in_window(0, 8)
    _, f, diag = prov._dist_fn(prov.params, nn_pos, prov.nn_types)
    assert diag["rank_nonfinite"].sum() == 0 and bool(torch.isfinite(f).all())


# -- the verdict table ----------------------------------------------------------

def test_injected_overflow_replays_without_growth(md):
    _, ref = _run(md, 24)
    plan = FaultPlan([FaultSpec("overflow_flag", step=7)])
    eng, out = _run(md, 24, faults=plan)
    assert plan.faults[0].fired
    assert eng.diagnostics["window_reruns"] == 1
    assert eng.diagnostics["special_growths"] == 0
    assert eng.diagnostics["capacity_growths"] == []
    assert _same(ref, out)


def test_persistent_trip_escalates_to_emergency_dump(md, tmp_path):
    # a 1e-6 K ceiling trips every window and every replay: recovery must
    # escalate after max_rollbacks with a restorable dump
    guard = GuardConfig(enabled=True, temp_ceiling=1e-6, max_rollbacks=2)
    eng = MDEngine(md["system"], EngineConfig(emergency_path=str(tmp_path),
                                              **_CFG), guard=guard)
    with pytest.raises(GuardTripError) as ei:
        eng.run(eng.init_state(md["pos"], 200.0, seed=1), 12)
    assert "emergency checkpoint" in str(ei.value)
    assert eng.diagnostics["guard_rollbacks"] == 2
    [dump] = eng.diagnostics["emergency_dumps"]
    bundle = json.load(open(os.path.join(dump, "diagnostics.json")))
    assert "guard trips persist" in bundle["reason"]
    # the second replay ran at a shrunk dt; the bundle holds it as it was
    assert bundle["config"]["dt"] == pytest.approx(_CFG["dt"] * 0.5)
    assert eng.config.dt == _CFG["dt"]      # restored on exit
    restored = MDEngine.restore(dump, device="cpu")
    assert restored.positions.shape == md["pos"].shape
    assert restored.rng.dtype == torch.uint8


def test_capacity_exhaustion_dumps_before_raising(md, tmp_path):
    cfg = dict(_CFG, neighbor_capacity=2, max_capacity_growths=0,
               emergency_path=str(tmp_path))
    eng = MDEngine(md["system"], EngineConfig(**cfg))
    with pytest.raises(RuntimeError) as ei:
        eng.run(eng.init_state(md["pos"], 200.0, seed=1), 4)
    assert "neighbor capacity" in str(ei.value)
    assert "emergency checkpoint" in str(ei.value)
    [dump] = eng.diagnostics["emergency_dumps"]
    bundle = json.load(open(os.path.join(dump, "diagnostics.json")))
    assert "neighbor capacity" in bundle["reason"]
    assert load_pytree(dump)["positions"].shape == tuple(md["pos"].shape)


@pytest.mark.parametrize("special", [None, "one domain"])
def test_tainted_window_start_rolls_back_through_checkpointer(md, tmp_path,
                                                              special):
    ck = AsyncCheckpointer(str(tmp_path), keep=5)
    eng = MDEngine(md["system"], EngineConfig(checkpoint_every=3, **_CFG),
                   special_force=md["provider"](special),
                   guard=GuardConfig(enabled=True), checkpointer=ck)
    ref = eng.run(eng.init_state(md["pos"], 200.0, seed=1), 8)
    ck.wait()
    assert int(ref.step) == 8               # checkpoints exist at 3 and 6
    bad = dataclasses.replace(ref, positions=ref.positions * NAN)
    state0, nlist0, _ = eng._rollback_start((bad, None, None), 8)
    assert eng.diagnostics["checkpoint_restores"] == 1
    # restored from step 6 and caught up 2 steps: the committed trajectory
    assert int(state0.step) == 8
    assert _same(state0, ref)
    assert not bool(nlist0.overflow)


def test_rollback_without_checkpointer_dumps(md, tmp_path):
    eng = MDEngine(md["system"], EngineConfig(emergency_path=str(tmp_path),
                                              **_CFG),
                   guard=GuardConfig(enabled=True))
    st = eng.init_state(md["pos"], 200.0, seed=1)
    bad = dataclasses.replace(st, positions=st.positions * NAN)
    with pytest.raises(GuardTripError, match="no checkpointer"):
        eng._rollback_start((bad, None, None), 0)
    assert len(eng.diagnostics["emergency_dumps"]) == 1
    tree = load_pytree(eng.diagnostics["emergency_dumps"][0])
    assert set(tree) == set(state_tree(st))


# -- non-finite positions never become an out-of-range index -------------------

def test_nonfinite_positions_stay_in_range(md):
    """The cell lists, the DD grid, binning and assembly, and the PME
    spread at positions with NaN and +-Inf entries: nothing raises and
    every index stays in range (on the card an out-of-range index would
    be a device-side assert, which no rollback survives)."""
    system, pos = md["system"], md["pos"].clone()
    pos[3] = NAN
    pos[7, 1] = float("inf")
    pos[11, 2] = -float("inf")
    n = pos.shape[0]
    for cap in (96, 2):
        nl = build_neighbor_list(pos, system.box, 0.9, cap, half=True,
                                 skin=0.1)
        assert bool(((nl.idx >= -1) & (nl.idx < n)).all())
        assert not bool(nl.mask[3].any())
    nan_all = torch.full_like(pos, NAN)
    nl = build_neighbor_list(nan_all, system.box, 0.9, 96, half=True)
    assert not bool(nl.mask.any())
    prov = md["provider"]("dd")
    for balanced in (False, True):
        cfg = dataclasses.replace(prov.dd_config, balanced=balanced)
        pipe = ForcePipeline(prov.model, cfg, prov.box_model, prov.n_nn)
        for x in (prov._to_model(pos), prov._to_model(nan_all)):
            st = pipe.build_assembly_fn()(x, prov.nn_types)
            c = cfg.local_capacity + cfg.ghost_capacity
            for leaf, hi in (("l_idx", pipe.n_pad), ("g_idx", pipe.n_pad),
                             ("nbr_idx", c)):
                v = getattr(st, leaf)
                assert bool(((v >= 0) & (v < hi)).all()), leaf
            e, f, diag = pipe.build_evaluation_fn()(prov.params, x, st)
            assert f.shape == (prov.n_nn, 3)
            grid = ddinfer._make_grid(x, prov.box_model, cfg, prov.n_nn)
            ranks = grid.rank_of(x)
            assert bool(((ranks >= 0) & (ranks < cfg.n_ranks)).all())
    q = pme.charge_spread(pos, torch.linspace(-1, 1, n), system.box,
                          (8, 8, 8))
    assert q.shape == (8, 8, 8)


# -- the DD diagnostics against the reference's pipeline (8 host devices) ------

_REF_DIAG = SYSTEM_PRELUDE + r"""
from repro.core import ddinfer as jdd
from repro.core.pipeline import ForcePipeline
from repro.dp import DPConfig, DescriptorConfig
from repro.health import FaultPlan, FaultSpec
from repro.launch.mesh import make_dd_mesh
desc = DescriptorConfig(kind="dpa1", rcut=0.6, rcut_smth=0.3, sel=48,
                        ntypes=4, neuron=(8, 16), axis_neuron=4,
                        attn_layers=1, attn_hidden=32)
model = DPModel(DPConfig(descriptor=desc, fitting_neuron=(24, 24)))
params = model.init_params(jax.random.PRNGKey(0))
cfg = jdd.suggest_config(n, box, 8, 0.6, nbr_capacity=48, slack=2.5,
                         skin=0.05, force_mode="ghost_reduce", coords=ch)
mesh = make_dd_mesh(8)
for tag, rank in (("clean", None), ("rank3", 3)):
    hook = None
    if rank is not None:
        plan = FaultPlan([FaultSpec("nan_force", step=0, rank=rank)])
        plan.sync_window(0, 8)
        hook = plan.pipeline_hook()
    pipe = ForcePipeline(model, cfg, mesh, box, n, fault_hook=hook)
    diags = {"fused": pipe.build_force_fn()(params, coords, types)[2]}
    if rank is None:
        st = pipe.build_assembly_fn()(coords, types)
        diags["eval"] = pipe.build_evaluation_fn()(params, coords, st)[2]
    out[tag] = {k: {kk: np.asarray(vv).tolist() for kk, vv in d.items()}
                for k, d in diags.items()}
print("JSON" + json.dumps(out))
"""


def test_dd_diag_matches_reference_pipeline():
    """Every diagnostic of the fused force function (fault-free and with a
    rank-3 fault armed) and of the evaluation function (fault-free)
    against the JAX ``ForcePipeline`` on 8 host devices: the same keys,
    integers equal, floats within 1e-6 relative; ``rank_nonfinite`` zero,
    then 3 x n_pad on rank 3 alone."""
    want = run_json(_REF_DIAG)
    rng = np.random.default_rng(7)
    n, length = 160, 3.5
    box = np.array([length] * 3, np.float32)
    ch = rng.uniform(0, length, (n, 3)).astype(np.float32)
    types = rng.integers(0, 4, n).astype(np.int32)
    jm = JModel(JConfig(descriptor=JDesc(**_narrow_desc(sel=48)),
                        fitting_neuron=(24, 24)))
    params = bridge.params_to_torch(
        jax.device_get(jm.init_params(jax.random.PRNGKey(0))), "cpu")
    model = DPModel(bridge.config_to_torch(jm.cfg), device="cpu")
    cfg = suggest_config(n, box, 8, 0.6, nbr_capacity=48, slack=2.5,
                         skin=0.05, force_mode="ghost_reduce", coords=ch)
    x, t = torch.as_tensor(ch), torch.as_tensor(types)
    for tag, rank in (("clean", None), ("rank3", 3)):
        hook = None
        if rank is not None:
            plan = FaultPlan([FaultSpec("nan_force", step=0, rank=rank)])
            plan.sync_window(0, 8)
            hook = plan.pipeline_hook()
        pipe = ForcePipeline(model, cfg, box, n, fault_hook=hook)
        got = {"fused": pipe.build_force_fn()(params, x, t)[2]}
        if rank is None:
            st = pipe.build_assembly_fn()(x, t)
            got["eval"] = pipe.build_evaluation_fn()(params, x, st)[2]
        for which, diag in got.items():
            ref = want[tag][which]
            assert set(diag) == set(ref), (which, set(diag) ^ set(ref))
            for key, v in diag.items():
                a, b = v.numpy(), np.asarray(ref[key])
                if a.dtype.kind == "f":
                    np.testing.assert_allclose(a, b, rtol=1e-6, atol=0,
                                               err_msg=f"{tag} {which} {key}")
                else:
                    np.testing.assert_array_equal(
                        a.astype(np.int64), b.astype(np.int64),
                        err_msg=f"{tag} {which} {key}")
        bad = got["fused"]["rank_nonfinite"].numpy()
        if rank is None:
            assert bad.sum() == 0
        else:
            assert bad[3] == 3 * pipe.n_pad and np.delete(bad, 3).sum() == 0
