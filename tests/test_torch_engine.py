"""The port's MD engine, on the CPU:

* against JAX's ``MDEngine``: the solvated 5-residue protein with the
  paper's DPA-1 (``sel=32``, params carried over by ``bridge``), JAX's
  ``init_state`` carried across; 12 steps with a stateless provider (skin
  0), a stateful one (skin 0.08), and 10 steps of displacement rebuilds
  (``rebuild_every=1000, skin=0.02``): positions within 1e-5 nm (measured:
  0, the same bits), velocities within 1e-5 x max|v|, and the diagnostics
  (rebuild and growth counts) equal; overflow growth from a capacity of 2
  gives JAX's growth list;
* the port's own contracts (``tests/test_engine_scan.py`` of the
  reference, held bit for bit here): scan == step, the stateful provider
  == the stateless one within 1e-5 nm, displacement rebuilds inside the
  windows counted alike in both modes, a window replayed after a
  mid-window growth equal to the step loop's inline growth, the observe
  cadence, the step-mode timers;
* the DD trajectory (``repro_torch.launch.protein_md``, 8 virtual ranks)
  with cell-list assembly equal to the dense oracle bit for bit, with four
  intra-op threads;
* the options of items 8 and 9 (guards, faults, checkpoints, emergency
  dumps, obs) are taken and leave a quiet run's bits as they were;
  checkpoint and restore round-trip; ``protein_md --ckpt-dir`` writes.
"""
import contextlib
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro.core import DeepmdForceProvider as JProvider
from repro.dp import DPModel as JModel
from repro.dp import paper_dpa1_config as jpaper
from repro.md import EngineConfig as JConfig
from repro.md import MDEngine as JEngine
from repro.md import build_solvated_protein as jbuild
from repro.md import mark_nn_group as jmark
from repro_torch import bridge
from repro_torch.ckpt import AsyncCheckpointer
from repro_torch.core import DeepmdForceProvider
from repro_torch.dp import DPModel
from repro_torch.health import FaultPlan, GuardConfig
from repro_torch.launch import protein_md
from repro_torch.md import (EngineConfig, MDEngine, build_solvated_protein,
                            mark_nn_group)
from repro_torch.obs import ObsConfig

# small CPU tensors: one intra-op thread keeps parallel test workers
# from oversubscribing the cores
torch.set_num_threads(1)

_CFG = dict(cutoff=0.9, neighbor_capacity=96, dt=0.0005, thermostat_t=200.0)
RUNS = {"stateless": (0.0, {}, 12), "stateful": (0.08, {}, 12),
        "displacement": (0.0, dict(rebuild_every=1000, skin=0.02), 10)}
DIAG_KEYS = ("displacement_rebuilds", "special_rebuilds", "cadence_rebuilds",
             "capacity_growths", "special_growths")


@contextlib.contextmanager
def _threads(n):
    prev = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


@pytest.fixture(scope="module")
def ref():
    """The JAX engine's runs (initial and final states, diagnostics) and
    the port's system, model and params."""
    system, pos, nn = jbuild(5, water_per_protein_atom=1.5)
    system = jmark(system, nn)
    model = JModel(jpaper(ntypes=4, rcut=0.6, sel=32))
    params = model.init_params(jax.random.PRNGKey(0))
    out = {"nn": nn, "runs": {}}
    for name, (skin, extra, n) in RUNS.items():
        prov = JProvider(model, params, nn, system.types, system.box,
                         system.n_atoms, nbr_capacity=48, skin=skin)
        eng = JEngine(system, JConfig(**_CFG, **extra), special_force=prov)
        st0 = eng.init_state(pos, 200.0)
        st = eng.run(st0, n)
        out["runs"][name] = (_np_tree(st0), _np_tree(st),
                             {k: eng.diagnostics[k] for k in DIAG_KEYS})
    eng = JEngine(system, JConfig(cutoff=0.9, neighbor_capacity=2, dt=0.0005,
                                  thermostat_t=200.0))
    st0 = eng.init_state(pos, 200.0)
    st = eng.run(st0, 4)
    out["growth"] = (_np_tree(st0), _np_tree(st),
                     {k: eng.diagnostics[k] for k in DIAG_KEYS})
    out["system"] = bridge.system_to_torch(_np_tree(system), "cpu")
    out["model"] = DPModel(bridge.config_to_torch(model.cfg), device="cpu")
    out["params"] = bridge.params_to_torch(jax.device_get(params), "cpu")
    return out


def _provider(ref, skin=0.0):
    s = ref["system"]
    return DeepmdForceProvider(ref["model"], ref["params"], ref["nn"], s.types,
                               s.box, s.n_atoms, nbr_capacity=48, skin=skin,
                               device="cpu")


def _engine(ref, sp_skin=0.0, special=True, **cfg):
    """An engine on the port's system; ``sp_skin`` is the provider's skin,
    ``cfg`` overrides the engine config (its ``skin`` included)."""
    return MDEngine(ref["system"], EngineConfig(**{**_CFG, **cfg}),
                    special_force=_provider(ref, sp_skin) if special else None)


def _start(ref, name="stateless"):
    return bridge.md_state_to_torch(ref["runs"][name][0], "cpu")


def _same_bits(a, b):
    return all(torch.equal(getattr(a, k), getattr(b, k))
               for k in ("positions", "velocities", "forces", "step"))


@pytest.mark.parametrize("name", list(RUNS))
def test_trajectory_matches_jax(ref, name):
    skin, extra, n = RUNS[name]
    st0, want, diag = ref["runs"][name]
    eng = _engine(ref, skin, **extra)
    got = eng.run(bridge.md_state_to_torch(st0, "cpu"), n)
    assert float(np.abs(got.positions.numpy() - want.positions).max()) <= 1e-5
    vmax = float(np.abs(want.velocities).max())
    assert float(np.abs(got.velocities.numpy()
                        - want.velocities).max()) <= 1e-5 * vmax
    assert int(got.step) == int(want.step) == n
    assert {k: eng.diagnostics[k] for k in DIAG_KEYS} == diag


def test_overflow_grows_like_jax(ref):
    st0, want, diag = ref["growth"]
    eng = MDEngine(ref["system"], EngineConfig(cutoff=0.9, neighbor_capacity=2,
                                               dt=0.0005, thermostat_t=200.0))
    got = eng.run(bridge.md_state_to_torch(st0, "cpu"), 4)
    assert bool(torch.isfinite(got.positions).all())
    assert eng.diagnostics["capacity_growths"] == diag["capacity_growths"]
    assert eng.diagnostics["capacity_growths"]
    assert eng.config.neighbor_capacity > 2
    assert float(np.abs(got.positions.numpy() - want.positions).max()) <= 1e-5


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------

def test_scan_matches_step_bitwise(ref):
    runs = {}
    for mode in ("scan", "step"):
        eng = _engine(ref, loop_mode=mode)
        runs[mode] = eng.run(_start(ref), 12)
    assert _same_bits(runs["scan"], runs["step"])
    assert int(runs["scan"].step) == 12


def test_stateful_reuse_matches_stateless(ref):
    st0 = _engine(ref).run(_start(ref), 12)
    prov = _provider(ref, skin=0.08)
    assert prov.stateful
    eng = MDEngine(ref["system"], EngineConfig(**_CFG), special_force=prov)
    st1 = eng.run(_start(ref), 12)
    assert bool(torch.isfinite(st1.positions).all())
    assert float((st0.positions - st1.positions).abs().max()) <= 1e-5


def test_displacement_rebuilds_inside_windows(ref):
    runs = {}
    for mode in ("scan", "step"):
        eng = _engine(ref, loop_mode=mode, rebuild_every=1000, skin=0.02)
        runs[mode] = (eng.run(_start(ref), 10), eng)
    (st_s, eng_s), (st_p, eng_p) = runs["scan"], runs["step"]
    assert eng_s.diagnostics["displacement_rebuilds"] > 0
    assert (eng_s.diagnostics["displacement_rebuilds"]
            == eng_p.diagnostics["displacement_rebuilds"])
    assert eng_s.diagnostics["cadence_rebuilds"] == 0
    assert _same_bits(st_s, st_p)


def test_grown_window_replay_equals_inline_growth(ref):
    """A list that overflows at a displacement rebuild inside a window:
    the scan path replays the window from its start with the grown
    capacity, the step loop grows in place; the same bits, the same
    growths.  (The classical forces do not depend on the capacity.)"""
    runs = {}
    for mode in ("scan", "step"):
        eng = _engine(ref, special=False, loop_mode=mode, rebuild_every=1000,
                      skin=0.02, dt=0.002)
        st0 = _start(ref)
        # the start list fits exactly (26 slots); at dt 0.002 the later
        # displacement rebuilds need 27-28
        eng.config.neighbor_capacity = int(eng.build_nlist(
            st0.positions).mask.sum(1).max())
        runs[mode] = (eng.run(st0, 10), eng)
    (st_s, eng_s), (st_p, eng_p) = runs["scan"], runs["step"]
    assert eng_s.diagnostics["window_reruns"] >= 1
    assert eng_s.diagnostics["capacity_growths"]
    assert (eng_s.diagnostics["capacity_growths"]
            == eng_p.diagnostics["capacity_growths"])
    assert _same_bits(st_s, st_p)


def test_observe_cadence_and_one_cadence_rebuild(ref):
    eng = _engine(ref, special=False)
    seen = []
    st = eng.run(_start(ref), 12, observe=lambda s, o: seen.append(o["step"]),
                 observe_every=5)
    assert seen == [1, 6, 11]
    assert int(st.step) == 12
    # pre-loop build + the cadence rebuild at i=10 only (not at i=0)
    assert eng.diagnostics["cadence_rebuilds"] == 1


def test_step_mode_writes_all_timers(ref):
    eng = _engine(ref, loop_mode="step")
    eng.run(_start(ref), 3)
    for key in ("neighbor", "classical", "special", "integrate"):
        assert eng.timings[key] > 0.0, (key, eng.timings)
    eng.reset()
    assert eng.diagnostics["cadence_rebuilds"] == 0


def test_no_graph_survives_a_step(ref):
    st = _engine(ref, sp_skin=0.08).run(_start(ref), 3)
    for k in ("positions", "velocities", "forces"):
        t = getattr(st, k)
        assert not t.requires_grad and t.grad_fn is None


def test_dd_trajectory_cells_equal_dense_bitwise_with_four_threads():
    runs = {}
    with _threads(4):
        for method in ("cells", "dense"):
            runs[method] = protein_md.main(
                ["--device", "cpu", "--residues", "5", "--steps", "6",
                 "--nbr-method", method], quiet=True)[0]
    assert _same_bits(runs["cells"], runs["dense"])
    assert bool(torch.isfinite(runs["cells"].positions).all())


# ---------------------------------------------------------------------------
# refusals and device rules
# ---------------------------------------------------------------------------

# These two tests held the refusals of items 8 and 9 until those items
# landed; they now hold that every such option is taken and works.
REFUSED = {
    "obs": (lambda d: dict(obs=ObsConfig(enabled=True)), {}),
    "guard": (lambda d: dict(guard=GuardConfig(enabled=True)), {}),
    "faults": (lambda d: dict(faults=FaultPlan([])), {}),
    "checkpointer": (lambda d: dict(checkpointer=AsyncCheckpointer(d)),
                     dict(checkpoint_every=2)),
    "checkpoint_every": (lambda d: {}, dict(checkpoint_every=2)),
    "checkpoint_path": (lambda d: {}, dict(checkpoint_every=2,
                                           checkpoint_path="ck")),
    "emergency_path": (lambda d: {}, dict(emergency_path="dump")),
}


@pytest.mark.parametrize("what", list(REFUSED))
def test_unported_options_raise_naming_their_item(ref, what, tmp_path):
    kw, cfg = REFUSED[what]
    cfg = {k: str(tmp_path / v) if k.endswith("_path") else v
           for k, v in cfg.items()}
    eng = MDEngine(ref["system"], EngineConfig(**{**_CFG, **cfg}),
                   **kw(str(tmp_path / "async")))
    plain = _engine(ref, special=False).run(_start(ref), 4)
    assert _same_bits(eng.run(_start(ref), 4), plain)
    if "checkpoint_path" in cfg:
        assert _same_bits(MDEngine.restore(cfg["checkpoint_path"], "cpu"),
                          plain)
    if what == "checkpointer":
        eng.checkpointer.wait()
        assert sorted(os.listdir(tmp_path / "async")) == [
            "step_000000002", "step_000000004"]
    if what == "obs":
        assert [e["step"] for e in eng.tracer.events
                if e["type"] == "step"] == [0, 1, 2, 3]


def test_checkpoint_restore_and_ckpt_dir_raise_naming_item_8(ref, tmp_path,
                                                            monkeypatch):
    eng = _engine(ref, special=False)
    st = eng.run(_start(ref), 3)
    eng.checkpoint(st, str(tmp_path / "ck"))
    back = MDEngine.restore(str(tmp_path / "ck"), device="cpu")
    assert _same_bits(back, st) and torch.equal(back.rng, st.rng)
    # restore defaults to the card, and raises without one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MDEngine.restore(str(tmp_path / "ck"))
    monkeypatch.undo()
    protein_md.main(["--device", "cpu", "--residues", "3", "--steps", "10",
                     "--ranks", "2", "--ckpt-dir", str(tmp_path / "run")],
                    quiet=True)
    assert int(MDEngine.restore(str(tmp_path / "run"), "cpu").step) == 10
    # a disabled guard is the unguarded engine
    MDEngine(ref["system"], EngineConfig(**_CFG), guard=GuardConfig())


def test_special_force_on_another_device_raises(ref):
    class Elsewhere:
        device = torch.device("meta")
        stateful = False

    with pytest.raises(ValueError, match="special force lives on"):
        MDEngine(ref["system"], EngineConfig(**_CFG),
                 special_force=Elsewhere())


def test_systems_take_the_device_and_the_engine_follows():
    system, pos, nn = build_solvated_protein(5, 1.5, device="cpu")
    system = mark_nn_group(system, nn)
    assert system.device.type == "cpu" and pos.device.type == "cpu"
    assert system.topology.exclusions.device.type == "cpu"
    eng = MDEngine(system, EngineConfig(**_CFG))
    assert eng.device == system.device
    st = eng.init_state(pos, 200.0)
    assert st.velocities.device.type == "cpu" and st.step.dtype == torch.int32
