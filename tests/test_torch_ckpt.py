"""Checkpoints in the port (``repro_torch.ckpt``), on the CPU:

* integrity: a CRC mismatch and a truncated shard raise
  ``CheckpointCorrupt``; a format-1 checkpoint (no CRCs) loads;
  ``restore_latest`` falls back past a truncated shard (the fault plan's
  ``truncate_ckpt`` seam); a write that dies before its rename leaves the
  previous checkpoint whole and only a ``.tmp`` behind, which nothing
  restores from and the next save sweeps;
* the format across packages: a JAX-written ``MDState`` checkpoint loads
  in the port, a port-written one loads with ``repro.ckpt.load_pytree``,
  with equal positions, velocities, forces and step and equal ``keys`` in
  both manifests (the ``rng`` leaf is each framework's own);
* restart: ``MDEngine.checkpoint``, ``restore`` and 5 more steps == 10
  uninterrupted steps, bit for bit (classical only and with the DP
  provider); an ``AsyncCheckpointer`` run whose newest checkpoint is
  truncated resumes from the one before it, bit for bit;
  ``protein_md --ckpt-dir`` writes a checkpoint and resumes from it.
"""
import dataclasses
import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.ckpt import load_pytree as jload
from repro.ckpt import save_pytree as jsave
from repro.md import MDEngine as JEngine
from repro.md import EngineConfig as JConfig
from repro.md import build_solvated_protein as jbuild
from repro_torch import bridge
from repro_torch.ckpt import (AsyncCheckpointer, CheckpointCorrupt,
                              latest_step_dir, load_pytree, save_pytree)
from repro_torch.ckpt import checkpoint as ckpt_mod
from repro_torch.core import DeepmdForceProvider
from repro_torch.dp import DPModel, paper_dpa1_config
from repro_torch.health import FaultPlan, FaultSpec
from repro_torch.launch import protein_md
from repro_torch.md import (EngineConfig, MDEngine, build_solvated_protein,
                            mark_nn_group)
from repro_torch.md.engine import state_tree

torch.set_num_threads(1)

_CFG = dict(cutoff=0.9, neighbor_capacity=96, dt=0.0005, thermostat_t=200.0)
STATE_KEYS = ("positions", "velocities", "forces", "step")


def _same(a, b) -> bool:
    return all(torch.equal(getattr(a, k), getattr(b, k)) for k in STATE_KEYS)


# -- integrity ----------------------------------------------------------------

def test_crc_mismatch_detected(tmp_path):
    path = str(tmp_path / "ck")
    tree = {"x": torch.arange(12, dtype=torch.float32).reshape(4, 3),
            "y": np.int32(7)}
    save_pytree(path, tree, step=5)
    man = json.load(open(os.path.join(path, "manifest.json")))
    assert man["format"] == 2 and len(man["crc32"]) == 2
    assert man["keys"] == ["['x']", "['y']"] and man["step"] == 5
    back = load_pytree(path)
    np.testing.assert_array_equal(back["x"], tree["x"].numpy())
    like = load_pytree(path, like={"x": torch.zeros(4, 3, dtype=torch.float64),
                                   "y": torch.zeros((), dtype=torch.int32)})
    assert like["x"].dtype == torch.float64 and int(like["y"]) == 7
    # tamper with a stored CRC: verification must fail loudly
    man["crc32"][0] ^= 0x1
    json.dump(man, open(os.path.join(path, "manifest.json"), "w"))
    with pytest.raises(CheckpointCorrupt, match="CRC mismatch"):
        load_pytree(path)


def test_truncated_shard_detected(tmp_path):
    path = str(tmp_path / "ck")
    save_pytree(path, {"x": np.zeros((64, 3), np.float32)}, step=1)
    shard = os.path.join(path, "shard_host0.npz")
    with open(shard, "r+b") as f:
        f.truncate(os.path.getsize(shard) // 2)
    with pytest.raises(CheckpointCorrupt):
        load_pytree(path)
    with pytest.raises(CheckpointCorrupt, match="unreadable"):
        load_pytree(str(tmp_path / "missing"))


def test_format1_checkpoints_still_load(tmp_path):
    path = str(tmp_path / "ck")
    tree = {"x": np.arange(6, dtype=np.float32)}
    save_pytree(path, tree)
    man_path = os.path.join(path, "manifest.json")
    man = json.load(open(man_path))
    del man["crc32"]
    man["format"] = 1
    json.dump(man, open(man_path, "w"))
    np.testing.assert_array_equal(load_pytree(path)["x"], tree["x"])


def test_restore_latest_falls_back_past_truncated(tmp_path):
    plan = FaultPlan([FaultSpec("truncate_ckpt", nth=2)])
    ck = AsyncCheckpointer(str(tmp_path), keep=5, fault_plan=plan)
    ck.save({"x": torch.full((8,), 1.0)}, step=10)
    ck.save({"x": torch.full((8,), 2.0)}, step=20)   # truncated
    ck.wait()
    assert plan.faults[0].fired
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tree, step = ck.restore_latest({"x": torch.zeros(8)})
    assert step == 10                       # newest *verified*, not newest
    assert torch.equal(tree["x"], torch.full((8,), 1.0))
    assert any("corrupt" in str(x.message) for x in w)


def test_save_copies_before_the_caller_moves_on(tmp_path):
    """The host copy is taken on the caller's thread: a tensor changed in
    place right after ``save`` returns is saved as it was."""
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    x = torch.zeros(1000)
    ck.save({"x": x}, step=1)
    x += 1.0
    tree, step = ck.restore_latest({"x": torch.empty(1000)})
    assert step == 1 and float(tree["x"].abs().max()) == 0.0


def test_atomic_write_leaves_nothing_partial(tmp_path, monkeypatch):
    root = str(tmp_path)
    ck = AsyncCheckpointer(root, keep=3)
    ck.save({"x": torch.ones(4)}, step=1)
    ck.wait()

    def dies(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod.np, "savez", dies)
    with pytest.raises(OSError):
        save_pytree(os.path.join(root, "step_000000002"), {"x": torch.ones(4)},
                    step=2)
    monkeypatch.undo()
    names = sorted(os.listdir(root))
    assert names == ["step_000000001", "step_000000002.tmp"]
    assert latest_step_dir(root).endswith("step_000000001")
    tree, step = ck.restore_latest({"x": torch.zeros(4)})
    assert step == 1 and torch.equal(tree["x"], torch.ones(4))
    ck.save({"x": torch.ones(4) * 3}, step=3)        # sweeps the orphan
    ck.wait()
    assert sorted(os.listdir(root)) == ["step_000000001", "step_000000003"]


# -- the format across packages ----------------------------------------------------

@pytest.fixture(scope="module")
def jax_state():
    system, pos, _ = jbuild(3, water_per_protein_atom=1.5)
    eng = JEngine(system, JConfig(**_CFG))
    return eng.run(eng.init_state(pos, 200.0), 3)


def test_jax_checkpoint_loads_in_the_port(tmp_path, jax_state):
    path = str(tmp_path / "jax_ck")
    JEngine(None, JConfig()).checkpoint(jax_state, path)
    st = MDEngine.restore(path, device="cpu")
    for k in STATE_KEYS:
        np.testing.assert_array_equal(getattr(st, k).numpy(),
                                      np.asarray(getattr(jax_state, k)))
    assert st.positions.dtype == torch.float32 and st.step.dtype == torch.int32
    ours = str(tmp_path / "port_ck")
    MDEngine.checkpoint(None, st, ours)
    keys = [json.load(open(os.path.join(p, "manifest.json")))["keys"]
            for p in (path, ours)]
    assert keys[0] == keys[1] == ["['forces']", "['positions']", "['rng']",
                                  "['step']", "['velocities']"]


def test_port_checkpoint_loads_in_jax(tmp_path, jax_state):
    st = bridge.md_state_to_torch(jax.device_get(jax_state), "cpu")
    path = str(tmp_path / "port_ck")
    save_pytree(path, state_tree(st), step=int(st.step))
    back = jload(path)
    for k in STATE_KEYS:
        np.testing.assert_array_equal(back[k], getattr(st, k).numpy())
    assert back["rng"].dtype == np.uint8
    restored = JEngine.restore(path)
    np.testing.assert_array_equal(np.asarray(restored.positions),
                                  np.asarray(jax_state.positions))
    # and JAX's own writer on the same state: the same keys
    jpath = str(tmp_path / "jax_ck")
    jsave(jpath, dataclasses.asdict(jax_state))
    keys = [json.load(open(os.path.join(p, "manifest.json")))["keys"]
            for p in (path, jpath)]
    assert keys[0] == keys[1]


# -- restart ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def md():
    system, pos, nn = build_solvated_protein(5, water_per_protein_atom=1.5,
                                             device="cpu")
    system = mark_nn_group(system, nn)
    model = DPModel(paper_dpa1_config(ntypes=4, rcut=0.6, sel=32),
                    device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))

    def provider():
        return DeepmdForceProvider(model, params, nn, system.types,
                                   system.box.numpy(), system.n_atoms,
                                   nbr_capacity=48, skin=0.08, device="cpu")

    return system, pos, provider


@pytest.mark.parametrize("special", [False, True], ids=["classical", "dp"])
def test_restart_equals_uninterrupted(md, tmp_path, special):
    system, pos, provider = md

    def engine(**cfg):
        return MDEngine(system, EngineConfig(**_CFG, **cfg),
                        special_force=provider() if special else None)

    path = str(tmp_path / "ck")
    eng = engine(checkpoint_every=5, checkpoint_path=path)
    start = eng.init_state(pos, 200.0, seed=3)
    ref = eng.run(start, 10)
    first = engine(checkpoint_every=5, checkpoint_path=path)
    mid = first.run(start, 5)
    st = MDEngine.restore(path, device="cpu")
    assert _same(st, mid) and torch.equal(st.rng, mid.rng)
    out = engine(checkpoint_every=5, checkpoint_path=path).run(st, 5)
    assert int(out.step) == 10
    assert _same(out, ref)


def test_async_restart_falls_back_past_truncated_and_resumes(md, tmp_path):
    """Checkpoints every 5 steps, the second (step 10) truncated: the
    restore falls back to step 5, and 10 more steps from there equal the
    uninterrupted 15 bit for bit."""
    system, pos, provider = md

    def engine(ck=None):
        return MDEngine(system, EngineConfig(**_CFG, checkpoint_every=5),
                        special_force=provider(), checkpointer=ck)

    plan = FaultPlan([FaultSpec("truncate_ckpt", step=10)])
    ck = AsyncCheckpointer(str(tmp_path), keep=5, fault_plan=plan)
    eng = engine(ck)
    start = eng.init_state(pos, 200.0, seed=3)
    ref = eng.run(start, 15)
    ck.wait()
    assert plan.faults[0].fired
    os.rename(os.path.join(str(tmp_path), "step_000000015"),
              os.path.join(str(tmp_path), "moved_aside"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tree, step = ck.restore_latest(state_tree(start))
    assert step == 5
    out = engine().run(MDEngine.restore(
        os.path.join(str(tmp_path), "step_000000005"), device="cpu"), 10)
    assert _same(out, ref)
    assert torch.equal(tree["positions"], MDEngine.restore(
        os.path.join(str(tmp_path), "step_000000005"), "cpu").positions)


def test_protein_md_ckpt_dir_writes_and_resumes(tmp_path, capsys):
    ck = str(tmp_path / "run")
    st, eng = protein_md.main(["--device", "cpu", "--residues", "3",
                               "--steps", "10", "--ranks", "2",
                               "--ckpt-dir", ck])
    assert os.path.exists(os.path.join(ck, "manifest.json"))
    assert torch.equal(MDEngine.restore(ck, "cpu").positions, st.positions)
    st2, _ = protein_md.main(["--device", "cpu", "--residues", "3",
                              "--steps", "2", "--ranks", "2",
                              "--ckpt-dir", ck])
    assert "[restore] resumed from step 10" in capsys.readouterr().out
    assert int(st2.step) == 12
