"""Replicas on devices (``ensemble.make_ensemble_mesh``,
``ForcePipeline(n_replicas=R, mesh=...)``, ``BatchedDeepmdProvider`` inside
``EnsembleEngine``): 4 gloo processes on the CPU in a ``(2, 2)``
``(replica x dd)`` layout, R = 4 replicas and 4 DD ranks, so each process
evaluates 2 replicas x 2 ranks (``tests/ensemble_procs_worker.py``,
``file://`` rendezvous under ``tmp_path``, one intra-op thread a process),
against the virtual R x 4 path on ``tests/test_torch_dd_procs.py``'s
160-atom system and narrow DPA-1 (params from the JAX PRNG through
``bridge``), the replicas made from a numpy seed.

* Integer outputs equal the virtual path's exactly: each process's state
  leaves are the virtual state's rows of its resident replicas and its
  ranks; counts, ``rank_cost``, overflow and the rebuild checks (only the
  drifted replica trips) are every replica's, on every process.
* E and F are within the DP gate of the virtual path (E rtol 1e-5, F atol
  1e-4 x max|F|) in all four force-mode x reduce-mode configurations, and
  each replica within 1e-4 of JAX ``single_domain_forces``.  Every process
  returns the same bits; stale == fresh and overlap == sequential hold bit
  for bit inside the process path; the replica gather keeps replica order.
* A ``(1, 1)`` layout through a group in this process equals the virtual
  path bit for bit.
* A 6-step ``EnsembleEngine`` run over the mesh is the same on every
  process after every step: with exchange on, the same ladders and accept
  counts as the virtual ensemble, positions within 1e-5 nm; with exchange
  off, within 1e-5 nm of R independent virtual ``MDEngine`` runs.
* A ``nan_force`` aimed at (replica 3, rank 2) fires only in process 3;
  the guarded run recovers with only replica 3 tripped and ends on the
  unfaulted run's bits.  ``launch.remd --backend gloo --replica-shards 2``
  runs over the group; the mesh and the pipeline refuse bad layouts.

One spawn of 4 processes for the file; each waits at most 60 s in a
rendezvous or collective and the spawn at most 120 s in all.
"""
import dataclasses
import datetime
import os
import re
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
from repro_torch.core import DeepmdForceProvider, ForcePipeline
from repro_torch.core import ddinfer as tdd
from repro_torch.dp import DPModel
from repro_torch.ensemble import (BatchedDeepmdProvider, EnsembleConfig,
                                  EnsembleEngine, make_ensemble_mesh)
from repro_torch.launch.mesh import EnsembleMesh, make_dd_mesh
from repro_torch.md import (EngineConfig, MDEngine, build_solvated_protein,
                            mark_nn_group)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("ensemble_procs_worker.py")
WORLD, SHARDS, RANKS, R = 4, 2, 4, 4
SPAWN_S, GROUP_S = 120, 60
T = torch.tensor
RCUT, SEL, SKIN = 0.6, 48, 0.05
_rng = np.random.default_rng(7)
N, L = 160, 3.5
BOX = np.array([L, L, L], np.float32)
POS = _rng.uniform(0, L, (N, 3)).astype(np.float32)
TYPES = _rng.integers(0, 4, N).astype(np.int32)
# replica 0 is the system itself, the others offsets of 2e-3 nm
XS = np.stack([POS] + [np.mod(POS + np.random.default_rng(10 + r).normal(
    0, 2e-3, POS.shape), L) for r in range(1, R)]).astype(np.float32)
MODES = [f"{fm}-{rm}" for fm in ("owner_full", "ghost_reduce")
         for rm in ("all_reduce", "reduce_scatter")]
EXTRA = ("owner_full-all_reduce", "ghost_reduce-reduce_scatter")
MD_STEPS, EXCHANGE = 6, 3
MD_ENGINE = dict(cutoff=0.9, neighbor_capacity=96, dt=0.0005)
TEMPS = (200.0, 220.0, 240.0, 260.0)
FAULT = dict(step=3, rank=2, replica=3)
LEAVES = ("l_idx", "l_mask", "g_idx", "g_shift", "g_mask", "buf_types",
          "buf_mask", "nbr_idx", "nbr_mask")
WHOLE = ("local_count", "ghost_count", "cost_max", "overflow")
INT_DIAG = ("local_count", "ghost_count", "cost_max", "rank_cost",
            "rank_nonfinite", "overflow")


def _frozen_drift(xs, halo_eff, scale=2e-4, seed=1):
    """In-bound random steps of every replica; atoms within 1e-3 of a
    plane (0 or L/2 on every axis) or of a plane +- the halo stay put, so
    no local/ghost set changes."""
    crit = [np.array([0.0, L / 2])]
    crit += [(np.array([0.0, L / 2]) + d) % L for d in (halo_eff, -halo_eff)]
    crit = np.concatenate(crit)
    out = []
    for r, x in enumerate(xs):
        frozen = np.zeros(N, bool)
        for a in range(3):
            d = np.abs(x[:, a][:, None] - crit[None, :])
            frozen |= (np.minimum(d, L - d) < 1e-3).any(1)
        step = np.random.default_rng(seed + r).uniform(-scale, scale, (N, 3))
        step[frozen] = 0.0
        out.append(np.mod(x + step, BOX))
    return np.stack(out).astype(np.float32)


def _jax_model():
    desc = JDesc(kind="dpa1", rcut=RCUT, rcut_smth=0.3, sel=SEL, ntypes=4,
                 neuron=(8, 16), axis_neuron=4, attn_layers=1,
                 attn_hidden=32)
    return JModel(JConfig(descriptor=desc, fitting_neuron=(24, 24)))


def _config(mode, n_ranks=RANKS):
    fm, rm = mode.split("-")
    return dataclasses.replace(
        tdd.suggest_config(N, BOX, n_ranks, RCUT, nbr_capacity=SEL,
                           slack=2.5, skin=SKIN, force_mode=fm, coords=POS),
        reduce_mode=rm)


def _md_setup():
    """The 5-residue solvated protein (20 DP atoms), ghost_reduce over 4
    ranks with a skin."""
    system, pos, nn = build_solvated_protein(5, 1.5, device="cpu")
    system = mark_nn_group(system, nn)
    cfg = tdd.suggest_config(len(nn), system.box.numpy(), RANKS, RCUT,
                             nbr_capacity=SEL, slack=2.5, skin=0.04,
                             force_mode="ghost_reduce",
                             coords=pos.numpy()[nn])
    return (system, pos, nn), cfg


def _start(task: dict, tmp: Path):
    """Start ``task["world"]`` worker processes on ``task``; returns the
    task's path and the processes."""
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


def _force_path(model, params, mesh, modes, x, t, drift):
    out = {}
    for mode in modes:
        pipe = ForcePipeline(model, _config(mode), BOX, N, n_replicas=R,
                             mesh=mesh)
        st = pipe.build_assembly_fn()(x, t)
        out[mode] = {"fused": pipe.build_force_fn()(params, x, t),
                     "state": st,
                     "eval": pipe.build_evaluation_fn()(params, drift, st)}
    return out


def _ensemble(model, params, md_system, md_cfg, exchange):
    system, pos, nn = md_system
    prov = BatchedDeepmdProvider(model, params, nn, system.types, system.box,
                                 system.n_atoms, n_replicas=R,
                                 dd_config=md_cfg, device="cpu")
    eng = EnsembleEngine(system, EngineConfig(**MD_ENGINE),
                         EnsembleConfig(n_replicas=R, temps=TEMPS,
                                        exchange_interval=exchange),
                         special_force=prov)
    traj, ladders = [], []

    def observe(s, obs):
        traj.append(s.positions.clone())
        ladders.append(s.ladder.clone())

    eng.run(eng.init_state(pos), MD_STEPS, observe=observe, observe_every=1)
    return {"traj": traj, "ladders": ladders,
            "accepts": eng.diagnostics["exchange_accepts"],
            "attempts": eng.diagnostics["exchange_attempts"]}


def _independent(model, params, md_system, md_cfg):
    """R independent virtual ``MDEngine`` runs: replica r at TEMPS[r] with
    seed r, as ``EnsembleEngine.init_state`` draws it."""
    system, pos, nn = md_system
    out = []
    for r in range(R):
        prov = DeepmdForceProvider(model, params, nn, system.types,
                                   system.box, system.n_atoms,
                                   dd_config=md_cfg, device="cpu")
        t_r = float(np.float32(TEMPS[r]))
        eng = MDEngine(system, EngineConfig(thermostat_t=t_r, **MD_ENGINE),
                       special_force=prov)
        traj = []
        eng.run(eng.init_state(pos, t_r, seed=r), MD_STEPS,
                observe=lambda s, obs: traj.append(s.positions.clone()),
                observe_every=1)
        out.append(traj)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The workers' results, the virtual path's, JAX's single-domain E/F
    per replica, this process's (1, 1) layout results and the virtual
    engine runs."""
    tmp = tmp_path_factory.mktemp("ensemble_procs")
    jm = _jax_model()
    jparams = jm.init_params(jax.random.PRNGKey(0))
    model = DPModel(bridge.config_to_torch(jm.cfg), device="cpu")
    params = bridge.params_to_torch(jax.device_get(jparams), device="cpu")
    cfgs = {mode: _config(mode) for mode in MODES}
    drift = np.mod(XS + np.random.default_rng(2).uniform(
        -1, 1, XS.shape) * 0.2 * SKIN / np.sqrt(3), BOX).astype(np.float32)
    far = drift.copy()
    far[1, 0] = np.mod(far[1, 0] + np.float32(SKIN), L)   # replica 1 only
    frozen = _frozen_drift(XS, cfgs[MODES[0]].halo_eff)
    md_system, md_cfg = _md_setup()
    task = {"world": WORLD, "rendezvous": str(tmp / "rendezvous"),
            "timeout_s": GROUP_S, "model_cfg": model.cfg, "params": params,
            "pos": XS, "types": TYPES, "box": BOX, "cfgs": cfgs,
            "cfg8": _config(MODES[0], 8), "extra": EXTRA,
            "drift": drift, "far": far, "frozen": frozen,
            "md_system": md_system, "md_cfg": md_cfg,
            "md_engine": MD_ENGINE, "md_steps": MD_STEPS, "temps": TEMPS,
            "exchange": EXCHANGE, "fault": FAULT, "launcher_steps": 2}
    t0 = time.monotonic()
    path, workers = _start(task, tmp)
    # the references while the workers run
    x, t = T(XS), T(TYPES)
    virtual = _force_path(model, params, None, MODES, x, t, T(drift))
    pipe = ForcePipeline(model, cfgs[MODES[0]], BOX, N, n_replicas=R)
    virtual["check"] = pipe.build_check_fn()(T(far),
                                             virtual[MODES[0]]["state"])
    one, errors = {}, {}
    errors["no_group"] = _error(lambda: make_ensemble_mesh(1, RANKS,
                                                           device="cpu"))
    # (1, 1): a group of this process alone
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp / 'rendezvous1'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=GROUP_S))
    try:
        mesh = make_ensemble_mesh(1, RANKS, device="cpu")
        one["mesh"] = (type(mesh), mesh.world, mesh.index,
                       mesh.replica_index, mesh.dd.world, mesh.dd.index,
                       mesh.shape, mesh.backend, mesh.dd.host_copy)
        one.update(_force_path(model, params, mesh, MODES[:1], x, t,
                               T(drift)))
        one["check"] = ForcePipeline(model, cfgs[MODES[0]], BOX, N,
                                     n_replicas=R, mesh=mesh).build_check_fn(
        )(T(far), one[MODES[0]]["state"])
        errors["dd_mesh_replicas"] = _error(lambda: ForcePipeline(
            model, cfgs[MODES[0]], BOX, N, n_replicas=R,
            mesh=make_dd_mesh(RANKS, device="cpu")))
    finally:
        dist.destroy_process_group()
    sdf = jax.jit(lambda p, c: jdd.single_domain_forces(
        jm, p, c, jnp.asarray(TYPES), BOX, 64))
    jax_ef = [tuple(np.asarray(a) for a in sdf(jparams, jnp.asarray(xr)))
              for xr in XS]
    remd_v = _ensemble(model, params, md_system, md_cfg, EXCHANGE)
    independent = _independent(model, params, md_system, md_cfg)
    procs = _join(path, workers, t0 + SPAWN_S)
    return {"procs": procs, "virtual": virtual, "one": one, "sdf": jax_ef,
            "remd": remd_v, "independent": independent, "errors": errors}


def _error(fn) -> str:
    try:
        fn()
    except (ValueError, RuntimeError) as exc:
        return str(exc)
    return ""


def _same(a, b) -> bool:
    """Bit for bit, through tuples, dicts and DDStates (NaN == NaN)."""
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.isnan() if a.is_floating_point() else a,
                                b.isnan() if b.is_floating_point() else b)
                and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(u, v) for u, v in zip(a, b))
    if dataclasses.is_dataclass(a):
        return all(_same(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    return a == b


def _dp_gate(got, want):
    (e, f, _), (e0, f0, _) = got, want
    np.testing.assert_allclose(e.numpy(), e0.numpy(), rtol=1e-5)
    np.testing.assert_allclose(f.numpy(), f0.numpy(), rtol=0,
                               atol=1e-4 * float(f0.abs().max()))


def _cell(p):
    """Process p's (replica shard, dd position)."""
    return divmod(p, WORLD // SHARDS)


def test_mesh_layout_is_row_major(run):
    for p, out in enumerate(run["procs"]):
        world, index, rs, col, wd, shape, dev, backend = out["mesh"]
        assert (world, index, wd) == (WORLD, p, WORLD // SHARDS)
        assert (rs, col) == _cell(p)
        assert shape == {"replica": SHARDS, "dd": RANKS}
        assert (dev, backend) == ("cpu", "gloo")


@pytest.mark.parametrize("mode", MODES)
def test_integer_outputs_and_diagnostics_equal_the_virtual_path(run, mode):
    """Each process's per-rank state leaves, ``l_slot`` and ``ref`` are the
    virtual state's rows of its resident replicas and ranks; the whole
    scalars, every diagnostic and the rebuild checks are every replica's
    and equal the virtual path's."""
    v = run["virtual"][mode]
    vst = v["state"]
    for p, out in enumerate(run["procs"]):
        rs, col = _cell(p)
        reps = slice(2 * rs, 2 * rs + 2)
        got = out["force_path"][mode]
        st = got["state"]
        for name in LEAVES:
            leaf = getattr(vst, name)[reps]
            rows = leaf.shape[1] // RANKS
            assert torch.equal(getattr(st, name),
                               leaf[:, 2 * col * rows:2 * (col + 1) * rows]), \
                name
        for name in ("l_slot", "ref"):
            assert torch.equal(getattr(st, name), getattr(vst, name)[reps])
        for name in WHOLE:
            assert getattr(st, name).shape == (R,)
            assert torch.equal(getattr(st, name), getattr(vst, name)), name
        for call in ("fused", "eval"):
            for key in INT_DIAG:
                assert torch.equal(got[call][2][key], v[call][2][key]), \
                    (call, key)
            assert got[call][2]["rank_cost"].shape == (R, RANKS)
        assert int(got["fused"][2]["overflow"].sum()) == 0
        assert not bool(got["eval"][2]["needs_rebuild"].any())


def test_rebuild_flags_trip_only_the_drifted_replica(run):
    assert run["virtual"]["check"].tolist() == [False, True, False, False]
    for out in run["procs"]:
        for mode in MODES:
            inside, beyond = out["force_path"][mode]["check"]
            assert inside.tolist() == [False] * R
            assert beyond.tolist() == [False, True, False, False]


@pytest.mark.parametrize("mode", MODES)
def test_forces_within_the_dp_gate_of_virtual_and_jax(run, mode):
    v = run["virtual"][mode]
    for out in run["procs"]:
        got = out["force_path"][mode]
        for call in ("fused", "eval"):
            _dp_gate(got[call], v[call])
        e, f, _ = got["fused"]
        for r, (e_ref, f_ref) in enumerate(run["sdf"]):
            np.testing.assert_allclose(float(e[r]), float(e_ref), rtol=1e-5)
            np.testing.assert_allclose(f[r].numpy(), f_ref, rtol=0,
                                       atol=1e-4)


@pytest.mark.parametrize("mode", MODES)
def test_every_process_returns_the_same_bits(run, mode):
    first = run["procs"][0]["force_path"][mode]
    for out in run["procs"][1:]:
        got = out["force_path"][mode]
        assert set(got) == set(first)
        for call in got:
            if call != "state":
                assert _same(got[call], first[call]), call


@pytest.mark.parametrize("mode", EXTRA)
def test_stale_equals_fresh_and_overlap_equals_sequential_bitwise(run, mode):
    for out in run["procs"]:
        got = out["force_path"][mode]
        (e_s, f_s, d_s), (e_f, f_f, _) = got["stale"], got["fresh"]
        assert torch.equal(e_s, e_f) and torch.equal(f_s, f_f)
        assert not bool(d_s["needs_rebuild"].any())
        if "overlap" in got:
            e_o, f_o, d_o = got["overlap"]
            e, f, d = got["eval"]
            assert torch.equal(e_o, e) and torch.equal(f_o, f)
            assert bool(((d_o["interior_frac"] > 0)
                         & (d_o["interior_frac"] <= 1)).all())
            assert all(_same(d_o[k], d[k]) for k in d)
            assert set(got["probes"]) == {"gather", "assembly", "inference"}
            assert all(p.shape == (R, RANKS)
                       for p in got["probes"].values())


def test_batched_shim_runs_over_the_mesh(run):
    for out in run["procs"]:
        got = out["force_path"][EXTRA[0]]
        assert _same(got["shim"], got["fused"])


def test_replica_gather_keeps_replica_order(run):
    """Rl = 2 replicas a shard: the gathered rows run 0..3, the first two
    from shard 0's process at this dd position, so an interleaved order
    (0, 2, 1, 3) fails."""
    for p, out in enumerate(run["procs"]):
        vals, ids = out["gather_order"]
        _, col = _cell(p)
        assert ids.dtype == torch.int32 and ids.tolist() == list(range(R))
        assert vals[:, 0].tolist() == list(range(R))
        assert vals[:, 1].tolist() == [col, col, 2 + col, 2 + col]


def test_one_by_one_layout_equals_the_virtual_path_bitwise(run):
    one, v = run["one"], run["virtual"]
    assert one["mesh"] == (EnsembleMesh, 1, 0, 0, 1, 0,
                           {"replica": 1, "dd": RANKS}, "gloo", False)
    assert _same(one[MODES[0]], v[MODES[0]])
    assert _same(one["check"], v["check"])


def test_ensemble_run_with_exchange_same_on_every_process(run):
    """REMD (exchange every 3 steps) over the mesh: every process the
    same positions and ladder after every step and the same exchange
    counts; the ladders and accepts are the virtual ensemble's, the
    positions within 1e-5 nm of it."""
    runs = [out["remd"] for out in run["procs"]]
    v = run["remd"]
    assert len(runs[0]["traj"]) == MD_STEPS
    for md in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(md["traj"],
                                                     runs[0]["traj"]))
        assert all(torch.equal(a, b) for a, b in zip(md["ladders"],
                                                     runs[0]["ladders"]))
        assert md["diagnostics"] == runs[0]["diagnostics"]
    d = runs[0]["diagnostics"]
    # pairs (1, 2) at step 3, (0, 1) and (2, 3) at step 6
    assert d["exchange_attempts"] == v["attempts"] == 3
    assert d["exchange_accepts"] == v["accepts"] > 0
    assert all(torch.equal(a, b) for a, b in zip(runs[0]["ladders"],
                                                 v["ladders"]))
    for a, b in zip(runs[0]["traj"], v["traj"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


def test_ensemble_run_matches_independent_virtual_runs(run):
    runs = [out["independent"] for out in run["procs"]]
    for md in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(md["traj"],
                                                     runs[0]["traj"]))
    final = runs[0]["final"]
    assert final.step.tolist() == [MD_STEPS] * R
    for r, traj in enumerate(run["independent"]):
        assert len(traj) == MD_STEPS
        for a, b in zip(runs[0]["traj"], traj):
            np.testing.assert_allclose(a[r].numpy(), b.numpy(), rtol=0,
                                       atol=1e-5)


def test_fault_on_replica_3_rank_2_fires_only_in_process_3(run):
    for p, out in enumerate(run["procs"]):
        f = out["hook_fault"]
        rs, col = _cell(p)
        assert f["hook"]["rep0"] == 2 * rs
        assert f["hook"]["ranks"].tolist() == [[2 * col, 2 * col + 1]] * 2
        poisoned = (f["hook"]["nonfinite"] > 0).tolist()
        assert poisoned == ([[False, False], [True, False]] if p == 3
                            else [[False, False], [False, False]])
        bad = (f["rank_nonfinite"] > 0).nonzero().tolist()
        assert bad == [[3, 2]]
        assert f["finite"].tolist() == [True, True, True, False]


def test_masked_recovery_trips_only_replica_3(run):
    for out in run["procs"]:
        clean, faulted = out["guarded"], out["faulted"]
        assert faulted["fired"]
        assert faulted["diagnostics"]["replica_guard_trips"] == [0, 0, 0, 1]
        assert clean["diagnostics"]["replica_guard_trips"] == [0] * R
        assert _same(faulted["final"], clean["final"])
        assert _same(faulted["traj"], clean["traj"])


def test_remd_launcher_runs_over_the_group(run):
    outs = [out["launcher"] for out in run["procs"]]
    st = outs[0]["state"]
    assert bool(torch.isfinite(st.positions).all())
    assert sorted(st.ladder.tolist()) == list(range(R))
    assert outs[0]["attempts"] == 3      # 1 pair at step 1, 2 at step 2
    for o in outs[1:]:
        assert _same(o, outs[0])


ERRORS = {"shards": "world size 4 is not a multiple of n_replica_shards 3",
          "n_dd": "n_dd 3 is not a positive multiple of the 2 processes",
          "nccl": "world size 4 > \\d+ CUDA devices",
          "cuda": "no CUDA device",
          "n_replicas": "n_replicas 3 not divisible by the 'replica' mesh "
                        "axis \\(2\\)",
          "unbatched": "runs a replica-batched pipeline",
          "dd_size": "mesh dd size 4 != grid 8",
          "provider": "needs a replica-batched provider"}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_mesh_refusals(run, case):
    for out in run["procs"]:
        assert re.search(ERRORS[case], out["errors"][case]), \
            out["errors"][case]


def test_refusals_without_a_group_and_on_a_1d_mesh(run):
    assert "needs an initialised torch.distributed" in \
        run["errors"]["no_group"]
    msg = run["errors"]["dd_mesh_replicas"]
    assert "make_ensemble_mesh" in msg and "14(b)" in msg
