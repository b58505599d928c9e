"""The DD force path over real processes (``launch.mesh.make_dd_mesh``,
``ForcePipeline(mesh=...)``): 4 gloo processes on the CPU, 2 of the 8
ranks each, ``file://`` rendezvous under ``tmp_path``, one intra-op thread
a process (``tests/dd_procs_worker.py``), against the virtual 8-rank path
on ``tests/test_torch_dd.py``'s 160-atom system and narrow DPA-1 (params
from the JAX PRNG through ``bridge``).

* Integer outputs equal the virtual path's exactly: each process's state
  leaves are the virtual state's rows of its ranks; counts, ``rank_cost``,
  overflow and the rebuild checks are the same.
* E and F are within the DP gate of the virtual path (E rtol 1e-5, F atol
  1e-4 x max|F|), not bit for bit: the model sees 2 ranks' rows instead of
  8 (another GEMM M) and the forces' all-reduce adds the processes'
  partial sums in gloo's ring order.  The energy and the diagnostics are
  sums the pipeline takes locally over one gather of the per-rank
  scalars.  Every process returns the same bits; stale state == fresh and
  overlap == sequential hold bit for bit inside the process path; E/F
  hold against JAX ``single_domain_forces`` at ``test_torch_dd.py``'s gate.
* World size 1 through a group in this process equals the virtual path
  bit for bit.
* A 5-step MD run (``DeepmdForceProvider`` inside ``MDEngine`` over the
  mesh, from a ``k_eval`` of 8 that overflows and grows) is the same on
  every process and within 1e-5 nm of the virtual run, with the same
  growths; ``launch.protein_md --backend gloo`` runs over the group.
* A ``nan_force`` aimed at global rank 5 poisons only process 2's second
  rank, and ``rank_nonfinite`` names rank 5; the process collectives order
  an R = 2 layout replica-major; a mesh refuses a rank count that is not a
  multiple of the world size, NCCL without a card a process, and replicas
  on a 1-D mesh (item 14(b)).

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
from repro_torch.launch.mesh import DDMesh, make_dd_mesh
from repro_torch.md import (EngineConfig, MDEngine, build_solvated_protein,
                            mark_nn_group)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("dd_procs_worker.py")
WORLD, RANKS = 4, 8
SPAWN_S, GROUP_S = 120, 60
T = torch.tensor
RCUT, SEL, SKIN = 0.6, 48, 0.05
_rng = np.random.default_rng(7)
N, L = 160, 3.5
BOX = np.array([L, L, L], np.float32)
POS = _rng.uniform(0, L, (N, 3)).astype(np.float32)
TYPES = _rng.integers(0, 4, N).astype(np.int32)
MODES = [f"{fm}-{rm}" for fm in ("owner_full", "ghost_reduce")
         for rm in ("all_reduce", "reduce_scatter")]
MD_STEPS = 5
MD_ENGINE = dict(cutoff=0.9, neighbor_capacity=96, dt=0.0005,
                 thermostat_t=200.0)
LEAVES = ("l_idx", "l_mask", "g_idx", "g_shift", "g_mask", "buf_types",
          "buf_mask", "nbr_idx", "nbr_mask")


def _frozen_drift(halo_eff, scale=2e-4, seed=1):
    """In-bound random step; atoms within 1e-3 of a plane or of a plane
    +- the halo stay put, so no local/ghost set changes."""
    crit = [np.array([0.0, L / 2])]
    crit += [(np.array([0.0, L / 2]) + d) % L for d in (halo_eff, -halo_eff)]
    crit = np.concatenate(crit)
    frozen = np.zeros(N, bool)
    for a in range(3):
        d = np.abs(POS[:, a][:, None] - crit[None, :])
        frozen |= (np.minimum(d, L - d) < 1e-3).any(1)
    step = np.random.default_rng(seed).uniform(-scale, scale, (N, 3))
    step[frozen] = 0.0
    return np.mod(POS + step, BOX).astype(np.float32)


def _jax_model():
    desc = JDesc(kind="dpa1", rcut=RCUT, rcut_smth=0.3, sel=SEL, ntypes=4,
                 neuron=(8, 16), axis_neuron=4, attn_layers=1,
                 attn_hidden=32)
    return JModel(JConfig(descriptor=desc, fitting_neuron=(24, 24)))


def _configs():
    out = {}
    for mode in MODES:
        fm, rm = mode.split("-")
        out[mode] = dataclasses.replace(
            tdd.suggest_config(N, BOX, RANKS, RCUT, nbr_capacity=SEL,
                               slack=2.5, skin=SKIN, force_mode=fm,
                               coords=POS), reduce_mode=rm)
    return out


def _md_setup():
    """The 5-residue solvated protein (20 DP atoms), ghost_reduce with a
    skin, and a model-facing capacity of 8 that the first evaluation
    overflows."""
    system, pos, nn = build_solvated_protein(5, 1.5, device="cpu")
    system = mark_nn_group(system, nn)
    cfg = tdd.suggest_config(len(nn), system.box.numpy(), RANKS, RCUT,
                             nbr_capacity=SEL, slack=2.5, skin=SKIN,
                             force_mode="ghost_reduce",
                             coords=pos.numpy()[nn])
    return (system, pos, nn), dataclasses.replace(cfg, nbr_capacity_eval=8)


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


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The workers' results, the virtual path's, JAX's single-domain E/F,
    and this process's world-size-1 group results."""
    tmp = tmp_path_factory.mktemp("dd_procs")
    jm = _jax_model()
    jparams = jm.init_params(jax.random.PRNGKey(0))
    model = DPModel(bridge.config_to_torch(jm.cfg), device="cpu")
    params = bridge.params_to_torch(jax.device_get(jparams), device="cpu")
    cfgs = _configs()
    drift = np.mod(POS + np.random.default_rng(2).uniform(
        -1, 1, (N, 3)) * 0.2 * SKIN / np.sqrt(3), BOX).astype(np.float32)
    far = drift.copy()
    far[0] = np.mod(far[0] + np.float32(SKIN), L)        # moves > skin/2
    frozen = _frozen_drift(cfgs[MODES[0]].halo_eff)
    md_system, md_cfg = _md_setup()
    task = {"world": WORLD, "rendezvous": str(tmp / "rendezvous"),
            "timeout_s": GROUP_S, "model_cfg": model.cfg, "params": params,
            "pos": POS, "types": TYPES, "box": BOX, "cfgs": cfgs,
            "drift": drift, "far": far, "frozen": frozen,
            "md_system": md_system, "md_cfg": md_cfg,
            "md_engine": MD_ENGINE, "md_steps": MD_STEPS,
            "launcher_steps": 2}
    t0 = time.monotonic()
    path, workers = _start(task, tmp)
    # the references while the workers run
    x, t = T(POS), T(TYPES)
    virtual, one = {}, {}
    for mode, cfg in cfgs.items():
        pipe = ForcePipeline(model, cfg, BOX, N)
        st = pipe.build_assembly_fn()(x, t)
        virtual[mode] = {"fused": pipe.build_force_fn()(params, x, t),
                         "state": st,
                         "eval": pipe.build_evaluation_fn()(params, T(drift),
                                                            st)}
        if cfg.force_mode == "owner_full":
            over = ForcePipeline(model, dataclasses.replace(cfg, overlap=True),
                                 BOX, N)
            virtual[mode]["overlap"] = over.build_evaluation_fn()(
                params, T(drift), st)
    # world size 1: a group of this process alone
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp / 'rendezvous1'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=GROUP_S))
    try:
        mesh = make_dd_mesh(RANKS, device="cpu")
        one["mesh"] = mesh
        for mode, cfg in cfgs.items():
            pipe = ForcePipeline(model, cfg, BOX, N, mesh=mesh)
            st = pipe.build_assembly_fn()(x, t)
            one[mode] = {"fused": pipe.build_force_fn()(params, x, t),
                         "state": st,
                         "eval": pipe.build_evaluation_fn()(params, T(drift),
                                                            st)}
            if cfg.force_mode == "owner_full":
                over = ForcePipeline(model, dataclasses.replace(
                    cfg, overlap=True), BOX, N, mesh=mesh)
                one[mode]["overlap"] = over.build_evaluation_fn()(
                    params, T(drift), st)
    finally:
        dist.destroy_process_group()
    e_ref, f_ref = jax.jit(lambda p, c: jdd.single_domain_forces(
        jm, p, c, jnp.asarray(TYPES), BOX, 64))(jparams, jnp.asarray(POS))
    procs = _join(path, workers, t0 + SPAWN_S)
    return {"procs": procs, "virtual": virtual, "one": one, "model": model,
            "params": params, "md_system": md_system, "md_cfg": md_cfg,
            "sdf": (np.asarray(e_ref), np.asarray(f_ref))}


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
    np.testing.assert_allclose(float(e), float(e0), rtol=1e-5)
    np.testing.assert_allclose(f.numpy(), f0.numpy(), rtol=0,
                               atol=1e-4 * float(f0.abs().max()))


@pytest.mark.parametrize("mode", MODES)
def test_integer_outputs_and_diagnostics_equal_the_virtual_path(run, mode):
    """Each process's state leaves are the virtual state's rows of its two
    ranks; the whole-mesh leaves, every diagnostic (sums of exact per-rank
    values) and the rebuild checks equal the virtual path's bit for bit."""
    v = run["virtual"][mode]
    vst = v["state"]
    for p, out in enumerate(run["procs"]):
        got = out["force_path"][mode]
        st = got["state"]
        for name in LEAVES:
            leaf = getattr(vst, name)
            rows = leaf.shape[0] // RANKS
            assert torch.equal(getattr(st, name),
                               leaf[2 * p * rows:2 * (p + 1) * rows]), name
        for name in ("l_slot", "local_count", "ghost_count", "cost_max",
                     "overflow", "ref"):
            assert torch.equal(getattr(st, name), getattr(vst, name)), name
        for call in ("fused", "eval"):
            assert _same(got[call][2], v[call][2]), call
        assert int(got["fused"][2]["overflow"]) == 0
        assert [bool(c) for c in got["check"]] == [False, True]
        assert not bool(got["eval"][2]["needs_rebuild"])


@pytest.mark.parametrize("mode", MODES)
def test_forces_within_the_dp_gate_of_virtual_and_jax(run, mode):
    v = run["virtual"][mode]
    e_ref, f_ref = run["sdf"]
    for out in run["procs"]:
        got = out["force_path"][mode]
        for call in ("fused", "eval"):
            _dp_gate(got[call], v[call])
        if "overlap" in v:
            _dp_gate(got["overlap"], v["overlap"])
        np.testing.assert_allclose(float(got["fused"][0]), float(e_ref),
                                   rtol=1e-5)
        np.testing.assert_allclose(got["fused"][1].numpy(), f_ref, rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("mode", MODES)
def test_every_process_returns_the_same_bits(run, mode):
    first = run["procs"][0]["force_path"][mode]
    for out in run["procs"][1:]:
        got = out["force_path"][mode]
        for call in ("fused", "eval", "stale", "fresh", "check", "probes"):
            assert _same(got[call], first[call]), call
        if "overlap" in first:
            assert _same(got["overlap"], first["overlap"])


@pytest.mark.parametrize("mode", MODES)
def test_stale_equals_fresh_and_overlap_equals_sequential_bitwise(run, mode):
    for out in run["procs"]:
        got = out["force_path"][mode]
        (e_s, f_s, d_s), (e_f, f_f, _) = got["stale"], got["fresh"]
        assert float(e_s) == float(e_f) and torch.equal(f_s, f_f)
        assert not bool(d_s["needs_rebuild"])
        if "overlap" in got:
            e_o, f_o, d_o = got["overlap"]
            e, f, d = got["eval"]
            assert float(e_o) == float(e) and torch.equal(f_o, f)
            assert 0 < float(d_o["interior_frac"]) <= 1
            assert all(_same(d_o[k], d[k]) for k in d)


@pytest.mark.parametrize("mode", MODES)
def test_world_size_one_equals_the_virtual_path_bitwise(run, mode):
    mesh = run["one"]["mesh"]
    assert isinstance(mesh, DDMesh) and mesh.shape == {"dd": RANKS}
    assert (mesh.world, mesh.index, mesh.ranks_per_process) == (1, 0, RANKS)
    assert mesh.backend == "gloo" and not mesh.host_copy
    got, v = run["one"][mode], run["virtual"][mode]
    assert set(got) == set(v)
    for key in v:
        assert _same(got[key], v[key]), key


def test_md_run_identical_on_every_process_with_growth(run):
    """Every process integrates the same trajectory, grows together from
    k_eval 8, and stays within 1e-5 nm of the virtual run."""
    mds = [out["md"] for out in run["procs"]]
    assert len(mds[0]["traj"]) == MD_STEPS
    for md in mds[1:]:
        assert all(torch.equal(a, b) for a, b in zip(md["traj"],
                                                     mds[0]["traj"]))
        assert md["diagnostics"] == mds[0]["diagnostics"]
        assert md["k_eval"] == mds[0]["k_eval"]
    assert mds[0]["diagnostics"]["special_growths"] >= 1
    assert mds[0]["k_eval"] > 8
    system, pos, nn = run["md_system"]
    prov = DeepmdForceProvider(run["model"], run["params"], nn, system.types,
                               system.box, system.n_atoms,
                               dd_config=run["md_cfg"], device="cpu")
    eng = MDEngine(system, EngineConfig(**MD_ENGINE), special_force=prov)
    traj = []
    eng.run(eng.init_state(pos, 200.0), MD_STEPS,
            observe=lambda s, obs: traj.append(s.positions.clone()),
            observe_every=1)
    for a, b in zip(mds[0]["traj"], traj):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)
    assert eng.diagnostics["special_growths"] == \
        mds[0]["diagnostics"]["special_growths"]
    assert prov.dd_config.k_eval == mds[0]["k_eval"]


def test_protein_md_launcher_runs_over_the_group(run):
    outs = [out["launcher"] for out in run["procs"]]
    assert bool(torch.isfinite(outs[0]["positions"]).all())
    for o in outs[1:]:
        assert _same(o, outs[0])


def test_fault_on_global_rank_5_poisons_only_process_2(run):
    for p, out in enumerate(run["procs"]):
        f = out["fault"]
        assert f["hook"]["ranks"].tolist() == [2 * p, 2 * p + 1]
        poisoned = (f["hook"]["nonfinite"] > 0).tolist()
        assert poisoned == ([False, True] if p == 2 else [False, False])
        nonfinite = f["diag"]["rank_nonfinite"]
        assert (nonfinite > 0).nonzero().reshape(-1).tolist() == [5]
        assert not f["finite"]


def test_process_collectives_order_replicas_first(run):
    chunk = 3
    for p, out in enumerate(run["procs"]):
        lay = out["layouts"]
        assert lay["first_rank"] == 2 * p
        ids = 100 * torch.arange(2)[:, None] + torch.arange(RANKS)[None]
        assert torch.equal(lay["gather_ranks"], ids.float())
        shards = (ids[..., None] + torch.arange(chunk)[None, None] * 0.01)
        want = shards.float().reshape(2, -1)[..., None].expand(2, -1, 3)
        assert torch.equal(lay["all_gather"], want)
        assert torch.equal(lay["psum"], ids.float().sum(1))
        assert torch.equal(lay["pmax"], ids.float().amax(1))
        total = float(sum(range(1, RANKS + 1)))
        assert lay["psum_scatter"].shape == (2, 2, chunk, 3)
        assert bool((lay["psum_scatter"] == total).all())


ERRORS = {"n_ranks": "not a positive multiple of the world size 4",
          "nccl": "world size 4 > \\d+ CUDA devices",
          "replicas": "14\\(b\\)"}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_mesh_refusals(run, case):
    for out in run["procs"]:
        assert re.search(ERRORS[case], out["errors"][case]), \
            out["errors"][case]
