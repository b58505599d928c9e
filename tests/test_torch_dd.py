"""The distributed force path of the port (virtual DD on one device:
``ForcePipeline`` and ``DeepmdForceProvider(dd_config=...)``) against the
JAX package, on the 160-atom system of ``tests/parity_support.py``
(L = 3.5, rcut 0.6, sel 48, 8 virtual ranks, skin 0.05).

The model is a narrow DPA-1 at the same cutoff and sel (embedding (8, 16),
1 attention layer x 32, fitting (24, 24)) so the CPU runs each 8-rank
force call in about a second; the kernel tests and ``chip_smoke.py`` cover
the full width.

* E/F equal JAX ``single_domain_forces`` within E rtol 1e-5 and F atol 1e-4
  (``tests/test_ensemble_dd.py``'s gate), in both force modes and both
  reduce modes; the diagnostics' counts equal the JAX per-rank assembly's.
* Contracts inside the port, bitwise: cells == dense (with one intra-op
  thread and with four), and a stale state evaluated inside the skin == a
  fresh assembly (selection-critical atoms frozen, as
  ``parity_support.frozen_drift``); the force scatter repeats bit for bit
  with several threads above the size where PyTorch's CPU accumulate turns
  to atomic adds.
* Growth saturates ``k_eval`` at the port's limit of 128; ``DDConfig``'s
  error messages.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ddinfer as jdd
from repro.dp import DPConfig as JConfig
from repro.dp import DPModel as JModel
from repro.dp import DescriptorConfig as JDesc
from repro_torch import bridge
from repro_torch.backend import ForceRequest, StatefulForceBackend
from repro_torch.core import DDConfig, DeepmdForceProvider, ForcePipeline
from repro_torch.core import ddinfer as tdd
from repro_torch.core import pipeline as tpipe
from repro_torch.dp import DPModel
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels import nbr_attn

# small CPU tensors: one intra-op thread keeps parallel test workers
# from oversubscribing the cores
torch.set_num_threads(1)

T = torch.tensor
RCUT, SEL, SKIN, RANKS = 0.6, 48, 0.05, 8
_rng = np.random.default_rng(7)
N, L = 160, 3.5
BOX = np.array([L, L, L], np.float32)
POS = _rng.uniform(0, L, (N, 3)).astype(np.float32)
TYPES = _rng.integers(0, 4, N).astype(np.int32)
MODES = [(fm, rm) for fm in ("owner_full", "ghost_reduce")
         for rm in ("all_reduce", "reduce_scatter")]


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


@contextlib.contextmanager
def _threads(n):
    prev = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def _jax_model():
    desc = JDesc(kind="dpa1", rcut=RCUT, rcut_smth=0.3, sel=SEL, ntypes=4,
                 neuron=(8, 16), axis_neuron=4, attn_layers=1,
                 attn_hidden=32)
    return JModel(JConfig(descriptor=desc, fitting_neuron=(24, 24)))


def _config(force_mode="owner_full", method="cells", **kw):
    return tdd.suggest_config(N, BOX, RANKS, RCUT, nbr_capacity=SEL,
                              slack=2.5, skin=SKIN, force_mode=force_mode,
                              nbr_method=method, coords=POS, **kw)


@pytest.fixture(scope="module")
def ref():
    """JAX single-domain E/F at the start and at two drifted positions."""
    model = _jax_model()
    params = model.init_params(jax.random.PRNGKey(0))
    fn = jax.jit(lambda p, c: jdd.single_domain_forces(
        model, p, c, jnp.asarray(TYPES), BOX, 64))
    drift = np.mod(POS + np.random.default_rng(2).uniform(
        -1, 1, (N, 3)) * 0.2 * SKIN / np.sqrt(3), BOX).astype(np.float32)
    far = drift.copy()
    far[0] = np.mod(far[0] + np.float32(SKIN), L)    # moves > skin/2
    out = {"params": jax.device_get(params), "pos": [POS, drift, far]}
    out["sdf"] = [jax.device_get(fn(params, jnp.asarray(p)))
                  for p in out["pos"]]
    return out


def _port(ref):
    model = DPModel(bridge.config_to_torch(_jax_model().cfg), device="cpu")
    return model, bridge.params_to_torch(ref["params"], device="cpu")


def _check_ef(e, f, e_ref, f_ref):
    np.testing.assert_allclose(float(e), float(e_ref), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(f), np.asarray(f_ref), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("mode", MODES, ids=["-".join(m) for m in MODES])
def test_dd_forces_match_jax_single_domain(ref, mode):
    force_mode, reduce_mode = mode
    model, params = _port(ref)
    cfg = dataclasses.replace(_config(force_mode), reduce_mode=reduce_mode)
    prov = DeepmdForceProvider(model, params, np.arange(N), TYPES, BOX, N,
                               dd_config=cfg, device="cpu")
    assert isinstance(prov, StatefulForceBackend) and prov.stateful
    reset_launch_counts()
    # the first request assembles, the second reuses the state
    res = [prov.compute(ForceRequest(positions=T(p))) for p in ref["pos"][:2]]
    for r, (e_ref, f_ref) in zip(res, ref["sdf"]):
        _check_ef(r.energy, r.forces, e_ref, f_ref)
        assert r.diagnostics == {"overflow": False, "needs_rebuild": False}
        f = r.forces.numpy()
        assert np.abs(f.sum(0)).max() <= 1e-4 * np.abs(f).sum(0).max()
    assert prov.growths == 0
    # CPU tensors take the plain versions: no kernel launches
    assert sum(launch_counts().values()) == 0


def test_fused_force_fn_without_skin_matches_jax(ref):
    model, params = _port(ref)
    cfg = tdd.suggest_config(N, BOX, RANKS, RCUT, nbr_capacity=SEL,
                             slack=2.5, coords=POS)
    prov = DeepmdForceProvider(model, params, np.arange(N), TYPES, BOX, N,
                               dd_config=cfg, device="cpu")
    assert not prov.stateful
    r = prov.compute(ForceRequest(positions=T(POS)))
    _check_ef(r.energy, r.forces, *ref["sdf"][0])
    assert int(r.diagnostics["overflow"]) == 0


@pytest.mark.parametrize("reduce_mode", ["all_reduce", "reduce_scatter"])
def test_atom_axis_padding_matches_jax(ref, reduce_mode):
    """157 atoms on 8 ranks: the atom axis is padded to 160 with parked
    atoms that join no selection; both reduce modes still match."""
    n = 157
    model, params = _port(ref)
    jm = _jax_model()
    e_ref, f_ref = jax.jit(lambda p, c: jdd.single_domain_forces(
        jm, p, c, jnp.asarray(TYPES[:n]), BOX, 64))(ref["params"],
                                                    jnp.asarray(POS[:n]))
    cfg = dataclasses.replace(
        tdd.suggest_config(n, BOX, RANKS, RCUT, nbr_capacity=SEL, slack=2.5,
                           skin=SKIN, force_mode="ghost_reduce",
                           coords=POS[:n]), reduce_mode=reduce_mode)
    pipe = ForcePipeline(model, cfg, BOX, n)
    assert pipe.n_pad == 160
    st = pipe.build_assembly_fn()(T(POS[:n]), T(TYPES[:n]))
    e, f, diag = pipe.build_evaluation_fn()(params, T(POS[:n]), st)
    assert f.shape == (n, 3) and int(diag["local_count"]) == n
    _check_ef(e, f, e_ref, f_ref)


def test_diag_counts_equal_jax_assembly(ref):
    model, params = _port(ref)
    cfg = _config("owner_full")
    jc = jdd.suggest_config(N, BOX, RANKS, RCUT, nbr_capacity=SEL, slack=2.5,
                            skin=SKIN, coords=POS)
    grid = jdd._make_grid(jnp.asarray(POS), jnp.asarray(BOX), jc, N)
    jst = jax.device_get(jax.jit(jax.vmap(lambda r: jdd._assemble_rank(
        jnp.asarray(POS), jnp.asarray(TYPES), jnp.asarray(BOX), grid, jc,
        RCUT, r, N)))(jnp.arange(RANKS)))
    pipe = ForcePipeline(model, cfg, BOX, N)
    st = pipe.build_assembly_fn()(T(POS), T(TYPES))
    _, _, diag = pipe.build_evaluation_fn()(params, T(POS), st)
    cost = jst["local_count"] + jst["ghost_count"]
    assert int(diag["local_count"]) == int(jst["local_count"].sum()) == N
    assert int(diag["ghost_count"]) == int(jst["ghost_count"].sum())
    assert int(diag["cost_max"]) == int(cost.max())
    np.testing.assert_array_equal(diag["rank_cost"].numpy(), cost)
    assert int(diag["overflow"]) == 0 and not bool(diag["needs_rebuild"])
    assert 0 < float(diag["nbr_occupancy"]) <= 1
    assert float(diag["cost_ratio"]) == pytest.approx(
        cost.max() * RANKS / cost.sum())
    np.testing.assert_array_equal(st.l_slot.numpy(), st.l_idx.numpy())
    assert not bool(pipe.build_check_fn()(T(POS), st))


def _assert_cells_equal_dense(ref, force_mode):
    model, params = _port(ref)
    out = {}
    for method in ("cells", "dense"):
        pipe = ForcePipeline(model, _config(force_mode, method), BOX, N)
        out[method] = pipe.build_force_fn()(params, T(POS), T(TYPES))
    (e_c, f_c, d_c), (e_d, f_d, d_d) = out["cells"], out["dense"]
    assert float(e_c) == float(e_d)
    assert torch.equal(f_c, f_d)
    for key in ("local_count", "ghost_count", "cost_max", "overflow"):
        assert int(d_c[key]) == int(d_d[key])


@pytest.mark.parametrize("force_mode", ["owner_full", "ghost_reduce"])
def test_cells_equal_dense_bitwise(ref, force_mode):
    _assert_cells_equal_dense(ref, force_mode)


@pytest.mark.parametrize("force_mode", ["owner_full", "ghost_reduce"])
def test_cells_equal_dense_bitwise_with_four_threads(ref, force_mode):
    with _threads(4):
        _assert_cells_equal_dense(ref, force_mode)


def test_force_scatter_repeats_bitwise_with_threads():
    """200,000 contributions onto 50 rows (far above the 32,768 elements
    where ``index_put_(accumulate=True)`` adds with atomics on several CPU
    threads): ten calls with four threads equal the one-thread result bit
    for bit, and the sums agree with float64."""
    rng = np.random.default_rng(3)
    rows = T(rng.integers(0, 50, 200_000))
    vals = T(rng.normal(0, 1e3, (200_000, 3)).astype(np.float32))
    want = tpipe._scatter_rows(50, rows, vals)
    with _threads(4):
        got = [tpipe._scatter_rows(50, rows, vals) for _ in range(10)]
    assert all(torch.equal(g, want) for g in got)
    exact = np.zeros((50, 3))
    np.add.at(exact, rows.numpy(), vals.numpy().astype(np.float64))
    np.testing.assert_allclose(want.numpy(), exact, rtol=0, atol=2.0)


@pytest.mark.parametrize("force_mode", ["owner_full", "ghost_reduce"])
def test_stale_state_equals_fresh_bitwise(ref, force_mode):
    model, params = _port(ref)
    cfg = _config(force_mode)
    pipe = ForcePipeline(model, cfg, BOX, N)
    asm, ev = pipe.build_assembly_fn(), pipe.build_evaluation_fn()
    moved = T(_frozen_drift(cfg.halo_eff))
    e_stale, f_stale, d_stale = ev(params, moved, asm(T(POS), T(TYPES)))
    e_fresh, f_fresh, _ = ev(params, moved, asm(moved, T(TYPES)))
    assert float(e_stale) == float(e_fresh)
    assert torch.equal(f_stale, f_fresh)
    assert not bool(d_stale["needs_rebuild"])


def test_provider_reuses_state_and_rebuilds(ref):
    model, params = _port(ref)
    prov = DeepmdForceProvider(model, params, np.arange(N), TYPES, BOX, N,
                               dd_config=_config("ghost_reduce"),
                               device="cpu")
    states = []
    for p in ref["pos"]:
        prov.compute(ForceRequest(positions=T(p)))
        states.append(prov._state)
    assert states[1] is states[0]            # drift inside skin/2: reused
    assert states[2] is not states[1]        # beyond: rebuilt
    assert bool(prov.needs_rebuild(T(ref["pos"][2]), states[0]))
    assert not bool(prov.needs_rebuild(T(ref["pos"][1]), states[0]))
    assert not bool(prov.state_overflow(states[2]))
    _, _, flags = prov.evaluate(T(ref["pos"][1]), states[0])
    assert set(flags["counters"]) >= {"local_count", "ghost_count",
                                      "cost_ratio", "rank_cost",
                                      "nbr_occupancy"}


def test_provider_grows_after_overflow(ref):
    model, params = _port(ref)
    cfg = dataclasses.replace(_config("ghost_reduce"), nbr_capacity=8,
                              nbr_capacity_eval=6)
    prov = DeepmdForceProvider(model, params, np.arange(N), TYPES, BOX, N,
                               dd_config=cfg, device="cpu")
    r = prov.compute(ForceRequest(positions=T(POS)))
    assert prov.growths > 0 and not r.diagnostics["overflow"]
    _check_ef(r.energy, r.forces, *ref["sdf"][0])


def test_dd_grow_saturates_k_eval_at_128(ref):
    model, params = _port(ref)
    cfg = dataclasses.replace(_config("owner_full"), nbr_capacity=82,
                              nbr_capacity_eval=64)
    prov = DeepmdForceProvider(model, params, np.arange(N), TYPES, BOX, N,
                               dd_config=cfg, device="cpu")
    seen = []
    for _ in range(3):
        prov.grow()
        seen.append((prov.dd_config.nbr_capacity, prov.dd_config.k_eval))
    assert seen == [(164, 128), (328, 128), (656, 128)]
    assert prov.pipeline.cfg is prov.dd_config
    assert prov.dd_config.ghost_capacity <= 27 * N


def test_single_domain_grow_raises_past_128(ref):
    model, params = _port(ref)
    prov = DeepmdForceProvider(model, params, np.arange(N), TYPES, BOX, N,
                               nbr_capacity=64, skin=SKIN, device="cpu")
    assert prov.nbr_capacity == 82
    with pytest.raises(ValueError, match="port's limit of 128"):
        prov.grow()
    assert prov.nbr_capacity == 82 and prov.growths == 0


def test_provider_rejects_a_mesh_that_is_not_a_ddmesh(ref):
    """A process mesh comes from ``launch.mesh.make_dd_mesh``
    (``tests/test_torch_dd_procs.py``); any other object is refused."""
    model, params = _port(ref)
    with pytest.raises(ValueError, match="must be a repro_torch DDMesh"):
        DeepmdForceProvider(model, params, np.arange(N), TYPES, BOX, N,
                            dd_config=_config(), mesh=object(), device="cpu")


_BASE = dict(grid_dims=(2, 2, 2), local_capacity=8, ghost_capacity=8,
             nbr_capacity=8, halo=1.2)
_ERRORS = {
    "grid_dims": (dict(grid_dims=(2, 0, 2)), "three positive factors"),
    "capacities": (dict(ghost_capacity=0), "capacities must be positive"),
    "skin": (dict(skin=-0.1), "skin must be >= 0"),
    "k_eval_wider": (dict(nbr_capacity_eval=9), "cannot widen it"),
    "k_eval_limit": (dict(nbr_capacity=200, nbr_capacity_eval=129),
                     "port's limit of 128"),
    "overlap": (dict(overlap=True, force_mode="ghost_reduce"),
                "requires force_mode='owner_full'"),
    "overlap_capacity": (dict(overlap_capacity=-1), "overlap_capacity"),
}


@pytest.mark.parametrize("case", sorted(_ERRORS))
def test_ddconfig_error_messages(case):
    kw, msg = _ERRORS[case]
    with pytest.raises(ValueError, match=msg):
        DDConfig(**{**_BASE, **kw})
    assert DDConfig(**{**_BASE, "nbr_capacity": 200,
                       "nbr_capacity_eval": 128}).k_eval == nbr_attn.MAX_K
    with pytest.raises(ValueError, match="exceeds half box"):
        ForcePipeline(None, DDConfig(**{**_BASE, "halo": 2.0}), BOX, N)
