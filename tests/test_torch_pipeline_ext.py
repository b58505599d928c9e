"""The rest of ``core/pipeline.py`` in the port: the replica-batching
transform (``ForcePipeline(..., n_replicas=R)``) and the comms/compute
overlap evaluation (``DDConfig(overlap=True)``), on the 160-atom system of
``tests/parity_support.py`` with the narrow DPA-1 of
``tests/test_torch_dd.py`` (skin 0.05).

* Against JAX: the overlap row classes (``gfree``, ``interior``, ``deep``,
  ``deep2``) equal ``repro.core.pipeline._overlap_masks`` on JAX's per-rank
  assembly exactly; each replica of a batched DD call, in both force modes,
  equals JAX ``single_domain_forces`` within E rtol 1e-5 and F atol 1e-4.
* Inside the port, bit for bit: overlap == sequential at the build and at
  drifted positions (``parity_support.frozen_drift``'s protocol), batched
  == unbatched per replica, batched split == batched fused; a trimmed
  ``overlap_capacity`` within ulps, a tiny one flagging overflow
  (``tests/test_pipeline.py``'s protocol).
* Per-replica flags: a replica drifted past skin/2 trips only its rebuild
  flag, a ``replica=`` fault poisons only its replica; the call sites of
  the model and the force scatter run once per force call whatever R; the
  ``make_batched_*`` shims warn once.

The batched cases run 2 replicas x 4 virtual ranks (the layout of
``chip_smoke.py``'s batched DD), the overlap cases 8 ranks.  Adds about
45 s to tier-1 (one CPU thread; the plain attention stack over the
buffers' rows is most of it).
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ddinfer as jdd
from repro.core import pipeline as jpipe
from repro.dp import DPConfig as JConfig
from repro.dp import DPModel as JModel
from repro.dp import DescriptorConfig as JDesc
from repro_torch import bridge
from repro_torch.core import ForcePipeline
from repro_torch.core import ddinfer as tdd
from repro_torch.core import pipeline as tpipe
from repro_torch.dp import DPModel
from repro_torch.health import FaultPlan, FaultSpec

torch.set_num_threads(1)

T = torch.tensor
RCUT, SEL, SKIN, RANKS = 0.6, 48, 0.05, 8
B_RANKS = 4               # the batched cases: 2 replicas x 4 virtual ranks
_rng = np.random.default_rng(7)
N, L = 160, 3.5
BOX = np.array([L, L, L], np.float32)
POS = _rng.uniform(0, L, (N, 3)).astype(np.float32)
TYPES = _rng.integers(0, 4, N).astype(np.int32)
# a second replica: POS drifted inside skin/4
POS2 = np.mod(POS + np.random.default_rng(2).uniform(-1, 1, (N, 3))
              * 0.2 * SKIN / np.sqrt(3), BOX).astype(np.float32)


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


def _config(force_mode="owner_full", ranks=RANKS, **kw):
    return tdd.suggest_config(N, BOX, ranks, RCUT, nbr_capacity=SEL,
                              slack=2.5, skin=SKIN, force_mode=force_mode,
                              coords=POS, **kw)


@pytest.fixture(scope="module")
def ref():
    """JAX single-domain E/F at POS and POS2, the port's model and params,
    the sequential port evaluation at the build and at drifted positions,
    and the overlapped one at the build positions."""
    model = _jax_model()
    params = model.init_params(jax.random.PRNGKey(0))
    fn = jax.jit(lambda p, c: jdd.single_domain_forces(
        model, p, c, jnp.asarray(TYPES), BOX, 64))
    out = {"sdf": [jax.device_get(fn(params, jnp.asarray(p)))
                   for p in (POS, POS2)]}
    out["model"] = DPModel(bridge.config_to_torch(model.cfg), device="cpu")
    out["params"] = bridge.params_to_torch(jax.device_get(params), "cpu")
    pipe = ForcePipeline(out["model"], _config(), BOX, N)
    out["state"] = st = pipe.build_assembly_fn()(T(POS), T(TYPES))
    seq = pipe.build_evaluation_fn()
    out["drifted"] = T(_frozen_drift(_config().halo_eff))
    out["seq"] = {"build": seq(out["params"], T(POS), st),
                  "drifted": seq(out["params"], out["drifted"], st)}
    out["overlap_build"] = _overlap_fn(out)(out["params"], T(POS), st)
    return out


@pytest.fixture(scope="module")
def batched(ref):
    """R = 2 (POS, POS2) x 4 virtual ranks through one batched owner_full
    pipeline: the fused call, the assembled state and the split
    evaluation."""
    pipe = ForcePipeline(ref["model"], _config(ranks=B_RANKS), BOX, N,
                         n_replicas=2)
    x = T(np.stack([POS, POS2]))
    st = pipe.build_assembly_fn()(x, T(TYPES))
    return {"pipe": pipe, "x": x, "state": st,
            "fused": pipe.build_force_fn()(ref["params"], x, T(TYPES)),
            "split": pipe.build_evaluation_fn()(ref["params"], x, st)}


def _check_ef(e, f, e_ref, f_ref):
    np.testing.assert_allclose(float(e), float(e_ref), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(f), np.asarray(f_ref), rtol=0,
                               atol=1e-4)


def _overlap_fn(ref, **kw):
    cfg = dataclasses.replace(_config(), overlap=True, **kw)
    return ForcePipeline(ref["model"], cfg, BOX, N).build_evaluation_fn()


# -- overlap ---------------------------------------------------------------

def test_overlap_row_classes_equal_jax(ref):
    """gfree / interior / deep / deep2 from the assembled state alone,
    equal to JAX's classes on JAX's per-rank assembly, exactly."""
    jc = jdd.suggest_config(N, BOX, RANKS, RCUT, nbr_capacity=SEL, slack=2.5,
                            skin=SKIN, coords=POS)
    grid = jdd._make_grid(jnp.asarray(POS), jnp.asarray(BOX), jc, N)
    jmasks = jax.device_get(jax.jit(jax.vmap(lambda r: jpipe._overlap_masks(
        jc, jdd._assemble_rank(jnp.asarray(POS), jnp.asarray(TYPES),
                               jnp.asarray(BOX), grid, jc, RCUT, r, N))))(
        jnp.arange(RANKS)))
    pipe = ForcePipeline(ref["model"], _config(), BOX, N)
    masks = tpipe._overlap_masks(pipe.cfg, tpipe._st_dict(ref["state"],
                                                          pipe.ax))
    for name, got, want in zip(("gfree", "interior", "deep", "deep2"),
                               masks, jmasks):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)
    assert int(masks[0].sum()) > int(masks[1].sum()) > 0


@pytest.mark.parametrize("where", ["build", "drifted"])
def test_overlap_equals_sequential_bitwise(ref, where):
    """The overlapped evaluation (partition + pass A + pass B + merge) ==
    the sequential one, energy and forces, bit for bit, at the positions
    the state was built at and under stale-state reuse."""
    e0, f0, d0 = ref["seq"][where]
    if where == "build":
        e1, f1, d1 = ref["overlap_build"]
    else:
        e1, f1, d1 = _overlap_fn(ref)(ref["params"], ref["drifted"],
                                      ref["state"])
    assert float(e0) == float(e1)
    assert torch.equal(f0, f1)
    assert int(d1["overflow"]) == 0 and not bool(d1["needs_rebuild"])
    assert set(d1) == set(d0) | {"interior_frac"}


def test_overlap_interior_fraction_reported(ref):
    assert 0.0 < float(ref["overlap_build"][2]["interior_frac"]) < 1.0


def test_overlap_trimmed_capacity_protocol(ref):
    """A trimmed ``overlap_capacity`` stays ulp-close while the boundary
    shell fits and reports overflow (grow-and-retry) when it does not."""
    cfg = _config()
    c = cfg.local_capacity + cfg.ghost_capacity
    e0, f0, _ = ref["seq"]["build"]
    e4, f4, d4 = _overlap_fn(ref, overlap_capacity=c - 8)(
        ref["params"], T(POS), ref["state"])
    assert int(d4["overflow"]) == 0
    assert float((f4 - f0).abs().max()) < 1e-5
    assert abs(float(e4 - e0)) / abs(float(e0)) < 1e-5
    _, _, d5 = _overlap_fn(ref, overlap_capacity=8)(ref["params"], T(POS),
                                                   ref["state"])
    assert int(d5["overflow"]) > 0


def test_overlap_needs_owner_full():
    with pytest.raises(ValueError, match="requires force_mode='owner_full'"):
        dataclasses.replace(_config("ghost_reduce"), overlap=True)


# -- replica batching ------------------------------------------------------

@pytest.mark.parametrize("force_mode", ["owner_full", "ghost_reduce"])
def test_batched_dd_matches_jax_single_domain(ref, batched, force_mode):
    """R = 2 replicas through one batched pipeline: each replica against
    JAX ``single_domain_forces``.  owner_full also holds, bit for bit, the
    split (assembly + evaluation) against the fused call and each replica
    against the unbatched pipeline's call."""
    model, params, x = ref["model"], ref["params"], batched["x"]
    if force_mode == "owner_full":
        e, f, diag = batched["fused"]
    else:
        pipe = ForcePipeline(model, _config(force_mode, ranks=B_RANKS), BOX,
                             N, n_replicas=2)
        e, f, diag = pipe.build_force_fn()(params, x, T(TYPES))
    assert e.shape == (2,) and f.shape == (2, N, 3)
    assert diag["overflow"].tolist() == [0, 0]
    assert diag["rank_cost"].shape == (2, B_RANKS)
    for r in range(2):
        _check_ef(e[r], f[r], *ref["sdf"][r])
    if force_mode == "ghost_reduce":
        return
    n_pad = _config(ranks=B_RANKS).padded_atoms(N)
    assert batched["state"].ref.shape == (2, n_pad, 3)
    es, fs, ds = batched["split"]
    assert torch.equal(es, e) and torch.equal(fs, f)
    assert ds["needs_rebuild"].tolist() == [False, False]
    single = ForcePipeline(model, _config(ranks=B_RANKS), BOX,
                           N).build_force_fn()
    for r in range(2):
        e1, f1, _ = single(params, x[r], T(TYPES))
        assert float(e1) == float(e[r]) and torch.equal(f1, f[r])


def test_batched_overlap_equals_batched_sequential(ref, batched):
    cfg = dataclasses.replace(_config(ranks=B_RANKS), overlap=True)
    ov = ForcePipeline(ref["model"], cfg, BOX, N,
                       n_replicas=2).build_evaluation_fn()
    e1, f1, d1 = ov(ref["params"], batched["x"], batched["state"])
    e0, f0, _ = batched["split"]
    assert torch.equal(e0, e1) and torch.equal(f0, f1)
    assert d1["interior_frac"].shape == (2,)


def test_batched_rebuild_flags_per_replica(ref, batched):
    """Drifting replica 1 past skin/2 trips only its flag, in the
    standalone check (with and without a model) and in the evaluation's
    diagnostics."""
    pipe, st = batched["pipe"], batched["state"]
    far = POS2.copy()
    far[0] = np.mod(far[0] + np.float32(SKIN), L)
    y = T(np.stack([POS, far]))
    assert pipe.build_check_fn()(batched["x"], st).tolist() == [False, False]
    assert pipe.build_check_fn()(y, st).tolist() == [False, True]
    check_only = ForcePipeline(None, _config(ranks=B_RANKS), BOX, N,
                               n_replicas=2)
    assert check_only.build_check_fn()(y, st).tolist() == [False, True]
    _, _, diag = pipe.build_evaluation_fn()(ref["params"], y, st)
    assert diag["needs_rebuild"].tolist() == [False, True]
    assert diag["max_disp2"].shape == (2,)


def test_replica_fault_poisons_only_its_replica(ref, batched):
    """A rank-2 ``nan_force`` aimed at replica 1 through the pipeline's
    fault hook: replica 1's forces go non-finite (rank 2 attributed),
    replica 0's stay the unfaulted bits."""
    plan = FaultPlan([FaultSpec("nan_force", step=5, rank=2, replica=1)])
    plan.sync_window(5, 1)
    pipe = ForcePipeline(ref["model"], _config(ranks=B_RANKS), BOX, N,
                         n_replicas=2, fault_hook=plan.pipeline_hook())
    _, f, diag = pipe.build_force_fn()(ref["params"], batched["x"],
                                       T(TYPES))
    assert torch.equal(f[0], batched["fused"][1][0])
    assert not bool(torch.isfinite(f[1]).all())
    bad = diag["rank_nonfinite"]
    assert bad.shape == (2, B_RANKS)
    assert bad[0].sum() == 0 and bad[1, 2] > 0
    assert int(bad[1].sum()) == int(bad[1, 2])


@pytest.mark.parametrize("n_replicas", [0, 2])
def test_call_sites_once_per_force_call(ref, monkeypatch, n_replicas):
    """Whatever R, a fused force call reaches the model once and the force
    scatter at its two sites (the gather's backward, the force reduction)
    once each, and the cell filter once per site: on the card, one launch
    each."""
    calls = {"model": 0, "scatter": 0, "filter": 0}
    model = ref["model"]
    atomic_e, scatter = model._atomic_e, tpipe.fs.force_scatter
    filt = tpipe.cell_filter

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(model, "_atomic_e", count("model", atomic_e))
    monkeypatch.setattr(tpipe.fs, "force_scatter", count("scatter", scatter))
    monkeypatch.setattr(tpipe, "cell_filter", count("filter", filt))
    monkeypatch.setattr(tdd, "cell_filter", count("filter", filt))
    pipe = ForcePipeline(model, _config(ranks=B_RANKS), BOX, N,
                         n_replicas=n_replicas)
    x = T(POS) if n_replicas == 0 else T(np.stack([POS] * n_replicas))
    pipe.build_force_fn()(ref["params"], x, T(TYPES))
    # scatter: the gather's backward and the force reduction; filter: the
    # assembly's lists and the evaluation's re-filter
    assert calls == {"model": 1, "scatter": 2, "filter": 2}


def test_batched_shims_warn_once(ref):
    from repro_torch.core import (make_batched_assembly_fn,
                                  make_batched_check_fn,
                                  make_batched_evaluation_fn,
                                  make_batched_force_fn)
    cfg = _config(ranks=B_RANKS)
    shims = {"make_batched_assembly_fn":
             lambda: make_batched_assembly_fn(ref["model"], cfg, None, BOX, N,
                                              2),
             "make_batched_evaluation_fn":
             lambda: make_batched_evaluation_fn(ref["model"], cfg, None, BOX,
                                                N, 2),
             "make_batched_check_fn":
             lambda: make_batched_check_fn(cfg, None, BOX, N, 2),
             "make_batched_force_fn":
             lambda: make_batched_force_fn(ref["model"], cfg, None, BOX, N,
                                           2)}
    for name, make in shims.items():
        tdd._DEPRECATION_WARNED.discard(name)
        with pytest.warns(DeprecationWarning, match="ForcePipeline"):
            assert callable(make())
        with warnings.catch_warnings():
            warnings.simplefilter("error")   # the second call stays silent
            assert callable(make())
    x = T(np.stack([POS, POS2]))
    st = shims["make_batched_assembly_fn"]()(x, T(TYPES))
    assert shims["make_batched_check_fn"]()(x, st).shape == (2,)


def test_batched_pipeline_refuses_a_mesh_and_bad_shapes(ref):
    with pytest.raises(ValueError, match="virtual"):
        ForcePipeline(ref["model"], _config(ranks=B_RANKS), BOX, N,
                      n_replicas=2, mesh=object())
    pipe = ForcePipeline(ref["model"], _config(ranks=B_RANKS), BOX, N,
                         n_replicas=2)
    with pytest.raises(ValueError, match=r"\(2, N, 3\)"):
        pipe.build_force_fn()(ref["params"], T(POS), T(TYPES))


def test_batched_phase_probes_per_replica_rank(ref):
    pipe = ForcePipeline(ref["model"], _config(ranks=B_RANKS), BOX, N,
                         n_replicas=2)
    probes = pipe.build_phase_probes()
    assert sorted(probes) == ["assembly", "force_reduce", "gather",
                              "inference"]
    x = T(np.stack([POS, POS2]))
    assert probes["assembly"](ref["params"], x, T(TYPES)).shape == (2, B_RANKS)
