"""Descriptor and model of the port against the JAX package (jnp path and
Pallas path in interpret mode), parameters carried over by the bridge.

Gates (those of tests/test_dp_pallas_path.py): E rtol 1e-5; F rtol 1e-5
with atol 1e-5 x max|F|.  bf16: the port's bf16-vs-fp32 force RMSE is at
most twice JAX's own on the same inputs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dp import DPConfig as JConfig
from repro.dp import DPModel as JModel
from repro.dp import DescriptorConfig as JDesc
from repro.dp import common as jcommon
from repro.dp import networks as jnet
from repro.dp.common import EnvStats as JStats
from repro.dp.descriptors import apply_descriptor as j_apply
from repro.md.neighbors import brute_force_neighbor_list as j_nlist
from repro_torch import bridge
from repro_torch.dp import DPModel, apply_descriptor
from repro_torch.dp import common as tcommon
from repro_torch.dp import networks as tnet
from repro_torch.md.neighbors import brute_force_neighbor_list

# small CPU tensors: one intra-op thread keeps parallel test workers
# from oversubscribing the cores
torch.set_num_threads(1)

N, L, K = 56, 2.4, 32
BOX = np.array([L, L, L], np.float32)
T = torch.tensor


def _jax_models(dtype="float32"):
    desc = JDesc(kind="dpa1", rcut=0.6, rcut_smth=0.3, sel=K, ntypes=4,
                 neuron=(8, 16), axis_neuron=4, attn_layers=2,
                 attn_hidden=32, attn_heads=2)
    mk = lambda up: JModel(JConfig(
        descriptor=dataclasses.replace(desc, use_pallas=up),
        fitting_neuron=(24, 24), dtype=dtype), stats=STATS)
    return mk(False), mk(True)


_rng = np.random.default_rng(21)
STATS = JStats(davg=jnp.asarray(_rng.normal(0, 0.1, (4, 4)), jnp.float32),
               dstd=jnp.asarray(_rng.uniform(0.5, 1.5, (4, 4)), jnp.float32))
COORDS = _rng.uniform(0, L, (N, 3)).astype(np.float32)
TYPES = _rng.integers(0, 4, N).astype(np.int32)
REPLICAS = np.mod(COORDS + _rng.normal(0, 0.02, (3, N, 3)), L).astype(np.float32)
RTYPES = _rng.integers(0, 4, (3, N)).astype(np.int32)
FORCE_MASK = (_rng.random(N) > 0.3).astype(np.float32)
REPORT_MASK = FORCE_MASK * (_rng.random(N) > 0.5)


def _nl(coords):
    nl = j_nlist(jnp.asarray(coords), jnp.asarray(BOX), 0.6, K)
    return nl.idx, nl.mask


def _gathered(coords, idx, mask):
    """coords_nbr with minimum-image shifts, as DPModel._atomic_e builds."""
    idx = np.asarray(idx)
    dr = coords[np.where(idx >= 0, idx, 0)] - coords[:, None, :]
    dr = dr - BOX * np.round(dr / BOX)
    return (coords[:, None, :] + dr).astype(np.float32)


@pytest.fixture(scope="module")
def ref():
    m_jnp, m_pal = _jax_models()
    params = m_jnp.init_params(jax.random.PRNGKey(0))
    box = jnp.asarray(BOX)
    c, t = jnp.asarray(COORDS), jnp.asarray(TYPES)
    idx, mask = _nl(COORDS)
    local = jnp.ones(N)
    out = {"params": jax.device_get(params), "idx": np.asarray(idx),
           "mask": np.asarray(mask)}
    nbr = _gathered(COORDS, idx, mask)
    tn = t[jnp.where(idx >= 0, idx, 0)]
    for tag, mdl in (("jnp", m_jnp), ("pal", m_pal)):
        desc = jax.jit(lambda p, *a, cfg=mdl.cfg.descriptor: j_apply(
            p, cfg, STATS, *a))
        out[f"desc_{tag}"] = np.asarray(desc(
            params["descriptor"], c, jnp.asarray(nbr), t, tn, mask))
        out[f"ef_{tag}"] = jax.device_get(jax.jit(mdl.energy_and_forces)(
            params, c, t, idx, mask, local, box))
    out["dual"] = jax.device_get(jax.jit(m_jnp.energy_and_forces_dual)(
        params, c, t, idx, mask, jnp.asarray(FORCE_MASK),
        jnp.asarray(REPORT_MASK), box))
    out["virial"] = jax.device_get(jax.jit(m_jnp.energy_forces_virial)(
        params, c, t, idx, mask, local, box))
    lists = [_nl(x) for x in REPLICAS]
    bidx = jnp.stack([a for a, _ in lists])
    bmask = jnp.stack([b for _, b in lists])
    out["batched_idx"], out["batched_mask"] = np.asarray(bidx), np.asarray(bmask)
    for tag, types in (("shared", TYPES), ("per_replica", RTYPES)):
        out[f"batched_{tag}"] = jax.device_get(
            jax.jit(m_jnp.energy_and_forces_batched)(
                params, jnp.asarray(REPLICAS), jnp.asarray(types), bidx,
                bmask, jnp.ones((3, N)), box))
    bf_jnp, _ = _jax_models("bfloat16")
    out["ef_bf16"] = jax.device_get(jax.jit(bf_jnp.energy_and_forces)(
        params, c, t, idx, mask, local, box))
    return out


def _port(ref, dtype="float32"):
    cfg = bridge.config_to_torch(_jax_models(dtype)[0].cfg)
    model = DPModel(cfg, stats=bridge.stats_to_torch(STATS, device="cpu"),
                    device="cpu")
    return model, bridge.params_to_torch(ref["params"], device="cpu")


def _check_ef(e, f, e_ref, f_ref):
    f_ref = np.asarray(f_ref)
    np.testing.assert_allclose(np.asarray(e), np.asarray(e_ref), rtol=1e-5)
    np.testing.assert_allclose(f.numpy(), f_ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(f_ref).max()))


def test_bridge_keeps_tree_and_drops_use_pallas(ref):
    model, params = _port(ref)
    assert not hasattr(model.cfg.descriptor, "use_pallas")
    jtree = jax.tree_util.tree_structure(ref["params"])
    ttree = jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda x: x.numpy(), params))
    assert jtree == ttree
    fresh = model.init_params(torch.Generator().manual_seed(0))
    shapes = lambda tr: [tuple(np.shape(x)) for x in
                         jax.tree_util.tree_leaves(tr)]
    assert shapes(jax.tree_util.tree_map(lambda x: x.numpy(), fresh)) == \
        shapes(ref["params"])


@pytest.mark.parametrize("oracle", ["jnp", "pal"])
def test_descriptor_matches_jax(ref, oracle):
    model, params = _port(ref)
    idx = T(ref["idx"])
    nbr = T(_gathered(COORDS, ref["idx"], ref["mask"]))
    types = T(TYPES)
    d = apply_descriptor(params["descriptor"], model.cfg.descriptor,
                         model.stats, T(COORDS), nbr, types,
                         types[torch.where(idx >= 0, idx, 0)],
                         T(ref["mask"]))
    want = ref[f"desc_{oracle}"]
    np.testing.assert_allclose(d.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("oracle", ["jnp", "pal"])
def test_energy_and_forces_match_jax(ref, oracle):
    model, params = _port(ref)
    e, f = model.energy_and_forces(params, T(COORDS), T(TYPES),
                                   T(ref["idx"]), T(ref["mask"]),
                                   torch.ones(N), box=T(BOX))
    _check_ef(e, f, *ref[f"ef_{oracle}"])


def test_dual_and_virial_match_jax(ref):
    model, params = _port(ref)
    args = (params, T(COORDS), T(TYPES), T(ref["idx"]), T(ref["mask"]))
    e, f = model.energy_and_forces_dual(*args, T(FORCE_MASK),
                                        T(REPORT_MASK), box=T(BOX))
    _check_ef(e, f, *ref["dual"])
    e, f, vir = model.energy_forces_virial(*args, torch.ones(N), box=T(BOX))
    _check_ef(e, f, *ref["virial"][:2])
    want = np.asarray(ref["virial"][2])
    np.testing.assert_allclose(vir.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("types", ["shared", "per_replica"])
def test_batched_matches_jax(ref, types):
    model, params = _port(ref)
    tt = T(TYPES if types == "shared" else RTYPES)
    e, f = model.energy_and_forces_batched(
        params, T(REPLICAS), tt, T(ref["batched_idx"]),
        T(ref["batched_mask"]), torch.ones(3, N), box=T(BOX))
    _check_ef(e, f, *ref[f"batched_{types}"])


def test_coincident_atoms_finite_forces(ref):
    model, params = _port(ref)
    coords = COORDS.copy()
    coords[1] = coords[0]
    nl = brute_force_neighbor_list(T(coords), T(BOX), 0.6, K)
    e, f = model.energy_and_forces(params, T(coords), T(TYPES), nl.idx,
                                   nl.mask, torch.ones(N), box=T(BOX))
    assert bool(torch.isfinite(e)) and bool(torch.isfinite(f).all())


def test_bf16_force_error_within_twice_jax(ref):
    model, params = _port(ref, "bfloat16")
    _, fb = model.energy_and_forces(params, T(COORDS), T(TYPES),
                                    T(ref["idx"]), T(ref["mask"]),
                                    torch.ones(N), box=T(BOX))
    f32 = np.asarray(ref["ef_jnp"][1])
    rmse = lambda f: float(np.sqrt(((np.asarray(f) - f32) ** 2).mean()))
    port, jax_own = rmse(fb.numpy()), rmse(ref["ef_bf16"][1])
    assert np.isfinite(port) and 0 < port <= 2 * jax_own, (port, jax_own)


def test_common_helpers_match_jax(ref):
    """env_matrix(_shifted) (switch_fn, _guarded_env), compute_env_stats,
    layer_norm
    and the parameter count against their JAX counterparts."""
    idx, mask = ref["idx"], ref["mask"]
    want = jcommon.env_matrix(jnp.asarray(COORDS), jnp.asarray(BOX),
                              jnp.asarray(idx), jnp.asarray(mask), 0.3, 0.6)
    got = tcommon.env_matrix(T(COORDS), T(BOX), T(idx), T(mask), 0.3, 0.6)
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(b).max()))
    nbr = _gathered(COORDS, idx, mask)
    want_s = jcommon.env_matrix_shifted(jnp.asarray(COORDS), jnp.asarray(nbr),
                                        jnp.asarray(mask), 0.3, 0.6)
    got_s = tcommon.env_matrix_shifted(T(COORDS), T(nbr), T(mask), 0.3, 0.6)
    for a, b in zip(got_s, want_s):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(b).max()))
    frames = np.asarray(want[0])[None]
    js = jcommon.compute_env_stats(jnp.asarray(frames), jnp.asarray(TYPES)[None],
                                   jnp.asarray(mask)[None], 4)
    ts = tcommon.compute_env_stats(T(frames), T(TYPES)[None], T(mask)[None], 4)
    np.testing.assert_allclose(ts.davg.numpy(), np.asarray(js.davg), rtol=1e-5)
    np.testing.assert_allclose(ts.dstd.numpy(), np.asarray(js.dstd), rtol=1e-5)
    x = _rng.normal(size=(5, 16)).astype(np.float32)
    gam, bet = (_rng.normal(size=16).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        tnet.layer_norm(T(x), T(gam), T(bet)).numpy(),
        np.asarray(jnet.layer_norm(jnp.asarray(x), jnp.asarray(gam),
                                   jnp.asarray(bet))), rtol=1e-5, atol=1e-6)
    model, params = _port(ref)
    assert model.n_params(params) == jnet.count_params(ref["params"])
