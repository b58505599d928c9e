"""The slice as a whole: single-domain forces and the ``DeepmdForceProvider``
request path of the port against the JAX package on the same sequence of
requests (energies rtol 1e-5; forces rtol 1e-5 with atol 1e-5 x max|F|;
rebuild and overflow flags equal)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backend import ForceRequest as JRequest
from repro.core import ddinfer as jdd
from repro.core.nnpot import DeepmdForceProvider as JProvider
from repro.dp import DPConfig as JConfig
from repro.dp import DPModel as JModel
from repro.dp import DescriptorConfig as JDesc
from repro_torch import bridge
from repro_torch.backend import ForceRequest, StatefulForceBackend
from repro_torch.core import ddinfer as tdd
from repro_torch.core.nnpot import DeepmdForceProvider
from repro_torch.dp import DPModel

# small CPU tensors: one intra-op thread keeps parallel test workers
# from oversubscribing the cores
torch.set_num_threads(1)

N_ALL, L, SKIN = 80, 2.5, 0.05
BOX = np.array([L, L, L], np.float32)
T = torch.tensor
_rng = np.random.default_rng(31)
POS = _rng.uniform(0, L, (N_ALL, 3)).astype(np.float32)
TYPES = _rng.integers(0, 4, N_ALL).astype(np.int32)
NN = np.sort(_rng.choice(N_ALL, 60, replace=False))


def _requests():
    """Four drifts well inside skin/2, then one that trips the rebuild."""
    out = [POS]
    for step in range(3):
        d = _rng.normal(0, 1, (N_ALL, 3))
        d *= (SKIN / 8) / np.linalg.norm(d, axis=1, keepdims=True)
        out.append((out[-1] + d).astype(np.float32))
    far = out[-1].copy()
    far[NN[0]] += np.float32(SKIN)        # one NN atom moves > skin/2
    return out + [far]


REQUESTS = _requests()


def _jax_model(use_pallas=False):
    desc = JDesc(kind="dpa1", rcut=0.6, rcut_smth=0.3, sel=32, ntypes=4,
                 neuron=(8, 16), axis_neuron=4, attn_layers=2,
                 attn_hidden=32, attn_heads=2, use_pallas=use_pallas)
    return JModel(JConfig(descriptor=desc, fitting_neuron=(24, 24)))


def _run_jax_provider(model, params, capacity):
    prov = JProvider(model, params, NN, jnp.asarray(TYPES), BOX, N_ALL,
                     nbr_capacity=capacity, skin=SKIN)
    # the evaluation hook's own body under jax.jit (eager tracing of the
    # model costs tens of seconds on the CPU; the results are the same)
    ev = jax.jit(lambda p, x, s: jdd.single_domain_forces_nlist(
        model, p, x, prov.nn_types, prov.box_model, s))

    def backend_evaluate(nn_pos, state):
        e, f_nn = ev(prov.params, nn_pos, state)
        return e, f_nn, {"overflow": state.overflow,
                         "needs_rebuild": prov.backend_needs_rebuild(
                             nn_pos, state)}

    prov.backend_evaluate = backend_evaluate
    res = [prov.compute(JRequest(positions=jnp.asarray(p)))
           for p in REQUESTS]
    return ([(float(r.energy), np.asarray(r.forces), r.diagnostics)
             for r in res], prov.nbr_capacity, prov.growths)


@pytest.fixture(scope="module")
def ref():
    m_jnp, m_pal = _jax_model(False), _jax_model(True)
    params = m_jnp.init_params(jax.random.PRNGKey(0))
    c = jnp.asarray(POS[NN])
    t = jnp.asarray(TYPES[NN])
    out = {"params": jax.device_get(params)}
    for tag, mdl in (("jnp", m_jnp), ("pal", m_pal)):
        fn = jax.jit(lambda p, c, t, mdl=mdl: jdd.single_domain_forces(
            mdl, p, c, t, BOX, 32))
        out[f"sdf_{tag}"] = jax.device_get(fn(params, c, t))
    reps = jnp.asarray(np.stack([r[NN] for r in REQUESTS[:3]]))
    out["batched"] = jax.device_get(jax.jit(
        lambda p, c: jdd.single_domain_forces_batched(m_jnp, p, c, t, BOX,
                                                      32))(params, reps))
    fn = jdd.make_padded_batch_fn(m_jnp, 64, 32)
    pad = np.zeros((2, 64, 3), np.float32)
    pad[0, :60], pad[1, :40] = POS[NN], POS[NN[:40]]
    ptypes = np.zeros((2, 64), np.int32)
    ptypes[0, :60], ptypes[1, :40] = TYPES[NN], TYPES[NN[:40]]
    pmask = np.zeros((2, 64), np.float32)
    pmask[0, :60], pmask[1, :40] = 1, 1
    pbox = np.stack([BOX, BOX * 1.1])
    out["padded_in"] = (pad, ptypes, pmask, pbox)
    out["padded"] = jax.device_get(fn(params, *map(jnp.asarray,
                                                   out["padded_in"])))
    out["provider"] = _run_jax_provider(m_jnp, params, 32)
    out["grown"] = _run_jax_provider(m_jnp, params, 4)
    return out


def _port(ref):
    model = DPModel(bridge.config_to_torch(_jax_model().cfg), device="cpu")
    return model, bridge.params_to_torch(ref["params"], device="cpu")


def _check_ef(e, f, e_ref, f_ref):
    f_ref = np.asarray(f_ref)
    np.testing.assert_allclose(np.asarray(e), np.asarray(e_ref), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(f), f_ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(f_ref).max()))


@pytest.mark.parametrize("oracle", ["jnp", "pal"])
def test_single_domain_forces_match_jax(ref, oracle):
    model, params = _port(ref)
    e, f = tdd.single_domain_forces(model, params, T(POS[NN]), T(TYPES[NN]),
                                    BOX, 32)
    _check_ef(e, f, *ref[f"sdf_{oracle}"])


def test_single_domain_batched_matches_jax(ref):
    model, params = _port(ref)
    reps = T(np.stack([r[NN] for r in REQUESTS[:3]]))
    e, f = tdd.single_domain_forces_batched(model, params, reps,
                                            T(TYPES[NN]), BOX, 32)
    _check_ef(e, f, *ref["batched"])


def test_padded_batch_matches_jax(ref):
    model, params = _port(ref)
    fn = tdd.make_padded_batch_fn(model, 64, 32)
    e, f, over = fn(params, *map(T, ref["padded_in"]))
    _check_ef(e, f, *ref["padded"][:2])
    np.testing.assert_array_equal(over.numpy(), np.asarray(ref["padded"][2]))


def _run_port(ref, capacity):
    model, params = _port(ref)
    prov = DeepmdForceProvider(model, params, NN, TYPES, BOX, N_ALL,
                               nbr_capacity=capacity, skin=SKIN, device="cpu")
    assert isinstance(prov, StatefulForceBackend) and prov.stateful
    states, results = [], []
    for p in REQUESTS:
        results.append(prov.compute(ForceRequest(positions=T(p))))
        states.append(prov._state)
    return prov, results, states


def _check_sequence(results, want):
    for r, (e_ref, f_ref, diag_ref) in zip(results, want):
        _check_ef(r.energy, r.forces, e_ref, f_ref)
        assert r.diagnostics == diag_ref
        off = np.setdiff1d(np.arange(N_ALL), NN)
        assert float(r.forces[off].abs().max()) == 0.0


def test_provider_sequence_matches_jax(ref):
    prov, results, states = _run_port(ref, 32)
    want, capacity, growths = ref["provider"]
    _check_sequence(results, want)
    assert (prov.nbr_capacity, prov.growths) == (capacity, growths)
    # the first four requests reused one state; the fifth rebuilt it
    assert all(s is states[0] for s in states[:4])
    assert states[4] is not states[3]
    assert not any(r.diagnostics["needs_rebuild"] for r in results)


def test_provider_grows_after_overflow(ref):
    prov, results, _ = _run_port(ref, 4)
    want, capacity, growths = ref["grown"]
    assert growths > 0
    assert (prov.nbr_capacity, prov.growths) == (capacity, growths)
    _check_sequence(results, want)
    assert not any(r.diagnostics["overflow"] for r in results)


def test_provider_without_skin_matches_single_domain(ref):
    model, params = _port(ref)
    prov = DeepmdForceProvider(model, params, NN, TYPES, BOX, N_ALL,
                               nbr_capacity=32, device="cpu")
    r = prov.compute(ForceRequest(positions=T(POS)))
    _check_ef(r.energy, r.forces[NN], *ref["sdf_jnp"])


def test_provider_rejects_distributed_config(ref):
    """The port runs its decomposition on virtual ranks: a device mesh, or a
    DDConfig that is not the port's, is refused."""
    model, params = _port(ref)
    dd = dataclasses.make_dataclass("DD", [])()
    with pytest.raises(TypeError, match="repro_torch DDConfig"):
        DeepmdForceProvider(model, params, NN, TYPES, BOX, N_ALL,
                            dd_config=dd, device="cpu")
    with pytest.raises(ValueError, match="virtual"):
        DeepmdForceProvider(model, params, NN, TYPES, BOX, N_ALL,
                            mesh=object(), device="cpu")
