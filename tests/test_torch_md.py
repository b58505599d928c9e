"""The MD substrate of the port against the JAX package (``repro.md``,
``repro.health``), on the CPU:

* systems: every field of the water box and the solvated proteins (marked
  and unmarked) equal to JAX's exactly, the chunked carve-out included;
* the force field per term (bond, angle, dihedral, LJ, Coulomb RF and the
  PME real-space term, the PME reciprocal energy) and in total: energies
  rtol 1e-5, forces atol 1e-5 x max|F|;
* the reference's own force-field cases on the port (finite, zero-sum
  forces; F = -dE/dr by finite differences; NVE conservation; PME against
  direct Ewald; the thermostat; the NN group's bonded terms removed);
* integrators and observables: leapfrog, velocity Verlet, Langevin (JAX's
  noise passed in) and Berendsen equal to JAX's within rtol 1e-6 (measured:
  the same bits, or within a few ulp), observables within rtol 1e-6;
  the port's Maxwell-Boltzmann draw by its statistics;
* guards and verdicts: ``step_guard_trip`` flags and the policy table
  equal to JAX's;
* the classical forces repeat bit for bit with four intra-op threads, and
  do not depend on the neighbour list's capacity.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import health as jhealth
from repro.md import forcefield as jff
from repro.md import integrators as jint
from repro.md import neighbors as jnb
from repro.md import observables as jobs
from repro.md import pme as jpme
from repro.md import system as jsys
from repro_torch import bridge
from repro_torch import health as thealth
from repro_torch.md import (EngineConfig, MDEngine, build_neighbor_list,
                            forcefield as tff, integrators as tint,
                            observables as tobs, pme as tpme,
                            system as tsys)

# small CPU tensors: one intra-op thread keeps parallel test workers
# from oversubscribing the cores
torch.set_num_threads(1)

T = torch.tensor
CUT = 0.9


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


def _assert_fields_equal(port, ref):
    """Every tensor field of a port dataclass equals the JAX one's, dtype
    included (nested dataclasses too)."""
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            _assert_fields_equal(a, b)
            continue
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, f.name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f.name)


@pytest.mark.parametrize("case", ["water5", "protein5", "protein8"])
@pytest.mark.parametrize("marked", [False, True])
def test_systems_equal_jax(case, marked):
    if case == "water5":
        (js_, jpos), (ts_, tpos) = (jsys.build_water_box(5),
                                    tsys.build_water_box(5, device="cpu"))
        jnn = tnn = np.arange(0, 125, 7)
    else:
        args = (5, 1.5) if case == "protein5" else (8,)
        js_, jpos, jnn = jsys.build_solvated_protein(*args)
        ts_, tpos, tnn = tsys.build_solvated_protein(*args, device="cpu")
        np.testing.assert_array_equal(tnn, jnn)
    if marked:
        js_, ts_ = jsys.mark_nn_group(js_, jnn), tsys.mark_nn_group(ts_, tnn)
    _assert_fields_equal(ts_, js_)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))


def test_chunked_carve_out_equals_jax(monkeypatch):
    """Chunks of 7 water points (the carve-out's loop, not one block) keep
    the same waters."""
    monkeypatch.setattr(tsys, "CARVE_CHUNK", 7)
    js_, jpos, _ = jsys.build_solvated_protein(8, 2.0, seed=3)
    ts_, tpos, _ = tsys.build_solvated_protein(8, 2.0, seed=3, device="cpu")
    _assert_fields_equal(ts_, js_)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))


def test_system_bridge_round_trip():
    js_, _, jnn = jsys.build_solvated_protein(5, 1.5)
    js_ = jsys.mark_nn_group(js_, jnn)
    _assert_fields_equal(bridge.system_to_torch(_np_tree(js_), "cpu"), js_)


# ---------------------------------------------------------------------------
# force field, term by term
# ---------------------------------------------------------------------------

def _with_dihedrals(js_):
    """``build_solvated_protein`` masks every dihedral: a chain of unmasked ones (every
    fourth masked) on consecutive protein atoms."""
    n = 16
    d = np.stack([np.arange(n) + i for i in range(4)], -1).astype(np.int32)
    prm = np.stack([np.linspace(0.1, 1.0, n), np.full(n, 5.0),
                    np.full(n, 3.0)], -1).astype(np.float32)
    mask = np.ones(n, np.float32)
    mask[::4] = 0.0
    top = dataclasses.replace(js_.topology, dihedrals=jnp.asarray(d),
                              dihedral_params=jnp.asarray(prm),
                              dihedral_mask=jnp.asarray(mask))
    return dataclasses.replace(js_, topology=top)


@pytest.fixture(scope="module")
def systems():
    """JAX (system, positions, list) and the port's counterparts: the
    5-residue protein (bonded terms live, dihedrals added), the same
    protein marked as the NN group, and a perturbed charged water box."""
    out = {}
    js_, jpos, jnn = jsys.build_solvated_protein(5, 1.5)
    out["protein"] = _with_dihedrals(js_), jpos
    out["protein_marked"] = jsys.mark_nn_group(js_, jnn), jpos
    jw, wpos = jsys.build_water_box(5)
    rng = np.random.default_rng(1)
    jw = dataclasses.replace(jw, charges=jnp.asarray(
        rng.uniform(-0.4, 0.4, jw.n_atoms).astype(np.float32)))
    wpos = jnp.asarray(np.mod(np.asarray(wpos) + rng.normal(
        0, 0.03, wpos.shape), np.asarray(jw.box)).astype(np.float32))
    out["water"] = jw, wpos
    res = {}
    for name, (s, p) in out.items():
        nl = jnb.build_neighbor_list(p, s.box, CUT, 96, half=True, skin=0.1)
        tnl = build_neighbor_list(T(np.asarray(p)), T(np.asarray(s.box)),
                                  CUT, 96, half=True, skin=0.1)
        np.testing.assert_array_equal(tnl.idx.numpy(), np.asarray(nl.idx))
        res[name] = (s, p, nl, bridge.system_to_torch(_np_tree(s), "cpu"),
                     T(np.asarray(p)), tnl)
    return res


def _port_ef(fn, pos):
    p = pos.clone().requires_grad_(True)
    e = fn(p)
    (g,) = torch.autograd.grad(e, p)
    return float(e.detach()), -g.numpy()


def _jax_ef(fn, pos):
    e, g = jax.value_and_grad(fn)(pos)
    return float(e), -np.asarray(g)


def _check_ef(port, ref):
    (e, f), (e_ref, f_ref) = port, ref
    assert np.isfinite(f).all()
    np.testing.assert_allclose(e, e_ref, rtol=1e-5)
    np.testing.assert_allclose(f, f_ref, rtol=0,
                               atol=1e-5 * np.abs(f_ref).max())


_PME = dict(use_pme=True, pme_grid=(16, 16, 16))
TERMS = {
    "bond": lambda m, s, p, nl: m.bond_energy(
        p, s.box, s.topology.bonds, s.topology.bond_params,
        s.topology.bond_mask),
    "angle": lambda m, s, p, nl: m.angle_energy(
        p, s.box, s.topology.angles, s.topology.angle_params,
        s.topology.angle_mask),
    "dihedral": lambda m, s, p, nl: m.dihedral_energy(
        p, s.box, s.topology.dihedrals, s.topology.dihedral_params,
        s.topology.dihedral_mask),
    "lj": lambda m, s, p, nl: m.lj_energy(p, s, nl, CUT, True),
    "coulomb_rf": lambda m, s, p, nl: m.coulomb_energy(
        p, s, nl, m.ForceFieldConfig(cutoff=CUT), True),
    "coulomb_pme_real": lambda m, s, p, nl: m.coulomb_energy(
        p, s, nl, m.ForceFieldConfig(cutoff=CUT, **_PME), False),
    "total_rf": lambda m, s, p, nl: m.classical_energy(
        p, s, nl, m.ForceFieldConfig(cutoff=CUT)),
    "total_pme": lambda m, s, p, nl: m.classical_energy(
        p, s, nl, m.ForceFieldConfig(cutoff=CUT, **_PME)),
}
CASES = [(t, s) for t in TERMS for s in ("protein", "protein_marked", "water")
         if not (t in ("bond", "angle", "dihedral") and s != "protein")]


@pytest.mark.parametrize("term,name", CASES, ids=[f"{t}-{s}" for t, s in CASES])
def test_force_field_terms_match_jax(systems, term, name):
    js_, jpos, jnl, ts_, tpos, tnl = systems[name]
    fn = TERMS[term]
    _check_ef(_port_ef(lambda p: fn(tff, ts_, p, tnl), tpos),
              _jax_ef(lambda p: fn(jff, js_, p, jnl), jpos))


def test_classical_forces_entry_point_matches_jax(systems):
    js_, jpos, jnl, ts_, tpos, tnl = systems["protein"]
    e, f = tff.classical_forces(tpos, ts_, tnl, tff.ForceFieldConfig(cutoff=CUT))
    e_ref, f_ref = jff.classical_forces(jpos, js_, jnl,
                                        jff.ForceFieldConfig(cutoff=CUT))
    assert not e.requires_grad and not f.requires_grad
    _check_ef((float(e), f.numpy()), (float(e_ref), np.asarray(f_ref)))


def test_pme_reciprocal_matches_jax(systems):
    js_, jpos, _, ts_, tpos, _ = systems["protein"]
    box = np.asarray(js_.box)
    for grid in ((16, 16, 16), (12, 14, 15)):
        _check_ef(
            _port_ef(lambda p: tpme.pme_reciprocal_energy(
                p, ts_.charges, ts_.box, grid, 4, 3.0), tpos),
            _jax_ef(lambda p: jpme.pme_reciprocal_energy(
                p, js_.charges, jnp.asarray(box), grid, 4, 3.0), jpos))


def test_pme_spread_repeats_bitwise_with_four_threads():
    """The charge spread is the ordered force scatter: 40,000 stencil
    entries onto an 8^3 grid give the same bits on every call."""
    rng = np.random.default_rng(4)
    box = T([2.0, 2.5, 3.0])
    pos = T(rng.uniform(0, 1, (625, 3)).astype(np.float32)) * box
    q = T(rng.uniform(-1, 1, 625).astype(np.float32))
    with _threads(4):
        runs = [_port_ef(lambda p: tpme.pme_reciprocal_energy(
            p, q, box, (8, 8, 8), 4, 3.0), pos) for _ in range(5)]
    assert all(e == runs[0][0] and np.array_equal(f, runs[0][1])
               for e, f in runs)


# ---------------------------------------------------------------------------
# the reference's force-field cases (tests/test_forcefield.py) on the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def water():
    return tsys.build_water_box(5, device="cpu")


def test_forces_finite_and_zero_sum(water):
    sys_, pos = water
    nl = build_neighbor_list(pos, sys_.box, 0.8, 128, half=True)
    e, f = tff.classical_forces(pos, sys_, nl, tff.ForceFieldConfig(cutoff=0.8))
    assert bool(torch.isfinite(f).all())
    assert float(f.sum(0).abs().max()) < 1e-2


def test_force_is_minus_grad(water):
    sys_, pos = water
    nl = build_neighbor_list(pos, sys_.box, 0.8, 128, half=True)
    cfg = tff.ForceFieldConfig(cutoff=0.8)
    eps = 1e-3
    _, f = tff.classical_forces(pos, sys_, nl, cfg)
    for (i, d) in [(0, 0), (10, 1), (50, 2)]:
        dp, dm = pos.clone(), pos.clone()
        dp[i, d] += eps
        dm[i, d] -= eps
        fd = -(tff.classical_energy(dp, sys_, nl, cfg)
               - tff.classical_energy(dm, sys_, nl, cfg)) / (2 * eps)
        assert abs(float(fd - f[i, d])) < 2e-2 + 0.05 * abs(float(f[i, d]))


def test_nve_energy_conservation(water):
    sys_, pos = water
    eng = MDEngine(sys_, EngineConfig(cutoff=0.8, neighbor_capacity=160,
                                      dt=0.001))
    energies = []

    def obs(s, o):
        ke = 0.5 * float((sys_.masses[:, None] * s.velocities ** 2).sum())
        energies.append(o["e_classical"] + ke)

    eng.run(eng.init_state(pos, 100.0), 60, observe=obs, observe_every=5)
    e = np.array(energies[1:])
    assert abs(e[-1] - e[0]) / abs(e[0]) < 0.05


def test_thermostat_drives_temperature(water):
    sys_, pos = water
    eng = MDEngine(sys_, EngineConfig(cutoff=0.8, neighbor_capacity=160,
                                      thermostat_t=250.0, thermostat_tau=0.1))
    st = eng.run(eng.init_state(pos, 50.0), 80)
    t = float(tobs.temperature(st.velocities, sys_.masses))
    assert 80.0 < t < 500.0


def test_pme_matches_direct_ewald():
    rng = np.random.default_rng(0)
    n = 20
    box = T([2.0, 2.5, 3.0])
    pos = T(rng.uniform(0, 1, (n, 3)).astype(np.float32)) * box
    q = T(rng.uniform(-1, 1, n).astype(np.float32))
    q = q - q.mean()
    e_pme = tpme.pme_reciprocal_energy(pos, q, box, (32, 32, 32), 4, 3.0)
    e_ref = tpme.ewald_reciprocal_reference(pos, q, box, 3.0, kmax=10)
    assert abs(float(e_pme - e_ref)) / abs(float(e_ref)) < 1e-3


def test_nn_exclusions_remove_bonded_terms():
    system, _, nn_idx = tsys.build_solvated_protein(8, device="cpu")
    marked = tsys.mark_nn_group(system, nn_idx)
    assert float(marked.topology.bond_mask.sum()) == 0.0
    assert float(marked.topology.angle_mask.sum()) == 0.0
    assert float(marked.nn_mask.sum()) == len(nn_idx)


# ---------------------------------------------------------------------------
# integrators, observables
# ---------------------------------------------------------------------------

N_INT = 300
_irng = np.random.default_rng(11)
BOX_I = np.array([3.0, 3.5, 4.0], np.float32)
ARR = {"pos": _irng.uniform(0, 1, (N_INT, 3)).astype(np.float32) * BOX_I,
       "vel": _irng.normal(0, 0.5, (N_INT, 3)).astype(np.float32),
       "frc": _irng.normal(0, 50.0, (N_INT, 3)).astype(np.float32),
       "mass": _irng.uniform(1.0, 20.0, N_INT).astype(np.float32),
       "sel": (_irng.uniform(0, 1, N_INT) < 0.4).astype(np.float32),
       "noise": _irng.normal(0, 1, (N_INT, 3)).astype(np.float32)}
CENTER = np.float32(1.7)


def _states():
    key = jax.random.PRNGKey(3)
    js_ = jint.MDState(positions=jnp.asarray(ARR["pos"]),
                       velocities=jnp.asarray(ARR["vel"]),
                       forces=jnp.asarray(ARR["frc"]),
                       step=jnp.zeros((), jnp.int32), rng=key)
    return js_, bridge.md_state_to_torch(_np_tree(js_), "cpu")


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


def test_leapfrog_and_berendsen_match_jax():
    js_, ts_ = _states()
    m, box = ARR["mass"], BOX_I
    jn = jint.leapfrog_step(js_, jnp.asarray(ARR["frc"]), jnp.asarray(m),
                            jnp.asarray(box), 0.002)
    tn = tint.leapfrog_step(ts_, T(ARR["frc"]), T(m), T(box), 0.002)
    for k in ("positions", "velocities", "forces"):
        _close(getattr(tn, k), getattr(jn, k))
    assert int(tn.step) == int(jn.step) == 1
    for target in (150.0, 3000.0):
        _close(tint.berendsen_rescale(T(ARR["vel"]), T(m), target, 0.002, 0.1),
               jint.berendsen_rescale(jnp.asarray(ARR["vel"]), jnp.asarray(m),
                                      target, 0.002, 0.1))


def test_velocity_verlet_and_langevin_match_jax():
    js_, ts_ = _states()
    m, box = ARR["mass"], BOX_I

    def jf(x):
        return -25.0 * (x - CENTER)

    def tf(x):
        return -25.0 * (x - CENTER)

    jn = jint.velocity_verlet_step(js_, jf, jnp.asarray(m), jnp.asarray(box),
                                   0.002)
    tn = tint.velocity_verlet_step(ts_, tf, T(m), T(box), 0.002)
    for k in ("positions", "velocities", "forces"):
        _close(getattr(tn, k), getattr(jn, k))
    # Langevin: JAX's own noise (the split of its key) passed to the port
    _, sub = jax.random.split(js_.rng)
    noise = jax.random.normal(sub, (N_INT, 3), jnp.float32)
    jn = jint.langevin_baoab_step(js_, jf, jnp.asarray(m), jnp.asarray(box),
                                  0.002, 300.0, 1.0)
    tn = tint.langevin_baoab_step(ts_, tf, T(m), T(box), 0.002, 300.0, 1.0,
                                  noise=T(np.asarray(noise)))
    for k in ("positions", "velocities", "forces"):
        _close(getattr(tn, k), getattr(jn, k))
    assert torch.equal(tn.rng, ts_.rng)


def test_langevin_draws_from_and_advances_the_state_generator():
    _, ts_ = _states()
    m, box = T(ARR["mass"]), T(BOX_I)
    f = lambda x: torch.zeros_like(x)
    a = tint.langevin_baoab_step(ts_, f, m, box, 0.002, 300.0, 1.0)
    b = tint.langevin_baoab_step(ts_, f, m, box, 0.002, 300.0, 1.0)
    assert torch.equal(a.velocities, b.velocities)          # same state
    assert not torch.equal(a.rng, ts_.rng)
    c = tint.langevin_baoab_step(a, f, m, box, 0.002, 300.0, 1.0)
    assert not torch.equal(c.velocities - a.velocities,
                           a.velocities - ts_.velocities)


def test_wrap_matches_jnp_mod():
    x = np.array([-3.0, -1e-8, 0.0, 2.9999998, 3.0, 7.25, -0.0],
                 np.float32)[:, None].repeat(3, 1)
    got = tint.wrap(T(x), T(np.full(3, 3.0, np.float32)))
    want = np.asarray(jnp.mod(jnp.asarray(x), jnp.float32(3.0)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sel", [False, True])
def test_observables_match_jax(sel):
    pos, vel, m = ARR["pos"], ARR["vel"], ARR["mass"]
    s_t = T(ARR["sel"]) if sel else None
    s_j = jnp.asarray(ARR["sel"]) if sel else None
    _close(tobs.kinetic_energy(T(vel), T(m)),
           jobs.kinetic_energy(jnp.asarray(vel), jnp.asarray(m)))
    _close(tobs.temperature(T(vel), T(m)),
           jobs.temperature(jnp.asarray(vel), jnp.asarray(m)))
    _close(tobs.com_drift(T(vel), T(m)),
           jobs.com_drift(jnp.asarray(vel), jnp.asarray(m)))
    _close(tobs.radius_of_gyration(T(pos), T(m), s_t),
           jobs.radius_of_gyration(jnp.asarray(pos), jnp.asarray(m), s_j))
    _close(tobs.gyration_radii_axes(T(pos), T(m), s_t),
           jobs.gyration_radii_axes(jnp.asarray(pos), jnp.asarray(m), s_j))


def test_init_velocities_statistics():
    """Zero centre-of-mass momentum, and the temperature of 20,000 atoms
    within 3% of the target (its standard error is 0.58%)."""
    m = T(np.random.default_rng(2).uniform(1.0, 20.0, 20_000)
          .astype(np.float32))
    v = tint.init_velocities(torch.Generator().manual_seed(5), m, 300.0)
    p = (m[:, None] * v).sum(0)
    assert float(p.abs().max()) <= 1e-5 * float((m[:, None] * v).abs().sum())
    assert abs(float(tobs.temperature(v, m)) - 300.0) < 9.0


# ---------------------------------------------------------------------------
# guards and verdicts
# ---------------------------------------------------------------------------

GUARDS = [dict(enabled=True),
          dict(enabled=True, check_nonfinite=False, max_disp=0.05),
          dict(enabled=True, temp_ceiling=400.0),
          dict(enabled=True, energy_jump=10.0),
          dict(enabled=True, max_disp=0.2, temp_ceiling=1e4,
               energy_jump=100.0)]


@pytest.mark.parametrize("kw", GUARDS)
@pytest.mark.parametrize("case", ["quiet", "nan", "jump", "hot", "energy"])
def test_step_guard_trip_matches_jax(kw, case):
    js_, ts_ = _states()
    prev = ARR["pos"].copy()
    pos, vel = ARR["pos"].copy(), ARR["vel"].copy()
    e_tot, e_prev = 5.0, 4.0
    if case == "nan":
        vel[3, 1] = np.nan
    elif case == "jump":
        pos[7] = np.mod(pos[7] + 0.1, BOX_I)
    elif case == "hot":
        vel *= 30.0
    elif case == "energy":
        e_tot = 60.0
    js_ = dataclasses.replace(js_, positions=jnp.asarray(pos),
                              velocities=jnp.asarray(vel))
    ts_ = dataclasses.replace(ts_, positions=T(pos), velocities=T(vel))
    want = jhealth.step_guard_trip(jhealth.GuardConfig(**kw), jnp.asarray(prev),
                                   js_, jnp.asarray(ARR["mass"]),
                                   jnp.asarray(BOX_I), jnp.float32(e_tot),
                                   jnp.float32(e_prev))
    got = thealth.step_guard_trip(thealth.GuardConfig(**kw), T(prev), ts_,
                                  T(ARR["mass"]), T(BOX_I), T(e_tot),
                                  T(e_prev))
    assert got.shape == () and bool(got) == bool(want)


def test_guard_config_checks_and_verdict_table_match_jax():
    assert thealth.RECOVERY_POLICY == jhealth.RECOVERY_POLICY
    assert thealth.VERDICT_KINDS == jhealth.VERDICT_KINDS
    for kind in thealth.VERDICT_KINDS:
        assert (thealth.WindowVerdict(kind).policy
                == jhealth.WindowVerdict(kind).policy)
    for bad in (dict(max_rollbacks=0), dict(dt_shrink=0.0),
                dict(dt_shrink=1.5)):
        with pytest.raises(ValueError):
            jhealth.GuardConfig(**bad)
        with pytest.raises(ValueError):
            thealth.GuardConfig(**bad)
    with pytest.raises(ValueError, match="unknown verdict kind"):
        thealth.WindowVerdict("fine")


# ---------------------------------------------------------------------------
# the same bits: threads, capacity
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def charged_water():
    """1,728 perturbed, charged waters: a half list of 96 slots per atom
    (165,888 slots, far above the 32,768 elements where PyTorch's CPU
    gather backward adds in thread order)."""
    sys_, pos = tsys.build_water_box(12, device="cpu")
    rng = np.random.default_rng(0)
    pos = torch.remainder(pos + T(rng.normal(0, 0.02, pos.shape)
                                  .astype(np.float32)), sys_.box)
    sys_ = dataclasses.replace(sys_, charges=T(
        rng.uniform(-0.5, 0.5, sys_.n_atoms).astype(np.float32)))
    return sys_, pos


def test_classical_forces_repeat_bitwise_with_four_threads(charged_water):
    sys_, pos = charged_water
    cfg = tff.ForceFieldConfig(cutoff=0.8)
    nl = build_neighbor_list(pos, sys_.box, 0.8, 96, half=True)
    assert nl.idx.numel() >= 32_768 and not bool(nl.overflow)
    f_one = tff.classical_forces(pos, sys_, nl, cfg)[1]
    with _threads(4):
        runs = [tff.classical_forces(pos, sys_, nl, cfg) for _ in range(10)]
    e0, f0 = runs[0]
    assert all(float(e) == float(e0) and torch.equal(f, f0) for e, f in runs)
    # the forces' bits do not depend on the thread count either (the
    # energy's sum does)
    assert torch.equal(f0, f_one)


def test_classical_forces_do_not_depend_on_list_capacity(charged_water):
    """The same valid pairs in 96 and 384 slots per atom: the same force
    bits (so a list grown mid-window changes no force)."""
    sys_, pos = charged_water
    cfg = tff.ForceFieldConfig(cutoff=0.8)
    f = [tff.classical_forces(pos, sys_, build_neighbor_list(
        pos, sys_.box, 0.8, k, half=True), cfg)[1] for k in (96, 384)]
    assert torch.equal(f[0], f[1])
