"""The force scatter (``repro_torch/kernels/force_scatter.py``): the
backward of the DP model's neighbour gather, on the CPU's plain version,
and the port's forces through it against the JAX package.

* The plain scatter equals autograd's gradient of ``coords[safe]`` with the
  masked slots' cotangents at 0 (atol 1e-6 x max: only the order of the
  sums differs) and, bit for bit, a sequential float32 sum of the valid
  slots in ascending flat order; the reverse list holds exactly those
  slots in that order.
* Masked slots add nothing: other cotangents there, or padded and masked
  slots pointed at other atoms, leave the sums bitwise unchanged.
* ``neighbor_gather`` passes ``gradcheck`` and ``gradgradcheck`` in
  float64 on 12 atoms.
* Port vs JAX on the 160-atom system (rcut 0.6, sel 48; a narrow DPA-1
  with 2 heads): ``energy_and_forces`` and ``energy_and_forces_dual`` on a
  fresh list and on a skin-widened list re-filtered to the cutoff (masked
  slots that still hold an atom), at the gates of ``test_torch_model.py``
  (E rtol 1e-5; F rtol 1e-5 with atol 1e-5 x max|F|); a force-matching
  gradient (grad of grad through the gather) against ``jax.grad`` at the
  same gate per parameter, on the model without attention layers, through
  the training route (``second_order=True``: the plain env matrix under
  autograd); the kernel route's autograd Functions (the attention stack,
  the env matrix) are first order and raise when differentiated twice
  (also tested).
* With 4 intra-op threads, ten force calls on 1,200 atoms at K = 64
  (76,800 slots, above the 32,768 elements where PyTorch's CPU
  accumulate adds with atomics) give the same bits.
* The reverse list's order and the plain sums' bits on the shapes the
  card's list has to sort stably: a classical pair table (N, 2K) whose
  own-index half holds masked slots that still point at an atom, a pile-up
  (every valid slot on one atom) and one segment of 1,500 entries among
  short ones.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dp import DPConfig as JConfig
from repro.dp import DPModel as JModel
from repro.dp import DescriptorConfig as JDesc
from repro.md.neighbors import brute_force_neighbor_list as j_nlist
from repro_torch import bridge
from repro_torch.dp import DPModel
from repro_torch.dp.descriptors import DescriptorConfig
from repro_torch.dp.model import DPConfig
from repro_torch.kernels import force_scatter as fs
from repro_torch.md.neighbors import brute_force_neighbor_list

# small CPU tensors: one intra-op thread keeps parallel test workers
# from oversubscribing the cores
torch.set_num_threads(1)

T = torch.tensor
RCUT, SEL, SKIN = 0.6, 48, 0.05
_rng = np.random.default_rng(7)
N, L = 160, 3.5
BOX = np.array([L, L, L], np.float32)
POS = _rng.uniform(0, L, (N, 3)).astype(np.float32)
TYPES = _rng.integers(0, 4, N).astype(np.int32)
FORCE_MASK = (_rng.random(N) > 0.3).astype(np.float32)
REPORT_MASK = FORCE_MASK * (_rng.random(N) > 0.5)


@contextlib.contextmanager
def _threads(n):
    prev = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def _scatter_args(seed, n, k, p_valid):
    """Cotangents g (N, K, 3), idx (N, K) with -1 padding, a {0, 1} mask
    that also masks slots holding an atom, and large g on masked slots."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, (n, k)).astype(np.int32)
    idx[rng.random((n, k)) < 0.3] = -1
    mask = ((rng.random((n, k)) < p_valid) & (idx >= 0)).astype(np.float32)
    g = rng.normal(0, 1, (n, k, 3)).astype(np.float32)
    g[mask == 0] = 1e6
    return T(g), T(idx), T(mask)


@pytest.mark.parametrize("n,k", [(56, 32), (160, 48)])
def test_plain_scatter_equals_the_gathers_gradient(n, k):
    g, idx, mask = _scatter_args(n + k, n, k, 0.6)
    got = fs.force_scatter_plain(g, idx, mask, n)
    # autograd's gradient of coords[safe], masked cotangents at 0
    x = torch.zeros(n, 3, requires_grad=True)
    safe = torch.where(idx >= 0, idx, torch.zeros_like(idx))
    g0 = torch.where(mask[..., None] > 0, g, torch.zeros(()))
    (want,) = torch.autograd.grad(x[safe], x, g0)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-6 * float(want.abs().max()))
    # a float32 sum of the valid slots in ascending flat order
    seq = np.zeros((n, 3), np.float32)
    gn, idn, mn = g.numpy().reshape(-1, 3), idx.numpy().ravel(), mask.numpy().ravel()
    for s in range(n * k):
        if idn[s] >= 0 and mn[s] > 0:
            seq[idn[s]] = seq[idn[s]] + gn[s]
    assert np.array_equal(got.numpy(), seq)
    # the reverse list: each atom's valid slots, ascending
    perm, off = fs.reverse_list(idx, mask, n)
    valid = (idn >= 0) & (mn > 0)
    assert int(off[-1]) == int(valid.sum()) and int(off[0]) == 0
    for j in range(n):
        slots = perm[off[j]:off[j + 1]].numpy()
        assert np.array_equal(slots, np.flatnonzero(valid & (idn == j)))


def test_masked_slots_add_nothing():
    n, k = 160, 48
    g, idx, mask = _scatter_args(3, n, k, 0.5)
    want = fs.force_scatter_plain(g, idx, mask, n)
    masked = mask == 0
    g2 = g.clone()
    g2[masked] = torch.randn(int(masked.sum()), 3) * 1e8
    assert torch.equal(fs.force_scatter_plain(g2, idx, mask, n), want)
    idx2 = idx.clone()
    idx2[masked] = torch.randint(0, n, (int(masked.sum()),), dtype=idx.dtype)
    assert torch.equal(fs.force_scatter_plain(g, idx2, mask, n), want)
    assert not bool(fs.force_scatter_plain(
        g, idx, torch.zeros_like(mask), n).any())
    assert fs.force_scatter_plain(g[:0], idx[:0], mask[:0], 0).shape == (0, 3)


def test_neighbor_gather_gradcheck_and_gradgradcheck():
    n, k = 12, 7
    _, idx, mask = _scatter_args(11, n, k, 0.6)
    m = mask.double()[..., None]
    c = torch.tensor(np.random.default_rng(12).normal(size=(n, 3)),
                     dtype=torch.float64, requires_grad=True)
    # the masked slots' outputs count as constants: the function under
    # test multiplies them by 0, as the DP model's cotangent there is 0
    fn = lambda x: torch.sin(fs.neighbor_gather(x, idx, mask)) * m
    assert torch.autograd.gradcheck(fn, (c,))
    assert torch.autograd.gradgradcheck(fn, (c,))


def _jax_model(attn_layers=2):
    desc = JDesc(kind="dpa1", rcut=RCUT, rcut_smth=0.3, sel=SEL, ntypes=4,
                 neuron=(8, 16), axis_neuron=4, attn_layers=attn_layers,
                 attn_hidden=32, attn_heads=2)
    return JModel(JConfig(descriptor=desc, fitting_neuron=(24, 24)))


def _lists():
    """{"fresh": the list at rcut, "refiltered": the list at rcut + skin
    with the mask re-filtered to rcut} as numpy (idx, mask)."""
    fresh = j_nlist(jnp.asarray(POS), jnp.asarray(BOX), RCUT, SEL)
    wide = j_nlist(jnp.asarray(POS), jnp.asarray(BOX), RCUT + SKIN, 64)
    idx, mask = np.asarray(wide.idx), np.asarray(wide.mask)
    dr = POS[np.where(idx >= 0, idx, 0)] - POS[:, None, :]
    dr = dr - BOX * np.round(dr / BOX)
    mask = mask * ((dr * dr).sum(-1) < RCUT ** 2).astype(np.float32)
    return {"fresh": (np.asarray(fresh.idx), np.asarray(fresh.mask)),
            "refiltered": (idx, mask)}


@pytest.fixture(scope="module")
def ref():
    model = _jax_model()
    params = model.init_params(jax.random.PRNGKey(0))
    c, t, box = jnp.asarray(POS), jnp.asarray(TYPES), jnp.asarray(BOX)
    out = {"params": jax.device_get(params), "lists": _lists()}
    for name, (idx, mask) in out["lists"].items():
        i, m = jnp.asarray(idx), jnp.asarray(mask)
        out[("energy_and_forces", name)] = jax.device_get(
            jax.jit(model.energy_and_forces)(params, c, t, i, m,
                                             jnp.ones(N), box))
        out[("energy_and_forces_dual", name)] = jax.device_get(
            jax.jit(model.energy_and_forces_dual)(
                params, c, t, i, m, jnp.asarray(FORCE_MASK),
                jnp.asarray(REPORT_MASK), box))
    idx, mask = out["lists"]["refiltered"]
    w = np.random.default_rng(8).normal(size=(N, 3)).astype(np.float32)
    plain = _jax_model(attn_layers=0)
    p0 = plain.init_params(jax.random.PRNGKey(1))

    def loss(p):
        _, f = plain.energy_and_forces(p, c, t, jnp.asarray(idx),
                                       jnp.asarray(mask), jnp.ones(N), box)
        return (f * w).sum()

    out["w"], out["params_no_attn"] = w, jax.device_get(p0)
    out["force_loss_grad"] = jax.device_get(jax.grad(loss)(p0))
    return out


def _port(ref, attn_layers=2):
    model = DPModel(bridge.config_to_torch(_jax_model(attn_layers).cfg),
                    device="cpu")
    key = "params" if attn_layers else "params_no_attn"
    return model, bridge.params_to_torch(ref[key], device="cpu")


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("lst", ["fresh", "refiltered"])
@pytest.mark.parametrize("entry", ["energy_and_forces",
                                   "energy_and_forces_dual"])
def test_forces_match_jax(ref, entry, lst):
    model, params = _port(ref)
    idx, mask = ref["lists"][lst]
    masks = ((torch.ones(N),) if entry == "energy_and_forces"
             else (T(FORCE_MASK), T(REPORT_MASK)))
    e, f = getattr(model, entry)(params, T(POS), T(TYPES), T(idx), T(mask),
                                 *masks, box=T(BOX))
    e_ref, f_ref = ref[(entry, lst)]
    np.testing.assert_allclose(float(e), float(e_ref), rtol=1e-5)
    _close(f.numpy(), f_ref)


def test_force_matching_gradient_matches_jax(ref):
    """d/dparams sum(F * w): the gather's backward differentiated again."""
    model, params = _port(ref, attn_layers=0)
    leaves, tree = jax.tree_util.tree_flatten(
        params, is_leaf=lambda v: isinstance(v, torch.Tensor))
    leaves = [v.clone().requires_grad_(True) for v in leaves]
    params = jax.tree_util.tree_unflatten(tree, leaves)
    idx, mask = ref["lists"]["refiltered"]
    _, f = model.energy_and_forces(params, T(POS), T(TYPES), T(idx),
                                   T(mask), torch.ones(N), box=T(BOX),
                                   second_order=True)
    grads = torch.autograd.grad((f * T(ref["w"])).sum(), leaves,
                                allow_unused=True)
    want = jax.tree_util.tree_leaves(ref["force_loss_grad"])
    assert len(want) == len(grads)
    for got, w in zip(grads, want):
        got = torch.zeros(np.shape(w)) if got is None else got.detach()
        _close(got.numpy(), w)


def test_second_derivative_through_attention_raises(ref):
    """The attention stack's backward is first order (its stash is kept
    outside autograd's graph): forces with ``create_graph=True`` raise
    instead of giving a second derivative without the terms through the
    stash."""
    model, params = _port(ref)
    params = jax.tree_util.tree_map(
        lambda v: v.clone().requires_grad_(True), params,
        is_leaf=lambda v: isinstance(v, torch.Tensor))
    idx, mask = ref["lists"]["fresh"]
    c = T(POS).requires_grad_(True)
    e = model.total_energy(params, c, T(TYPES), T(idx), T(mask),
                           torch.ones(N), box=T(BOX))
    with pytest.raises(RuntimeError, match="differentiable once"):
        torch.autograd.grad(e, c, create_graph=True)


def test_second_derivative_through_env_mat_raises(ref):
    """The env matrix's backward is first order on every device (on the
    card it is a kernel whose result carries no graph): forces with
    ``create_graph=True`` on the kernel route raise, here on a model
    without attention layers, so the env matrix is the first Function the
    backward reaches."""
    model, params = _port(ref, attn_layers=0)
    params = jax.tree_util.tree_map(
        lambda v: v.clone().requires_grad_(True), params,
        is_leaf=lambda v: isinstance(v, torch.Tensor))
    idx, mask = ref["lists"]["fresh"]
    c = T(POS).requires_grad_(True)
    e = model.total_energy(params, c, T(TYPES), T(idx), T(mask),
                           torch.ones(N), box=T(BOX))
    with pytest.raises(RuntimeError, match="env_mat is differentiable once"):
        torch.autograd.grad(e, c, create_graph=True)


def test_forces_repeat_bitwise_with_four_threads():
    """The thread-order fault of PyTorch's CPU gather backward: ten force
    calls with four intra-op threads give the same bits."""
    n, k = 1200, 64
    side = (n / 30.0) ** (1 / 3)
    rng = np.random.default_rng(5)
    x = T(rng.uniform(0, side, (n, 3)).astype(np.float32))
    types = T(rng.integers(0, 4, n).astype(np.int32))
    box = T(np.full(3, side, np.float32))
    cfg = DPConfig(descriptor=DescriptorConfig(
        kind="dpa1", rcut=RCUT, rcut_smth=0.3, sel=k, ntypes=4,
        neuron=(8, 16), axis_neuron=4, attn_layers=1, attn_hidden=16),
        fitting_neuron=(16, 16))
    model = DPModel(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    nl = brute_force_neighbor_list(x, box, RCUT, k)
    assert n * k >= 32_768 and not bool(nl.overflow)
    with _threads(4):
        runs = [model.energy_and_forces(params, x, types, nl.idx, nl.mask,
                                        torch.ones(n), box)
                for _ in range(10)]
    e0, f0 = runs[0]
    assert all(float(e) == float(e0) and torch.equal(f, f0) for e, f in runs)


def _pair_table(seed, n, k):
    """The classical force field's pair table (N, 2K): (own i, neighbour
    j) per slot of a -1 padded list, both ends under the pair's mask, so
    the own half keeps pointing at atom i where the pair is masked."""
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, n, (n, k)).astype(np.int32)
    nbr[rng.random((n, k)) < 0.4] = -1
    m = ((rng.random((n, k)) < 0.8) & (nbr >= 0)).astype(np.float32)
    own = np.broadcast_to(np.arange(n, dtype=np.int32)[:, None], (n, k))
    return np.stack([own, nbr], -1).reshape(n, 2 * k), np.repeat(m, 2, 1)


def _pile_up(seed, n, slots):
    """Every valid slot on atom 7; padded and masked slots around it."""
    rng = np.random.default_rng(seed)
    idx = np.where(rng.random((slots, 1)) < 0.2, -1, 7).astype(np.int32)
    return idx, ((rng.random((slots, 1)) < 0.9) & (idx >= 0)).astype(
        np.float32)


def _long_segment(seed, n, slots, length=1500):
    """Atom 42 holds ``length`` slots spread over the table; the others
    hold a few each."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, (slots, 1)).astype(np.int32)
    idx[idx == 42] = 43
    idx[rng.choice(slots, length, replace=False)] = 42
    return idx, np.ones((slots, 1), np.float32)


@pytest.mark.parametrize("case,n", [("pair_table", 60), ("pile_up", 40),
                                    ("long_segment", 120)])
def test_reverse_list_orders_every_segment(case, n):
    idx, mask = {"pair_table": lambda: _pair_table(4, n, 24),
                 "pile_up": lambda: _pile_up(5, n, 3000),
                 "long_segment": lambda: _long_segment(6, n, 4000)}[case]()
    rng = np.random.default_rng(n)
    g = rng.normal(0, 1, (*idx.shape, 3)).astype(np.float32)
    g[mask == 0] = 1e6
    perm, off = fs.reverse_list(T(idx), T(mask), n)
    flat, valid = idx.ravel(), (idx.ravel() >= 0) & (mask.ravel() > 0)
    order = np.flatnonzero(valid)
    order = order[np.argsort(flat[order], kind="stable")]
    assert np.array_equal(perm[:int(off[-1])].numpy(), order)
    assert np.array_equal(off.numpy(), np.searchsorted(
        flat[order], np.arange(n + 1)))
    lengths = np.diff(off.numpy())
    assert lengths.max() >= {"pair_table": 20, "pile_up": 2000,
                             "long_segment": 1500}[case]
    # the plain sums: one float32 add per valid slot, in list order
    seq = np.zeros((n, 3), np.float32)
    rows = g.reshape(-1, 3)
    for s in order:
        seq[flat[s]] = seq[flat[s]] + rows[s]
    assert np.array_equal(
        fs.force_scatter_plain(T(g), T(idx), T(mask), n).numpy(), seq)
