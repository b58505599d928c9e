"""The compacted-row layout of the attention stack's CUDA kernels (the
forward, and the force path's backward), on the CPU: the index arithmetic
the wrapper hands to the card (``nbr_attn.compact_rows`` and
``row_passes``), the stash helpers between the compacted and the plain
layout (``compact_stash``, ``dense_stash``), and the plain forward and
backward run over compacted rows and scattered back, against the plain
versions over all K slots and against the JAX Pallas kernels (interpret
mode).

Tolerances: compacted vs full plain version atol 1e-6 x max|out| (per
output for gradients): the same sums without their +0 terms, in another
order; vs Pallas rtol 1e-4 / atol 1e-5 x max, as ``test_torch_kernels.py``.
The stash helpers are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import nbr_attention_stack_op as j_stack_op
from repro_torch.kernels import nbr_attn, ref

torch.set_num_threads(1)

NAMES = "dg drx dry drz dsw".split()


def _masks(n=7, k=12, seed=0):
    rng = np.random.default_rng(seed)
    masks = {
        "prefix": (np.arange(k)[None, :] < rng.integers(0, k + 1, (n, 1))),
        "non_prefix": rng.random((n, k)) > 0.5,
        "empty": np.zeros((n, k), bool),
        "full": np.ones((n, k), bool),
    }
    masks["non_prefix"][2] = False                 # one atom with none valid
    masks["non_prefix"][3] = np.arange(k) == 5     # one valid slot, mid-row
    return {name: torch.tensor(m.astype(np.float32)) for name, m in masks.items()}


@pytest.mark.parametrize("kind", ["prefix", "non_prefix", "empty", "full"])
def test_compact_rows_stable_slots_and_counts(kind):
    mask = _masks()[kind]
    n, k = mask.shape
    order, count, start, rows = nbr_attn.compact_rows(mask)
    valid = mask.numpy() > 0
    want_count = valid.sum(1)
    assert sorted(order.tolist()) == list(range(n))
    assert count.tolist() == want_count[order.numpy()].tolist()
    # longest first; ties keep atom order
    keys = [(-int(want_count[a]), a) for a in range(n)]
    assert order.tolist() == [a for _, a in sorted(keys)]
    assert start.tolist() == (np.cumsum(count.numpy()) - count.numpy()).tolist()
    assert len(rows) == int(want_count.sum())
    for a, c, s in zip(order.tolist(), count.tolist(), start.tolist()):
        got = rows[s:s + c].tolist()
        assert got == [a * k + j for j in np.flatnonzero(valid[a])]


def test_row_passes_cover_the_live_atoms():
    count = torch.tensor([9, 7, 7, 3, 1, 0, 0])
    for cap in (1, 8, 10, 16, 100):
        passes = nbr_attn.row_passes(count, cap)
        atoms = [a for a0, a1, _, _ in passes for a in range(a0, a1)]
        assert atoms == [0, 1, 2, 3, 4]
        r = 0
        for a0, a1, r0, r1 in passes:
            assert r0 == r and r1 - r0 == int(count[a0:a1].sum())
            assert r1 - r0 <= cap or a1 - a0 == 1
            r = r1
    assert nbr_attn.row_passes(torch.zeros(4, dtype=torch.long)) == []


def _inputs(seed, n, k, m=16, h=32, layers=2, mask=None):
    rng = np.random.default_rng(seed)
    f = lambda *s, sd=1.0: rng.normal(0, sd, s).astype(np.float32)
    if mask is None:
        mask = (rng.random((n, k)) > 0.45).astype(np.float32)
        mask[1] = 0.0                               # no valid neighbour
        mask[2] = 0.0
        mask[2, k // 2] = 1.0                       # one, mid-row
        mask[3] = 1.0                               # all K valid
    w = [f(layers, m, h, sd=m ** -0.5) for _ in range(3)]
    w += [f(layers, h, m, sd=h ** -0.5), 1 + f(layers, m, sd=0.1),
          f(layers, m, sd=0.1)]
    args = [f(n, k, m), f(n, k), f(n, k), f(n, k),
            rng.random((n, k)).astype(np.float32), mask] + w
    return args, f(n, k, m)


class _Stacked:
    """The stacked valid rows of ``compact_rows(mask)`` laid out one padded
    row of width max(count) per atom, longest first: ``atom``/``pos`` place
    stacked row r, ``rows`` is its flat slot."""

    def __init__(self, mask):
        self.n, self.k = n, k = mask.shape
        _, count, start, self.rows = nbr_attn.compact_rows(mask)
        width = max(int(count.max()), 1) if n else 1
        self.atom = torch.arange(n).repeat_interleave(count)
        self.pos = torch.arange(len(self.rows)) - start.repeat_interleave(count)
        slot = torch.full((n, width), -1, dtype=torch.long)
        slot[self.atom, self.pos] = self.rows
        self.valid = slot >= 0
        self.idx = slot.clamp_min(0)

    def plane(self, p):      # (N, K) -> (N, W), zero padded
        return p.reshape(self.n * self.k)[self.idx] * self.valid

    def rows_of(self, t):    # (..., N, K, M) -> (..., N, W, M), zero padded
        flat = t.reshape(*t.shape[:-3], self.n * self.k, t.shape[-1])
        return flat[..., self.idx, :] * self.valid[..., None]

    def scatter(self, r, like):   # (N, W, ...) -> like (N, K, ...), zeros
        full = torch.zeros_like(like).reshape(self.n * self.k,
                                              *like.shape[2:])
        full[self.rows] = r[self.atom, self.pos]
        return full.reshape(like.shape)


def _compacted_bwd(stash, planes, weights, dout, heads):
    """The plain backward over the stacked valid rows of ``compact_rows``,
    scattered back to (N, K)."""
    s = _Stacked(planes[4])
    res = ref.nbr_attention_stack_bwd_ref(
        s.rows_of(stash), *[s.plane(p) for p in planes], *weights,
        s.rows_of(dout), heads=heads)[:5]
    return [s.scatter(r, like)
            for r, like in zip(res, [dout] + [planes[4]] * 4)]


def _compacted_fwd(g, planes, weights, heads):
    """The plain forward over the stacked valid rows of ``compact_rows``, as
    the card's forward runs it: (out scattered back to (N, K, M), the
    compacted stash (L, R, M) in stacked order, the rows' flat slots)."""
    s = _Stacked(planes[4])
    out, st = ref.nbr_attention_stack_ref(
        s.rows_of(g), *[s.plane(p) for p in planes], *weights, heads=heads,
        stash=True)
    return s.scatter(out, g), st[:, s.atom, s.pos], s.rows


def _hold(got, want, name, scale=None):
    scale = float(want.abs().max()) if scale is None else scale
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * scale + 1e-30, err_msg=name)


@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("kind", ["random", "prefix", "empty", "full"])
def test_compacted_plain_bwd_equals_full(kind, heads):
    n, k = 7, 12
    mask = None if kind == "random" else _masks(n, k, 1)[kind].numpy()
    args, ct = _inputs(5, n, k, mask=mask)
    t = list(map(torch.tensor, args))
    _, stash = ref.nbr_attention_stack_ref(*t, heads=heads, stash=True)
    full = ref.nbr_attention_stack_bwd_ref(stash, *t[1:], torch.tensor(ct),
                                           heads=heads)[:5]
    comp = _compacted_bwd(stash, t[1:6], t[6:], torch.tensor(ct), heads)
    masked = t[5] == 0
    for name, a, b in zip(NAMES, comp, full):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-6 * float(b.abs().max()) + 1e-30,
                                   err_msg=name)
        assert not bool(a[masked].any()), name      # exact zeros
        assert not bool(b[masked].any()), name


def test_compacted_plain_bwd_matches_pallas_vjp():
    n, k, m, h, layers = 6, 16, 16, 32, 2
    args, ct = _inputs(11, n, k, m, h, layers)
    ja = [jnp.asarray(a) for a in args]

    def loss(*xs):
        full = list(xs[:5]) + [ja[5]] + list(ja[6:])
        y = j_stack_op(*full, use_pallas=True, interpret=True)
        return (y * ct).sum()

    want = jax.grad(loss, tuple(range(5)))(*ja[:5])
    t = list(map(torch.tensor, args))
    _, stash = ref.nbr_attention_stack_ref(*t, stash=True)
    got = _compacted_bwd(stash, t[1:6], t[6:], torch.tensor(ct), 1)
    for name, a, b in zip(NAMES, got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(b).max()),
                                   err_msg=name)


@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("kind", ["prefix", "non_prefix", "empty", "full"])
def test_compacted_plain_fwd_equals_full(kind, heads):
    n, k = 7, 12
    args, _ = _inputs(6, n, k, mask=_masks(n, k, 2)[kind].numpy())
    t = list(map(torch.tensor, args))
    want, want_st = ref.nbr_attention_stack_ref(*t, heads=heads, stash=True)
    out, x, rows = _compacted_fwd(t[0], t[1:6], t[6:], heads)
    _hold(out, want, "out")
    masked = t[5] == 0
    assert not bool(out[masked].any()) and not bool(want[masked].any())
    st = nbr_attn.dense_stash(t[0], x, rows)
    assert torch.equal(st[0], t[0])           # layer 0 is g, masked rows too
    _hold(st, want_st, "stash")


@pytest.mark.parametrize("heads", [1, 2])
def test_compacted_plain_fwd_ignores_masked_inputs(heads):
    """Large g at the masked slots reaches no valid row, and the dense stash
    hands it back unchanged; mask weights other than 1 scale the rows."""
    n, k = 7, 12
    mask = _masks(n, k, 3)["non_prefix"].numpy()
    mask *= np.random.default_rng(4).uniform(0.5, 1.5, mask.shape)
    args, _ = _inputs(7, n, k, mask=mask.astype(np.float32))
    t = list(map(torch.tensor, args))
    masked = t[5] == 0
    big = t[0].clone()
    big[masked] = 1e6
    zero = t[0] * (~masked)[..., None]
    want = ref.nbr_attention_stack_ref(zero, *t[1:], heads=heads)
    full = ref.nbr_attention_stack_ref(big, *t[1:], heads=heads)
    out, x, rows = _compacted_fwd(big, t[1:6], t[6:], heads)
    _hold(full, want, "full plain, large masked g")
    _hold(out, want, "compacted, large masked g")
    assert not bool(out[masked].any())
    assert float(x.abs().max()) < 1e3           # only valid rows stacked
    assert torch.equal(nbr_attn.dense_stash(big, x, rows)[0], big)


def test_compacted_plain_fwd_matches_pallas():
    n, k, m, h, layers = 6, 16, 16, 32, 2
    args, _ = _inputs(12, n, k, m, h, layers)
    want = np.asarray(j_stack_op(*map(jnp.asarray, args), use_pallas=True,
                                 interpret=True))
    t = list(map(torch.tensor, args))
    out, _, _ = _compacted_fwd(t[0], t[1:6], t[6:], 1)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("kind", ["prefix", "non_prefix", "empty", "full"])
def test_stash_helpers_rebuild_the_plain_stash(kind):
    n, k = 7, 12
    args, _ = _inputs(8, n, k, mask=_masks(n, k, 5)[kind].numpy())
    t = list(map(torch.tensor, args))
    _, st = ref.nbr_attention_stack_ref(*t, stash=True)
    _, _, _, rows = nbr_attn.compact_rows(t[5])
    x = nbr_attn.compact_stash(st, rows)
    assert x.shape == (st.shape[0], len(rows), st.shape[-1])
    assert torch.equal(nbr_attn.dense_stash(t[0], x, rows), st)
    assert torch.equal(nbr_attn.compact_stash(
        nbr_attn.dense_stash(t[0], x, rows), rows), x)


def test_row_stash_is_the_cards_layout():
    args, ct = _inputs(9, 5, 8)
    t = list(map(torch.tensor, args))
    with pytest.raises(ValueError, match="rows"):
        nbr_attn.nbr_attention_stack_fwd(*t, stash="rows")
    _, count, start, rows = nbr_attn.compact_rows(t[5])
    rs = nbr_attn.RowStash(t[0].reshape(1, -1, 16)[:, rows], count, start,
                           rows, count.numpy(), [])
    with pytest.raises(ValueError, match="RowStash"):
        nbr_attn.nbr_attention_stack_bwd(rs, *t[1:], torch.tensor(ct),
                                         param_grads=False)
