"""The compacted-row layout of the force path's attention backward, on the
CPU: the index arithmetic the wrapper hands to the card
(``nbr_attn.compact_rows`` and ``row_passes``), and the plain backward run
over compacted rows and scattered back, against the plain backward over all
K slots and against the JAX Pallas VJP (interpret mode).

Tolerances: compacted vs full plain backward atol 1e-6 x max|grad| per
output (the same sums without their +0 terms, in another order); vs the
Pallas VJP rtol 1e-4 / atol 1e-5 x max|grad|, as ``test_torch_kernels.py``.
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


def _compacted_bwd(stash, planes, weights, dout, heads):
    """The plain backward over the stacked valid rows of ``compact_rows``
    (one padded row per atom, longest first), scattered back to (N, K)."""
    mask = planes[4]
    n, k = mask.shape
    _, count, start, rows = nbr_attn.compact_rows(mask)
    width = max(int(count.max()), 1)
    atom = torch.arange(n).repeat_interleave(count)
    pos = torch.arange(len(rows)) - start.repeat_interleave(count)
    slot = torch.full((n, width), -1, dtype=torch.long)
    slot[atom, pos] = rows
    valid = slot >= 0
    idx = slot.clamp_min(0)

    def plane(p):            # (N, K) -> (N, W), zero padded
        return p.reshape(n * k)[idx] * valid

    def rows_of(t):          # (..., N, K, M) -> (..., N, W, M), zero padded
        flat = t.reshape(*t.shape[:-3], n * k, t.shape[-1])
        return flat[..., idx, :] * valid[..., None]

    res = ref.nbr_attention_stack_bwd_ref(
        rows_of(stash), *[plane(p) for p in planes], *weights, rows_of(dout),
        heads=heads)[:5]
    outs = []
    for r, like in zip(res, [dout] + [mask] * 4):
        full = torch.zeros_like(like).reshape(n * k, *like.shape[2:])
        full[rows] = r[atom, pos]
        outs.append(full.reshape(like.shape))
    return outs


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
