"""Card-only tests of the port's kernels (marked ``cuda``; they skip without
an NVIDIA card).  No JAX here, so the card's machine runs them:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_card.py

* ``cell_filter``: flags equal the plain version bit for bit, on random
  candidates and on pairs placed at the cutoff and one ulp either side;
* the attention stack at K = 64, 82 and 128 (the backward's shared-memory
  and device-workspace instances) against its plain version: forward atol
  1e-4 x max|out|, backward atol 1e-4 x max|grad| per output, parameter
  gradients included.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import cell_filter as cf
from repro_torch.kernels import nbr_attn, ref


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _cutoff_pairs(rcut, n, seed):
    """(p, q) pairs whose float32 d^2 = (dx*dx + dy*dy) + dz*dz is
    fp32(rcut*rcut) or one ulp either side of it."""
    thr = np.float32(rcut * rcut)
    targets = {np.nextafter(thr, np.float32(0)), thr,
               np.nextafter(thr, np.float32(np.inf))}
    rng = np.random.default_rng(seed)
    ps, qs = [], []
    while len(ps) < n:
        p = rng.uniform(0.5, 2.5, 3).astype(np.float32)
        u = rng.normal(size=3)
        q = (p + rcut * u / np.linalg.norm(u)).astype(np.float32)
        for step in range(-64, 65):
            qq = q.copy()
            qq[0] = q[0] + np.float32(step) * np.spacing(q[0])
            d = qq - p
            if d[0] * d[0] + d[1] * d[1] + d[2] * d[2] in targets:
                ps.append(p)
                qs.append(qq)
    return np.array(ps[:n]), np.array(qs[:n])


@pytest.mark.cuda
@pytest.mark.parametrize("rcut", [0.6, 0.65])
def test_cell_filter_kernel_equals_plain(card, rcut):
    rng = np.random.default_rng(1)
    p, q = _cutoff_pairs(rcut, 500, 2)
    xyz = np.concatenate([p, q, rng.uniform(0, 3, (400, 3))]).astype(np.float32)
    r = len(xyz)
    idx = rng.integers(-1, r, (r, 300)).astype(np.int32)
    idx[:500, 0] = np.arange(500) + 500
    mask = (rng.random(r) > 0.1).astype(np.float32)
    args = [torch.tensor(a) for a in (xyz, idx, mask)]
    before = cf.cell_filter.launches
    got = cf.cell_filter(*[a.to(card) for a in args], rcut)
    assert cf.cell_filter.launches == before + 1
    assert torch.equal(got.cpu(), cf.cell_filter_plain(*args, rcut))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 82, 128])
def test_attention_stack_on_card_up_to_k128(card, k):
    gen = torch.Generator(device=card).manual_seed(k)
    rnd = lambda *s: torch.randn(*s, device=card, generator=gen)
    n, m, h, layers = 48, 128, 256, 3
    rx, ry, rz = (0.5 * rnd(n, k) for _ in range(3))
    sw = torch.rand(n, k, device=card, generator=gen)
    mask = (torch.rand(n, k, device=card, generator=gen) < 0.6).float()
    weights = [0.05 * rnd(layers, m, h) for _ in range(3)]
    weights += [0.05 * rnd(layers, h, m), 1 + 0.1 * rnd(layers, m),
                0.1 * rnd(layers, m)]
    args = [rnd(n, k, m), rx, ry, rz, sw, mask, *weights]
    out, stash = nbr_attn.nbr_attention_stack_fwd(*args, stash=True)
    want, want_stash = ref.nbr_attention_stack_ref(*args, stash=True)
    torch.testing.assert_close(out, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))
    dout = rnd(n, k, m)
    got = nbr_attn.nbr_attention_stack_bwd(want_stash, *args[1:], dout)
    exp = ref.nbr_attention_stack_bwd_ref(want_stash, *args[1:], dout)
    for a, b in zip(got, exp):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))
    assert nbr_attn.uses_workspace(k, m) == (k > 89)
