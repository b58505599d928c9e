"""Any embedding width M through the attention stack's card layout, on the
CPU: the compacted-row kernels run M in multiples of 4, so the wrappers
zero-pad g, the weights and gamma/beta (``nbr_attn.pad_embedding``) and the
LayerNorm takes its statistics over the true M.  Here the plain stack run
that way (``ref.nbr_attention_stack_ref(..., m_true=M)``, forward and
analytic backward) is held against the unpadded plain stack at atol 1e-6 x
max (fp32, the padded products sum extra zero terms), with exact zeros in
the padded columns.  The kernels themselves: ``tests/test_torch_card.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import nbr_attn, ref

torch.set_num_threads(1)


def _stack(seed, n, k, m, h, layers=2):
    rng = np.random.default_rng(seed)
    t = lambda *s, scale=1.0: torch.tensor(
        (scale * rng.normal(size=s)).astype(np.float32))
    rx, ry, rz = (t(n, k, scale=0.5) for _ in range(3))
    sw = torch.tensor(rng.random((n, k)).astype(np.float32))
    mask = torch.tensor((rng.random((n, k)) < 0.6).astype(np.float32))
    mask[0] = 0.0                                  # an atom with no neighbour
    weights = [t(layers, m, h, scale=0.1) for _ in range(3)]
    weights += [t(layers, h, m, scale=0.1), 1 + t(layers, m, scale=0.1),
                t(layers, m, scale=0.1)]
    return t(n, k, m), [rx, ry, rz, sw, mask], weights


def _close(got, want):
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("m,heads", [(30, 1), (62, 2), (5, 1), (64, 2)])
def test_padded_plain_stack_matches_unpadded(m, heads):
    n, k, h = 7, 12, 16
    g, planes, weights = _stack(m + heads, n, k, m, h)
    mp = nbr_attn.padded_width(m)
    assert mp % 4 == 0 and m <= mp < m + 4
    gp, wp = nbr_attn.pad_embedding(g, weights, mp)
    out, stash = ref.nbr_attention_stack_ref(g, *planes, *weights,
                                             heads=heads, stash=True)
    out_p, stash_p = ref.nbr_attention_stack_ref(gp, *planes, *wp,
                                                 heads=heads, stash=True,
                                                 m_true=m)
    _close(out_p[..., :m], out)
    _close(stash_p[..., :m], stash)
    assert not bool(out_p[..., m:].any()) and not bool(stash_p[..., m:].any())

    dout = torch.tensor(np.random.default_rng(m).normal(
        size=(n, k, m)).astype(np.float32))
    exp = ref.nbr_attention_stack_bwd_ref(stash, *planes, *weights, dout,
                                          heads=heads)
    got = ref.nbr_attention_stack_bwd_ref(
        stash_p, *planes, *wp, torch.nn.functional.pad(dout, (0, mp - m)),
        heads=heads, m_true=m)
    _close(got[0][..., :m], exp[0])
    assert not bool(got[0][..., m:].any())
    for a, b in zip(got[1:5], exp[1:5]):             # the planes' cotangents
        _close(a, b)
    # parameter gradients: the true block matches, the padded one is 0
    dwq, dwk, dwv, dwo, dgamma, dbeta = got[5:]
    for a, b in zip((dwq, dwk, dwv), exp[5:8]):
        _close(a[:, :m], b)
        assert not bool(a[:, m:].any())
    _close(dwo[..., :m], exp[8])
    _close(dgamma[:, :m], exp[9])
    _close(dbeta[:, :m], exp[10])


def test_pad_embedding_zero_pads_every_operand():
    g, _, weights = _stack(3, 4, 6, 30, 8)
    gp, wp = nbr_attn.pad_embedding(g, weights, 32)
    assert gp.shape == (4, 6, 32) and torch.equal(gp[..., :30], g)
    assert [tuple(w.shape) for w in wp] == [(2, 32, 8)] * 3 + [(2, 8, 32)] \
        + [(2, 32)] * 2
    for w, w0 in zip(wp[:3], weights[:3]):
        assert torch.equal(w[:, :30], w0) and not bool(w[:, 30:].any())
    for w, w0 in zip(wp[3:], weights[3:]):
        assert torch.equal(w[..., :30], w0) and not bool(w[..., 30:].any())
    same_g, same_w = nbr_attn.pad_embedding(g, weights, 30)
    assert same_g is g and all(a is b for a, b in zip(same_w, weights))
