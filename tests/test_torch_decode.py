"""The port's decode attention on the CPU: ``flash_attn.flash_decode``'s
plain version (a whole cache, the position a 0-d tensor) against the JAX
``repro.lm.layers.chunked_attention`` with ``kv_len``/``q_offset``, as the
reference decodes; the plain split-and-merge (``ref.attention_split_ref``,
the decode kernel's structure) against ``ref.attention_ref``; and the
serving path's ``pos`` as a tensor (``serve_step``, ``serve_tokens``).

Tolerances: against JAX rtol = atol = 3e-4 (fp32), the reference's own for
its flash kernel (``tests/test_kernels.py``); split-and-merge against the
plain attention atol 1e-6 x max (both fp32, sums in other orders).  The
decode kernel itself needs the card: ``tests/test_torch_card.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.lm import layers as JL
from repro_torch import kernels
from repro_torch.kernels import flash_attn, ref
from repro_torch.launch import serve as tserve

torch.set_num_threads(1)
S_MAX = 130


def _qkv(seed, b, hq, hkv, sq, sk, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, hq, sq, d)).astype(np.float32),
            rng.normal(0, 1, (b, hkv, sk, d)).astype(np.float32),
            rng.normal(0, 1, (b, hkv, sk, d)).astype(np.float32))


DECODE_CASES = [  # hq, hkv, sq, length, window, cap
    (4, 4, 1, 1, 0, 0.0),          # group 1, the first key alone
    (8, 4, 1, 63, 0, 50.0),        # group 2, one short of a block
    (8, 4, 1, 64, 48, 50.0),       # a whole block, window
    (8, 4, 1, 65, 48, 0.0),        # one key into the next block
    (8, 1, 1, 128, 0, 30.0),       # group 8
    (8, 1, 1, S_MAX, 16, 50.0),    # the whole cache, group 8, window
    (4, 2, 2, 97, 32, 50.0),       # two queries a step: 4 rows per KV head
]


@pytest.mark.parametrize("hq,hkv,sq,length,window,cap", DECODE_CASES)
def test_decode_plain_matches_jax_chunked_attention(hq, hkv, sq, length,
                                                    window, cap):
    """The queries sit at the last ``sq`` positions of ``length`` keys of a
    cache of S_MAX rows whose tail holds other data (it must not count)."""
    q, k, v = _qkv(length + hq, 2, hq, hkv, sq, S_MAX, 32)
    pos = length - sq
    before = kernels.launch_counts()
    got = flash_attn.flash_decode(torch.tensor(q), torch.tensor(k),
                                  torch.tensor(v), torch.tensor(pos), window,
                                  cap)
    assert kernels.launch_counts() == before     # CPU: the plain version
    want = JL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, window=window,
                                softcap=cap, q_offset=pos, kv_len=length,
                                chunk=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=3e-4)


SPLIT_CASES = [  # hq, hkv, sq, sk, causal, window, cap, off
    (8, 4, 1, 300, True, 128, 50.0, 299),     # a window: leading splits
    (8, 4, 1, 300, True, 0, 0.0, 299),
    (4, 4, 3, 200, True, 0, 30.0, 100),       # keys past the queries
    (2, 1, 1, 70, False, 0, 0.0, 69),
    (8, 1, 2, 257, True, 40, 0.0, 200),       # group 8, two queries
    (2, 1, 3, 6, True, 4, 0.0, 10),           # no query sees a key
]


@pytest.mark.parametrize("splits", [1, 3, 17])
@pytest.mark.parametrize("hq,hkv,sq,sk,causal,window,cap,off", SPLIT_CASES)
def test_split_and_merge_matches_attention_ref(splits, hq, hkv, sq, sk,
                                               causal, window, cap, off):
    q, k, v = (torch.tensor(a) for a in _qkv(sk + splits, 2, hq, hkv, sq, sk,
                                             64))
    got = ref.attention_split_ref(q, k, v, causal, window, cap, off, splits)
    want = ref.attention_ref(q, k, v, causal, window, cap, off)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-6 * max(float(want.abs().max()), 1.0))
    # the ranges cover the visible keys once, in order; some are empty
    ranges = ref.decode_split_ranges(sq, sk, off, causal, window, splits)
    assert len(ranges) == splits
    seen = [j for k0, k1 in ranges for j in range(k0, k1)]
    vis = ref.attention_visible(sq, sk, causal, window, off).any(0)
    lo = int(vis.nonzero().min()) if vis.any() else 0
    hi = int(vis.nonzero().max()) + 1 if vis.any() else 0
    assert seen == list(range(lo, hi))
    if splits == 17:
        assert any(k1 <= k0 for k0, k1 in ranges)


def test_decode_splits_follow_the_capacity_only():
    """The decode kernel's grid: fixed by the keys given (the cache's
    capacity), about two CTAs per SM, one wave at most, one per 64-key
    block at most."""
    assert flash_attn.decode_splits(4, 4, 6176, 132) == 16   # gemma2-2b
    assert flash_attn.decode_splits(1, 1, 6176, 132) == 97   # blocks bound
    assert flash_attn.decode_splits(64, 8, 6176, 132) == 1
    assert 4 * 4 * flash_attn.decode_splits(4, 4, 6176, 132) <= 2 * 132


def test_decode_ref_reads_the_length_from_the_tensor():
    q, k, v = (torch.tensor(a) for a in _qkv(5, 1, 4, 2, 1, 90, 32))
    got = ref.decode_ref(q, k, v, torch.tensor(40), 0, 50.0)
    want = ref.attention_ref(q, k[:, :, :41], v[:, :, :41], True, 0, 50.0, 40)
    assert torch.equal(got, want)
    assert torch.equal(ref.decode_ref(q, k, v, 40, 0, 50.0), want)


def test_serve_tokens_graph_needs_the_card():
    with pytest.raises(ValueError, match="CUDA"):
        tserve.serve_tokens(None, None, torch.zeros((1, 4), dtype=torch.int64),
                            2, graph=True)
