"""The port's attention (``repro_torch.kernels.ops.attention_op``, the plain
version on the CPU) against the JAX reference ``repro.kernels.ref.
attention_ref``, and the port's ``lm.layers.chunked_attention`` against the
JAX one, ``kv_len`` included.

Tolerances are the reference's own for its flash kernel
(``tests/test_kernels.py``): rtol = atol = 3e-4 in fp32, 5e-2 in bf16.
The flash kernel itself needs the card: ``tests/test_torch_card.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.lm import layers as JL
from repro_torch import kernels
from repro_torch.kernels import flash_attn, ops
from repro_torch.lm import layers as TL

RNG = np.random.default_rng(0)
CASES = [  # b, hq, hkv, sq, sk, d, causal, window, cap, off
    (2, 4, 2, 128, 128, 64, True, 0, 0.0, 0),
    (1, 8, 2, 200, 200, 64, True, 128, 30.0, 0),
    (1, 4, 4, 1, 256, 64, False, 0, 0.0, 255),
    (2, 2, 1, 96, 160, 32, True, 0, 0.0, 64),
    (1, 2, 2, 64, 64, 128, True, 32, 50.0, 0),
    # keys not a multiple of any block, no causal mask: every key counts
    (1, 4, 2, 72, 200, 64, False, 0, 0.0, 0),
    # decode: one query at the last position, window and softcap
    (2, 8, 4, 1, 300, 64, True, 128, 50.0, 299),
    # GQA group 6 (qwen2's), Sq and Sk off the 64- and 128-row/key tiles
    (1, 12, 2, 200, 333, 128, True, 0, 0.0, 133),
    (2, 6, 1, 257, 257, 32, True, 96, 50.0, 0),
    (1, 12, 2, 130, 129, 256, False, 0, 50.0, 0),
]


def _qkv(b, hq, hkv, sq, sk, d):
    return (RNG.normal(0, 1, (b, hq, sq, d)).astype(np.float32),
            RNG.normal(0, 1, (b, hkv, sk, d)).astype(np.float32),
            RNG.normal(0, 1, (b, hkv, sk, d)).astype(np.float32))


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window,cap,off", CASES)
def test_attention_op_matches_jax_reference(b, hq, hkv, sq, sk, d, causal,
                                            window, cap, off):
    q, k, v = _qkv(b, hq, hkv, sq, sk, d)
    before = kernels.launch_counts()["flash_attention"]
    got = ops.attention_op(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                           causal, window, cap, off)
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal, window, cap, off)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=3e-4, atol=3e-4)
    # CPU tensors take the plain version: no launch
    assert kernels.launch_counts()["flash_attention"] == before


def test_attention_op_bf16_matches_jax_reference():
    q, k, v = _qkv(1, 4, 2, 128, 128, 64)
    tq, tk, tv = (torch.tensor(a).to(torch.bfloat16) for a in (q, k, v))
    got = ops.attention_op(tq, tk, tv, True, 0, 0.0, 0)
    assert got.dtype == torch.bfloat16
    want = jref.attention_ref(*(jnp.asarray(a, jnp.bfloat16)
                                for a in (q, k, v)), True, 0, 0.0, 0)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("b,h,sq,sk,causal,off", [
    (2, 4, 16, 40, True, 24),       # MLA at Sq <= 16
    (1, 2, 129, 257, True, 128),    # off the 64- and 128-row/key tiles
])
def test_attention_op_mla_widths_match_jax_reference(b, h, sq, sk, causal,
                                                     off):
    """MLA's (D, DV) = (192, 128): scores at q/k width 192, values 128."""
    q = RNG.normal(0, 1, (b, h, sq, 192)).astype(np.float32)
    k = RNG.normal(0, 1, (b, h, sk, 192)).astype(np.float32)
    v = RNG.normal(0, 1, (b, h, sk, 128)).astype(np.float32)
    got = ops.attention_op(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                           causal, 0, 0.0, off)
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal, 0, 0.0, off)
    assert got.shape == (b, h, sq, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=3e-4, atol=3e-4)


def test_tma_stride_check():
    """K and V reach the bf16 prefill kernel's tensor map only with rows
    of D contiguous elements at a 16-byte aligned address and head and
    batch strides of whole 16-byte units; a dimension of size 1 may have
    any stride; other views are copied by the wrapper."""
    bf = torch.bfloat16
    assert flash_attn._tma_ok(torch.empty(2, 4, 300, 128, dtype=bf))
    cache = torch.empty(2, 2, 4, 512, 64, dtype=bf)    # a cache view
    assert flash_attn._tma_ok(cache[0, :, :, :200])
    base = torch.empty(8192, dtype=bf)
    odd_heads = base.as_strided((2, 3, 5, 64), (3 * 324, 324, 64, 1))
    assert flash_attn._rows_ok(odd_heads) and not flash_attn._tma_ok(odd_heads)
    one_head = base.as_strided((2, 1, 5, 64), (328, 4, 64, 1))
    assert flash_attn._tma_ok(one_head)
    assert not flash_attn._tma_ok(base[1:4097].view(1, 1, 64, 64))
    # float32: 16 bytes are 4 elements
    f32 = torch.empty(4096).as_strided((2, 3, 5, 32), (3 * 164, 164, 32, 1))
    assert flash_attn._tma_ok(f32)


def test_row_without_visible_key_is_zero():
    # window 4 and q_offset 10 over 6 keys: query 0 sees keys 7..10 only
    q, k, v = (torch.tensor(a) for a in _qkv(1, 2, 1, 3, 6, 32))
    out = ops.attention_op(q, k, v, True, 4, 0.0, 10)
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("sq,sk,kv_len,causal,window,cap,off", [
    (1, 96, 61, True, 32, 50.0, 60),     # decode against a partial cache
    (1, 96, 96, True, 0, 0.0, 95),
    (40, 40, None, True, 16, 50.0, 0),   # prefill, window cuts
    (24, 80, 70, False, 0, 0.0, 0),      # unmasked keys past kv_len
])
def test_chunked_attention_matches_jax(sq, sk, kv_len, causal, window, cap,
                                       off):
    q, k, v = _qkv(2, 4, 2, sq, sk, 32)
    got = TL.chunked_attention(torch.tensor(q), torch.tensor(k),
                               torch.tensor(v), causal=causal, window=window,
                               softcap=cap, q_offset=off, kv_len=kv_len)
    want = JL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, window=window,
                                softcap=cap, q_offset=off, kv_len=kv_len,
                                chunk=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=3e-4, atol=3e-4)
