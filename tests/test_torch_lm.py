"""The port's LM serving path (``repro_torch.lm``) against the JAX
``repro.lm`` on reduced gemma2 (4 layers, d_model 64, window 32, a 48-token
prompt so the window cuts keys), with the JAX weights carried over by
``bridge.lm_params_to_torch``: forward logits, prefill last logits and
cache k/v, then 4 decode steps; plus decode == forward inside the port and
the bridge's bit-exact bf16 leaves.

Tolerances: fp32 atol 1e-4 x max|reference| (the two frameworks sum in
other orders).  bf16 atol 6e-2 x max|reference|: every matmul output, norm
and residual is rounded to bf16 (relative step 2^-8 = 3.9e-3) at places
XLA and PyTorch choose differently (XLA fuses elementwise chains without
intermediate rounding, PyTorch rounds after each op), and the port keeps
the attention probabilities in fp32 where JAX's ``chunked_attention``
rounds them to bf16; over 4 layers that adds up to a few bf16 steps of the
largest logit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.lm import model as JM
from repro.lm import serve_lib as JS
from repro_torch import bridge
from repro_torch.launch import serve as tserve
from repro_torch.lm import model as TM
from repro_torch.lm import serve_lib as TS

B, PROMPT, NEW = 2, 48, 4
TOL = {"float32": 1e-4, "bfloat16": 6e-2}


def _f32(x):
    x = x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32)
    return np.asarray(x)


def _close(got, want, dtype, what):
    want = _f32(want)
    np.testing.assert_allclose(_f32(got), want, rtol=0,
                               atol=TOL[dtype] * np.abs(want).max(),
                               err_msg=what)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def models(request):
    jcfg = jax_get_arch("gemma2-2b").reduced(n_layers=4, d_model=64)
    jcfg = dataclasses.replace(jcfg, dtype=request.param)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = bridge.arch_config_to_torch(jcfg)
    tparams = bridge.lm_params_to_torch(jax.device_get(jparams), "cpu")
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab,
                                               (B, PROMPT + NEW))
    return request.param, jcfg, jparams, tcfg, tparams, tokens


def test_config_carries_over(models):
    _, jcfg, _, tcfg, _, _ = models
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.scan_pattern()[:2] == (0, 2)
    assert tcfg.window == 32 < PROMPT


def test_forward_matches_jax(models):
    dtype, jcfg, jparams, tcfg, tparams, tokens = models
    want, _ = JM.forward(jparams, jcfg, jnp.asarray(tokens))
    with torch.no_grad():
        got, aux = TM.forward(tparams, tcfg, torch.tensor(tokens))
    assert got.dtype == getattr(torch, dtype)
    assert float(aux) == 0.0
    _close(got, want, dtype, "forward logits")


def test_prefill_and_decode_match_jax(models):
    dtype, jcfg, jparams, tcfg, tparams, tokens = models
    ml = PROMPT + NEW
    jl, jc = JS.make_prefill(jcfg, max_len=ml, remat="none")(
        jparams, jnp.asarray(tokens[:, :PROMPT]))
    tl, tc = TS.make_prefill(tcfg, max_len=ml)(
        tparams, torch.tensor(tokens[:, :PROMPT]))
    _close(tl, jl, dtype, "prefill last logits")
    for j, (jpos, tpos) in enumerate(zip(jc["pattern"], tc["pattern"])):
        for name in ("k", "v"):
            assert tuple(tpos[name].shape) == jpos[name].shape
            _close(tpos[name], jpos[name], dtype, f"cache {j} {name}")
    jstep = jax.jit(JS.make_serve_step(jcfg))
    tstep = TS.make_serve_step(tcfg)
    for t in range(PROMPT, ml):
        jl, jc = jstep(jparams, jc, jnp.asarray(tokens[:, t:t + 1]), t)
        tl, tc = tstep(tparams, tc, torch.tensor(tokens[:, t:t + 1]), t)
        _close(tl, jl, dtype, f"decode logits at {t}")


def test_serve_step_takes_pos_as_a_tensor(models):
    """``pos`` as a 0-d tensor (the reference's traced ``pos ()``): the same
    bits as the int form on the CPU, logits and cache, and the JAX jitted
    step's logits at the dtype's gate."""
    dtype, jcfg, jparams, tcfg, tparams, tokens = models
    ml = PROMPT + NEW
    _, jc = JS.make_prefill(jcfg, max_len=ml, remat="none")(
        jparams, jnp.asarray(tokens[:, :PROMPT]))
    _, c_int = TS.make_prefill(tcfg, max_len=ml)(
        tparams, torch.tensor(tokens[:, :PROMPT]))
    c_pos = {part: [{k: t.clone() for k, t in c.items()} for c in caches]
             for part, caches in c_int.items()}
    jstep = jax.jit(JS.make_serve_step(jcfg))
    tstep = TS.make_serve_step(tcfg)
    for t in range(PROMPT, ml):
        tok = torch.tensor(tokens[:, t:t + 1])
        a, c_int = tstep(tparams, c_int, tok, t)
        b, c_pos = tstep(tparams, c_pos, tok, torch.tensor(t, dtype=torch.int32))
        assert torch.equal(a, b), f"pos tensor vs int at {t}"
        jl, jc = jstep(jparams, jc, jnp.asarray(tokens[:, t:t + 1]),
                       jnp.int32(t))
        _close(b, jl, dtype, f"decode logits at {t}, pos a tensor")
    for a, b in zip(c_int["pattern"], c_pos["pattern"]):
        assert all(torch.equal(a[k], b[k]) for k in ("k", "v"))


def test_decode_equals_forward_in_the_port(models):
    dtype, _, _, tcfg, tparams, tokens = models
    tok = torch.tensor(tokens)
    res = tserve.serve_tokens(tcfg, tparams, tok[:, :PROMPT], NEW)
    fed = torch.cat([tok[:, :PROMPT], res["tokens"][:, :-1]], 1)
    with torch.no_grad():
        full, _ = TM.forward(tparams, tcfg, fed)
    # the prefill's last logits are not soft-capped (as in the reference)
    first = TM.final_softcap(tcfg, res["logits"][0])
    _close(first, full[:, PROMPT - 1], dtype, "prefill vs forward")
    for i, lg in enumerate(res["logits"][1:]):
        _close(lg, full[:, PROMPT + i], dtype, f"decode step {i} vs forward")
    if dtype == "float32":   # bf16 logits may tie
        assert torch.equal(res["tokens"], full[:, PROMPT - 1:].argmax(-1))


def test_bf16_leaves_carry_over_bit_for_bit():
    x = jax.random.normal(jax.random.PRNGKey(3), (5, 7), jnp.bfloat16)
    tree = {"a": [jax.device_get(x)], "b": np.arange(3, dtype=np.int32)}
    got = bridge.lm_params_to_torch(tree, "cpu")
    assert got["a"][0].dtype == torch.bfloat16
    assert got["b"].dtype == torch.int32
    bits = np.asarray(jax.device_get(x)).view(np.uint16)
    assert np.array_equal(got["a"][0].view(torch.int16).numpy().view(np.uint16),
                          bits)
