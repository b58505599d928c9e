"""LM training in the port (``repro_torch.lm.train_lib``,
``launch/{train,elastic}.py``, ``forward(remat="full")`` and the attention's
autograd Function ``kernels.ops.FlashAttention``) against the JAX package,
at the reduced sizes of ``tests/test_lm_archs.py`` (4 layers, d_model 48,
d_ff 96, vocab 128; batch 2, 12 tokens), fp32, the JAX weights carried over
by ``bridge.lm_params_to_torch``, inputs from numpy with a seed.

* ``FlashAttention`` (forward with the row log-sum-exp, the plain chunked
  backward ``ref.attention_bwd_ref``) against ``jax.vjp`` of the JAX LM's
  ``chunked_attention`` in fp32 (GQA; causal and not; a window; softcap
  50; Sk = 600, off the 512-key chunk; (D, DV) = (192, 128); rows with no
  visible key): output and dq/dk/dv within atol 1e-4 x max|JAX| (the
  gate of ``tests/test_torch_lm_archs.py``), and against plain autograd
  through ``attention_ref`` within 1e-5 x max|plain|;
* one ``train_step`` against JAX's ``make_train_step``
  (``TrainHParams(remat="none")``; the port with its default
  ``remat="full"``) for qwen2-1.5b, gemma2-2b, deepseek-v3 (MLA, MoE aux,
  MTP), jamba (Mamba, MoE), rwkv6-3b and whisper-medium (its context
  stub): the metrics and every updated parameter leaf within 1e-4 x
  max|JAX|; the other four registry archs: the loss finite and every
  parameter leaf moved;
* ``remat="full"`` equal to ``"none"`` bit for bit (loss and every
  gradient), on the six archs above and the vision model (every mixer);
* ``launch.train.main`` interrupted at step 6 and resumed: last loss and
  final parameters equal to the uninterrupted run's bit for bit (JAX's own
  gate is 1e-5, ``tests/test_optim_ckpt.py``); without CUDA it raises
  unless ``--device cpu``;
* ``elastic.rebuild_dd`` field for field equal to JAX's; ``supervise``
  restarting a command that fails twice;
* ``cross_entropy`` (z-loss, ignored labels) and ``abstract_params``
  (shapes and dtypes on the ``meta`` device) against JAX.

The file takes ~60 s in one process, most of it JAX's train steps.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.lm import layers as JL
from repro.lm import model as JM
from repro.lm import train_lib as JT
from repro_torch import bridge
from repro_torch.kernels import ops, ref
from repro_torch.launch import elastic
from repro_torch.launch import train as tlaunch
from repro_torch.lm import model as TM
from repro_torch.lm import train_lib as TT

ALL = sorted(ARCHS)
VS_JAX = ("qwen2-1.5b", "gemma2-2b", "deepseek-v3-671b",
          "jamba-1.5-large-398b", "rwkv6-3b", "whisper-medium")
B, S = 2, 12
TOL = 1e-4


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, what, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


# ---------------------------------------------------------------------------
# the attention's autograd Function
# ---------------------------------------------------------------------------

# (b, hq, hkv, sq, sk, d, dv, causal, window, softcap, q_offset)
ATTN_CASES = {
    "gqa_causal": (2, 4, 2, 24, 24, 16, 16, True, 0, 0.0, 0),
    "gqa_noncausal": (2, 4, 2, 24, 24, 16, 16, False, 0, 0.0, 0),
    "window": (1, 4, 1, 40, 40, 16, 16, True, 8, 0.0, 0),
    "softcap": (1, 2, 2, 20, 20, 32, 32, True, 0, 50.0, 0),
    "sk600": (1, 4, 2, 40, 600, 16, 16, True, 0, 0.0, 560),
    "dv_ne_d": (1, 2, 2, 20, 20, 192, 128, True, 0, 0.0, 0),
    "no_visible_key": (1, 4, 2, 16, 20, 16, 16, True, 4, 0.0, 10),
}


def _attn_inputs(case, seed=0):
    b, hq, hkv, sq, sk, d, dv, *_ = case
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, shape).astype(np.float32)
            for shape in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, dv),
                          (b, hq, sq, dv))]


def _function_grads(q, k, v, do, args):
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = ops.attention_op(qt, kt, vt, *args)
    dq, dk, dv = torch.autograd.grad(out, (qt, kt, vt), torch.tensor(do))
    return out, dq, dk, dv


@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_flash_attention_function_matches_jax(name):
    case = ATTN_CASES[name]
    args = case[7:]
    q, k, v, do = _attn_inputs(case)
    causal, window, softcap, q_offset = args

    @jax.jit
    def fwd_bwd(q, k, v, do):
        out, vjp = jax.vjp(lambda q, k, v: JL.chunked_attention(
            q, k, v, causal, window, softcap, q_offset), q, k, v)
        return (out, *vjp(do))

    wants = fwd_bwd(*map(jnp.asarray, (q, k, v, do)))
    got = _function_grads(q, k, v, do, args)
    for what, g, w in zip(("out", "dq", "dk", "dv"), got, wants):
        _close(g, w, f"{name} {what}")
    if name == "no_visible_key":          # rows 13-15 see no key
        assert float(got[0].detach()[:, :, 13:].abs().max()) == 0.0
        assert float(got[1][:, :, 13:].abs().max()) == 0.0


@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_flash_attention_function_matches_plain_autograd(name):
    case = ATTN_CASES[name]
    args = case[7:]
    q, k, v, do = _attn_inputs(case, seed=1)
    got = _function_grads(q, k, v, do, args)
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = ref.attention_ref(qt, kt, vt, *args)
    wants = (out, *torch.autograd.grad(out, (qt, kt, vt), torch.tensor(do)))
    for what, g, w in zip(("out", "dq", "dk", "dv"), got, wants):
        _close(g, w, f"{name} {what}", tol=1e-5)
    # the log-sum-exp the Function keeps, against a dense logsumexp
    lse = ref.attention_lse_ref(torch.tensor(q), torch.tensor(k), *args)
    assert lse.shape == q.shape[:3]
    if name == "no_visible_key":
        assert bool(torch.isneginf(lse[:, :, 13:]).all())
        assert bool(torch.isfinite(lse[:, :, :13]).all())


def test_flash_attention_function_routes_and_is_first_order():
    """Without grad the attention is the serving call (no Function in the
    graph); a backward asked to build a graph raises."""
    q, k, v, do = _attn_inputs(ATTN_CASES["gqa_causal"])
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    with torch.no_grad():
        assert ops.attention_op(qt, kt, vt).grad_fn is None
    out = ops.attention_op(qt, kt, vt)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    with pytest.raises(RuntimeError, match="differentiable once"):
        torch.autograd.grad(out, qt, torch.tensor(do), create_graph=True)


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

def _models(name):
    """(jcfg, jparams, tcfg, tparams, batch as numpy): the port's
    initialiser's weights (seeded), the same numbers in JAX; the tree is
    the reference's, path for path and shape for shape (against
    ``jax.eval_shape`` of JAX's initialiser)."""
    jcfg = ARCHS[name].reduced(n_layers=4, d_model=48, d_ff=96, vocab=128)
    tcfg = bridge.arch_config_to_torch(jcfg)
    tparams = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    shapes = dict(_leaves(jax.eval_shape(
        lambda key: JM.init_params(key, jcfg), jax.random.PRNGKey(0))))
    got = dict(_leaves(tparams))
    assert got.keys() == shapes.keys()
    assert all(tuple(got[p].shape) == shapes[p].shape for p in shapes)
    rng = np.random.default_rng(3)
    tok = rng.integers(0, jcfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if jcfg.enc_dec or jcfg.cross_attn_every:
        t = jcfg.n_audio_frames if jcfg.enc_dec else jcfg.n_image_tokens
        batch["context"] = rng.normal(0, 1, (B, t, jcfg.d_model)).astype(
            np.float32)
    return jcfg, _to_jax(tparams), tcfg, tparams, batch


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_jax(v) for v in tree]
    return jnp.asarray(tree.numpy())


def _tbatch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _grads(cfg, hp, params, batch):
    """The port's loss gradient, leaf by leaf (path -> tensor)."""
    leaves = {p: t.detach().requires_grad_() for p, t in _leaves(params)}
    loss, metrics = TT.make_loss_fn(cfg, hp)(_rebuild(params, leaves), batch)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True, materialize_grads=True)
    return loss, metrics, dict(zip(leaves, grads))


def _rebuild(tree, by_path, path=""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, by_path, f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, by_path, f"{path}/{i}") for i, v in enumerate(tree)]
    return by_path[path]


@pytest.mark.parametrize("name", VS_JAX)
def test_train_step_matches_jax(name):
    """The metrics within 1e-4 x |JAX|; each leaf of Adam's first moment
    after the step, (1 - b1) g of the clipped gradient g, within 1e-4 x max
    of JAX's leaf; each updated parameter leaf within 1e-4 x max|JAX leaf|,
    plus, element by element, what that gradient gate allows Adam's first
    step to make of it: the step is -lr g / (|g| + eps), so a gradient off
    by d moves it by up to lr d eps / ((|g| - d)+ + eps)^2 -- nothing where
    |g| >> eps, up to lr where a gradient of the size of eps is rounding
    noise (qwen2's zero-initialised bk: about a fifth of its 96 entries)."""
    jcfg, jparams, tcfg, tparams, batch = _models(name)
    jstep, jopt = JT.make_train_step(jcfg, JT.TrainHParams(remat="none"))
    jp, jstate, jm = jax.jit(lambda p, b: jstep(p, jopt.init(p), b))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    hp = TT.TrainHParams()
    tstep, topt = TT.make_train_step(tcfg, hp)
    tp, tstate, tm = tstep(tparams, topt.init(tparams), _tbatch(batch))
    assert int(tstate["count"]) == int(jstate["count"]) == 1
    assert sorted(tm) == sorted(jm), (sorted(tm), sorted(jm))
    for key in jm:
        want = float(jm[key])
        assert abs(float(tm[key]) - want) <= TOL * max(abs(want), 1e-30), \
            (name, key, float(tm[key]), want)
    jm1 = dict(_leaves(jax.device_get(jstate["m"])))
    jp = dict(_leaves(jax.device_get(jp)))
    tm1, got = dict(_leaves(tstate["m"])), dict(_leaves(tp))
    assert got.keys() == jp.keys() == jm1.keys() == tm1.keys()
    for path in jp:
        _close(tm1[path], jm1[path], f"{name} first moment {path}")
        g = np.abs(np.asarray(jm1[path], np.float64)) / 0.1  # 1 - b1
        d = TOL * g.max()
        amp = hp.lr * d * 1e-8 / (np.maximum(g - d, 0.0) + 1e-8) ** 2
        want = np.asarray(jp[path], np.float64)
        err = np.abs(_np(got[path]) - want)
        bad = err > TOL * np.abs(want).max() + amp
        assert not bad.any(), (name, path, int(bad.sum()),
                               float(err[bad].max()))


@pytest.mark.parametrize("name", [n for n in ALL if n not in VS_JAX])
def test_train_step_smoke(name):
    """The loss is finite and every parameter leaf moves (the vision model
    at 5 layers, so its cross-attention layer is in the stack)."""
    n_layers = 5 if name == "llama-3.2-vision-90b" else 4
    cfg = bridge.arch_config_to_torch(ARCHS[name]).reduced(
        n_layers=n_layers, d_model=48, d_ff=96, vocab=128)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    step, opt = TT.make_train_step(cfg, TT.TrainHParams())
    batch = tlaunch.make_batch(cfg, 0, B, S, "cpu")
    new, _, metrics = step(params, opt.init(params), batch)
    assert all(bool(torch.isfinite(v)) for v in metrics.values()), metrics
    for path, leaf in _leaves(params):
        assert not torch.equal(leaf, dict(_leaves(new))[path]), (name, path)


@pytest.mark.parametrize("name", VS_JAX + ("llama-3.2-vision-90b",))
def test_remat_full_equals_none_bitwise(name):
    """Every mixer and head: attention with its bias and norms, the local
    layers and softcaps, MLA, MoE and MTP, Mamba, RWKV6, the encoder and
    both kinds of cross-attention context."""
    n_layers = 5 if name == "llama-3.2-vision-90b" else 4
    cfg = bridge.arch_config_to_torch(ARCHS[name]).reduced(
        n_layers=n_layers, d_model=48, d_ff=96, vocab=128)
    params = TM.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    batch = tlaunch.make_batch(cfg, 3, B, S, "cpu")
    l0, m0, g0 = _grads(cfg, TT.TrainHParams(remat="none"), params, batch)
    l1, m1, g1 = _grads(cfg, TT.TrainHParams(remat="full"), params, batch)
    assert torch.equal(l0, l1)
    assert m0.keys() == m1.keys()
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    for path in g0:
        assert torch.equal(g0[path], g1[path]), (name, path)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.normal(0, 3, (2, 7, 33)).astype(np.float32)
    labels = rng.integers(0, 33, (2, 7)).astype(np.int32)
    labels[0, :3] = -1
    for z in (0.0, 1e-4):
        want = float(jax.jit(JT.cross_entropy, static_argnums=2)(
            jnp.asarray(logits), jnp.asarray(labels), z))
        got = float(TT.cross_entropy(torch.tensor(logits),
                                     torch.tensor(labels), z))
        assert abs(got - want) <= 1e-6 * abs(want), (z, got, want)
    all_ignored = torch.full((2, 7), -1)
    assert float(TT.cross_entropy(torch.tensor(logits), all_ignored)) == 0.0


def test_abstract_params_match_jax():
    """qwen2-1.5b's full tree on the meta device: no storage, the
    reference's shapes and dtypes leaf for leaf (``_models`` holds the
    reduced trees of six archs to JAX's the same way)."""
    name = "qwen2-1.5b"
    got = dict(_leaves(TT.abstract_params(bridge.arch_config_to_torch(
        ARCHS[name]))))
    want = dict(_leaves(JT.abstract_params(ARCHS[name])))
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert got[path].device.type == "meta", path
        assert tuple(got[path].shape) == tuple(w.shape), path
        assert str(got[path].dtype).split(".")[-1] == str(w.dtype), path


# ---------------------------------------------------------------------------
# the launcher and the supervisor
# ---------------------------------------------------------------------------

ARGS = ["--reduced", "--device", "cpu", "--steps", "12", "--ckpt-every", "4",
        "--batch", "2", "--seq", "16", "--d-model", "32", "--n-layers", "2"]


def test_train_restart_bitwise(tmp_path, capsys):
    from repro_torch.ckpt import latest_step_dir, load_pytree
    a = tlaunch.main(ARGS + ["--ckpt-dir", str(tmp_path / "a")])
    with pytest.raises(SystemExit) as exc:
        tlaunch.main(ARGS + ["--ckpt-dir", str(tmp_path / "b"),
                             "--simulate-failure", "6"])
    assert exc.value.code == 42
    capsys.readouterr()
    b = tlaunch.main(ARGS + ["--ckpt-dir", str(tmp_path / "b")])
    assert "[restore] resumed from step 4" in capsys.readouterr().out
    assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
    pa = load_pytree(latest_step_dir(str(tmp_path / "a")))
    pb = load_pytree(latest_step_dir(str(tmp_path / "b")))
    la, lb = dict(_leaves(pa)), dict(_leaves(pb))
    assert la.keys() == lb.keys() and any("params" in p for p in la)
    for path in la:
        assert np.array_equal(la[path], lb[path]), path


def test_train_main_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.main(["--reduced", "--steps", "1"])


def test_rebuild_dd_matches_jax():
    """Every field of the port's ``DDConfig`` equal to JAX's (the port has
    no ``use_pallas``: the device picks the kernel)."""
    from repro.launch.elastic import rebuild_dd
    box = np.array([4.0, 4.0, 4.0])
    for p in (2, 4, 8, 16):
        want = rebuild_dd(1000, box, p, rcut=0.6)
        got = elastic.rebuild_dd(1000, box, p, rcut=0.6)
        assert got.n_ranks == p
        assert ({f.name for f in dataclasses.fields(want)}
                - {f.name for f in dataclasses.fields(got)}) == {"use_pallas"}
        for f in dataclasses.fields(got):
            w, g = getattr(want, f.name), getattr(got, f.name)
            assert np.array_equal(np.asarray(g), np.asarray(w)), (p, f.name)
        got.validate(box)


def test_supervise_restarts_until_success(tmp_path):
    counter = tmp_path / "runs"
    script = (f"import pathlib, sys; p = pathlib.Path({str(counter)!r}); "
              "n = int(p.read_text()) + 1 if p.exists() else 1; "
              "p.write_text(str(n)); sys.exit(0 if n >= 3 else 42)")
    cmd = [sys.executable, "-c", script]
    assert elastic.supervise(cmd, max_restarts=3, backoff_s=0.0) == 0
    assert counter.read_text() == "3"
    counter.unlink()
    assert elastic.supervise(cmd, max_restarts=1, backoff_s=0.0) == 42
    assert counter.read_text() == "2"
