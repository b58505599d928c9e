"""DPA-1 training in the port (``repro_torch/{optim,data,dp/train}.py``,
``launch/train_dpa1.py``) against the JAX package on the CPU.

Every case feeds the same seeded numpy inputs to the JAX function and to
its port.  Gates:

* schedules and prefactors: rtol 1e-6;
* ``adam``/``adamw``/``sgd``/``adam8bit``: five steps over a seeded
  gradient sequence, each step from JAX's state bridged by
  ``opt_state_to_torch``: updates and fp32 state atol 1e-6 x max|leaf|,
  ``count``, ``adam8bit``'s int8 codes and its bf16 second moments
  exactly; ``global_norm`` rtol 1e-6, ``clip_by_global_norm`` atol 1e-6 x
  max;
* ``DeterministicLoader.batch_at`` (also sharded) and
  ``synthetic_token_batch``: exact;
* ``make_dataset``: coordinates atol 1e-5 nm (80 capped relaxation steps
  amplify rounding), the labels by the oracle on JAX's coordinates (E rtol
  1e-5; F atol 1e-5 x max|F|); ``frame_neighbor_lists`` exact on the same
  coordinates;
* ``fit_env_stats`` atol 1e-5, ``fit_energy_bias`` rtol 1e-6;
* the force-matching loss through the training route (``second_order``):
  the value rtol 1e-5, its gradient atol 2e-5 x max|leaf| per parameter
  leaf, on one frame and on a batch of four;
* ``train`` from JAX's initial parameters (bridged), 5 steps: every
  history value rtol 1e-5 at step 0 and 1e-4 at step 4; a restart from the
  step-2 checkpoint ends with the uninterrupted run's parameters bit for
  bit, and a step's gradient repeats bit for bit with 4 CPU threads; a
  JAX checkpoint restores in the port, which continues to the JAX
  run's step-4 record (rtol 1e-4);
* ``launch/train_dpa1.py --device cpu`` runs; without ``--device`` it,
  and every entry point of the data and training modules, raises on a
  machine without CUDA.

The model is a narrow DPA-1 (embedding (8, 16), 2 attention layers x 32, 2
heads, fitting (24, 24), sel 16) on 16 frames of 24 atoms.
"""
import dataclasses
import importlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.data import loader as jloader
from repro.data import synthetic as jsyn
from repro.dp import DPConfig as JConfig
from repro.dp import DPModel as JModel
from repro.dp import DescriptorConfig as JDesc
from repro_torch import bridge
from repro_torch import optim as topt
from repro_torch.data import loader as tloader
from repro_torch.data import synthetic as tsyn
from repro_torch.dp import DPModel
from repro_torch.launch import train_dpa1
from repro_torch.optim.adam import tree_leaves, tree_map

jtrain = importlib.import_module("repro.dp.train")
ttrain = importlib.import_module("repro_torch.dp.train")

torch.set_num_threads(1)

SEL = 16
TRAIN = dict(n_steps=5, eval_every=4, batch_size=4, lr0=1e-3,
             checkpoint_every=2)
T = torch.as_tensor


def _jax_cfg():
    return JConfig(descriptor=JDesc(
        kind="dpa1", rcut=0.6, rcut_smth=0.3, sel=SEL, ntypes=4,
        neuron=(8, 16), axis_neuron=4, attn_layers=2, attn_hidden=32,
        attn_heads=2), fitting_neuron=(24, 24))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """JAX's dataset, stats, initial parameters and a 5-step training run
    with checkpoints at steps 2 and 4."""
    data = jsyn.make_dataset(16, n_atoms=24, seed=0)
    tr, va = data.split(0.25)
    cfg = _jax_cfg()
    stats = jtrain.fit_env_stats(cfg, tr, n_sample=8)
    model = JModel(cfg, stats)
    ckpt = tmp_path_factory.mktemp("jax_ckpt")
    _, hist = jtrain.train(model, tr, va,
                           jtrain.TrainConfig(**TRAIN, checkpoint_dir=str(ckpt)))
    return {"data": data, "tr": tr, "va": va, "cfg": cfg, "stats": stats,
            "model": model, "hist": hist, "ckpt": ckpt,
            "init": jax.device_get(model.init_params(jax.random.PRNGKey(0)))}


def _port_model(ref):
    model = DPModel(bridge.config_to_torch(ref["cfg"]),
                    bridge.stats_to_torch(ref["stats"], "cpu"), device="cpu")
    # train() starts from model.init_params: give it JAX's initial weights
    model.init_params = lambda gen: bridge.params_to_torch(ref["init"], "cpu")
    return model


def _close(got, want, rtol=0.0, atol_rel=0.0):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=atol_rel * float(np.abs(want).max()))


# -- optim -------------------------------------------------------------------

@pytest.mark.parametrize("name", ["exponential_decay", "cosine_with_warmup",
                                  "deepmd_prefactors"])
def test_schedules_match_jax(name):
    steps = np.array([0, 1, 7, 49, 50, 51, 333, 1000, 5000], np.int32)
    if name == "deepmd_prefactors":
        ratio = np.linspace(0.0, 1.0, 9).astype(np.float32)
        want = jopt.deepmd_prefactors()(jnp.asarray(ratio))
        got = topt.deepmd_prefactors()(T(ratio))
        for g, w in zip(got, want):
            _close(g.numpy(), w, rtol=1e-6)
        return
    args = ((2e-3, 500, 0.95, 1e-5) if name == "exponential_decay"
            else (3e-4, 50, 1000))
    want = getattr(jopt, name)(*args)(jnp.asarray(steps))
    got = getattr(topt, name)(*args)(T(steps))
    assert got.dtype == torch.float32
    _close(got.numpy(), want, rtol=1e-6)


_SHAPES = {"w": (40, 128), "b": (7,), "layers": [(3, 5), (4100,)]}


def _tree(rng, scale=False):
    def leaf(s):
        x = rng.normal(0, 1, s)
        return (x * rng.uniform(0, 2, s) if scale else x).astype(np.float32)
    return {k: [leaf(s) for s in v] if isinstance(v, list) else leaf(v)
            for k, v in _SHAPES.items()}


def _state_equal(got, want):
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        w = np.asarray(w)
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.float().numpy(),
                                          w.astype(np.float32))
        elif w.dtype.kind == "i":
            assert str(g.dtype) == f"torch.{w.dtype.name}"
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            _close(g.numpy(), w, atol_rel=1e-6)


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd", "adam8bit"])
def test_optimizer_steps_match_jax(name):
    """Five steps over seeded gradients, each from JAX's state bridged;
    ``adam8bit`` quantizes the two leaves of >= 4096 elements."""
    rng = np.random.default_rng(5)
    params = _tree(rng)
    grads = [_tree(rng, scale=True) for _ in range(5)]
    lr = 1e-2 if name == "sgd" else 1e-3
    jo, to = getattr(jopt, name)(lr), getattr(topt, name)(lr)
    jp = jax.tree.map(jnp.asarray, params)
    tp = bridge.params_to_torch(params, "cpu")
    state = jo.init(jp)
    _state_equal(to.init(tp), jax.device_get(state))
    for g in grads:
        ju, new = jax.jit(jo.update)(jax.tree.map(jnp.asarray, g), state, jp)
        tu, tnew = to.update(bridge.params_to_torch(g, "cpu"),
                             bridge.opt_state_to_torch(jax.device_get(state),
                                                       "cpu"), tp)
        for a, b in zip(tree_leaves(tu), jax.tree_util.tree_leaves(ju)):
            _close(a.numpy(), b, atol_rel=1e-6)
        _state_equal(tnew, jax.device_get(new))
        state = new
    _close(tree_leaves(topt.apply_updates(tp, tu))[0].numpy(),
           jax.tree_util.tree_leaves(jopt.apply_updates(jp, ju))[0],
           atol_rel=1e-6)


@pytest.mark.parametrize("max_norm", [1e-3, 1e6])
def test_global_norm_and_clip_match_jax(max_norm):
    g = _tree(np.random.default_rng(6), scale=True)
    jc, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    tc, tn = topt.clip_by_global_norm(bridge.params_to_torch(g, "cpu"),
                                      max_norm)
    _close(float(tn), float(jn), rtol=1e-6)
    _close(float(topt.global_norm(bridge.params_to_torch(g, "cpu"))),
           float(jopt.global_norm(g)), rtol=1e-6)
    for a, b in zip(tree_leaves(tc), jax.tree_util.tree_leaves(jc)):
        _close(a.numpy(), b, atol_rel=1e-6)


# -- data --------------------------------------------------------------------

@pytest.mark.parametrize("shard_index,shard_count", [(0, 1), (1, 2), (2, 3)])
def test_loader_batches_match_jax(shard_index, shard_count):
    arrays = {"x": np.arange(60), "y": np.arange(120.0).reshape(60, 2)}
    cfg = dict(batch_size=4, seed=7)
    jl = jloader.DeterministicLoader(arrays, jloader.LoaderConfig(**cfg),
                                     shard_index, shard_count)
    tl = tloader.DeterministicLoader(arrays, tloader.LoaderConfig(**cfg),
                                     shard_index, shard_count, device="cpu")
    assert tl.steps_per_epoch == jl.steps_per_epoch
    for step in range(2 * jl.steps_per_epoch + 3):
        want, got = jl.batch_at(step), tl.batch_at(step)
        for k in arrays:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    rng_j, rng_t = np.random.default_rng(3), np.random.default_rng(3)
    want = jloader.synthetic_token_batch(rng_j, 2, 9, 50)
    got = tloader.synthetic_token_batch(rng_t, 2, 9, 50, device="cpu")
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_make_dataset_and_oracle_match_jax(ref):
    data = ref["data"]
    port = tsyn.make_dataset(16, n_atoms=24, seed=0, device="cpu")
    np.testing.assert_array_equal(port.types, data.types)
    np.testing.assert_allclose(port.coords, data.coords, rtol=0, atol=1e-5)
    e, f = tsyn.oracle_energy_and_forces(T(data.coords), T(data.types).long())
    _close(e.numpy(), data.energies, rtol=1e-5)
    _close(f.numpy(), data.forces, atol_rel=1e-5)
    tr, va = bridge.dataset_to_torch(data).split(0.25)
    assert (tr.n_frames, va.n_frames, tr.n_atoms) == (12, 4, 24)


def test_frame_neighbor_lists_match_jax(ref):
    coords = ref["data"].coords
    ji, jm = jsyn.frame_neighbor_lists(jnp.asarray(coords), 0.6, SEL)
    ti, tm = tsyn.frame_neighbor_lists(T(coords), 0.6, SEL)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_env_stats_and_energy_bias_match_jax(ref):
    cfg = bridge.config_to_torch(ref["cfg"])
    stats = ttrain.fit_env_stats(cfg, bridge.dataset_to_torch(ref["tr"]),
                                 n_sample=8, device="cpu")
    np.testing.assert_allclose(stats.davg.numpy(), ref["stats"].davg, atol=1e-5)
    np.testing.assert_allclose(stats.dstd.numpy(), ref["stats"].dstd, atol=1e-5)
    _close(ttrain.fit_energy_bias(ref["tr"], 4),
           jtrain.fit_energy_bias(ref["tr"], 4), rtol=1e-6)


# -- the loss through the training route --------------------------------------

@pytest.mark.parametrize("frames", [1, 4])
def test_loss_and_gradient_match_jax(ref, frames):
    """Force matching differentiates the forces to the parameters: the
    JAX jnp route against the port's ``second_order`` route."""
    params = dict(ref["init"], bias=jtrain.fit_energy_bias(ref["tr"], 4))
    arrays = jtrain.prepare_batches(ref["tr"], 0.6, SEL, frames, 0)
    batch = {k: v[3:3 + frames] for k, v in arrays.items()}
    (want, (we, wf)), wg = jax.jit(jax.value_and_grad(
        jtrain.make_loss_fn(ref["model"]), has_aux=True))(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()}, 0.5, 900.0)
    live = tree_map(lambda p: p.requires_grad_(True),
                    bridge.params_to_torch(params, "cpu"))
    loss, (l_e, l_f) = ttrain.make_loss_fn(_port_model(ref))(
        live, {k: T(np.array(v)) for k, v in batch.items()}, 0.5, 900.0)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    for got, w in ((loss, want), (l_e, we), (l_f, wf)):
        _close(float(got.detach()), float(w), rtol=1e-5)
    want_leaves = jax.tree_util.tree_leaves(wg)
    assert len(want_leaves) == len(grads)
    for got, w in zip(grads, want_leaves):
        _close(got.numpy(), w, atol_rel=2e-5)


# -- train ---------------------------------------------------------------------

def _port_train(ref, ckpt=None):
    return ttrain.train(_port_model(ref), bridge.dataset_to_torch(ref["tr"]),
                        bridge.dataset_to_torch(ref["va"]),
                        ttrain.TrainConfig(**TRAIN, checkpoint_dir=ckpt))


def _history_close(got, want, rtol):
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in ("loss", "rmse_e_per_atom", "rmse_f_train",
                    "rmse_f_valid", "lr"):
            assert np.isfinite(g[key])
            _close(g[key], w[key], rtol=rtol[g["step"]])


def test_train_history_matches_jax(ref):
    _, hist = _port_train(ref)
    _history_close(hist, ref["hist"], {0: 1e-5, 4: 1e-4})


def test_restart_equals_uninterrupted_bitwise(ref, tmp_path):
    full, hist = _port_train(ref, str(tmp_path / "a"))
    shutil.copytree(tmp_path / "a" / "step_000000002",
                    tmp_path / "b" / "step_000000002")
    resumed, hist_b = _port_train(ref, str(tmp_path / "b"))
    assert [r["step"] for r in hist_b] == [4]
    assert hist_b[0]["loss"] == hist[-1]["loss"]
    for a, b in zip(tree_leaves(resumed), tree_leaves(full)):
        assert torch.equal(a, b)


def test_training_step_repeats_bitwise_with_four_threads(ref):
    """The loss's gradient on all 12 training frames (36,864 type-embedding
    rows: above the 32,768 elements where the CPU's indexing backward adds
    in thread order) gives the same bits on every repeat with 4 threads."""
    model = _port_model(ref)
    arrays = ttrain.prepare_batches(bridge.dataset_to_torch(ref["tr"]), 0.6,
                                    SEL, "cpu")
    cfg = ttrain.TrainConfig(batch_size=12)
    lr_fn = topt.exponential_decay(cfg.lr0, cfg.decay_steps, cfg.decay_rate)
    step = ttrain.make_train_step(model, cfg, lr_fn, topt.adam(lr_fn))
    params = model.init_params(None)
    state = topt.adam(lr_fn).init(params)
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        runs = [tree_leaves(step(params, state, arrays,
                                 torch.tensor(0, dtype=torch.int32))[5])
                for _ in range(4)]
    finally:
        torch.set_num_threads(before)
    for run in runs[1:]:
        for a, b in zip(run, runs[0]):
            assert torch.equal(a, b)


def test_port_continues_jax_checkpoint(ref, tmp_path):
    """JAX's step-2 checkpoint (params and Adam state under JAX's key
    strings) restores in the port, which runs steps 3-4."""
    shutil.copytree(ref["ckpt"] / "step_000000002",
                    tmp_path / "step_000000002")
    _, hist = _port_train(ref, str(tmp_path))
    _history_close(hist, ref["hist"][-1:], {4: 1e-4})


@pytest.mark.parametrize("device", ["cpu", None])
def test_train_dpa1_launcher(device, monkeypatch, capsys):
    """The example's counterpart at the paper's width (16 frames of 16
    atoms, 2 steps); the default device is the card."""
    argv = ["--steps", "2", "--frames", "16", "--atoms", "16"]
    if device is None:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_dpa1.main(argv)
        return
    train_dpa1.main(argv + ["--device", device])
    out = capsys.readouterr().out
    assert "final force RMSE (valid):" in out
    assert "step     1" in out


def test_training_entry_points_raise_without_cuda(monkeypatch):
    data = tsyn.Dataset(np.zeros((2, 3, 3), np.float32),
                        np.zeros((2, 3), np.int32), np.zeros(2, np.float32),
                        np.zeros((2, 3, 3), np.float32))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda: tsyn.make_dataset(2, n_atoms=4),
             lambda: tsyn.relax_geometry(data.coords[0], data.types[0]),
             lambda: ttrain.fit_env_stats(bridge.config_to_torch(_jax_cfg()),
                                          data),
             lambda: ttrain.prepare_batches(data, 0.6, SEL),
             lambda: tloader.DeterministicLoader({"x": np.arange(4)},
                                                 tloader.LoaderConfig(2)),
             lambda: tloader.synthetic_token_batch(np.random.default_rng(0),
                                                   1, 2, 3),
             lambda: bridge.opt_state_to_torch({"count": np.int32(0)})]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_train_config_fields_match_jax():
    names = lambda cls: [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert names(ttrain.TrainConfig) == names(jtrain.TrainConfig)
