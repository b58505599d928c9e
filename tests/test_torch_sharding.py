"""The port's sharding rules (``repro_torch.lm.sharding``, train_lib's
sharding helpers, ``launch/mesh.py``) against the JAX package's.

JAX's own functions run on ``jax.sharding.AbstractMesh`` layouts (no
devices), over the full-size parameter, optimizer-state, cache and batch
trees (``jax.eval_shape``); the port's over the same trees on the ``meta``
device and a ``MeshLayout``.  For every registry arch at (16, 16), (2, 16,
16) and (2, 4), the specs are equal leaf by leaf (same paths), and so are
the per-device blocks: the port's ``shard_shape`` against JAX's
``NamedSharding(...).shard_shape``.  Covered: ``params_shardings`` with fsdp
on and off (and ``EXPERT_2D`` on and off for the MoE archs),
``opt_state_shardings`` for adam and adam8bit, ``cache_shardings`` for
``decode_32k`` (and ``long_500k`` where the arch runs it), ``batch_specs``
and ``context_spec`` at ``train_4k``.  About 1-2 s an arch in one process.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.lm import model as JM
from repro.lm import serve_lib as JSL
from repro.lm import sharding as JS
from repro.lm import train_lib as JT
from repro_torch.configs import ARCHS, SHAPES, applicable_shapes
from repro_torch.launch.mesh import (MeshLayout, make_card_mesh,
                                     make_production_mesh)
from repro_torch.lm import serve_lib as SL
from repro_torch.lm import sharding as S
from repro_torch.lm import train_lib as TL

torch.set_num_threads(1)
LAYOUTS = (((16, 16), ("data", "model")),
           ((2, 16, 16), ("pod", "data", "model")),
           ((2, 4), ("data", "model")))


def _jax_specs(tree):
    """{path: (spec, shape, itemsize)} of a tree of ShapeDtypeStructs or
    NamedShardings laid over ShapeDtypeStructs."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(JS._path_str(p) for p in path): leaf for path, leaf in flat}


def _check(name, shapes, shardings, port_tree, port_specs, layout):
    """Port specs == JAX specs leaf by leaf, and the per-device blocks."""
    j_sh = _jax_specs(shardings)
    j_shape = _jax_specs(shapes)
    p_spec = dict(S.leaves_with_paths(port_specs))
    p_leaf = dict(S.leaves_with_paths(port_tree))
    assert set(p_spec) == set(j_sh), (name, set(p_spec) ^ set(j_sh))
    for path, sh in j_sh.items():
        assert p_spec[path] == tuple(sh.spec), (name, path)
        assert tuple(p_leaf[path].shape) == tuple(j_shape[path].shape), \
            (name, path)
        assert S.shard_shape(p_leaf[path].shape, p_spec[path], layout) == \
            tuple(sh.shard_shape(j_shape[path].shape)), (name, path)


@pytest.fixture
def expert_2d():
    """Set both packages' EXPERT_2D; restored after the test."""
    def set_both(v):
        JS.set_expert_2d(v)
        S.set_expert_2d(v)
    yield set_both
    set_both(False)


def test_mesh_layouts():
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (single.axis_names, single.shape, single.size) == (
        ("data", "model"), {"data": 16, "model": 16}, 256)
    assert (multi.axis_names, multi.size) == (("pod", "data", "model"), 512)
    assert make_card_mesh().size == 1
    with pytest.raises(ValueError):
        MeshLayout((2, 2), ("data",))


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_and_opt_specs_equal_jax(name, expert_2d):
    cfg, jcfg = ARCHS[name], JARCHS[name]
    j_params = jax.eval_shape(lambda r: JM.init_params(r, jcfg),
                              jax.random.PRNGKey(0))
    params = TL.abstract_params(cfg)
    opts = {}
    for opt in ("adam", "adam8bit"):
        j_opt = jax.eval_shape(
            JT.make_optimizer(JT.TrainHParams(optimizer=opt)).init, j_params)
        opts[opt] = j_opt, TL.make_optimizer(TL.TrainHParams(
            optimizer=opt)).init(params)
    for i, (sizes, names) in enumerate(LAYOUTS):
        amesh, layout = AbstractMesh(sizes, names), MeshLayout(sizes, names)
        for e2d in ((False, True) if cfg.n_experts else (False,)):
            expert_2d(e2d)
            for fsdp in (True, False):
                _check(f"params {sizes} fsdp={fsdp} expert_2d={e2d}",
                       j_params, JS.params_shardings(j_params, amesh, fsdp),
                       params, S.params_shardings(params, layout, fsdp),
                       layout)
        expert_2d(False)
        j_pshard = JS.params_shardings(j_params, amesh)
        p_specs = S.params_shardings(params, layout)
        for opt, (j_opt, o) in opts.items():
            if i == 0:      # the whole helper once; its parts at each layout
                (_, o), (_, o_specs) = TL.abstract_train_state(
                    cfg, TL.TrainHParams(optimizer=opt), layout)
                assert all(t.device.type == "meta"
                           for t in TL.tree_leaves(o))
            else:
                o_specs = TL.opt_state_shardings(o, p_specs, layout)
            _check(f"{opt} state {sizes}", j_opt,
                   JT.opt_state_shardings(j_opt, j_pshard, amesh),
                   o, o_specs, layout)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_cache_and_batch_specs_equal_jax(name):
    cfg, jcfg = ARCHS[name], JARCHS[name]
    train = JSHAPES["train_4k"]
    for sizes, names in LAYOUTS:
        amesh, layout = AbstractMesh(sizes, names), MeshLayout(sizes, names)
        for shp in applicable_shapes(cfg):
            shape = SHAPES[shp]
            if shape.kind != "decode":
                continue
            j_cache = JSL.abstract_cache(jcfg, shape.global_batch,
                                         shape.seq_len)
            cache = SL.abstract_cache(cfg, shape.global_batch, shape.seq_len)
            long = shape.seq_len > 100_000
            _check(f"cache {shp} {sizes}", j_cache,
                   JS.cache_shardings(j_cache, amesh, long_context=long),
                   cache, S.cache_shardings(cache, layout, long_context=long),
                   layout)
        j_batch = JT.batch_specs(jcfg, train.seq_len, train.global_batch,
                                 amesh)
        batch, specs = TL.batch_specs(cfg, train.seq_len, train.global_batch,
                                      layout)
        _check(f"batch {sizes}", j_batch,
               jax.tree.map(lambda s: s.sharding, j_batch), batch, specs,
               layout)
        for key in batch:
            assert batch[key].dtype == getattr(torch,
                                               str(j_batch[key].dtype)), key
        j_ctx = JT.context_spec(jcfg, train.global_batch, amesh)
        ctx = TL.context_spec(cfg, train.global_batch, layout)
        assert (j_ctx is None) == (ctx is None)
        if ctx is not None:
            assert tuple(ctx[0].shape) == j_ctx.shape
            assert ctx[1] == tuple(j_ctx.sharding.spec)
        assert S.batch_spec(layout) == tuple(JS.batch_spec(amesh))


def test_shard_bytes_sums_the_blocks():
    cfg = ARCHS["qwen2-1.5b"]
    params = TL.abstract_params(cfg)
    for sizes, names in LAYOUTS:
        amesh, layout = AbstractMesh(sizes, names), MeshLayout(sizes, names)
        specs = S.params_shardings(params, layout)
        want = sum(int(np.prod(NamedSharding(amesh, jax.sharding.PartitionSpec(
            *spec)).shard_shape(tuple(t.shape)))) * t.element_size()
            for (_, t), (_, spec) in zip(S.leaves_with_paths(params),
                                         S.leaves_with_paths(specs)))
        assert S.shard_bytes(params, specs, layout) == want
    # on one device every leaf is whole
    card = make_card_mesh()
    assert S.shard_bytes(params, S.params_shardings(params, card), card) == \
        sum(t.numel() * t.element_size() for t in TL.tree_leaves(params))
