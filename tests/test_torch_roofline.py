"""The port's step accounting (``repro_torch.launch.roofline``,
``launch/dryrun.py``) against the JAX package and against itself.

* The ported pure functions (``_wire_bytes``, ``roofline_terms``'
  dominance, ``model_flops_per_step``) agree with JAX's on the cases of
  ``tests/test_roofline_dryrun.py``, the H100 constants in place of the
  TPU's.
* ``count_step`` gives the same counts on ``meta`` as on the CPU, exactly
  (FLOPs by aten op, bytes, the live-bytes peak, the flash kernel's
  formula), for a reduced forward and training step of every registry
  arch.
* The reduced forward's GEMM FLOPs (aten ``mm``/``bmm``/...) equal the sum
  of 2 M N K over the ``dot_general``s of JAX's jaxpr of the same forward,
  scan bodies times their length, with JAX's ``chunked_attention``
  replaced by a stand-in without products: every arch contracts in JAX's
  order.  The attention core is held to its formula apart: 2 (D + DV)
  FLOPs per (query, key) pair a dense numpy mask of the layer's causality
  and window lets through, per batch row and q head.
* Indexed ops count the rows they move (each op against a hand count,
  whatever the table's size), and a decode step over a long cache counts
  the weights, the visible K/V, the written rows and the embedding row.
* ``run_cell`` gives ``ok`` for train, prefill and decode at reduced sizes
  on the ``card`` layout and a (2, 4) one, ``0.05 < useful_flops_ratio <
  10`` as the reference's test asks, and ``scripts/make_roofline_table.py``
  renders its JSON; its per-device memory holds outputs and gradients at
  their specs' shards.

Reduced configs: 4 layers (the vision model 5, for its cross-attention
layer), d_model 64, d_ff 128, vocab 256, fp32; batch 2 x 16 tokens.
"""
import functools
import json
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.extend as je
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.launch import roofline as JR
from repro.lm import layers as JL
from repro.lm import model as JM
from repro_torch.configs import ARCHS, param_count
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as R
from repro_torch.launch.mesh import MeshLayout
from repro_torch.launch.train import make_batch
from repro_torch.lm import model as M
from repro_torch.lm import train_lib as TL
from repro_torch.optim.adam import tree_map

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
B, SEQ = 2, 16
TPU = {"peak_flops": 197e12, "hbm_bw": 819e9, "ici_bw": 50e9}


def reduced(name, jax_side=False):
    kw = dict(n_layers=5 if name == "llama-3.2-vision-90b" else 4,
              d_model=64, d_ff=128, vocab=256)
    return (JARCHS if jax_side else ARCHS)[name].reduced(**kw)


def test_wire_bytes_equal_jax():
    for kind in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                 "collective-permute", "other"):
        for rb, g in ((16, 4), (4, 4), (100, 1), (3 * 2 ** 20, 16), (7, 2)):
            assert R._wire_bytes(kind, rb, g) == JR._wire_bytes(kind, rb, g)
    assert R._wire_bytes("all-gather", 16, 4) == 12


def test_roofline_terms_dominance_equals_jax():
    """The reference's cases, and each term dominant in turn, with each
    package's time equal to 1 s for the same work under its constants."""
    hw = R.HW
    t = R.roofline_terms(flops=hw["peak_flops"], bytes_accessed=1.0,
                         wire_bytes=1.0)
    assert t["dominant"] == "compute" and abs(t["compute_s"] - 1.0) < 1e-9
    t = R.roofline_terms(flops=1.0, bytes_accessed=hw["hbm_bw"],
                         wire_bytes=1.0)
    assert t["dominant"] == "memory"
    for c, m, x in ((2.0, 1.0, 0.5), (0.5, 2.0, 1.0), (0.1, 0.2, 3.0)):
        mine = R.roofline_terms(c * hw["peak_flops"], m * hw["hbm_bw"],
                                x * hw["network_bw"])
        ref = JR.roofline_terms(c * TPU["peak_flops"], m * TPU["hbm_bw"],
                                x * TPU["ici_bw"])
        assert mine["dominant"] == ref["dominant"]
        for key in ("compute_s", "memory_s", "collective_s",
                    "step_lower_bound_s", "roofline_fraction"):
            assert mine[key] == pytest.approx(ref[key], rel=1e-12)
    # the split by link takes the place of the network-wide rate
    t = R.roofline_terms(1.0, 1.0, 1e12, collective_s=0.5)
    assert t["collective_s"] == 0.5


def test_model_flops_per_step_equals_jax():
    for name in ("qwen2-1.5b", "deepseek-v3-671b", "whisper-medium"):
        total, active = param_count(ARCHS[name])
        for shp, shape in JSHAPES.items():
            for chips in (1, 256, 512):
                assert R.model_flops_per_step(ARCHS[name], shape, chips, total,
                                              active) == \
                    JR.model_flops_per_step(JARCHS[name], shape, chips,
                                            total, active)


def test_collectives_follow_the_specs():
    """FSDP-sharded leaves are gathered 3x a remat training step, every
    gradient is reduced over data and pod; groups within an 8-GPU node
    ride NVLink."""
    cfg = reduced("qwen2-1.5b")
    params = TL.abstract_params(cfg)
    for sizes, names, link in (((2, 4), ("data", "model"), "nvlink"),
                               ((2, 16, 16), ("pod", "data", "model"),
                                "network")):
        mesh = MeshLayout(sizes, names)
        specs = dryrun.S.params_shardings(params, mesh)
        recs = R.parameter_collectives(params, specs, mesh, train=True,
                                       remat=True)
        n_fsdp = sum("data" in dryrun.S.spec_axes(s)
                     for _, s in dryrun.S.leaves_with_paths(specs))
        n_leaves = len(TL.tree_leaves(params))
        gathers = [r for r in recs if r.kind == "all-gather"]
        assert len(gathers) == n_fsdp and all(r.loop_mult == 3
                                              for r in gathers)
        assert sum(r.kind in ("reduce-scatter", "all-reduce")
                   and r.group_size == mesh.shape["data"]
                   for r in recs) == n_leaves
        assert all(r.link == link for r in recs if r.group_size ==
                   mesh.shape["data"])
        summary = R.collective_summary(recs)
        assert summary["total_wire_bytes"] == sum(r.wire_bytes for r in recs)
        assert summary["collective_s"] == pytest.approx(sum(
            r.wire_bytes / R.HW[f"{r.link}_bw"] for r in recs))
    assert R.axis_link(MeshLayout((2, 16, 16), ("pod", "data", "model")),
                       ("pod",)) == "network"


def _inputs(cfg, device):
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = make_batch(cfg, 0, B, SEQ, "cpu")
    if device == "meta":
        params = tree_map(lambda t: torch.empty_like(t, device="meta"), params)
        batch = {k: torch.empty_like(v, device="meta")
                 for k, v in batch.items()}
    return params, batch


@functools.cache
def _count(name, device, train):
    """The count of ``name``'s reduced forward or train step (cached: the
    meta forward serves two tests)."""
    cfg = reduced(name)
    params, batch = _inputs(cfg, device)
    if train:
        step, opt = TL.make_train_step(cfg, TL.TrainHParams())
        return R.count_step(step, params, opt.init(params), batch)[0]
    with torch.no_grad():
        return R.count_step(M.forward, params, cfg, batch["tokens"],
                            batch.get("context"))[0]


@pytest.fixture
def flush_denormals():
    """The CPU flushes subnormal floats while a test runs: the Mamba scan's
    decay products underflow, and subnormal arithmetic makes jamba's CPU
    step ~50x slower.  Counts do not depend on values."""
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


@pytest.mark.parametrize("train", (False, True), ids=("forward", "train"))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_count_on_meta_equals_cpu(name, train, flush_denormals):
    cpu, meta = _count(name, "cpu", train), _count(name, "meta", train)
    assert cpu.to_dict() == meta.to_dict()
    assert cpu.flops > 0 and cpu.bytes > 0 and cpu.live_peak_bytes > 0


def _dot_flops(jaxpr, mult=1):
    """2 M N K over a jaxpr's dot_generals, sub-jaxprs included, a scan's
    body times its length."""
    total = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (lc, _), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval.shape
            total += 2 * math.prod(eqn.outvars[0].aval.shape) * math.prod(
                lhs[i] for i in lc) * mult
        assert eqn.primitive.name != "conv_general_dilated", eqn
        m = mult * (eqn.params["length"] if eqn.primitive.name == "scan"
                    else 1)
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                sub = getattr(sub, "jaxpr", sub)
                if isinstance(sub, je.core.Jaxpr):
                    total += _dot_flops(sub, m)
    return total


def _no_attention(q, k, v, *args, **kwargs):
    """JAX's chunked_attention with no product: the output's shape only."""
    b, hq, sq, _ = q.shape
    return jnp.zeros((b, hq, sq, v.shape[-1]), v.dtype) + \
        0 * (q.sum() + k.sum() + v.sum()).astype(v.dtype)


def _visible_pairs(sq, sk, causal, window):
    """(query, key) pairs a dense mask lets through."""
    qi, kj = np.arange(sq)[:, None], np.arange(sk)[None, :]
    mask = np.ones((sq, sk), bool)
    if causal:
        mask &= kj <= qi
    if window:
        mask &= qi - kj < window
    return int(mask.sum())


def _attention_formula(cfg):
    """The attention core's FLOPs in a forward of B x SEQ tokens."""
    hd, h = cfg.resolved_head_dim, cfg.n_heads
    ctx = cfg.n_audio_frames if cfg.enc_dec else cfg.n_image_tokens
    total = 0
    for spec in cfg.layer_specs():
        if spec.mixer == "mla":
            d, dv = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
            total += 2 * (d + dv) * _visible_pairs(SEQ, SEQ, True, 0) * B * h
        elif spec.mixer in ("attn", "attn_local"):
            window = cfg.window if spec.mixer == "attn_local" else 0
            total += 4 * hd * _visible_pairs(SEQ, SEQ, True, window) * B * h
        elif spec.mixer == "cross":
            total += 4 * hd * _visible_pairs(SEQ, ctx, False, 0) * B * h
    if cfg.enc_dec:     # the encoder's self-attention over the frames
        total += cfg.n_enc_layers * 4 * hd * _visible_pairs(
            ctx, ctx, False, 0) * B * h
    return total


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_forward_gemm_flops_equal_jax_jaxpr(name, monkeypatch):
    cfg, jcfg = reduced(name), reduced(name, jax_side=True)
    count = _count(name, "meta", False)
    monkeypatch.setattr(JL, "chunked_attention", _no_attention)
    j_params = jax.eval_shape(lambda r: JM.init_params(r, jcfg),
                              jax.random.PRNGKey(0))
    ctx = None
    if cfg.enc_dec or cfg.cross_attn_every:
        t = cfg.n_audio_frames if cfg.enc_dec else cfg.n_image_tokens
        ctx = jax.ShapeDtypeStruct((B, t, cfg.d_model), jnp.float32)
    jaxpr = jax.make_jaxpr(lambda p, t, c: JM.forward(p, jcfg, t, c))(
        j_params, jax.ShapeDtypeStruct((B, SEQ), jnp.int32), ctx)
    assert count.aten_flops == _dot_flops(jaxpr.jaxpr)
    assert set(count.flops_by_op) <= {"mm", "bmm", "addmm", "baddbmm"}
    assert count.kernel_flops == _attention_formula(cfg)


def test_decode_count_reads_positions_not_the_device():
    """The decode kernel's keys come from ``positions``; without it the
    counter refuses."""
    from repro_torch.lm import serve_lib as SL
    cfg = reduced("gemma2-2b")
    params, _ = _inputs(cfg, "meta")
    cache = SL.abstract_cache(cfg, B, 64)
    tok = torch.empty((B, 1), dtype=torch.int32, device="meta")
    pos = torch.empty((), dtype=torch.int64, device="meta")
    step = SL.make_serve_step(cfg)
    counts = [R.count_step(step, params, cache, tok, pos, positions=p)[0]
              for p in (10, 40)]
    hd, h = cfg.resolved_head_dim, cfg.n_heads
    for p, c in zip((10, 40), counts):
        keys = sum(min(p + 1, cfg.window if spec.mixer == "attn_local"
                       else p + 1) for spec in cfg.layer_specs())
        assert c.kernels["flash_decode"]["flops"] == 4 * hd * keys * B * h
    assert counts[0].aten_flops == counts[1].aten_flops
    with pytest.raises(ValueError, match="positions"):
        R.count_step(step, params, cache, tok, pos)


SMALL_SHAPES = (ShapeConfig("train_small", 16, 2, "train"),
                ShapeConfig("prefill_small", 16, 2, "prefill"),
                ShapeConfig("decode_small", 32, 2, "decode"))


TABLE = (100, 8)           # rows x width, fp32
IDX = [[1, 2, 3], [4, 5, 6]]
ROW = 8 * 4                 # one row's bytes


def _indexed(op, rows):
    """(the call on a ``rows`` x 8 table, its expected bytes): the indices,
    the source (a scalar's 4 bytes, a tensor's footprint) and the rows the
    op reads and writes; the table's size enters nowhere."""
    t = torch.randn(rows, TABLE[1])
    idx = torch.tensor(IDX)
    i1 = idx[0]
    ones = torch.ones(3, TABLE[1])
    one = torch.ones(2, 3)
    g = lambda out: out.numel() * 4
    return {
        # gathers: indices + the rows read + the output written
        "embedding": (lambda: F.embedding(idx, t), idx.nbytes + 2 * 6 * ROW),
        "index": (lambda: t[idx], idx.nbytes + 2 * 6 * ROW),
        "index_select": (lambda: t.index_select(0, i1),
                         i1.nbytes + 2 * 3 * ROW),
        "gather": (lambda: t.gather(1, idx), idx.nbytes + 2 * g(one)),
        # in-place writes: indices + the source + the rows written (read
        # and written where they accumulate)
        "index_copy_": (lambda: t.index_copy_(0, i1, ones),
                        i1.nbytes + ones.nbytes + 3 * ROW),
        "index_put_": (lambda: t.index_put_((i1,), ones),
                       i1.nbytes + ones.nbytes + 3 * ROW),
        "index_put_accumulate": (
            lambda: t.index_put_((i1,), ones, accumulate=True),
            i1.nbytes + ones.nbytes + 2 * 3 * ROW),
        "index_put_scalar": (lambda: t.__setitem__(i1, 1.0),
                             i1.nbytes + 4 + 3 * ROW),
        "index_add_": (lambda: t.index_add_(0, i1, ones),
                       i1.nbytes + ones.nbytes + 2 * 3 * ROW),
        "scatter_": (lambda: t.scatter_(1, idx, one),
                     idx.nbytes + one.nbytes + g(one)),
        "scatter_add_": (lambda: t.scatter_add_(1, idx, one),
                         idx.nbytes + one.nbytes + 2 * g(one)),
    }[op]


@pytest.mark.parametrize("op", ("embedding", "index", "index_select",
                                "gather", "index_copy_", "index_put_",
                                "index_put_accumulate", "index_put_scalar",
                                "index_add_", "scatter_",
                                "scatter_add_"))
def test_indexed_ops_count_the_rows_they_move(op):
    """An indexed op counts the rows it moves, whatever its table's size."""
    for rows in (TABLE[0], 100 * TABLE[0]):
        fn, want = _indexed(op, rows)
        count = R.count_step(fn)[0]
        aten = op if op in count.bytes_by_op else "index_put_"
        assert count.bytes_by_op == {aten: want}, (rows, count.bytes_by_op)


def test_decode_bytes_match_a_hand_count():
    """One decode step over a cache far larger than the weights moves the
    weights, the K/V rows the query sees, the new token's K/V row per layer
    and its embedding row: not the whole cache nor the whole table.  The
    step's activations and its copies of weights (an einsum's transposed
    ``wo``) stay below two more reads of the weights at this size, and the
    cache is over five times the weights: a count of the whole cache per
    write would not fit."""
    from repro_torch.lm import serve_lib as SL
    cfg = reduced("gemma2-2b")
    b, s_max, pos = 8, 2048, 2000
    params, _ = _inputs(cfg, "meta")
    cache = SL.abstract_cache(cfg, b, s_max)
    tok = torch.empty((b, 1), dtype=torch.int32, device="meta")
    count = R.count_step(SL.make_serve_step(cfg), params, cache, tok,
                         torch.empty((), dtype=torch.int64, device="meta"),
                         positions=pos)[0]
    es, d = 4, cfg.d_model
    hd, hq, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    weights = sum(t.numel() * es for t in TL.tree_leaves(params))
    keys = [min(pos + 1, cfg.window) if spec.mixer == "attn_local"
            else pos + 1 for spec in cfg.layer_specs()]
    visible = sum(b * hkv * n * 2 * hd * es for n in keys)
    q_and_o = len(keys) * b * hq * 2 * hd * es
    idx = 8                                   # the position, int64
    rows = len(keys) * 2 * (idx + 2 * b * hkv * hd * es)
    embed_row = tok.nbytes + 2 * b * d * es
    assert count.kernels["flash_decode"]["bytes"] == visible + q_and_o
    assert count.bytes_by_op["index_copy_"] == rows
    assert count.bytes_by_op["index"] == embed_row
    cache_bytes = sum(t.numel() * es for t in TL.tree_leaves(cache))
    assert visible > 5 * weights and cache_bytes > 5 * weights
    hand = weights + visible + q_and_o + rows + embed_row
    assert hand <= count.bytes <= hand + 2 * weights, (count.bytes, hand)


def test_dryrun_memory_shards_outputs_and_gradients():
    """A training step on a (1, 8) layout (no data parallelism): the
    outputs (new parameters and optimizer state) are held at their specs'
    shards and the other storages (activations, gradients) over "model",
    so the step's per-device peak falls well below the one-card step's;
    the outputs' storages at their shares sum to their bytes over the
    layout, each storage once."""
    cfg = reduced("qwen2-1.5b")
    shape = SMALL_SHAPES[0]
    card, mp8 = dryrun.run_cells(cfg, shape,
                                 ["card", MeshLayout((1, 8),
                                                     ("data", "model"))])
    step = lambda r: r["memory"]["peak_bytes_est"] - \
        r["memory"]["argument_bytes"]
    assert card["memory"]["temp_bytes"] < step(card)
    assert step(mp8) < 0.4 * step(card), (step(mp8), step(card))
    hp = TL.TrainHParams()
    cell = dryrun.build_cell(cfg, shape, hp)
    count, out, _ = dryrun.count_cell(cell)
    mesh = MeshLayout((1, 8), ("data", "model"))
    specs = dryrun.arg_specs(cell, mesh)
    out_specs = [specs[0], specs[1], {k: dryrun.S.P() for k in out[2]}]
    share = dryrun.storage_shares(list(out), out_specs, mesh, 1)
    assert share(R.Storage(0, (2, 16, 64))) == 1 / 8   # not an output
    outs = count.peak_bytes(lambda st: share(st) if st.out else 0.0)
    spec_of = dict(dryrun.S.leaves_with_paths(out_specs))
    want, seen = 0, set()        # "loss" is "ce" without an aux loss
    for path, t in dryrun.S.leaves_with_paths(list(out)):
        if t.untyped_storage() not in seen:
            seen.add(t.untyped_storage())
            want += dryrun._tree_bytes(t, spec_of[path], mesh)
    assert outs == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", ("qwen2-1.5b", "whisper-medium"))
def test_run_cell_on_reduced_configs(name, tmp_path):
    cfg = reduced(name)
    layouts = ["card", MeshLayout((2, 4), ("data", "model"))]
    for shape in SMALL_SHAPES:
        card, mesh24 = dryrun.run_cells(cfg, shape, layouts,
                                        {"optimizer": "adam8bit"})
        for res in (card, mesh24):
            assert res["ok"], res.get("traceback")
            assert 0.05 < res["useful_flops_ratio"] < 10.0, res
            assert res["roofline"]["dominant"] in ("compute", "memory",
                                                   "collective")
            with open(tmp_path / f"{name}__{shape.name}__{res['mesh']}.json",
                      "w") as f:
                json.dump(res, f)
        assert card["chips"] == 1 and mesh24["chips"] == 8
        assert card["roofline"]["collective_s"] == 0.0
        assert mesh24["memory"]["argument_bytes"] < \
            card["memory"]["argument_bytes"]
        assert card["counted"] == mesh24["counted"]
    one = dryrun.run_cell(cfg, SMALL_SHAPES[0], "card")
    assert one["ok"] and one["mesh"] == "card"
    out = subprocess.run([sys.executable,
                          str(ROOT / "scripts" / "make_roofline_table.py"),
                          str(tmp_path)], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    assert f"<!-- {2 * len(SMALL_SHAPES)} ok / 0 failed -->" in out
    assert out.count(f"| {cfg.name} |") == 2 * len(SMALL_SHAPES)


def test_dryrun_cli_refuses_the_jax_layer_knobs(tmp_path):
    """The reference's layer knobs are taken, as its dry run takes them:
    each flag sets the layers' knob, and a decode cell's JSON says which
    knobs its per-device attention was counted under."""
    from repro_torch.lm import layers as TLL
    try:
        for flag, knob in (("--gqa-repeat", "gqa_repeat"),
                           ("--flash-decode", "flash_decode")):
            out = tmp_path / flag.strip("-")
            dryrun.main(["--arch", "qwen2-1.5b", "--shape", "decode_32k",
                         "--mesh", "card", "--out", str(out), flag])
            assert getattr(TLL, knob.upper()) is True
            res = json.loads((out / "qwen2-1.5b__decode_32k__card.json"
                              ).read_text())
            assert res["ok"] and res["decode_attention"][knob] is True
    finally:
        TLL.set_gqa_repeat(False)
        TLL.set_flash_decode(False)


def test_flash_decode_dryrun_counts_the_device_slice():
    """qwen2-1.5b's decode_32k cell (B 128, S 32,768, 28 layers, bf16) at
    16 x 16: with ``--flash-decode`` each device's attention reads its 8
    batch rows' q and o for all 12 heads, its 2,048-key slice of both KV
    heads (every key visible at the last position) and writes the rows'
    fp32 log-sum-exp; without it the cache, whose 2 KV heads "model"
    cannot shard, is attended whole.  The merge's all-reduces are not
    counted (the JSON says so)."""
    from repro_torch.lm import layers as TLL
    mesh = MeshLayout((16, 16), ("data", "model"))
    bl, hq, hkv, hd, s, es, layers = 8, 12, 2, 128, 32768, 2, 28
    q_and_o = 2 * bl * hq * hd * es
    flash = layers * (q_and_o + bl * hkv * (s // 16) * 2 * hd * es
                      + 4 * bl * hq)
    whole = layers * (q_and_o + bl * hkv * s * 2 * hd * es)
    try:
        TLL.set_flash_decode(True)
        on = dryrun.run_cell("qwen2-1.5b", "decode_32k", mesh)
    finally:
        TLL.set_flash_decode(False)
    off = dryrun.run_cell("qwen2-1.5b", "decode_32k", mesh)
    assert on["ok"] and off["ok"]
    assert on["decode_attention"]["bytes_per_chip"] == flash
    assert off["decode_attention"]["bytes_per_chip"] == whole
    assert "all-reduces" in on["decode_attention"]["not_counted"]
    assert on["counted"] == off["counted"]
    assert off["bytes_per_chip"] - on["bytes_per_chip"] == whole - flash
