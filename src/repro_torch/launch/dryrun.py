"""Dry run of the port's LM steps (``repro/launch/dryrun.py``): per (arch x
shape x mesh) cell, does the model and its optimizer fit per device, and
which of compute, memory or collectives bounds the step?

Per cell:
  1. the step's inputs on the ``meta`` device (parameters, optimizer state
     and batch for training; parameters and tokens for prefill; parameters,
     cache, one token and the position for decode) and their spec trees
     over the mesh layout (``lm/sharding.py``);
  2. one step counted on ``meta`` (``roofline.count_step``): the FLOPs by
     aten op and the flash kernel's formula, the bytes, the live-bytes
     high-water mark; no device is touched;
  3. the memory per device: the arguments exactly, through the specs
     (``sharding.shard_shape``); the step's own storages at their
     high-water mark, each at its shard (``storage_shares``): outputs by
     their specs, the rest (activations, gradients, optimizer transients)
     over the data-parallel devices and "model";
  4. the parameters' collectives modelled from the specs
     (``roofline.parameter_collectives``) and the three-term roofline with
     H100 datasheet constants.

The counted step is the one-card program: the whole (global) batch.  Its
FLOPs and bytes are divided evenly over the devices, an estimate for a
layout of more than one device (replicated weight reads and the
tensor-parallel activations' collectives are not modelled).  The reference
fits FLOPs and bytes over two reduced depths because XLA's cost analysis
counts a ``scan`` body once; the port's Python loops run, and so count,
every layer, so there is no depth fit (no ``_depth_fit``, no ``refit``).

A decode cell's attention is counted per device instead
(:func:`device_decode_attention`): each device's kernel calls on its own
shapes on ``meta``, under the reference's knobs ``--flash-decode`` (the
device attends its S / model slice of the cache, JAX's
``_flash_decode_sharded``) and ``--gqa-repeat`` (K/V repeated to the
device's query heads where "model" does not divide the KV heads; else,
without either knob, a cache the KV heads cannot shard is gathered and
attended whole).  The flash-decoding merge's collectives (three
all-reduces of (B, Hq, 1[, hd]) per layer over "model") are not counted.

Mesh kinds: ``card`` (1 x 1: the program that runs on one H100 today),
and the reference's ``single`` (16 x 16) and ``multi`` (2 x 16 x 16).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k --mesh card
  python -m repro_torch.launch.dryrun --all --mesh all --out build/dryrun_torch
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from ..configs import ARCHS, SHAPES, applicable_shapes, param_count
from ..configs.base import ArchConfig, ShapeConfig
from ..lm import layers as L
from ..lm import serve_lib, train_lib
from ..lm import sharding as S
from . import roofline as R
from .mesh import MeshLayout, make_card_mesh, make_production_mesh

MESHES = {"card": make_card_mesh,
          "single": make_production_mesh,
          "multi": lambda: make_production_mesh(multi_pod=True)}


@dataclasses.dataclass
class Cell:
    """One (arch, shape) step on ``meta``: its function, arguments and, for
    decode, the host-side position."""
    arch: ArchConfig
    shape: ShapeConfig
    hp: train_lib.TrainHParams
    fn: object
    args: tuple
    positions: int | None = None


def build_cell(arch: ArchConfig, shape: ShapeConfig,
               hp: train_lib.TrainHParams) -> Cell:
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        params = train_lib.abstract_params(arch)
        step, opt = train_lib.make_train_step(arch, hp)
        batch, _ = train_lib.batch_specs(arch, s, b, make_card_mesh())
        return Cell(arch, shape, hp, step, (params, opt.init(params), batch))
    params = train_lib.abstract_params(arch)
    ctx = train_lib.context_spec(arch, b, make_card_mesh())
    if shape.kind == "prefill":
        tokens = torch.empty((b, s), dtype=torch.int32, device="meta")
        args = (params, tokens) + (() if ctx is None else (ctx[0],))
        return Cell(arch, shape, hp,
                    serve_lib.make_prefill(arch, max_len=s), args)
    # decode: one new token at the last position of a seq_len cache
    tokens = torch.empty((b, 1), dtype=torch.int32, device="meta")
    cache = serve_lib.abstract_cache(arch, b, s)
    pos = torch.empty((), dtype=torch.int64, device="meta")
    return Cell(arch, shape, hp, serve_lib.make_serve_step(arch),
                (params, cache, tokens, pos), positions=s - 1)


def _token_spec(mesh, b: int) -> tuple:
    """The batch dim over the data-parallel axes where they divide it."""
    return S.P(S.dp_fit(b, mesh))


def arg_specs(cell: Cell, mesh, infer_fsdp: bool = True) -> tuple:
    """The spec trees of the cell's arguments over ``mesh``."""
    kind, b = cell.shape.kind, cell.shape.global_batch
    if kind == "train":
        params, opt_state, _ = cell.args
        p_specs = S.params_shardings(params, mesh)
        _, b_specs = train_lib.batch_specs(cell.arch, cell.shape.seq_len, b,
                                           mesh)
        return (p_specs, train_lib.opt_state_shardings(opt_state, p_specs,
                                                       mesh), b_specs)
    # inference has no optimizer state: infer_fsdp=False shards the
    # parameters over "model" only
    p_specs = S.params_shardings(cell.args[0], mesh, fsdp=infer_fsdp)
    tok = S.P(_token_spec(mesh, b)[0], None)
    if kind == "prefill":
        ctx = train_lib.context_spec(cell.arch, b, mesh)
        return (p_specs, tok) + (() if ctx is None else (ctx[1],))
    cache = S.cache_shardings(cell.args[1], mesh,
                              long_context=cell.shape.seq_len > 100_000)
    return p_specs, cache, tok, S.P()


def _tree_bytes(tree, specs, mesh) -> int:
    if isinstance(tree, torch.Tensor):
        return math.prod(S.shard_shape(tree.shape, specs, mesh)) \
            * tree.element_size()
    return S.shard_bytes(tree, specs, mesh)


def _share(shape, spec, mesh) -> float:
    """The fraction of a tensor of ``shape`` one device holds under
    ``spec``."""
    return math.prod(S.shard_shape(shape, spec, mesh)) / max(
        1, math.prod(shape))


def storage_shares(out, out_specs, mesh, dp_n: int):
    """``share(storage)``: the fraction of one of the step's storages a
    device holds over ``mesh``.  An output (``out``, a list as
    ``count_step`` names its paths) at its spec; any other storage over
    the data-parallel devices that divide the batch and the "model" axis.
    The reference's rules shard the residual stream (sequence), heads, ffn
    hidden and vocab over "model", and every large weight over "data" and
    "model" (FSDP + TP), so its gradients and optimizer transients take
    that share too.  An estimate, as the count's FLOPs and bytes are: a
    tensor a rule leaves whole (too few KV heads, a norm's weight) is held
    at the same share."""
    out_spec = dict(S.leaves_with_paths(out_specs))
    out_share = {path: _share(t.shape, out_spec[path], mesh)
                 for path, t in S.leaves_with_paths(out)
                 if isinstance(t, torch.Tensor)}
    rest = 1.0 / (dp_n * mesh.shape.get(S.TP, 1))
    return lambda st: out_share.get(st.out, rest)


def device_decode_attention(arch: ArchConfig, shape: ShapeConfig,
                            mesh) -> dict:
    """One device's decode attention over ``mesh`` at the cell's last
    position (``S - 1``): the decode kernel's formula
    (``flash_attn.decode_work``) on the device's own q and K/V shapes, on
    ``meta``, summed over the ``attn``/``attn_local`` layers, the slowest
    device's where devices differ.  ``layers.FLASH_DECODE`` where "model"
    divides S: q with every head against the device's S / model keys, at
    each slice's base; else the KV heads over "model" where it divides
    them, K/V repeated to the device's query heads with
    ``layers.GQA_REPEAT``, or every head against the whole cache."""
    from ..kernels import flash_attn
    b, s = shape.global_batch, shape.seq_len
    m = mesh.shape.get(S.TP, 1)
    dp = _token_spec(mesh, b)[0]
    bl = b // math.prod(mesh.shape[a] for a in
                        ((dp,) if isinstance(dp, str) else (dp or ())))
    hq, hkv, hd = arch.n_heads, arch.n_kv_heads, arch.resolved_head_dim
    dt = L.dt(arch)
    meta = lambda *sh: torch.empty(sh, dtype=dt, device="meta")
    pos = torch.empty((), dtype=torch.int64, device="meta")
    fits = lambda n: n >= m and n % m == 0
    flops = nbytes = 0
    for spec in arch.layer_specs():
        if spec.mixer not in L.ATTN_MIXERS:
            continue
        window = L.layer_window(arch, spec)
        if L.FLASH_DECODE and s % m == 0:
            kv = meta(bl, hkv, s // m, hd)
            work = max((flash_attn.decode_work(
                meta(bl, hq, 1, hd), kv, kv, pos, window,
                kv_base=j * (s // m), return_lse=True, positions=s - 1)
                for j in range(m)), key=lambda w: w[1])
        else:
            if fits(hkv):
                hql, hkl = hq // m, hkv // m
            elif L.GQA_REPEAT and fits(hq):
                hql = hkl = hq // m
            else:
                hql, hkl = hq, hkv
            kv = meta(bl, hkl, s, hd)
            work = flash_attn.decode_work(meta(bl, hql, 1, hd), kv, kv, pos,
                                          window, positions=s - 1)
        flops += work[0]
        nbytes += work[1]
    return {"flops_per_chip": flops, "bytes_per_chip": nbytes,
            "flash_decode": L.FLASH_DECODE, "gqa_repeat": L.GQA_REPEAT,
            "not_counted": "the flash-decoding merge's all-reduces over "
                           "'model' (three per layer)"}


def cell_result(cell: Cell, count: R.StepCount, out, mesh,
                infer_fsdp: bool = True) -> dict:
    """The reference's per-cell keys for ``count`` over ``mesh``."""
    chips = mesh.size
    specs = arg_specs(cell, mesh, infer_fsdp)
    arg_bytes = sum(_tree_bytes(a, sp, mesh)
                    for a, sp in zip(cell.args, specs))
    kind, b = cell.shape.kind, cell.shape.global_batch
    dp = _token_spec(mesh, b)[0]
    dp_n = math.prod(mesh.shape[a] for a in
                     ((dp,) if isinstance(dp, str) else (dp or ())))
    if kind == "train":
        out_specs = [specs[0], specs[1],
                     {k: S.P() for k in out[2]}]
    else:
        logits, cache = out
        v_ax = S._fit(logits.shape[-1], S.TP, mesh)
        out_specs = [S.P(dp, None, v_ax), S.cache_shardings(
            cache, mesh, long_context=cell.shape.seq_len > 100_000)]
    out_bytes = sum(_tree_bytes(o, sp, mesh)
                    for o, sp in zip(out, out_specs))
    share = storage_shares(list(out), out_specs, mesh, dp_n)
    # the step's storages at their shards: the high-water mark of all of
    # them, and of those that are not outputs (XLA's temp buffers)
    step_peak = count.peak_bytes(share)
    temp = count.peak_bytes(lambda st: 0.0 if st.out else share(st))
    records = R.parameter_collectives(
        cell.args[0], specs[0], mesh, train=kind == "train",
        remat=cell.hp.remat == "full")
    colls = R.collective_summary(records)
    colls.update(modelled="parameters", not_modelled=(
        "the residual stream's tensor-parallel collectives over 'model' "
        "(multi-card execution is not ported)"))
    flops, nbytes = count.flops / chips, count.bytes / chips
    extra = {}
    if kind == "decode" and "flash_decode" in count.kernels:
        # the attention per device, in place of its share of the count
        att = device_decode_attention(cell.arch, cell.shape, mesh)
        k = count.kernels["flash_decode"]
        flops += att["flops_per_chip"] - k["flops"] / chips
        nbytes += att["bytes_per_chip"] - k["bytes"] / chips
        extra["decode_attention"] = att
    total, active = param_count(cell.arch)
    mf = R.model_flops_per_step(cell.arch, cell.shape, chips, total, active)
    return {
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": temp,
            # the arguments live through the step; the step's storages,
            # fresh outputs included, at their high-water mark (the decode
            # cache is written in place, so it is an argument only)
            "peak_bytes_est": arg_bytes + step_peak,
        },
        "flops_per_chip": flops,
        "bytes_per_chip": nbytes,
        "per_chip_is": "the one-card step's count divided by the "
                       "devices; a decode step's attention the device's own",
        "counted": count.to_dict(),
        "collectives": colls,
        "roofline": R.roofline_terms(flops, nbytes,
                                     colls["total_wire_bytes"],
                                     colls["collective_s"]),
        "model_flops_per_chip": mf,
        "useful_flops_ratio": (mf / flops) if flops else None,
        "params_total": total, "params_active": active,
        "constants": "H100 SXM5 datasheet (roofline.HW), not measured",
        **extra,
    }


def count_cell(cell: Cell):
    """(StepCount, the step's outputs, seconds) of one step on ``meta``:
    the dry run touches no device (``chip_smoke.py`` counts the same steps
    on the card)."""
    t0 = time.perf_counter()
    count, out = R.count_step(cell.fn, *cell.args, positions=cell.positions)
    return count, out, time.perf_counter() - t0


def run_cells(arch, shape, meshes, hp_overrides: dict | None = None, *,
              infer_fsdp: bool = True) -> list[dict]:
    """One result per layout of ``meshes`` (names of ``MESHES`` or
    ``MeshLayout``s) from one step counted on ``meta``: the count does not
    depend on the layout.  ``arch`` a registry name or an ``ArchConfig``, ``shape`` a
    name of ``SHAPES`` or a ``ShapeConfig``."""
    arch = ARCHS[arch] if isinstance(arch, str) else arch
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    hp = train_lib.TrainHParams(**(hp_overrides or {}))
    t0 = time.perf_counter()
    try:
        cell = build_cell(arch, shape, hp)
        count, out, secs = count_cell(cell)
        err = None
    except Exception as e:  # noqa: BLE001 — report the failure as data
        err, tb = f"{type(e).__name__}: {e}", traceback.format_exc()[-4000:]
    results = []
    for mk in meshes:
        mesh = mk if isinstance(mk, MeshLayout) else MESHES[mk]()
        name = mk if isinstance(mk, str) else "x".join(
            map(str, mesh.axis_sizes))
        res = {"arch": arch.name, "shape": shape.name, "mesh": name,
               "chips": mesh.size, "device": "meta", "ok": err is None}
        if err is None:
            res.update(compile_s=round(secs, 2),
                       **cell_result(cell, count, out, mesh, infer_fsdp))
        else:
            res.update(error=err, traceback=tb)
        res["wall_s"] = round(time.perf_counter() - t0, 2)
        results.append(res)
    return results


def run_cell(arch, shape, mesh_kind, hp_overrides: dict | None = None, *,
             infer_fsdp: bool = True) -> dict:
    """One cell (``run_cells`` with one layout), counted on ``meta``."""
    return run_cells(arch, shape, [mesh_kind], hp_overrides,
                     infer_fsdp=infer_fsdp)[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["card", "single", "multi", "both", "all"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun_torch")
    ap.add_argument("--optimizer", default="adam8bit")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--no-infer-fsdp", action="store_true")
    ap.add_argument("--expert-2d", action="store_true")
    # the reference's layer knobs (lm/layers.py), as the reference sets them
    ap.add_argument("--gqa-repeat", action="store_true")
    ap.add_argument("--flash-decode", action="store_true")
    args = ap.parse_args(argv)
    if args.gqa_repeat:
        L.set_gqa_repeat(True)
    if args.flash_decode:
        L.set_flash_decode(True)
    if args.expert_2d:
        S.set_expert_2d(True)

    cells = ([(name, shp) for name, cfg in ARCHS.items()
              for shp in applicable_shapes(cfg)] if args.all
             else [(args.arch, args.shape)])
    meshes = {"both": ["single", "multi"],
              "all": ["card", "single", "multi"]}.get(args.mesh, [args.mesh])
    hp = {"optimizer": args.optimizer, "remat": args.remat}
    os.makedirs(args.out, exist_ok=True)
    path = lambda arch, shp, mk: os.path.join(args.out,
                                              f"{arch}__{shp}__{mk}.json")
    for arch, shp in cells:
        todo = [mk for mk in meshes if not os.path.exists(path(arch, shp, mk))]
        for mk in meshes:
            if mk not in todo:
                print(f"[skip] {arch}__{shp}__{mk} (cached)")
        if not todo:
            continue
        print(f"[run ] {arch}__{shp} on meta", flush=True)
        for res in run_cells(arch, shp, todo, hp,
                             infer_fsdp=not args.no_infer_fsdp):
            with open(path(arch, shp, res["mesh"]), "w") as f:
                json.dump(res, f, indent=1)
            if res["ok"]:
                r = res["roofline"]
                print(f"       {res['mesh']}: OK count={res['compile_s']}s "
                      f"mem={res['memory']['peak_bytes_est'] / 1e9:.1f}GB "
                      f"dom={r['dominant']} t=(c{r['compute_s']:.4f} "
                      f"m{r['memory_s']:.4f} x{r['collective_s']:.4f})s",
                      flush=True)
            else:
                print(f"       {res['mesh']}: FAIL {res['error'][:120]}",
                      flush=True)


if __name__ == "__main__":
    main()
