"""DPA-1 gated neighbour-attention stack: CUDA kernels, plain versions,
autograd.

Replaces the Pallas ``repro/kernels/nbr_attn.py::_stack_fwd_kernel`` and
``_stack_bwd_kernel`` (custom VJP ``nbr_attention_stack``).  The kernels are
CUDA C++ for ``sm_90a`` in ``csrc/nbr_attn.cu`` (built by
:mod:`repro_torch.kernels.build`, bound with ctypes); that file's header
says what bounds them on the H100 (fp32 operations) and what the design
does about it.  The plain versions are
:func:`~repro_torch.kernels.ref.nbr_attention_stack_ref` and
:func:`~repro_torch.kernels.ref.nbr_attention_stack_bwd_ref`.

Dispatch goes by the tensors' device: CUDA tensors launch the kernels (and
raise if they cannot build or launch, or on a shape they do not take), CPU
tensors take the plain versions.  The forward (every caller) and the force
path's backward (no parameter gradients) run over compacted rows:
:func:`compact_rows` gathers each atom's valid neighbour slots in ascending
slot order, atoms longest first, and the kernels work on those rows only
and leave exact zeros at the masked slots.  The forward keeps each layer's
input on those rows; on the force path autograd hands that
:class:`RowStash`, compaction included, to the backward, so a force call
compacts, and waits for the host, once.  The public functions take and
return the plain version's (L, N, K, M) stash; :func:`dense_stash` and
:func:`compact_stash` convert.  The backward with parameter gradients
(training; off the force path) keeps two template instances over all K
slots: the shared-memory one wherever its tiles fit (K <= 89 at M = 128),
and above that one whose K x M tiles sit in a per-CTA device workspace
served by L2.  ``MAX_K`` is the neighbour capacity the port's model path
accepts (``DDConfig`` and the providers' ``grow`` enforce it) on every
device, so card and CPU results stay comparable.  The compacted-row
kernels run head widths in multiples of 4, H in multiples of 8 and M in
multiples of 4: the wrappers zero-pad each head (:func:`pad_heads`, exact;
the score scale stays that of the true head width) and the embedding width
(:func:`pad_embedding`; the LayerNorm kernels take the true M apart from
the padded row stride and keep the padded columns at exact zeros), so any
M runs on the card.  Each kernel
wrapper counts its launches in ``<wrapper>.launches``: one per call,
however many CUDA kernels the call runs.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import build
from .ref import attn_scale, nbr_attention_stack_bwd_ref, nbr_attention_stack_ref

SMEM_LIMIT = 232_448      # bytes of shared memory one block may use (H100)
PARAM_GRAD_BLOCKS = 132   # CTAs of a parameter-gradient launch (one per SM)
MAX_K = 128               # the port's neighbour-capacity limit (both ways)
ROW_PASS = 1 << 20        # stacked rows per pass of the compacted-row kernels


def k_limit_message(k: int) -> str:
    return (f"neighbour capacity K={k} exceeds the port's limit of {MAX_K}: "
            "the attention kernels (repro_torch/kernels/csrc/nbr_attn.cu) "
            f"take K <= {MAX_K} at M = 128 in both directions")


_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = build.load("nbr_attn")
    if not getattr(lib, "_bound", False):
        lib.nbr_attn_fwd_rows.argtypes = ([_P] * 14 + [_LL, _I] + [_P] * 3
                                          + [_LL] + [_I] * 3 + [_P] * 3
                                          + [_I] * 6 + [_F, _P])
        lib.nbr_attn_bwd.argtypes = [_P] * 20 + [_I] * 8 + [_F, _P]
        lib.nbr_attn_bwd_rows.argtypes = ([_P, _LL] + [_P] * 19 + [_LL]
                                          + [_I] * 3 + [_P] * 6 + [_I] * 6
                                          + [_F, _P])
        lib.nbr_attn_reduce.argtypes = [_P, _P, _I, _LL, _P]
        for fn in (lib.nbr_attn_fwd_rows, lib.nbr_attn_bwd,
                   lib.nbr_attn_bwd_rows, lib.nbr_attn_reduce):
            fn.restype = _I
        for fn in (lib.nbr_attn_bwd_smem, lib.nbr_attn_bwd_gmem_smem):
            fn.argtypes = [_I, _I]
            fn.restype = ctypes.c_size_t
        lib.nbr_attn_rows_smem.argtypes = [_I]
        lib.nbr_attn_rows_smem.restype = ctypes.c_size_t
        lib.nbr_attn_bwd_gmem_blocks.argtypes = [_I] * 3
        lib.nbr_attn_bwd_gmem_blocks.restype = _I
        lib._bound = True
    return lib


def _smem(k: int, m: int, param_grads: bool, workspace: bool) -> int:
    lib = _lib()
    if not param_grads:
        return lib.nbr_attn_rows_smem(k)   # an atom with all K valid
    if workspace:
        return lib.nbr_attn_bwd_gmem_smem(k, m)
    return lib.nbr_attn_bwd_smem(k, m)


def max_k(m: int, param_grads: bool = False, workspace: bool = False) -> int:
    """Largest neighbour capacity K a kernel instance takes at embedding
    width m: the compacted-row kernels (the forward and the force-path
    backward; every slot of an atom valid), or with ``param_grads`` the
    backward with parameter gradients, every tile in shared memory or
    (``workspace``) its K x M tiles in device memory."""
    k = 1
    while _smem(k + 1, m, param_grads, workspace) <= SMEM_LIMIT:
        k += 1
    return k


def uses_workspace(k: int, m: int) -> bool:
    """True when the parameter-gradient backward at (K, M) runs the
    device-workspace instance (its shared-memory tiles do not fit)."""
    return _lib().nbr_attn_bwd_smem(k, m) > SMEM_LIMIT


def compact_rows(mask):
    """The valid neighbour slots (``mask > 0``) of every atom, stacked.

    Returns ``(order, count, start, rows)``: ``order`` (N,) the atoms by
    descending count (stable, so ties keep atom order); ``count`` and
    ``start`` (N,) each atom's number of valid slots and its first stacked
    row, in that order; ``rows`` (R,) the flat index ``atom * K + slot`` of
    each stacked row, each atom's slots ascending.  All int64, on mask's
    device."""
    n, k = mask.shape
    valid = mask > 0
    count = valid.sum(1)
    order = torch.sort(count, descending=True, stable=True).indices
    count = count[order]
    flat = torch.nonzero(valid[order].reshape(-1)).reshape(-1)
    rows = order[flat // k] * k + flat % k
    start = torch.cumsum(count, 0) - count
    return order, count, start, rows


def row_passes(count, max_rows: int = ROW_PASS):
    """Split the atoms of :func:`compact_rows` (``count`` in its order, on
    the host) into passes of consecutive atoms of at most ``max_rows``
    stacked rows each (one atom more than that takes a pass of its own).
    Atoms without a valid slot take none.  Returns [(a0, a1, r0, r1)]."""
    counts = np.asarray(count, dtype=np.int64)
    live = int((counts > 0).sum())
    ends = np.cumsum(counts[:live])
    passes, a0, r0 = [], 0, 0
    while a0 < live:
        a1 = max(a0 + 1, int(np.searchsorted(ends, r0 + max_rows, "right")))
        r1 = int(ends[a1 - 1])
        passes.append((a0, a1, r0, r1))
        a0, r0 = a1, r1
    return passes


class RowStash(NamedTuple):
    """The forward's layer inputs on compacted rows, and the compaction they
    follow: ``x`` (L, R, M), layer l's input at the R stacked valid slots;
    ``count``, ``start`` and ``rows`` as :func:`compact_rows` gives them (on
    the card); ``count_h`` the counts on the host and ``passes`` their
    :func:`row_passes`."""
    x: torch.Tensor
    count: torch.Tensor
    start: torch.Tensor
    rows: torch.Tensor
    count_h: np.ndarray
    passes: list


def _compaction(mask):
    """(count, start, rows, count_h, passes) of ``mask``: the host copy of
    the counts is the one host sync of a force call."""
    _, count, start, rows = compact_rows(mask)
    count_h = count.cpu().numpy()
    return count, start, rows, count_h, row_passes(count_h, ROW_PASS)


def compact_stash(stash, rows):
    """(L, R, M): the stacked rows ``rows`` (flat slots, as
    :func:`compact_rows` gives them) of an (L, N, K, M) stash."""
    layers, n, k, m = stash.shape
    return stash.reshape(layers, n * k, m)[:, rows]


def dense_stash(g, x, rows):
    """The plain version's (L, N, K, M) stash from the compacted one ``x``
    (L, R, M) on the slots ``rows``: layer 0 is g, masked slots included;
    layers >= 1 hold x's rows and zeros at the masked slots (every layer's
    output is multiplied by the mask)."""
    n, k, m = g.shape
    st = g.new_zeros((x.shape[0], n * k, m))
    st[0] = g.reshape(n * k, m)
    st[1:, rows] = x[1:]
    return st.view(-1, n, k, m)


def _validate(g, planes, weights, heads: int, param_grads: bool = False):
    n, k, m = g.shape
    layers, _, h = weights[0].shape
    for t in (g, *planes, *weights):
        if t.dtype != torch.float32 or t.device != g.device:
            raise ValueError("nbr_attention_stack takes float32 tensors on "
                             "one device")
    if any(p.shape != (n, k) for p in planes):
        raise ValueError(f"planes must be ({n}, {k})")
    shapes = [(layers, m, h)] * 3 + [(layers, h, m), (layers, m), (layers, m)]
    if [tuple(w.shape) for w in weights] != shapes:
        raise ValueError(f"stacked params must be {shapes}")
    if h % heads:
        raise ValueError(f"attn_hidden {h} not divisible by heads {heads}")
    lib = _lib()
    workspace = param_grads and uses_workspace(k, m)
    smem = _smem(k, m, param_grads, workspace)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"K={k} at M={m} needs {smem} bytes of shared memory for the "
            f"attention kernels; the largest K they take is "
            f"{max_k(m, param_grads, param_grads)}")
    return lib, n, k, m, h, layers


def _head_width(h: int, heads: int) -> int:
    """The head width the compacted-row kernels run: h // heads rounded up
    to a multiple of 4 (of 8 for an odd number of heads), so that the
    padded H is a multiple of 8."""
    step = 4 if heads % 2 == 0 else 8
    return -(-(h // heads) // step) * step


def pad_heads(weights, heads: int):
    """(wq, wk, wv, wo, gamma, beta) with each head's columns of wq/wk/wv
    (L, M, H) and rows of wo (L, H, M) zero-padded to :func:`_head_width`.
    Exact: zero q/k columns add nothing to a score, zero v columns and zero
    wo rows nothing to the output.  The kernels' score scale stays
    1/sqrt(the true head width), which the callers pass."""
    wq, wk, wv, wo, gamma, beta = weights
    layers, m, h = wq.shape
    dh, dp = h // heads, _head_width(h, heads)
    if dp == dh:
        return list(weights)

    def cols(w):
        out = w.new_zeros((layers, m, heads, dp))
        out[..., :dh] = w.reshape(layers, m, heads, dh)
        return out.reshape(layers, m, heads * dp)

    wo_p = wo.new_zeros((layers, heads, dp, m))
    wo_p[:, :, :dh] = wo.reshape(layers, heads, dh, m)
    return [cols(wq), cols(wk), cols(wv), wo_p.reshape(layers, heads * dp, m),
            gamma, beta]


def padded_width(m: int) -> int:
    """The embedding width the compacted-row kernels run: M rounded up to a
    multiple of 4."""
    return -(-m // 4) * 4


def pad_embedding(g, weights, mp: int):
    """g (..., M) with zero columns up to width ``mp``, and (wq, wk, wv, wo,
    gamma, beta) with zero rows of wq/wk/wv (L, M, H), zero columns of wo
    (L, H, M) and zeros in gamma and beta.  Exact: the zero columns add
    nothing to q, k and v, the out-projection writes zeros there, and with
    gamma = beta = 0 the LayerNorm's output there is 0 (its statistics run
    over the true M, which the kernels are given apart)."""
    m = g.shape[-1]
    if mp == m:
        return g, list(weights)
    wq, wk, wv, wo, gamma, beta = weights
    rows = lambda w: torch.nn.functional.pad(w, (0, 0, 0, mp - m))
    return _pad_cols(g, mp), [rows(wq), rows(wk), rows(wv), _pad_cols(wo, mp),
                              _pad_cols(gamma, mp), _pad_cols(beta, mp)]


def _pad_cols(t, width: int):
    """``t`` with zero columns (last axis) up to ``width`` (``t`` itself
    when it has that width)."""
    if t.shape[-1] == width:
        return t
    return torch.nn.functional.pad(t, (0, width - t.shape[-1]))


def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def nbr_attention_stack_fwd(g, rx, ry, rz, sw, mask, wq, wk, wv, wo, gamma,
                            beta, heads: int = 1,
                            compute_dtype: str = "float32",
                            stash: bool | str = False):
    """Forward stack.  With ``stash=True`` also the layer inputs
    (L, N, K, M) the backward needs, as the plain version gives them; with
    ``stash="rows"`` (CUDA tensors only) those inputs on the valid slots
    alone, as a :class:`RowStash` the force-path backward takes.  The CUDA
    kernels over compacted rows for CUDA tensors."""
    if not g.is_cuda:
        if stash == "rows":
            raise ValueError("stash='rows' is the CUDA kernels' layout")
        return nbr_attention_stack_ref(g, rx, ry, rz, sw, mask, wq, wk, wv,
                                       wo, gamma, beta, heads=heads,
                                       compute_dtype=compute_dtype,
                                       stash=stash)
    planes = [p.contiguous() for p in (rx, ry, rz, sw, mask)]
    weights = [w.contiguous() for w in (wq, wk, wv, wo, gamma, beta)]
    g = g.contiguous()
    lib, n, k, m, h, layers = _validate(g, planes, weights, heads)
    scale = float(attn_scale(h // heads))
    mp = padded_width(m)
    g_in = g
    g, weights = pad_embedding(g, pad_heads(weights, heads), mp)
    h = weights[0].shape[2]
    out = torch.zeros_like(g)
    comp = _compaction(planes[4])
    count, start, rows, count_h, passes = comp
    total = passes[-1][3] if passes else 0
    cap = max((r1 - r0 for _, _, r0, r1 in passes), default=0)
    keep = stash is not False
    # layer l's input rows: all of them kept (the stash), or two buffers of
    # one pass used in turn
    x = g.new_empty((layers, total, mp) if keep else (2, cap, mp))
    ld, ring = (total * mp, layers) if keep else (cap * mp, 2)
    qkv, ob, y = g.new_empty(cap, 3 * h), g.new_empty(cap, h), \
        g.new_empty(cap, mp)
    for a0, a1, r0, r1 in passes:
        err = lib.nbr_attn_fwd_rows(
            *_ptrs(g, *planes, *weights, out),
            x.data_ptr() + (4 * mp * r0 if keep else 0), ld, ring,
            rows.data_ptr() + 8 * r0, start.data_ptr() + 8 * a0,
            count.data_ptr() + 8 * a0, r0, a1 - a0, r1 - r0,
            int(count_h[a0]), *_ptrs(qkv, ob, y), mp, m, h, layers, heads,
            int(compute_dtype == "bfloat16"), scale, _stream())
        build.check(err, lib, "nbr_attn_fwd_rows")
    if passes:
        nbr_attention_stack_fwd.launches += 1
    if mp != m:
        out = out[..., :m].contiguous()
    if not keep:
        return out
    if stash == "rows":
        return out, RowStash(x, *comp)
    return out, dense_stash(g_in, x[..., :m], rows)


def nbr_attention_stack_bwd(stash, rx, ry, rz, sw, mask, wq, wk, wv, wo,
                            gamma, beta, dout, heads: int = 1,
                            compute_dtype: str = "float32",
                            param_grads: bool = True):
    """(dg, drx, dry, drz, dsw, dwq, dwk, dwv, dwo, dgamma, dbeta); the
    parameter gradients are None unless ``param_grads``.  ``stash`` is the
    (L, N, K, M) layer-input stash or, for CUDA tensors without parameter
    gradients, the forward's :class:`RowStash` of this mask.  The CUDA
    kernels (plus a deterministic reduction of per-CTA partials when
    parameter gradients are asked for) for CUDA tensors."""
    rows = isinstance(stash, RowStash)
    if not dout.is_cuda:
        if rows:
            raise ValueError("a RowStash is the CUDA kernels' layout")
        res = nbr_attention_stack_bwd_ref(stash, rx, ry, rz, sw, mask, wq, wk,
                                          wv, wo, gamma, beta, dout,
                                          heads=heads,
                                          compute_dtype=compute_dtype)
        return res if param_grads else res[:5] + (None,) * 6
    planes = [p.contiguous() for p in (rx, ry, rz, sw, mask)]
    weights = [w.contiguous() for w in (wq, wk, wv, wo, gamma, beta)]
    dout = dout.contiguous()
    lib, n, k, m, h, layers = _validate(dout, planes, weights, heads,
                                        param_grads)
    bf16 = int(compute_dtype == "bfloat16")
    scale = float(attn_scale(h // heads))
    mp = padded_width(m)
    if rows:
        if param_grads or stash.x.shape[::2] != (layers, mp):
            raise ValueError(f"a RowStash serves the backward without "
                             f"parameter gradients, with x of ({layers}, R, "
                             f"{mp})")
    else:
        stash = stash.contiguous()
        if stash.shape != (layers, n, k, m) or stash.dtype != torch.float32:
            raise ValueError(f"stash must be ({layers}, {n}, {k}, {m}) "
                             "float32")
    if not param_grads:
        if not rows:
            comp = _compaction(planes[4])
            stash = RowStash(_pad_cols(compact_stash(stash, comp[2]), mp),
                             *comp)
        dout, weights = pad_embedding(dout, pad_heads(weights, heads), mp)
        dg, *dplanes = _bwd_rows(lib, stash, planes, weights, dout, heads,
                                 bf16, scale, m)
        if mp != m:
            dg = dg[..., :m].contiguous()
        return (dg, *dplanes) + (None,) * 6
    dg = torch.empty_like(dout)
    dplanes = [torch.empty_like(planes[0]) for _ in range(4)]
    sizes = [layers * m * h] * 4 + [layers * m] * 2
    ws = None
    if uses_workspace(k, m):
        # persistent grid of the resident CTAs, one workspace slot each
        nblk = lib.nbr_attn_bwd_gmem_blocks(k, m, bf16)
        if nblk <= 0:
            raise RuntimeError(f"nbr_attn_bwd: no resident CTA at K={k}")
        nblk = max(1, min(n, nblk))
        ws = dout.new_empty((nblk, 2, k, m))
    else:
        nblk = max(1, min(n, PARAM_GRAD_BLOCKS))
    part = dout.new_zeros((nblk, sum(sizes)))
    if n:
        err = lib.nbr_attn_bwd(
            *_ptrs(stash, *planes, *weights, dout, dg, *dplanes, part),
            ws.data_ptr() if ws is not None else None, nblk, n, k, m, h,
            layers, heads, bf16, scale, _stream())
        build.check(err, lib, "nbr_attn_bwd")
        nbr_attention_stack_bwd.launches += 1
    total = dout.new_empty(sum(sizes))
    err = lib.nbr_attn_reduce(part.data_ptr(), total.data_ptr(), nblk,
                              total.numel(), _stream())
    build.check(err, lib, "nbr_attn_reduce")
    shapes = [(layers, m, h)] * 3 + [(layers, h, m), (layers, m), (layers, m)]
    pg = [t.view(s) for t, s in zip(total.split(sizes), shapes)]
    return (dg, *dplanes, *pg)


def _bwd_rows(lib, rs, planes, weights, dout, heads, bf16, scale, m_true):
    """The force-path backward over the compacted rows of the RowStash
    ``rs``: (dg, drx, dry, drz, dsw), exact zeros at the masked slots; rows,
    weights and dout at the padded width, ``m_true`` the true one.  Passes
    of at most ``ROW_PASS`` stacked rows bound the scratch memory."""
    layers, total, m = rs.x.shape
    h = weights[0].shape[2]
    dg = torch.zeros_like(dout)
    dplanes = [torch.zeros_like(planes[0]) for _ in range(4)]
    if not rs.passes:
        return (dg, *dplanes)
    cap = max(r1 - r0 for _, _, r0, r1 in rs.passes)
    new = lambda *s: dout.new_empty(s)
    qkv, dqkv = new(cap, 3 * h), new(cap, 3 * h)
    ob, xb, db, gacc = new(cap, h), new(cap, m), new(cap, m), new(cap, 4)
    for a0, a1, r0, r1 in rs.passes:
        err = lib.nbr_attn_bwd_rows(
            rs.x.data_ptr() + 4 * m * r0, total * m,
            *_ptrs(*planes, *weights[:5], dout, dg, *dplanes),
            rs.rows.data_ptr() + 8 * r0, rs.start.data_ptr() + 8 * a0,
            rs.count.data_ptr() + 8 * a0, r0, a1 - a0, r1 - r0,
            int(rs.count_h[a0]), *_ptrs(qkv, ob, xb, db, dqkv, gacc), m,
            m_true, h, layers, heads, bf16, scale, _stream())
        build.check(err, lib, "nbr_attn_bwd_rows")
    nbr_attention_stack_bwd.launches += 1
    return (dg, *dplanes)


nbr_attention_stack_fwd.launches = 0
nbr_attention_stack_bwd.launches = 0


class NbrAttentionStack(torch.autograd.Function):
    """Differentiable in everything but the mask; the backward skips the
    parameter gradients when autograd does not ask for them (the MD force
    path), and then on the card takes the forward's compacted rows.  First
    order only: the stash it reads lies outside autograd's graph, so a
    second derivative through it would be wrong; a backward asked to build
    a graph (``create_graph=True``) raises instead."""

    @staticmethod
    def forward(ctx, g, rx, ry, rz, sw, mask, wq, wk, wv, wo, gamma, beta,
                heads, compute_dtype):
        rows = g.is_cuda and not any(ctx.needs_input_grad[6:12])
        out, stash = nbr_attention_stack_fwd(
            g, rx, ry, rz, sw, mask, wq, wk, wv, wo, gamma, beta, heads,
            compute_dtype, stash="rows" if rows else True)
        if rows:
            ctx.host = stash[4:]          # count_h, passes
            stash = stash[:4]             # x, count, start, rows
        else:
            ctx.host, stash = None, (stash,)
        ctx.save_for_backward(*stash, rx, ry, rz, sw, mask, wq, wk, wv, wo,
                              gamma, beta)
        ctx.cfg = (heads, compute_dtype)
        return out

    @staticmethod
    def backward(ctx, dout):
        if torch.is_grad_enabled():
            raise RuntimeError(
                "nbr_attention_stack is differentiable once: its backward "
                "cannot build a graph for a second derivative "
                "(create_graph=True), which would miss the terms through "
                "the forward's stash")
        heads, compute_dtype = ctx.cfg
        saved = ctx.saved_tensors
        if ctx.host is None:
            stash, rest = saved[0], saved[1:]
        else:
            stash, rest = RowStash(*saved[:4], *ctx.host), saved[4:]
        param_grads = any(ctx.needs_input_grad[6:12])
        (dg, drx, dry, drz, dsw, *pg) = nbr_attention_stack_bwd(
            stash, *rest, dout, heads=heads, compute_dtype=compute_dtype,
            param_grads=param_grads)
        return (dg, drx, dry, drz, dsw, None, *pg, None, None)


def nbr_attention_stack(g, rx, ry, rz, sw, mask, wq, wk, wv, wo, gamma, beta,
                        heads: int = 1, compute_dtype: str = "float32"):
    """l_a fused gated self-attention layers over the neighbour axis.

    g (N, K, M); rx/ry/rz/sw/mask (N, K); stacked params wq/wk/wv (L, M, H),
    wo (L, H, M), gamma/beta (L, M).  Returns the updated (N, K, M).  The
    layer-input stash is written only when autograd will need it.
    """
    args = (g, rx, ry, rz, sw, mask, wq, wk, wv, wo, gamma, beta)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return NbrAttentionStack.apply(*args, heads, compute_dtype)
    return nbr_attention_stack_fwd(*args, heads=heads,
                                   compute_dtype=compute_dtype)
