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
raise if they cannot build or launch, or if K exceeds what the kernels
take), CPU tensors take the plain versions.  The force path's backward (no
parameter gradients) runs over compacted rows: :func:`compact_rows` gathers
each atom's valid neighbour slots in ascending slot order, atoms longest
first, and the kernels work on those rows only and leave exact zeros at the
masked slots.  The backward with parameter gradients (training; off the
force path) keeps two template instances: the shared-memory one wherever
its tiles fit (K <= 89 at M = 128), and above that one whose K x M tiles sit
in a per-CTA device workspace served by L2.  ``MAX_K`` is the neighbour
capacity the port's model path accepts (``DDConfig`` and the providers'
``grow`` enforce it) on every device, so card and CPU results stay
comparable.  Each kernel wrapper counts its launches in
``<wrapper>.launches``: one per call, however many CUDA kernels the call
runs.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build
from .ref import attn_scale, nbr_attention_stack_bwd_ref, nbr_attention_stack_ref

SMEM_LIMIT = 232_448      # bytes of shared memory one block may use (H100)
PARAM_GRAD_BLOCKS = 132   # CTAs of a parameter-gradient launch (one per SM)
MAX_K = 128               # the port's neighbour-capacity limit (both ways)
ROW_PASS = 1 << 20        # stacked rows per pass of the force-path backward


def k_limit_message(k: int) -> str:
    return (f"neighbour capacity K={k} exceeds the port's limit of {MAX_K}: "
            "the attention kernels (repro_torch/kernels/csrc/nbr_attn.cu) "
            f"take K <= {MAX_K} at M = 128 in both directions")


_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = build.load("nbr_attn")
    if not getattr(lib, "_bound", False):
        lib.nbr_attn_fwd.argtypes = [_P] * 14 + [_I] * 7 + [_F, _P]
        lib.nbr_attn_bwd.argtypes = [_P] * 20 + [_I] * 8 + [_F, _P]
        lib.nbr_attn_bwd_rows.argtypes = ([_P] * 20 + [_LL] + [_I] * 3
                                          + [_P] * 6 + [_I] * 7 + [_F, _P])
        lib.nbr_attn_reduce.argtypes = [_P, _P, _I, _LL, _P]
        for fn in (lib.nbr_attn_fwd, lib.nbr_attn_bwd, lib.nbr_attn_bwd_rows,
                   lib.nbr_attn_reduce):
            fn.restype = _I
        for fn in (lib.nbr_attn_fwd_smem, lib.nbr_attn_bwd_smem,
                   lib.nbr_attn_bwd_gmem_smem):
            fn.argtypes = [_I, _I]
            fn.restype = ctypes.c_size_t
        lib.nbr_attn_bwd_rows_smem.argtypes = [_I]
        lib.nbr_attn_bwd_rows_smem.restype = ctypes.c_size_t
        lib.nbr_attn_bwd_gmem_blocks.argtypes = [_I] * 3
        lib.nbr_attn_bwd_gmem_blocks.restype = _I
        lib._bound = True
    return lib


def _smem(k: int, m: int, backward: bool, workspace: bool,
          param_grads: bool) -> int:
    lib = _lib()
    if not backward:
        return lib.nbr_attn_fwd_smem(k, m)
    if not param_grads:
        return lib.nbr_attn_bwd_rows_smem(k)   # an atom with all K valid
    if workspace:
        return lib.nbr_attn_bwd_gmem_smem(k, m)
    return lib.nbr_attn_bwd_smem(k, m)


def max_k(m: int, backward: bool = True, workspace: bool = False,
          param_grads: bool = True) -> int:
    """Largest neighbour capacity K a kernel instance takes at embedding
    width m: the forward; the force-path backward (``param_grads=False``,
    compacted rows, every slot of an atom valid); or the backward with
    parameter gradients, every tile in shared memory or (``workspace``)
    its K x M tiles in device memory."""
    k = 1
    while _smem(k + 1, m, backward, workspace, param_grads) <= SMEM_LIMIT:
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


def _validate(g, planes, weights, heads: int, backward: bool,
              param_grads: bool = True):
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
    if backward and not param_grads and (m % 4 or (h // heads) % 4 or h % 8):
        raise ValueError(f"the force-path attention backward takes M and the "
                         f"head width in multiples of 4 and H in multiples of "
                         f"8; got M={m}, H={h}, heads={heads}")
    lib = _lib()
    workspace = backward and param_grads and uses_workspace(k, m)
    smem = _smem(k, m, backward, workspace, param_grads)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"K={k} at M={m} needs {smem} bytes of shared memory for the "
            f"{'backward' if backward else 'forward'} attention kernel; the "
            f"largest K it takes is "
            f"{max_k(m, backward, backward and param_grads, param_grads)}")
    return lib, n, k, m, h, layers


def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def nbr_attention_stack_fwd(g, rx, ry, rz, sw, mask, wq, wk, wv, wo, gamma,
                            beta, heads: int = 1,
                            compute_dtype: str = "float32",
                            stash: bool = False):
    """Forward stack; with ``stash=True`` also the layer inputs
    (L, N, K, M) the backward needs.  The CUDA kernel for CUDA tensors."""
    if not g.is_cuda:
        return nbr_attention_stack_ref(g, rx, ry, rz, sw, mask, wq, wk, wv,
                                       wo, gamma, beta, heads=heads,
                                       compute_dtype=compute_dtype,
                                       stash=stash)
    planes = [p.contiguous() for p in (rx, ry, rz, sw, mask)]
    weights = [w.contiguous() for w in (wq, wk, wv, wo, gamma, beta)]
    g = g.contiguous()
    lib, n, k, m, h, layers = _validate(g, planes, weights, heads, False)
    out = torch.empty_like(g)
    st = g.new_empty((layers, n, k, m)) if stash else None
    if n:
        err = lib.nbr_attn_fwd(
            *_ptrs(g, *planes, *weights, out), st.data_ptr() if stash else None,
            n, k, m, h, layers, heads, int(compute_dtype == "bfloat16"),
            float(attn_scale(h // heads)), _stream())
        build.check(err, lib, "nbr_attn_fwd")
        nbr_attention_stack_fwd.launches += 1
    return (out, st) if stash else out


def nbr_attention_stack_bwd(stash, rx, ry, rz, sw, mask, wq, wk, wv, wo,
                            gamma, beta, dout, heads: int = 1,
                            compute_dtype: str = "float32",
                            param_grads: bool = True):
    """(dg, drx, dry, drz, dsw, dwq, dwk, dwv, dwo, dgamma, dbeta); the
    parameter gradients are None unless ``param_grads``.  The CUDA kernel
    (plus a deterministic reduction of per-CTA partials when parameter
    gradients are asked for) for CUDA tensors."""
    if not dout.is_cuda:
        res = nbr_attention_stack_bwd_ref(stash, rx, ry, rz, sw, mask, wq, wk,
                                          wv, wo, gamma, beta, dout,
                                          heads=heads,
                                          compute_dtype=compute_dtype)
        return res if param_grads else res[:5] + (None,) * 6
    planes = [p.contiguous() for p in (rx, ry, rz, sw, mask)]
    weights = [w.contiguous() for w in (wq, wk, wv, wo, gamma, beta)]
    dout, stash = dout.contiguous(), stash.contiguous()
    lib, n, k, m, h, layers = _validate(dout, planes, weights, heads, True,
                                        param_grads)
    if stash.shape != (layers, n, k, m) or stash.dtype != torch.float32:
        raise ValueError(f"stash must be ({layers}, {n}, {k}, {m}) float32")
    bf16 = int(compute_dtype == "bfloat16")
    scale = float(attn_scale(h // heads))
    if not param_grads:
        res = _bwd_rows(lib, stash, planes, weights, dout, heads, bf16, scale)
        return res + (None,) * 6
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


def _bwd_rows(lib, stash, planes, weights, dout, heads, bf16, scale):
    """The force-path backward over compacted rows: (dg, drx, dry, drz,
    dsw), exact zeros at the masked slots.  Passes of at most ``ROW_PASS``
    stacked rows bound the scratch memory."""
    layers, n, k, m = stash.shape
    h = weights[0].shape[2]
    dg = torch.zeros_like(dout)
    dplanes = [torch.zeros_like(planes[0]) for _ in range(4)]
    _, count, start, rows = compact_rows(planes[4])
    count_h = count.cpu().numpy()
    passes = row_passes(count_h)
    if not passes:
        return (dg, *dplanes)
    cap = max(r1 - r0 for _, _, r0, r1 in passes)
    new = lambda *s: dout.new_empty(s)
    qkv, dqkv = new(cap, 3 * h), new(cap, 3 * h)
    ob, xb, db, gacc = new(cap, h), new(cap, m), new(cap, m), new(cap, 4)
    for a0, a1, r0, r1 in passes:
        err = lib.nbr_attn_bwd_rows(
            *_ptrs(stash, *planes, *weights[:5], dout, dg, *dplanes),
            rows.data_ptr() + 8 * r0, start.data_ptr() + 8 * a0,
            count.data_ptr() + 8 * a0, r0, a1 - a0, r1 - r0,
            int(count_h[a0]), *_ptrs(qkv, ob, xb, db, dqkv, gacc), n, k, m,
            h, layers, heads, bf16, scale, _stream())
        build.check(err, lib, "nbr_attn_bwd_rows")
    nbr_attention_stack_bwd.launches += 1
    return (dg, *dplanes)


nbr_attention_stack_fwd.launches = 0
nbr_attention_stack_bwd.launches = 0


class NbrAttentionStack(torch.autograd.Function):
    """Differentiable in everything but the mask; the backward skips the
    parameter gradients when autograd does not ask for them (the MD force
    path)."""

    @staticmethod
    def forward(ctx, g, rx, ry, rz, sw, mask, wq, wk, wv, wo, gamma, beta,
                heads, compute_dtype):
        out, stash = nbr_attention_stack_fwd(g, rx, ry, rz, sw, mask, wq, wk,
                                             wv, wo, gamma, beta, heads,
                                             compute_dtype, stash=True)
        ctx.save_for_backward(stash, rx, ry, rz, sw, mask, wq, wk, wv, wo,
                              gamma, beta)
        ctx.cfg = (heads, compute_dtype)
        return out

    @staticmethod
    def backward(ctx, dout):
        heads, compute_dtype = ctx.cfg
        param_grads = any(ctx.needs_input_grad[6:12])
        (dg, drx, dry, drz, dsw, *pg) = nbr_attention_stack_bwd(
            *ctx.saved_tensors, dout, heads=heads,
            compute_dtype=compute_dtype, param_grads=param_grads)
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
