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
take), CPU tensors take the plain versions.  The backward has two template
instances: the shared-memory one wherever its tiles fit (K <= 89 at
M = 128), and above that one whose K x M tiles sit in a per-CTA device
workspace served by L2.  ``MAX_K`` is the neighbour capacity the port's
model path accepts (``DDConfig`` and the providers' ``grow`` enforce it) on
every device, so card and CPU results stay comparable.  Each kernel wrapper
counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import attn_scale, nbr_attention_stack_bwd_ref, nbr_attention_stack_ref

SMEM_LIMIT = 232_448      # bytes of shared memory one block may use (H100)
PARAM_GRAD_BLOCKS = 132   # CTAs of a parameter-gradient launch (one per SM)
MAX_K = 128               # the port's neighbour-capacity limit (both ways)


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
        lib.nbr_attn_reduce.argtypes = [_P, _P, _I, _LL, _P]
        for fn in (lib.nbr_attn_fwd, lib.nbr_attn_bwd, lib.nbr_attn_reduce):
            fn.restype = _I
        for fn in (lib.nbr_attn_fwd_smem, lib.nbr_attn_bwd_smem,
                   lib.nbr_attn_bwd_gmem_smem):
            fn.argtypes = [_I, _I]
            fn.restype = ctypes.c_size_t
        lib.nbr_attn_bwd_gmem_blocks.argtypes = [_I] * 4
        lib.nbr_attn_bwd_gmem_blocks.restype = _I
        lib._bound = True
    return lib


def _smem_fn(backward: bool, workspace: bool = False):
    lib = _lib()
    if not backward:
        return lib.nbr_attn_fwd_smem
    return lib.nbr_attn_bwd_gmem_smem if workspace else lib.nbr_attn_bwd_smem


def max_k(m: int, backward: bool = True, workspace: bool = False) -> int:
    """Largest neighbour capacity K a kernel instance takes at embedding
    width m: the forward, the backward with every tile in shared memory, or
    (``workspace``) the backward whose K x M tiles live in device memory."""
    smem = _smem_fn(backward, workspace)
    k = 1
    while smem(k + 1, m) <= SMEM_LIMIT:
        k += 1
    return k


def uses_workspace(k: int, m: int) -> bool:
    """True when the backward at (K, M) runs the device-workspace instance
    (its shared-memory tiles do not fit)."""
    return _lib().nbr_attn_bwd_smem(k, m) > SMEM_LIMIT


def _validate(g, planes, weights, heads: int, backward: bool):
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
    workspace = backward and uses_workspace(k, m)
    smem = _smem_fn(backward, workspace)(k, m)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"K={k} at M={m} needs {smem} bytes of shared memory for the "
            f"{'backward' if backward else 'forward'} attention kernel; the "
            f"largest K it takes is {max_k(m, backward, backward)}")
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
    lib, n, k, m, h, layers = _validate(dout, planes, weights, heads, True)
    if stash.shape != (layers, n, k, m) or stash.dtype != torch.float32:
        raise ValueError(f"stash must be ({layers}, {n}, {k}, {m}) float32")
    dg = torch.empty_like(dout)
    dplanes = [torch.empty_like(planes[0]) for _ in range(4)]
    sizes = [layers * m * h] * 4 + [layers * m] * 2
    bf16 = int(compute_dtype == "bfloat16")
    ws = None
    if uses_workspace(k, m):
        # persistent grid of the resident CTAs, one workspace slot each
        nblk = lib.nbr_attn_bwd_gmem_blocks(k, m, int(param_grads), bf16)
        if nblk <= 0:
            raise RuntimeError(f"nbr_attn_bwd: no resident CTA at K={k}")
        nblk = max(1, min(n, nblk))
        ws = dout.new_empty((nblk, 2, k, m))
    else:
        nblk = max(1, min(n, PARAM_GRAD_BLOCKS)) if param_grads else 0
    part = dout.new_zeros((nblk, sum(sizes))) if param_grads else None
    if n:
        err = lib.nbr_attn_bwd(
            *_ptrs(stash, *planes, *weights, dout, dg, *dplanes),
            part.data_ptr() if param_grads else None,
            ws.data_ptr() if ws is not None else None, nblk, n, k, m, h,
            layers, heads, bf16, float(attn_scale(h // heads)), _stream())
        build.check(err, lib, "nbr_attn_bwd")
        nbr_attention_stack_bwd.launches += 1
    if not param_grads:
        return (dg, *dplanes) + (None,) * 6
    total = dout.new_empty(sum(sizes))
    err = lib.nbr_attn_reduce(part.data_ptr(), total.data_ptr(), nblk,
                              total.numel(), _stream())
    build.check(err, lib, "nbr_attn_reduce")
    shapes = [(layers, m, h)] * 3 + [(layers, h, m), (layers, m), (layers, m)]
    pg = [t.view(s) for t, s in zip(total.split(sizes), shapes)]
    return (dg, *dplanes, *pg)


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
