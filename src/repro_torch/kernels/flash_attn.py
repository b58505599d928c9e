"""Blockwise (flash) attention of the LM substrate: CUDA kernel and plain
version.

Replaces the Pallas ``repro/kernels/flash_attn.py::_flash_kernel``
(``flash_attention``).  The kernel is CUDA C++ for ``sm_90a`` in
``csrc/flash_attn.cu`` (built by :mod:`repro_torch.kernels.build`, bound
with ctypes); that file's header says what bounds it on the H100 and what
its design does about it: bf16 calls with more than 16 query rows per
KV head (prefill) run on the tensor cores (``mma.sync``, P rounded to bf16
in registers), decode and fp32 calls on fp32 FMAs.  The plain version is
:func:`~repro_torch.kernels.ref.attention_ref`.  Forward only, as the TPU
kernel is.

Dispatch goes by the tensors' device: CUDA tensors launch the kernel (and
raise if it cannot build or launch, or on a head dimension it has no
instance for), CPU tensors take the plain version.  Unlike the Pallas
wrapper, any Sq and Sk are taken without padding, keys past Sk are masked
(the Pallas kernel attends to its zero padding when ``causal=False``), and
K and V are read per KV head (no copy per q head).  K and V may be views
whose rows are contiguous, such as a cache sliced to its filled length.
At decode (at most 16 query rows per KV head) the visible KV blocks are
split over several CTAs and their partials merged by a second kernel in a
fixed order (``key_splits``; the workspace is allocated here).  The wrapper
counts its launches in ``flash_attention.launches``, one per call.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import attention_ref

HEAD_DIMS = (32, 64, 128, 256)   # the kernel's template instances
BK = 64                          # keys per KV block (csrc/flash_attn.cu)
DECODE_ROWS = 16                 # rows of the decode instance's row block
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attn")
    if not getattr(lib, "_bound", False):
        lib.flash_attn_fwd.argtypes = ([_P] * 4 + [_I] * 7 + [_LL] * 4
                                       + [_I, _I, _F, _I, _I, _P, _P])
        lib.flash_attn_fwd.restype = _I
        lib._bound = True
    return lib


def key_splits(b, hq, hkv, sq, sk, causal, window, q_offset, sms) -> int:
    """CTAs over which the decode instance (Hq / Hkv * Sq <= 16 rows per
    KV head) divides the visible KV blocks: about two CTAs per SM (``sms``
    of them) in all, at most one per block; 1 for every other call."""
    if (hq // hkv) * sq > DECODE_ROWS:
        return 1
    begin = max(0, q_offset - window + 1) if window > 0 else 0
    end = min(sk, q_offset + sq) if causal else sk
    blocks = (end + BK - 1) // BK - begin // BK if end > begin else 0
    return max(1, min(blocks, -(-2 * sms // (b * hkv))))


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0):
    """q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D), Hq % Hkv == 0 -> (B, Hq, Sq, D)
    in q's dtype (float32 or bfloat16).  ``q_offset`` is the absolute
    position of query 0 (decode).  The CUDA kernel for CUDA tensors."""
    if not q.is_cuda:
        return attention_ref(q, k, v, causal, window, softcap, q_offset)
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if (k.shape[0] != b or v.shape != k.shape or k.shape[3] != d
            or hq % hkv):
        raise ValueError(f"flash_attention takes q (B, Hq, Sq, D) and k/v "
                         f"(B, Hkv, Sk, D) with Hq % Hkv == 0; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention has instances for D in {HEAD_DIMS}, "
                         f"not D={d}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes float32 or bfloat16 q, k, v "
                         f"of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (k.device == v.device == q.device):
        raise ValueError("flash_attention inputs lie on different devices")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention is forward only (as the TPU "
                           "kernel is); call it under torch.no_grad()")
    # rows of D contiguous elements, 16-byte aligned (the kernel's loads)
    q = q.contiguous()
    q = q if q.data_ptr() % 16 == 0 else q.clone()
    k, v = (t if t.stride(3) == 1 and t.stride(2) == d
            and t.data_ptr() % 16 == 0
            else t.clone(memory_format=torch.contiguous_format)
            for t in (k, v))
    out = torch.empty_like(q)
    if out.numel():
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        splits = key_splits(b, hq, hkv, sq, sk, causal, window, q_offset, sms)
        ws = (torch.empty((splits, b * hq * sq, d + 2), dtype=torch.float32,
                          device=q.device) if splits > 1 else None)
        lib = _lib()
        err = lib.flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, hq, hkv, sq, sk, d, k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), int(bool(causal)), int(window),
            float(softcap), int(q_offset), splits,
            None if ws is None else ws.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        build.check(err, lib, "flash_attention")
        flash_attention.launches += 1
    return out


flash_attention.launches = 0
