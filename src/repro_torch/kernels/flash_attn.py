"""Blockwise (flash) attention of the LM substrate: CUDA kernels and plain
versions.

Replaces the Pallas ``repro/kernels/flash_attn.py::_flash_kernel``
(``flash_attention``).  The kernels are CUDA C++ for ``sm_90a`` in
``csrc/flash_attn.cu`` (built by :mod:`repro_torch.kernels.build`, bound
with ctypes); that file's header says what bounds them on the H100 and what
their design does about it: bf16 prefill (more than 16 query rows per KV
head) on Hopper's tensor-core path (``wgmma.mma_async`` fed by TMA through
an mbarrier ring, a producer warpgroup and two consumer warpgroups; P
rounded to bf16 in registers), fp32 prefill on fp32 FMAs, and decode (at
most 16 rows per KV head, fp32 or bf16) in a kernel bound by bytes that
streams K/V through a cp.async ring.
The plain versions are :func:`~repro_torch.kernels.ref.attention_ref` and
:func:`~repro_torch.kernels.ref.decode_ref`.  Forward only, as the TPU
kernel is; for training the prefill kernels also return the rows'
log-sum-exp (``return_lse``), which ``ops.FlashAttention`` keeps for its
plain backward (:func:`~repro_torch.kernels.ref.attention_bwd_ref`).

Two entry points:

* :func:`flash_attention` (q, k, v, causal, window, softcap, q_offset):
  host ints, any Sq and Sk, the TPU kernel's signature; v may have its own
  head width (MLA's (192, 128): the prefill kernels at every Sq, since the
  decode kernel keeps one width);
* :func:`flash_decode` (q, k_cache, v_cache, pos, window, softcap): decode
  over a whole cache, the position a 0-d int64 tensor on the card (queries
  at ``pos``.., keys ``< pos + Sq``, causal).  Nothing on the host depends
  on ``pos``: the grid is fixed by the cache's capacity, the SM count is
  read once and the split workspace is kept per shape, so a decode step
  that calls it can be captured and replayed as a CUDA graph.

Dispatch goes by the tensors' device: CUDA tensors launch a kernel (and
raise if it cannot build or launch, or on a shape it has no instance for),
CPU tensors take the plain version.  Unlike the Pallas wrapper, any Sq and
Sk are taken without padding, keys past Sk (or the decode length) are
masked (the Pallas kernel attends to its zero padding when
``causal=False``), and K and V are read per KV head (no copy per q head).
K and V may be views whose rows are contiguous, such as a cache sliced to
its filled length (for the bf16 prefill also with head and batch strides
of whole 16-byte units, :func:`_tma_ok`; others are copied).  At decode the visible KV blocks are split over several
CTAs (:func:`decode_splits`) and their partials merged in split order by
a second kernel.  Each wrapper counts its launches in
``<wrapper>.launches``, one per call.

:func:`attention_flops_bytes` is the work of one call, the kernel's
operations and the bytes it must move; a step counter
(``launch/roofline.py::count_step``) takes it in place of the wrapper's
insides (:mod:`~repro_torch.kernels.accounting`), and ``chip_smoke.py``
bounds the kernel's time by it.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build
from .accounting import accounted
from .ref import attention_lse_ref, attention_ref, decode_ref

HEAD_DIMS = (32, 64, 128, 256)   # the kernels' template instances (D = DV)
# (D, DV) instances of the prefill kernels: equal widths, and MLA's
# qk_nope + qk_rope = 192 with v_head_dim = 128 (deepseek-v3)
QK_V_DIMS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)
BK = 64                          # keys per KV block (csrc/flash_attn.cu)
DECODE_ROWS = 16                 # the decode kernel's most rows per KV head
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attn")
    if not getattr(lib, "_bound", False):
        lib.flash_attn_fwd.argtypes = ([_P] * 4 + [_I] * 8 + [_LL] * 4
                                       + [_I, _I, _F, _I, _P, _P])
        lib.flash_attn_decode.argtypes = ([_P] * 4 + [_I] * 7 + [_LL] * 4
                                          + [_I, _I, _F, _I, _P, _I, _P, _I,
                                             _P, _P])
        for fn in (lib.flash_attn_fwd, lib.flash_attn_decode):
            fn.restype = _I
        lib._bound = True
    return lib


def decode_splits(b: int, hkv: int, sk: int, sms: int) -> int:
    """CTAs per (b, KV head) of the decode kernel over ``sk`` keys (the
    cache's capacity at decode): about two CTAs per SM (``sms`` of them) in
    all, never more than one wave, and at most one per 64-key block."""
    blocks = -(-sk // BK)
    return max(1, min(blocks, (2 * sms) // max(1, b * hkv)))


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _workspace(device, splits: int, rows: int, d: int) -> torch.Tensor:
    """The split partials' buffer of one shape, splits x rows x (D + 2)
    floats, kept for every later call (a captured graph keeps its address).
    Calls of one shape share it, so they go on one stream."""
    return torch.empty((splits, rows, d + 2), dtype=torch.float32,
                       device=device)


def _check_qkv(what, q, k, v, instances=QK_V_DIMS):
    b, hq, sq, d = q.shape
    if (k.dim() != 4 or v.dim() != 4 or k.shape[0] != b
            or v.shape[:3] != k.shape[:3] or k.shape[3] != d
            or hq % k.shape[1]):
        raise ValueError(f"{what} takes q (B, Hq, Sq, D), k (B, Hkv, Sk, D) "
                         f"and v (B, Hkv, Sk, DV) with Hq % Hkv == 0; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if (d, v.shape[3]) not in instances:
        raise ValueError(f"{what} has instances for (D, DV) in {instances}, "
                         f"not ({d}, {v.shape[3]})")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what} takes float32 or bfloat16 q, k, v "
                         f"of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (k.device == v.device == q.device):
        raise ValueError(f"{what} inputs lie on different devices")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(f"{what} is forward only (as the TPU kernel is); "
                           "call it under torch.no_grad()")


def _rows_ok(t: torch.Tensor) -> bool:
    """Rows of D contiguous elements, 16-byte aligned (the kernels' loads)."""
    return (t.stride(3) == 1 and t.stride(2) == t.shape[3]
            and t.data_ptr() % 16 == 0)


def _tma_ok(t: torch.Tensor) -> bool:
    """K or V as the bf16 prefill kernel's tensor map reads it: rows as
    :func:`_rows_ok`, and head and batch strides of whole 16-byte units
    (TMA's rule; a dimension of size 1 is never stepped)."""
    unit = 16 // t.element_size()
    return _rows_ok(t) and all(t.stride(i) % unit == 0
                               for i in (0, 1) if t.shape[i] > 1)


def _decode_launch(q, k, v, causal, window, softcap, q_offset, pos,
                   kv_base=0, lse=None):
    """The decode kernel (Hq / Hkv * Sq <= 16); ``pos`` a device int64 or
    None (then ``q_offset`` and ``causal`` hold); ``kv_base`` the global
    index of key row 0; ``lse`` an fp32 (B, Hq, Sq) tensor for the rows'
    log-sum-exp, or None."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    splits = decode_splits(b, hkv, sk, _sm_count(q.device))
    ws = _workspace(q.device, splits, b * hq * sq, d) if splits > 1 else None
    lib = _lib()
    err = lib.flash_attn_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], b, hq, hkv, sq, sk, d, k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), int(bool(causal)), int(window),
        float(softcap), int(q_offset), None if pos is None else pos.data_ptr(),
        splits, None if ws is None else ws.data_ptr(), int(kv_base),
        None if lse is None else lse.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, lib, "flash_attention decode")
    return out


def attention_flops_bytes(b: int, hq: int, hkv: int, sq: int, sk: int,
                          d: int, dv: int, element_size: int, causal: bool,
                          window: int, q_offset: int,
                          lse: bool = False) -> tuple[int, int]:
    """(flops, bytes) of one attention call over the (query, key) pairs it
    sees: 2 (D + DV) FLOPs per visible pair and q head (Q K^T and P V; the
    softmax's exponentials not counted), against q and o once, the K/V rows
    some query can see once, and with ``lse`` the rows' fp32 log-sum-exp."""
    pos = q_offset + np.arange(sq, dtype=np.int64)   # first/last visible key
    hi = np.minimum(sk - 1, pos) if causal else np.full(sq, sk - 1)
    lo = (np.maximum(0, pos - window + 1) if window > 0
          else np.zeros(sq, np.int64))
    pairs = int(np.clip(hi - lo + 1, 0, None).sum()) * b * hq
    keys = max(0, int(hi.max()) - int(lo.min()) + 1) if sq else 0
    nbytes = element_size * (b * hq * sq * (d + dv) + b * hkv * keys * (d + dv))
    if lse:
        nbytes += 4 * b * hq * sq
    return 2 * (d + dv) * pairs, nbytes


def attention_work(q, k, v, causal: bool = True, window: int = 0,
                   softcap: float = 0.0, q_offset: int = 0, *,
                   return_lse: bool = False, positions=None):
    """:func:`flash_attention`'s (flops, bytes) for these arguments."""
    b, hq, sq, d = q.shape
    return attention_flops_bytes(b, hq, k.shape[1], sq, k.shape[2], d,
                                 v.shape[3], q.element_size(), causal, window,
                                 q_offset, return_lse)


def decode_work(q, k_cache, v_cache, pos, window: int = 0,
                softcap: float = 0.0, *, kv_base: int = 0,
                return_lse: bool = False, positions=None):
    """:func:`flash_decode`'s (flops, bytes): the cache rows holding keys
    < positions + Sq, ``positions`` the caller's host-side int (``pos`` is
    a device tensor, whose value the host does not read); a slice at
    ``kv_base`` is counted as the keys of the whole sequence it holds."""
    if positions is None:
        raise ValueError("flash_decode's work depends on its position: "
                         "give the counter the host-side positions")
    b, hq, sq, d = q.shape
    p = int(positions) - int(kv_base)          # the position within the slice
    n = max(0, min(k_cache.shape[2], p + sq))
    if p + sq <= 0:                            # the slice lies wholly past
        return 0, q.element_size() * b * hq * sq * (d + v_cache.shape[3]) \
            + (4 * b * hq * sq if return_lse else 0)
    return attention_flops_bytes(b, hq, k_cache.shape[1], sq, n, d,
                                 v_cache.shape[3], q.element_size(), True,
                                 window, p, lse=return_lse)


def _attention_out_like(q, k, v, *args, return_lse: bool = False, **kwargs):
    out = q.new_empty((*q.shape[:3], v.shape[3]))
    if return_lse:
        return out, q.new_empty(q.shape[:3], dtype=torch.float32)
    return out


def _decode_out_like(q, *args, return_lse: bool = False, **kwargs):
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if return_lse:
        return out, q.new_empty(q.shape[:3], dtype=torch.float32)
    return out


@accounted(attention_work, _attention_out_like)
def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0, *,
                    return_lse: bool = False):
    """q (B, Hq, Sq, D), k (B, Hkv, Sk, D), v (B, Hkv, Sk, DV), Hq % Hkv
    == 0 -> (B, Hq, Sq, DV) in q's dtype (float32 or bfloat16); scores
    scaled by 1/sqrt(D).  ``q_offset`` is the absolute position of query 0
    (decode).  A CUDA kernel for CUDA tensors: the prefill kernels above 16
    query rows per KV head or when DV != D, the decode kernel otherwise.

    ``return_lse`` (training, ``ops.FlashAttention``): also the rows'
    log-sum-exp of the scaled (soft-capped) scores, fp32 (B, Hq, Sq), -inf
    where a row sees no key; the prefill kernels write it at every Sq (the
    decode kernel has none), with the same output bits as a call
    without it."""
    if not q.is_cuda:
        out = attention_ref(q, k, v, causal, window, softcap, q_offset)
        if return_lse:
            return out, attention_lse_ref(q, k, causal, window, softcap,
                                          q_offset)
        return out
    _check_qkv("flash_attention", q, k, v)
    b, hq, sq, d = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[3]
    q = q.contiguous()
    q = q if q.data_ptr() % 16 == 0 else q.clone()
    decode = dv == d and (hq // hkv) * sq <= DECODE_ROWS and not return_lse
    ok = _tma_ok if q.dtype == torch.bfloat16 and not decode else _rows_ok
    k, v = (t if ok(t) else t.clone(memory_format=torch.contiguous_format)
            for t in (k, v))
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if not q.numel():
        out = q.new_empty((b, hq, sq, dv))
        return (out, lse) if return_lse else out
    if decode:
        out = _decode_launch(q, k, v, causal, window, softcap, q_offset, None)
    else:
        out = q.new_empty((b, hq, sq, dv))
        lib = _lib()
        err = lib.flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, hq, hkv, sq, sk, d, dv, k.stride(0),
            k.stride(1), v.stride(0), v.stride(1), int(bool(causal)),
            int(window), float(softcap), int(q_offset),
            None if lse is None else lse.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
        build.check(err, lib, "flash_attention")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


@accounted(decode_work, _decode_out_like)
def flash_decode(q, k_cache, v_cache, pos, window: int = 0,
                 softcap: float = 0.0, *, kv_base: int = 0,
                 return_lse: bool = False):
    """Decode attention over a whole cache: q (B, Hq, Sq, D) at absolute
    positions pos .. pos + Sq - 1 against k_cache/v_cache (B, Hkv, S_max,
    D), keys ``< pos + Sq`` (rows past them are never read), causal, with
    the optional window and softcap.  ``pos`` is a 0-d int64 tensor (the
    reference's traced ``pos``).  The decode kernel for CUDA tensors (Hq /
    Hkv * Sq <= 16; the cache's rows contiguous and 16-byte aligned, as
    ``serve_lib.init_cache`` makes them), the plain version for CPU ones.

    ``kv_base`` (a host int): the caches are the slice of a longer cache
    whose row 0 is key ``kv_base`` (a cache sharded by its sequence over a
    device mesh); the masks compare global positions.  ``return_lse``:
    also the rows' log-sum-exp of the scaled (soft-capped) scores, fp32
    (B, Hq, Sq), -inf for a row that sees no key of the slice (its output
    is 0), so slices merge as exp(lse - max lse)-weighted sums."""
    if not q.is_cuda:
        return decode_ref(q, k_cache, v_cache, pos, window, softcap,
                          kv_base, return_lse)
    _check_qkv("flash_decode", q, k_cache, v_cache,
               tuple((d, d) for d in HEAD_DIMS))
    b, hq, sq, d = q.shape
    if (hq // k_cache.shape[1]) * sq > DECODE_ROWS:
        raise ValueError(f"flash_decode takes at most {DECODE_ROWS} query "
                         f"rows per KV head (Hq / Hkv * Sq); got "
                         f"{(hq // k_cache.shape[1]) * sq}")
    if (not isinstance(pos, torch.Tensor) or pos.dim() != 0
            or pos.dtype != torch.int64 or pos.device != q.device):
        raise ValueError("flash_decode takes pos as a 0-d int64 tensor on "
                         "q's device")
    if not (_rows_ok(k_cache) and _rows_ok(v_cache)):
        raise ValueError("flash_decode reads cache rows of D contiguous, "
                         "16-byte aligned elements")
    q = q.contiguous()
    if q.data_ptr() % 16:
        raise ValueError("flash_decode reads q from a 16-byte aligned address")
    lse = (torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
           if return_lse else None)
    if not q.numel():
        out = torch.empty_like(q)
        return (out, lse) if return_lse else out
    out = _decode_launch(q, k_cache, v_cache, True, window, softcap, 0, pos,
                         kv_base, lse)
    flash_decode.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_decode.launches = 0
