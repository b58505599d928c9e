"""The neighbour gather of the DP force path and its backward, the force
scatter: CUDA kernel, plain version, autograd.

Not a TPU kernel: the JAX reference gathers ``coords[safe]``
(``repro/dp/model.py::_atomic_e``) and XLA scatter-adds its gradient.
PyTorch's own backward of that gather (``index_put_`` with accumulate)
sorts every slot, padded ones too, and on the CPU adds with atomics, in
thread order, once it holds 32,768 or more elements and several intra-op
threads run, so forces did not repeat bit for bit.  Here the gather's
backward is :func:`force_scatter`: for each atom j, the sum of the
cotangent rows ``g[i, k]`` over the slots with ``idx[i, k] == j`` and
``mask[i, k] > 0``, from +0.0 in ascending flat order ``i*K + k``.  Masked
and padded slots add nothing: the DP model's cotangent there is +0.0, so
the sums are those of the full scatter.

The kernels are CUDA C++ for ``sm_90a`` in ``csrc/force_scatter.cu`` (built
by :mod:`repro_torch.kernels.build`, bound with ctypes); its header says
what bounds them (bytes) and why the sums have the plain version's bits.
:func:`_build_list` builds the reverse list on the card from ``(idx,
mask)`` with a stable radix sort written by hand over the valid slots only
(bookkeeping, no arithmetic), and :func:`_launch` sums each atom's
segment; the list is not cached, since the mask changes at every evaluate.
:func:`reverse_list` is the list's plain version (a stable ``torch.sort``)
and :func:`force_scatter_plain` the sums', ``index_add_`` over the valid
slots in ascending flat order.

Dispatch goes by the tensors' device: CUDA tensors launch the kernel (and
raise if it cannot build or launch), CPU tensors take the plain version.
The wrapper counts its launches in ``force_scatter.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
TILE = 4096                 # slots per block of the list's sort (csrc)
MAX_SLOTS = 2 ** 31 - 1     # list entries and places are 32-bit


def _lib() -> ctypes.CDLL:
    lib = build.load("force_scatter")
    if not getattr(lib, "_bound", False):
        for name in ("force_scatter_list_i32", "force_scatter_list_i64"):
            getattr(lib, name).argtypes = [_P, _P, _L, _I] + [_P] * 10
            getattr(lib, name).restype = _I
        lib.force_scatter_sum.argtypes = [_P, _P, _P, _P, _I, _P]
        lib.force_scatter_sum.restype = _I
        lib._bound = True
    return lib


def _valid(idx, mask):
    return (idx >= 0) & (mask > 0)


def force_scatter_plain(g, idx, mask, n: int):
    """The kernel's function in plain PyTorch: (n, 3) sums of the rows of
    ``g`` (C, K, 3) by destination ``idx`` (C, K) over the slots with
    ``mask`` (C, K) > 0, ``index_add_`` in ascending flat order."""
    slots = torch.nonzero(_valid(idx, mask).reshape(-1)).reshape(-1)
    out = g.new_zeros((n, 3))
    return out.index_add_(0, idx.reshape(-1)[slots].long(),
                          g.reshape(-1, 3)[slots])


def reverse_list(idx, mask, n: int):
    """(perm, offsets): the valid flat slots ordered by destination atom and,
    within an atom, ascending; atom j's slots are
    ``perm[offsets[j]:offsets[j + 1]]``.  Masked slots sort after every
    atom (key n), so no host sync is needed to drop them.  int64."""
    keys = torch.where(_valid(idx, mask), idx,
                       torch.full_like(idx, n)).reshape(-1)
    keys, perm = torch.sort(keys, stable=True)
    bounds = torch.arange(n + 1, dtype=keys.dtype, device=keys.device)
    return perm, torch.searchsorted(keys, bounds)


def force_scatter(g, idx, mask, n: int):
    """(n, 3) per-atom sums of the cotangent rows ``g`` (C, K, 3) float32 of
    the valid slots (``idx`` (C, K) >= 0, ``mask`` (C, K) > 0).  The CUDA
    kernels for CUDA tensors: the list built by :func:`_build_list`, the
    sums by :func:`_launch`."""
    if not g.is_cuda:
        return force_scatter_plain(g, idx, mask, n)
    if (g.dtype != torch.float32 or g.shape != (*idx.shape, 3)
            or mask.shape != idx.shape or idx.dtype not in (torch.int32,
                                                            torch.int64)):
        raise ValueError(
            f"force_scatter takes g (C, K, 3) float32 with integer indices "
            f"and a mask of (C, K); got g {tuple(g.shape)} {g.dtype}, idx "
            f"{tuple(idx.shape)} {idx.dtype}, mask {tuple(mask.shape)}")
    if not (idx.device == g.device == mask.device):
        raise ValueError("force_scatter inputs lie on different devices")
    return _launch(g, *_build_list(idx, mask, n), n)


def _build_list(idx, mask, n: int):
    """The reverse list of :func:`reverse_list` built on the card by the
    hand-written radix sort: (perm, off) int32, atom j's valid slots
    ``perm[off[j]:off[j + 1]]`` ascending; ``perm`` has C*K entries, of
    which the first ``off[n]`` are the list.  Slots whose index lies outside
    [0, n) are dropped with the masked ones."""
    if not idx.is_cuda:
        raise ValueError("_build_list builds the list on the card; "
                         "reverse_list is its plain version")
    slots = idx.numel()
    if slots > MAX_SLOTS or not 0 <= n < MAX_SLOTS:
        raise ValueError(f"force_scatter takes fewer than 2^31 slots and "
                         f"atoms; got {slots} slots, n = {n}")
    if mask.dtype != torch.float32:
        mask = (mask > 0).to(torch.float32)
    # the first pass reads 16 bytes a load: a view starting off a 16-byte
    # boundary is copied
    idx, mask = (t.reshape(-1).contiguous() for t in (idx, mask))
    idx, mask = (t.clone() if t.data_ptr() % 16 else t for t in (idx, mask))
    nb = -(-slots // TILE)
    sizes = (slots, slots, slots, slots, 256 * nb, nb, 256, 1, n + 1)
    ws = torch.empty(sum(sizes), dtype=torch.int32, device=idx.device)
    keys, perm, tmp_k, tmp_v, hist, count, total, nvalid, off = ws.split(sizes)
    if n:
        lib = _lib()
        fn = (lib.force_scatter_list_i32 if idx.dtype == torch.int32
              else lib.force_scatter_list_i64)
        err = fn(idx.data_ptr(), mask.data_ptr(), slots, n,
                 *(t.data_ptr() for t in (keys, perm, tmp_k, tmp_v, hist,
                                          count, total, nvalid, off)),
                 torch.cuda.current_stream().cuda_stream)
        build.check(err, lib, "force_scatter list")
    else:
        off.zero_()
    return perm, off


def _launch(g, perm, off, n: int):
    """The sums alone, over a built reverse list ``(perm, off)`` (int32, as
    :func:`_build_list` gives it)."""
    g = g.contiguous()
    out = g.new_empty((n, 3))
    if n:
        lib = _lib()
        err = lib.force_scatter_sum(g.data_ptr(), perm.data_ptr(),
                                    off.data_ptr(), out.data_ptr(), n,
                                    torch.cuda.current_stream().cuda_stream)
        build.check(err, lib, "force_scatter")
        force_scatter.launches += 1
    return out


force_scatter.launches = 0


def _safe(idx):
    return torch.where(idx >= 0, idx, torch.zeros_like(idx))


class _Gather(torch.autograd.Function):
    """``coords[safe]``; backward: the force scatter of the valid slots."""

    @staticmethod
    def forward(ctx, coords, idx, mask):
        ctx.save_for_backward(idx, mask)
        ctx.n = coords.shape[0]
        return coords[_safe(idx)]

    @staticmethod
    def backward(ctx, g):
        idx, mask = ctx.saved_tensors
        return _Scatter.apply(g, idx, mask, ctx.n), None, None


class _Scatter(torch.autograd.Function):
    """The force scatter; backward: the gather again, zero at the masked
    slots, so grad-of-grad stays exact."""

    @staticmethod
    def forward(ctx, g, idx, mask, n):
        ctx.save_for_backward(idx, mask)
        return force_scatter(g, idx, mask, n)

    @staticmethod
    def backward(ctx, dc):
        idx, mask = ctx.saved_tensors
        dg = _Gather.apply(dc, idx, mask)
        return (torch.where(_valid(idx, mask)[..., None], dg,
                            torch.zeros((), dtype=dg.dtype, device=dg.device)),
                None, None, None)


def scatter_sum(g, idx, mask, n: int):
    """:func:`force_scatter` under autograd (its backward is the gather,
    zero at the masked slots): (n, 3) ordered per-row sums of ``g`` (C, K,
    3) that differentiate to ``g``."""
    return _Scatter.apply(g, idx, mask, n)


def neighbor_gather(coords, idx, mask):
    """``coords[idx]`` (C, K, 3) for coords (N, 3), idx (C, K) (-1 padded,
    read as atom 0) and mask (C, K).  Its gradient sums each slot's
    cotangent onto its atom over the valid slots only (idx >= 0, mask > 0):
    the masked slots' outputs count as constants, as the DP model, whose
    cotangent there is +0.0, needs.  Twice differentiable."""
    return _Gather.apply(coords, idx, mask)
