"""Within-cutoff flags for gathered neighbour candidates: CUDA kernel and
plain version.

Replaces the Pallas ``repro/kernels/cell_gather.py::_cell_filter_kernel``
(``cell_filter``).  The kernel is CUDA C++ for ``sm_90a`` in
``csrc/cell_filter.cu`` (built by :mod:`repro_torch.kernels.build`, bound
with ctypes); it fuses the candidate gather the TPU version left to XLA,
and its header says what bounds it (bytes) and why it is written with
explicitly rounded intrinsics (flags equal to the plain version's bit for
bit).  The plain version gathers the displacements and applies
:func:`~repro_torch.kernels.ref.cell_filter_ref`.

Dispatch goes by the tensors' device: CUDA tensors launch the kernel (and
raise if it cannot build or launch), CPU tensors take the plain version.
The wrapper counts its launches in ``cell_filter.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import cell_filter_ref, cutoff2

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = build.load("cell_filter")
    if not getattr(lib, "_bound", False):
        lib.cell_filter.argtypes = [_P, _P, _P, _P, _LL, _I, _F, _P]
        lib.cell_filter.restype = _I
        lib._bound = True
    return lib


def cell_filter_plain(buf_coords, idx, buf_mask, rcut: float):
    """The kernel's function in plain PyTorch: (R, M) bool flags."""
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    safe = idx.clamp_min(0).long()
    dr = buf_coords[safe] - buf_coords[:, None, :]
    valid = (idx >= 0) & (idx != rows) & (buf_mask[:, None] > 0)
    return cell_filter_ref(dr[..., 0], dr[..., 1], dr[..., 2],
                           valid.to(buf_coords.dtype), rcut) > 0


def cell_filter(buf_coords, idx, buf_mask, rcut: float):
    """Flags ``|x[idx] - x[i]| < rcut`` for valid entries (idx >= 0, not the
    row itself, row mask > 0) of buffer coordinates (R, 3) float32, indices
    (R, M) int32 (-1 = none) and row mask (R,) float32 -> (R, M) bool.  The
    CUDA kernel for CUDA tensors."""
    if not buf_coords.is_cuda:
        return cell_filter_plain(buf_coords, idx, buf_mask, rcut)
    r, m = idx.shape
    if (buf_coords.shape != (r, 3) or buf_mask.shape != (r,)
            or buf_coords.dtype != torch.float32
            or buf_mask.dtype != torch.float32 or idx.dtype != torch.int32):
        raise ValueError(
            f"cell_filter takes coords ({r}, 3) float32, indices ({r}, M) "
            f"int32 and a ({r},) float32 mask; got {tuple(buf_coords.shape)} "
            f"{buf_coords.dtype}, {tuple(idx.shape)} {idx.dtype}, "
            f"{tuple(buf_mask.shape)} {buf_mask.dtype}")
    if not (idx.device == buf_coords.device == buf_mask.device):
        raise ValueError("cell_filter inputs lie on different devices")
    xyz, idx, mask = (t.contiguous() for t in (buf_coords, idx, buf_mask))
    out = torch.empty((r, m), dtype=torch.bool, device=xyz.device)
    if r * m:
        lib = _lib()
        err = lib.cell_filter(xyz.data_ptr(), idx.data_ptr(), mask.data_ptr(),
                              out.data_ptr(), r, m, float(cutoff2(rcut)),
                              torch.cuda.current_stream().cuda_stream)
        build.check(err, lib, "cell_filter")
        cell_filter.launches += 1
    return out


cell_filter.launches = 0
