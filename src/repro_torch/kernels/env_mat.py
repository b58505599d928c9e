"""Environment-matrix planes: Triton kernels, plain versions, autograd.

Replaces the Pallas ``repro/kernels/env_mat.py::_env_mat_kernel`` and
``_env_mat_bwd_kernel`` (custom VJP ``env_mat``).  The kernels live in
:mod:`repro_torch.kernels.env_mat_triton` (imported at the first launch);
the plain versions are :func:`~repro_torch.kernels.ref.env_mat_ref` and
:func:`~repro_torch.kernels.ref.env_mat_bwd_ref`.

Bound on the H100: device-memory bytes (8 planes moved forward, 11
backward, all fp32); see ``env_mat_triton`` for what the design does about
it.  Triton serves here because the passes are elementwise: a masked vector
load/store over a flattened block reaches the bandwidth a CUDA kernel would.

Dispatch goes by the tensors' device: CUDA tensors launch the kernel (and
raise if it cannot build or launch), CPU tensors take the plain version.
Each kernel wrapper counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import torch

from .ref import env_mat_bwd_ref, env_mat_ref


def _triton():
    from . import env_mat_triton
    return env_mat_triton


def _planes(*planes):
    """Check the (N, K) fp32 planes a kernel takes; returns them contiguous."""
    shape = planes[0].shape
    for p in planes:
        if p.dim() != 2 or p.shape != shape or p.dtype != torch.float32:
            raise ValueError(f"env_mat takes (N, K) float32 planes of one "
                             f"shape, got {tuple(p.shape)} {p.dtype}")
        if p.device != planes[0].device:
            raise ValueError("env_mat planes lie on different devices")
    return [p.contiguous() for p in planes]


def env_mat_fwd(dx, dy, dz, mask, rcut_smth: float, rcut: float):
    """(s, sx, sy, sz) planes; the Triton kernel for CUDA tensors."""
    if not dx.is_cuda:
        return env_mat_ref(dx, dy, dz, mask, rcut_smth, rcut)
    dx, dy, dz, mask = _planes(dx, dy, dz, mask)
    outs = [torch.empty_like(dx) for _ in range(4)]
    _triton().launch_fwd(dx, dy, dz, mask, *outs, rcut_smth, rcut)
    env_mat_fwd.launches += 1
    return tuple(outs)


def env_mat_bwd(dx, dy, dz, mask, gs, gsx, gsy, gsz, rcut_smth: float,
                rcut: float):
    """(ddx, ddy, ddz) from the four output cotangents; the Triton kernel for
    CUDA tensors."""
    if not dx.is_cuda:
        return env_mat_bwd_ref(dx, dy, dz, mask, gs, gsx, gsy, gsz,
                               rcut_smth, rcut)
    planes = _planes(dx, dy, dz, mask, gs, gsx, gsy, gsz)
    outs = [torch.empty_like(planes[0]) for _ in range(3)]
    _triton().launch_bwd(*planes, *outs, rcut_smth, rcut)
    env_mat_bwd.launches += 1
    return tuple(outs)


env_mat_fwd.launches = 0
env_mat_bwd.launches = 0


class EnvMat(torch.autograd.Function):
    """Differentiable in dx/dy/dz through the analytic backward; the mask
    gets no cotangent (it selects, it is not a coordinate function).  First
    order only: on the card the backward is a kernel whose result carries
    no graph, so a backward asked to build one (``create_graph=True``)
    raises on every device rather than drop the second-order terms there
    and keep them on the CPU.  Training takes the plain route
    (``apply_descriptor(second_order=True)``)."""

    @staticmethod
    def forward(ctx, dx, dy, dz, mask, rcut_smth, rcut):
        ctx.save_for_backward(dx, dy, dz, mask)
        ctx.cut = (rcut_smth, rcut)
        return env_mat_fwd(dx, dy, dz, mask, rcut_smth, rcut)

    @staticmethod
    def backward(ctx, gs, gsx, gsy, gsz):
        if torch.is_grad_enabled():
            raise RuntimeError(
                "env_mat is differentiable once: its backward cannot build "
                "a graph for a second derivative (create_graph=True), which "
                "on the card would miss the terms through the kernel's "
                "backward")
        dx, dy, dz, mask = ctx.saved_tensors
        if not any(ctx.needs_input_grad[:3]):
            return None, None, None, None, None, None
        cts = [torch.zeros_like(dx) if c is None else c
               for c in (gs, gsx, gsy, gsz)]
        ddx, ddy, ddz = env_mat_bwd(dx, dy, dz, mask, *cts, *ctx.cut)
        return ddx, ddy, ddz, None, None, None


def env_mat(dx, dy, dz, mask, rcut_smth: float, rcut: float):
    """Fused env-matrix planes from (N, K) displacement planes
    (differentiable).  Returns (s, s*x/r, s*y/r, s*z/r)."""
    return EnvMat.apply(dx, dy, dz, mask, rcut_smth, rcut)
