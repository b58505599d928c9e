"""Smooth particle-mesh Ewald (reciprocal part) in PyTorch.

Port of ``repro/md/pme.py``.  GROMACS evaluates long-range electrostatics
with PME (paper Sec. II-A): charges are spread onto a Cartesian mesh with
cardinal B-splines, the Poisson equation is solved in Fourier space
(``torch.fft.rfftn``), and the energy is gathered back.  The real-space
erfc term lives in ``forcefield.coulomb_energy`` (use_pme=True).

The charge spread (JAX's ``.at[flat].add``) is an ordered sum: the force
scatter (:func:`repro_torch.kernels.force_scatter.scatter_sum`) adds each
node's 4x4x4-stencil contributions in ascending (atom, stencil) order, the
CUDA kernel on the card and ``index_add_`` on the CPU, the same bits on
both and on every repeat; ``index_add_`` on the card adds with atomics.
The scatter sums rows of three, so each contribution goes in as (v, 0, 0).
"""
from __future__ import annotations

import math

import torch

from ..kernels.force_scatter import scatter_sum
from .system import COULOMB


def _bspline4(u: torch.Tensor) -> torch.Tensor:
    """Cardinal B-spline of order 4 evaluated at the 4 support points.

    ``u`` in [0,1) is the fractional offset; returns weights (..., 4) for grid
    nodes floor(x)-1 .. floor(x)+2 (standard smooth-PME spreading).
    """
    # times 1/6, not / 6: the card divides by a host scalar as a multiply
    # by its reciprocal and the CPU divides, so only the product gives the
    # same weights (and charge mesh) on both
    sixth = 1.0 / 6.0
    w0 = (1 - u) ** 3 * sixth
    w1 = (3 * u ** 3 - 6 * u ** 2 + 4) * sixth
    w2 = (-3 * u ** 3 + 3 * u ** 2 + 3 * u + 1) * sixth
    w3 = u ** 3 * sixth
    return torch.stack([w0, w1, w2, w3], dim=-1)


def _bspline_module(order: int, k: torch.Tensor, n: int) -> torch.Tensor:
    """|b(k)|^2 Euler exponential-spline factor for order-4 splines."""
    j = torch.arange(order - 1, device=k.device, dtype=k.dtype)
    mvals = torch.tensor([1.0 / 6.0, 4.0 / 6.0, 1.0 / 6.0], device=k.device)
    phase = torch.exp(2j * math.pi * (k[:, None] * j[None, :]).to(
        torch.complex64) / n)
    denom = (mvals[None, :] * phase).sum(-1)
    return 1.0 / (denom.abs() ** 2 + 1e-12)


def _freqs(n: int, like: torch.Tensor, half: bool = False) -> torch.Tensor:
    f = (torch.fft.rfftfreq if half else torch.fft.fftfreq)(
        n, dtype=like.dtype, device=like.device)
    return f * n


def charge_spread(pos: torch.Tensor, charges: torch.Tensor,
                  box: torch.Tensor, grid: tuple[int, int, int]) -> torch.Tensor:
    """The charge mesh Q (gx, gy, gz) of order-4 smooth PME: each charge
    spread over its 4x4x4 stencil, the nodes' sums ordered (the force
    scatter), differentiable in ``pos``."""
    gx, gy, gz = grid
    n = pos.shape[0]
    gdims = torch.tensor(grid, dtype=pos.dtype, device=pos.device)
    frac = pos / box * gdims                      # fractional grid coords
    base = torch.floor(frac).to(torch.int32)      # node floor(x)
    u = frac - base                               # in [0,1)
    w = _bspline4(u)                              # (N, 3, 4)

    # spread: Q[gx,gy,gz] += q * wx*wy*wz over the 4x4x4 stencil
    offs = torch.arange(-1, 3, device=pos.device, dtype=torch.int32)
    nodes = base[:, :, None] + offs[None, None, :]   # (N, 3, 4)
    nodes = torch.remainder(nodes, torch.tensor(grid, device=pos.device,
                                                dtype=torch.int32)[None, :, None])
    wx, wy, wz = w[:, 0], w[:, 1], w[:, 2]        # (N, 4) each
    wgt = wx[:, :, None, None] * wy[:, None, :, None] * wz[:, None, None, :]
    ix = nodes[:, 0][:, :, None, None]
    iy = nodes[:, 1][:, None, :, None]
    iz = nodes[:, 2][:, None, None, :]
    flat = ((ix * gy + iy) * gz + iz).reshape(n, -1)
    vals = (charges[:, None, None, None] * wgt).reshape(n, -1)
    rows = torch.stack([vals, torch.zeros_like(vals), torch.zeros_like(vals)],
                       dim=-1)                    # (N, 64, 3): the scatter's rows
    return scatter_sum(rows, flat, torch.ones_like(vals),
                       gx * gy * gz)[:, 0].reshape(gx, gy, gz)


def pme_reciprocal_energy(pos: torch.Tensor, charges: torch.Tensor,
                          box: torch.Tensor, grid: tuple[int, int, int],
                          order: int, beta: float) -> torch.Tensor:
    if order != 4:
        raise ValueError("only order-4 B-splines implemented")
    gx, gy, gz = grid
    q_grid = charge_spread(pos, charges, box, grid)

    # solve in k-space
    fq = torch.fft.rfftn(q_grid)
    kx, ky, kz = _freqs(gx, pos), _freqs(gy, pos), _freqs(gz, pos, half=True)
    mx = kx[:, None, None] / box[0]
    my = ky[None, :, None] / box[1]
    mz = kz[None, None, :] / box[2]
    m2 = mx ** 2 + my ** 2 + mz ** 2
    bx = _bspline_module(order, kx, gx)[:, None, None]
    by = _bspline_module(order, ky, gy)[None, :, None]
    bz = _bspline_module(order, kz, gz)[None, None, :]
    volume = box[0] * box[1] * box[2]
    # influence function; m=0 excluded (tinfoil boundary)
    green = torch.where(
        m2 > 1e-10,
        torch.exp(-(math.pi ** 2) * m2 / beta ** 2)
        / (m2 * math.pi * volume + 1e-30),
        torch.zeros((), dtype=m2.dtype, device=m2.device)) * bx * by * bz
    # rfft counts half-spectrum once; double non-self-conjugate planes
    kz3 = kz[None, None, :]
    dup = torch.where((kz3 == 0) | ((gz % 2 == 0) & (kz3 == gz // 2)),
                      1.0, 2.0)
    return 0.5 * COULOMB * (green * dup * fq.abs() ** 2).sum()


def ewald_reciprocal_reference(pos, charges, box, beta, kmax: int = 8):
    """Direct Ewald k-space sum — slow O(N * kmax^3) oracle for tests."""
    vol = box[0] * box[1] * box[2]
    ks = torch.arange(-kmax, kmax + 1, device=pos.device)
    kvecs = torch.stack(torch.meshgrid(ks, ks, ks, indexing="ij"),
                        -1).reshape(-1, 3)
    kvecs = kvecs[(kvecs ** 2).sum(-1) > 0]
    m = kvecs.to(pos.dtype) / box[None, :]
    m2 = (m ** 2).sum(-1)
    sk = (charges[None, :] * torch.exp(
        2j * math.pi * (m @ pos.T).to(torch.complex64))).sum(-1)
    amp = torch.exp(-(math.pi ** 2) * m2 / beta ** 2) / m2
    return COULOMB / (2 * math.pi * vol) * (amp * sk.abs() ** 2).sum()
