"""Triton source of the env-matrix kernels (forward and analytic backward).

Imported only by :mod:`repro_torch.kernels.env_mat` when a kernel is
launched on a CUDA tensor: this module imports ``triton`` at the top, and
machines without a card have none.

Replaces ``repro/kernels/env_mat.py::_env_mat_kernel`` (forward) and
``::_env_mat_bwd_kernel`` (backward).  Both are one elementwise pass over the
flattened (N*K) planes: 4 planes in and 4 out, or 8 in and 3 out, with no
reuse and no contraction, so they are bound by device-memory bytes on the
H100 (3.35 TB/s).  Each program handles ``BLOCK`` contiguous entries with
masked vector loads/stores; the arithmetic stays in registers, so the only
traffic is each input read once and each output written once.  The math is
the Pallas kernels' (rsqrt-based r, the 1e-12 clamp for valid pairs and r = 1
for padding, the r-chain zeroed below the clamp in the backward).
"""
import triton
import triton.language as tl

BLOCK = 1024
NUM_WARPS = 4


@triton.jit
def _env_mat_fwd_kernel(dx_ptr, dy_ptr, dz_ptr, m_ptr,
                        s_ptr, sx_ptr, sy_ptr, sz_ptr,
                        n, rcut_smth, rcut, BLOCK: tl.constexpr):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    inb = offs < n
    dx = tl.load(dx_ptr + offs, mask=inb, other=0.0)
    dy = tl.load(dy_ptr + offs, mask=inb, other=0.0)
    dz = tl.load(dz_ptr + offs, mask=inb, other=0.0)
    m = tl.load(m_ptr + offs, mask=inb, other=0.0)

    d2 = dx * dx + dy * dy + dz * dz
    # 1e-12: the shared zero-distance clamp (r >= 1e-6) for valid pairs
    d2 = tl.where(m > 0, tl.maximum(d2, 1e-12), 1.0)
    inv_r = tl.rsqrt(d2)
    r = d2 * inv_r
    u = (r - rcut_smth) / (rcut - rcut_smth)
    uu = tl.minimum(tl.maximum(u, 0.0), 1.0)
    poly = uu * uu * uu * (-6.0 * uu * uu + 15.0 * uu - 10.0) + 1.0
    h = tl.where(r < rcut, tl.where(r < rcut_smth, 1.0, poly), 0.0)
    sw = inv_r * h * m

    tl.store(s_ptr + offs, sw, mask=inb)
    tl.store(sx_ptr + offs, sw * dx * inv_r, mask=inb)
    tl.store(sy_ptr + offs, sw * dy * inv_r, mask=inb)
    tl.store(sz_ptr + offs, sw * dz * inv_r, mask=inb)


@triton.jit
def _env_mat_bwd_kernel(dx_ptr, dy_ptr, dz_ptr, m_ptr,
                        gs_ptr, gsx_ptr, gsy_ptr, gsz_ptr,
                        ddx_ptr, ddy_ptr, ddz_ptr,
                        n, rcut_smth, rcut, BLOCK: tl.constexpr):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    inb = offs < n
    dx = tl.load(dx_ptr + offs, mask=inb, other=0.0)
    dy = tl.load(dy_ptr + offs, mask=inb, other=0.0)
    dz = tl.load(dz_ptr + offs, mask=inb, other=0.0)
    m = tl.load(m_ptr + offs, mask=inb, other=0.0)
    gs = tl.load(gs_ptr + offs, mask=inb, other=0.0)
    gsx = tl.load(gsx_ptr + offs, mask=inb, other=0.0)
    gsy = tl.load(gsy_ptr + offs, mask=inb, other=0.0)
    gsz = tl.load(gsz_ptr + offs, mask=inb, other=0.0)

    d2_raw = dx * dx + dy * dy + dz * dz
    valid = m > 0
    d2 = tl.where(valid, tl.maximum(d2_raw, 1e-12), 1.0)
    inv_r = tl.rsqrt(d2)
    r = d2 * inv_r
    inv_r2 = inv_r * inv_r
    u = (r - rcut_smth) / (rcut - rcut_smth)
    uu = tl.minimum(tl.maximum(u, 0.0), 1.0)
    poly = uu * uu * uu * (-6.0 * uu * uu + 15.0 * uu - 10.0) + 1.0
    h = tl.where(r < rcut, tl.where(r < rcut_smth, 1.0, poly), 0.0)
    dpoly = -30.0 * uu * uu * (uu - 1.0) * (uu - 1.0) / (rcut - rcut_smth)
    hp = tl.where((r >= rcut_smth) & (r < rcut), dpoly, 0.0)

    ds_dr = hp * inv_r - h * inv_r2
    dq_dr = hp * inv_r2 - 2.0 * h * inv_r2 * inv_r
    q = h * inv_r2
    a = gsx * dx + gsy * dy + gsz * dz
    # below the clamp r is constant in d2: the r-chain vanishes, q*g stays
    live = valid & (d2_raw > 1e-12)
    chain = tl.where(live, (gs * ds_dr + a * dq_dr) * inv_r, 0.0)
    tl.store(ddx_ptr + offs, tl.where(valid, chain * dx + q * gsx, 0.0), mask=inb)
    tl.store(ddy_ptr + offs, tl.where(valid, chain * dy + q * gsy, 0.0), mask=inb)
    tl.store(ddz_ptr + offs, tl.where(valid, chain * dz + q * gsz, 0.0), mask=inb)


def launch_fwd(dx, dy, dz, mask, s, sx, sy, sz, rcut_smth: float, rcut: float):
    n = dx.numel()
    grid = (triton.cdiv(n, BLOCK),)
    _env_mat_fwd_kernel[grid](dx, dy, dz, mask, s, sx, sy, sz, n,
                              float(rcut_smth), float(rcut), BLOCK=BLOCK,
                              num_warps=NUM_WARPS)


def launch_bwd(dx, dy, dz, mask, gs, gsx, gsy, gsz, ddx, ddy, ddz,
               rcut_smth: float, rcut: float):
    n = dx.numel()
    grid = (triton.cdiv(n, BLOCK),)
    _env_mat_bwd_kernel[grid](dx, dy, dz, mask, gs, gsx, gsy, gsz,
                              ddx, ddy, ddz, n, float(rcut_smth), float(rcut),
                              BLOCK=BLOCK, num_warps=NUM_WARPS)
