"""Deep Potential common machinery: switching function, environment matrix.

Port of ``repro/dp/common.py``.  The environment matrix of atom i is
R^i_j = (s(r_ij), s x_ij/r_ij, s y_ij/r_ij, s z_ij/r_ij) with the smooth
switch s(r) that decays 1/r -> 0 between ``rcut_smth`` and ``rcut``, so
padded neighbours (s = 0) are harmless.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from ..kernels.ref import R2_MIN


def type_rows(table: torch.Tensor, types: torch.Tensor) -> torch.Tensor:
    """``table[types]`` (padding types -1 read as 0) as a one-hot product:
    the same values, and a gradient to ``table`` that is a matrix product,
    which repeats bit for bit on the CPU with several threads (indexing's
    backward adds there in thread order).  The training route's lookup."""
    onehot = torch.nn.functional.one_hot(types.clamp_min(0).long(),
                                         table.shape[0])
    return onehot.to(table.dtype) @ table


def switch_fn(r: torch.Tensor, rcut_smth: float, rcut: float) -> torch.Tensor:
    """DeePMD smooth switching: 1/r below rcut_smth, poly-decayed to 0 at rcut."""
    u = (r - rcut_smth) / (rcut - rcut_smth)
    uu = u.clamp(0.0, 1.0)
    poly = uu * uu * uu * (-6 * uu * uu + 15 * uu - 10) + 1.0
    inv_r = 1.0 / r.clamp_min(1e-6)
    return torch.where(r < rcut,
                       inv_r * torch.where(r < rcut_smth, torch.ones_like(r), poly),
                       torch.zeros_like(r))


def _guarded_env(dr: torch.Tensor, nbr_mask: torch.Tensor, rcut_smth: float,
                 rcut: float):
    """(dist, sw, r_hat) from displacement vectors, NaN-safe.

    The double ``where`` keeps masked entries off the gradient path; the
    clamp puts valid coincident pairs (d2 = 0) at r = 1e-6, so r_hat is
    0/1e-6 instead of 0/0 and autograd forces stay finite.
    """
    d2 = (dr * dr).sum(-1)
    d2 = torch.where(nbr_mask > 0, d2.clamp_min(R2_MIN), torch.ones_like(d2))
    dist = torch.sqrt(d2)
    sw = switch_fn(dist, rcut_smth, rcut) * nbr_mask
    r_hat = dr / dist[..., None]
    return dist, sw, r_hat


def env_matrix(coords, box, nbr_idx, nbr_mask, rcut_smth: float, rcut: float):
    """Environment matrix for every atom.

    coords (N, 3); box (3,) or None; nbr_idx (N, K) -1 padded; nbr_mask
    (N, K).  Returns R (N, K, 4), r_hat (N, K, 3), dist (N, K), sw (N, K).
    """
    safe = torch.where(nbr_idx >= 0, nbr_idx, torch.zeros_like(nbr_idx))
    dr = coords[safe] - coords[:, None, :]
    if box is not None:
        dr = dr - box * torch.round(dr / box)
    dist, sw, r_hat = _guarded_env(dr, nbr_mask, rcut_smth, rcut)
    R = torch.cat([sw[..., None], sw[..., None] * r_hat], dim=-1)
    return R, r_hat * nbr_mask[..., None], dist, sw


def env_matrix_shifted(coords_local, coords_nbr, nbr_mask, rcut_smth: float,
                       rcut: float):
    """Variant with pre-gathered (image-shifted) neighbour coordinates."""
    dr = coords_nbr - coords_local[:, None, :]
    dist, sw, r_hat = _guarded_env(dr, nbr_mask, rcut_smth, rcut)
    R = torch.cat([sw[..., None], sw[..., None] * r_hat], dim=-1)
    return R, r_hat * nbr_mask[..., None], dist, sw


@dataclasses.dataclass(frozen=True)
class EnvStats:
    """davg / dstd normalisation of the environment matrix (DeePMD stats)."""

    davg: torch.Tensor  # (ntypes, 4)
    dstd: torch.Tensor  # (ntypes, 4)

    def normalize(self, R: torch.Tensor, types: torch.Tensor) -> torch.Tensor:
        t = types.clamp_min(0)
        return (R - self.davg[t][:, None, :]) / self.dstd[t][:, None, :]

    def to(self, device) -> "EnvStats":
        return EnvStats(davg=self.davg.to(device), dstd=self.dstd.to(device))

    @staticmethod
    def identity(ntypes: int, device="cuda") -> "EnvStats":
        dev = resolve_device(device)
        return EnvStats(davg=torch.zeros((ntypes, 4), device=dev),
                        dstd=torch.ones((ntypes, 4), device=dev))


def compute_env_stats(frames_R, frames_types, frames_mask,
                      ntypes: int) -> EnvStats:
    """Per-type mean/std of env-matrix rows over sample frames.

    frames_R (F, N, K, 4); frames_types (F, N); frames_mask (F, N, K).  The
    radial column gets its own stats; the three angular columns share one
    std and zero mean.
    """
    davg, dstd = [], []
    zero = frames_R.new_zeros(())
    for t in range(ntypes):
        sel = (frames_types == t)[..., None] * frames_mask
        w = sel.sum().clamp_min(1.0)
        mean_r = (frames_R[..., 0] * sel).sum() / w
        var_r = (((frames_R[..., 0] - mean_r) * sel) ** 2).sum() / w
        var_a = ((frames_R[..., 1:] * sel[..., None]) ** 2).sum() / (3 * w)
        davg.append(torch.stack([mean_r, zero, zero, zero]))
        std_r = torch.sqrt(var_r + 1e-8).clamp_min(1e-2)
        std_a = torch.sqrt(var_a + 1e-8).clamp_min(1e-2)
        dstd.append(torch.stack([std_r, std_a, std_a, std_a]))
    return EnvStats(davg=torch.stack(davg), dstd=torch.stack(dstd))
