"""Learning-rate schedules and DeePMD loss-prefactor schedules.

Port of ``repro/optim/schedule.py``.  A schedule takes the step as a
Python number or a tensor (on any device) and returns a float32 tensor on
the step's device, formed in float32 as the reference's traced step is.
"""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


def exponential_decay(lr0: float, decay_steps: int, decay_rate: float,
                      lr_min: float = 0.0):
    def fn(step):
        s = _step(step)
        return (lr0 * decay_rate ** (s / decay_steps)).clamp_min(lr_min)
    return fn


def cosine_with_warmup(lr0: float, warmup: int, total: int,
                       lr_min_ratio: float = 0.1):
    def fn(step):
        s = _step(step)
        warm = lr0 * s / max(warmup, 1)
        prog = ((s - warmup) / max(total - warmup, 1)).clamp(0.0, 1.0)
        cos = lr_min_ratio * lr0 + (1 - lr_min_ratio) * lr0 * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)
    return fn


def deepmd_prefactors(start_pref_e: float = 0.02, limit_pref_e: float = 1.0,
                      start_pref_f: float = 1000.0, limit_pref_f: float = 1.0):
    """DeePMD loss prefactor schedule: interpolates with the lr decay ratio.

    pref(t) = limit + (start - limit) * lr(t)/lr(0); forces dominate early,
    energies late, as in DeePMD-kit's default training.
    """
    def fn(lr_ratio):
        pe = limit_pref_e + (start_pref_e - limit_pref_e) * lr_ratio
        pf = limit_pref_f + (start_pref_f - limit_pref_f) * lr_ratio
        return pe, pf
    return fn
