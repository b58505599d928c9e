"""Time integrators: leap-frog (GROMACS default), velocity Verlet, Langevin.

Port of ``repro/md/integrators.py``.  State layout matches the engine:
positions wrapped into the box each step, velocities at the leap-frog half
step.  Where JAX splits a PRNG key, the port draws from a
``torch.Generator`` whose state tensor ``MDState.rng`` carries (the draws
differ from JAX's; the noise can be passed in instead).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from .system import KB


@dataclasses.dataclass(frozen=True)
class MDState:
    positions: torch.Tensor   # (N, 3)
    velocities: torch.Tensor  # (N, 3)
    forces: torch.Tensor      # (N, 3)
    step: torch.Tensor        # () int32
    rng: torch.Tensor         # generator state (``torch.Generator.get_state``)


def wrap(pos: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """``jnp.mod(pos, box)``: fmod (exact) shifted into the divisor's sign
    (``torch.remainder`` computes ``a - b * floor(a / b)``, other bits)."""
    r = torch.fmod(pos, box)
    return torch.where((r != 0) & ((r < 0) != (box < 0)), r + box, r)


def leapfrog_step(state: MDState, forces_new: torch.Tensor,
                  masses: torch.Tensor, box: torch.Tensor,
                  dt: float) -> MDState:
    """v(t+dt/2) = v(t-dt/2) + F(t)/m dt ;  x(t+dt) = x(t) + v(t+dt/2) dt."""
    inv_m = 1.0 / masses[:, None]
    v = state.velocities + forces_new * inv_m * dt
    x = wrap(state.positions + v * dt, box)
    return dataclasses.replace(state, positions=x, velocities=v,
                               forces=forces_new, step=state.step + 1)


def velocity_verlet_step(state: MDState, force_fn: Callable, masses, box,
                         dt: float) -> MDState:
    inv_m = 1.0 / masses[:, None]
    v_half = state.velocities + 0.5 * dt * state.forces * inv_m
    x = wrap(state.positions + dt * v_half, box)
    f_new = force_fn(x)
    v = v_half + 0.5 * dt * f_new * inv_m
    return dataclasses.replace(state, positions=x, velocities=v, forces=f_new,
                               step=state.step + 1)


def langevin_baoab_step(state: MDState, force_fn: Callable, masses, box,
                        dt: float, temperature: float, friction: float,
                        noise: Optional[torch.Tensor] = None) -> MDState:
    """BAOAB splitting (Leimkuhler-Matthews), used for NVT equilibration.
    The O step's standard normals are drawn from ``state.rng`` (advanced in
    the result) unless ``noise`` (N, 3) is given; then ``rng`` is kept."""
    inv_m = 1.0 / masses[:, None]
    rng = state.rng
    if noise is None:
        gen = torch.Generator(device=state.velocities.device)
        gen.set_state(rng)
        noise = torch.randn(state.velocities.shape, generator=gen,
                            dtype=state.velocities.dtype,
                            device=state.velocities.device)
        rng = gen.get_state()
    v = state.velocities + 0.5 * dt * state.forces * inv_m            # B
    x = state.positions + 0.5 * dt * v                                # A
    c1 = math.exp(-friction * dt)
    c2 = (math.sqrt((1 - c1 ** 2) * KB * temperature)
          / torch.sqrt(masses)[:, None])
    v = c1 * v + c2 * noise                                           # O
    x = wrap(x + 0.5 * dt * v, box)                                   # A
    f_new = force_fn(x)
    v = v + 0.5 * dt * f_new * inv_m                                  # B
    return dataclasses.replace(state, positions=x, velocities=v, forces=f_new,
                               step=state.step + 1, rng=rng)


def berendsen_rescale(velocities, masses, target_t: float, dt: float,
                      tau: float) -> torch.Tensor:
    ke = 0.5 * (masses[:, None] * velocities ** 2).sum()
    ndof = velocities.numel() - 3
    t_now = 2 * ke / (ndof * KB)
    lam = torch.sqrt(torch.clamp(
        1 + dt / tau * (target_t / torch.clamp(t_now, min=1e-9) - 1),
        min=1e-3))
    return velocities * lam


def init_velocities(gen: torch.Generator, masses, temperature: float
                    ) -> torch.Tensor:
    """Maxwell-Boltzmann draw from ``gen`` with COM motion removed."""
    sigma = torch.sqrt(KB * temperature / masses)[:, None]
    v = sigma * torch.randn((masses.shape[0], 3), generator=gen,
                            dtype=masses.dtype, device=masses.device)
    p = (masses[:, None] * v).sum(0) / masses.sum()
    return v - p[None, :]
