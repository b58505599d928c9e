"""Temperature-ladder replica exchange (parallel tempering).

Port of ``repro/ensemble/exchange.py``.  The move follows the standard
REMD recipe (Sugita & Okamoto 1999), in the *temperature-swap* convention:
configurations stay on their replica slot, temperatures migrate.  At an
attempt with parity p, rung pairs (k, k+1) with k % 2 == p are proposed;
the Metropolis criterion for swapping rungs i < j is

    P_acc = min(1, exp[(beta_i - beta_j) (E_i - E_j)])

with E the potential energy of the configuration currently holding each
rung.  On acceptance the two replicas trade rungs and their velocities are
rescaled by sqrt(T_new / T_old) so the kinetic energy matches the new
thermostat target instantly.

Determinism: every replica's stream advances exactly once per attempt —
paired or not — and a pair consumes the *lower rung's* uniform draw, so the
accept/reject sequence depends only on the per-replica seeds, never on R or
the parity schedule.  The draws come from each replica's generator state in
``ReplicaState.rng`` (other numbers than JAX's keys give); ``u`` (R,) may
be passed in instead, as the integrators take ``noise``, and then ``rng``
is kept.  The rung bookkeeping is a handful of (R,) tensors, done on the
host at the window boundary where the engine applies the move; only the
velocity rescale touches the device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..md.system import KB
from .state import ReplicaState


def geometric_ladder(t_min: float, t_max: float, n: int) -> tuple:
    """The standard REMD ladder: geometric spacing gives roughly uniform
    acceptance across rungs for a system with T-independent heat capacity."""
    if n == 1:
        return (float(t_min),)
    r = (t_max / t_min) ** (1.0 / (n - 1))
    return tuple(float(t_min * r ** k) for k in range(n))


def _uniforms(state: ReplicaState):
    """One uniform draw from each replica's stream: (u (R,), advanced
    states (R, S))."""
    dev = state.velocities.device
    us, states = [], []
    for s in state.rng:
        gen = torch.Generator(device=dev)
        gen.set_state(s.clone())    # a row view would be read from its
        #                             storage's start
        us.append(torch.rand((), generator=gen, device=dev))
        states.append(gen.get_state())
    return torch.stack(us).cpu(), torch.stack(states)


def velocity_scale(ratio: torch.Tensor) -> torch.Tensor:
    """sqrt(T_new / T_old) of float32 ratios, correctly rounded to float32
    (what the reference's ``jnp.sqrt`` and ``np.sqrt`` give).  PyTorch's
    vectorised float32 ``sqrt`` on the CPU can be 1 ulp off; the root of
    the ratio taken in float64 and rounded once to float32 is exact, since
    a float64 root of a float32 value rounds to the nearest float32
    without double-rounding error."""
    return torch.sqrt(ratio.to(torch.float64)).to(torch.float32)


def make_exchange_fn(temp_table) -> Callable:
    """The exchange move for a static temperature table.

    Returns ``exchange(state, energies (R,), parity, u=None) ->
    (new_state, stats)`` where ``stats`` carries ``attempted``/``accepted``
    counts and per-rung-pair ``pair_attempts`` / ``pair_accepts`` vectors
    ((R-1,), pair k = rungs (k, k+1)).  Temperatures, betas and energies are
    float32, as in the reference.
    """
    table = torch.as_tensor(temp_table, dtype=torch.float32).cpu()
    n = table.shape[0]
    beta = 1.0 / (KB * table)                       # per rung

    def exchange(state: ReplicaState, energies, parity,
                 u: Optional[torch.Tensor] = None):
        ladder = state.ladder.cpu().long()
        order = torch.argsort(ladder)   # order[k] = the replica at rung k
        e_r = torch.as_tensor(energies).detach().cpu().to(torch.float32)[order]
        if u is None:
            u, new_rng = _uniforms(state)
        else:
            u = torch.as_tensor(u, dtype=torch.float32).cpu()
            new_rng = state.rng
        u_r = u[order]                              # draw of the rung-k holder
        k = torch.arange(n)
        is_lo = ((k % 2) == (int(parity) % 2)) & (k + 1 < n)
        delta = ((beta - torch.roll(beta, -1))
                 * (e_r - torch.roll(e_r, -1)))     # rung k vs k+1
        acc = is_lo & (torch.log(u_r) < delta)
        move_dn = torch.roll(acc, 1)                # rung k -> k-1
        target = torch.where(acc, k + 1, torch.where(move_dn, k - 1, k))
        new_ladder = torch.zeros_like(ladder)
        new_ladder[order] = target
        scale = velocity_scale(table[new_ladder] / table[ladder])
        dev = state.velocities.device
        velocities = state.velocities * scale.to(dev)[:, None, None]
        stats = {"attempted": int(is_lo.sum()), "accepted": int(acc.sum()),
                 "pair_attempts": is_lo[:-1].to(torch.int32),
                 "pair_accepts": acc[:-1].to(torch.int32)}
        new_state = dataclasses.replace(
            state, velocities=velocities, rng=new_rng,
            ladder=new_ladder.to(torch.int32).to(state.ladder.device))
        return new_state, stats

    return exchange
