"""Elastic and fault-tolerant supervision (``repro/launch/elastic.py``).

1. **Restart on failure**: :func:`supervise` relaunches the training
   driver (``python -m repro_torch.launch.train``) when it dies; the driver
   restores from the newest verified checkpoint (writes are atomic renames,
   so a crash mid-write never corrupts one) and its step-keyed data order
   replays the same batches.

2. **Elastic rank count (the DP side)**: the paper's *virtual* domain
   decomposition is rebuilt every step from the replicated coordinates, so
   a restart with another rank count migrates no data: :func:`rebuild_dd`
   emits a new ``DDConfig`` for it (Sec. IV-A).

Usage:
  python -m repro_torch.launch.elastic --reduced --device cpu --steps 12 \\
      --ckpt-dir /tmp/ck --ckpt-every 4
"""
from __future__ import annotations

import subprocess
import sys
import time


def supervise(cmd: list[str], max_restarts: int = 3,
              backoff_s: float = 0.5) -> int:
    """Relaunch ``cmd`` until it exits cleanly or the restart budget is
    spent; returns the last exit code."""
    restarts = 0
    while True:
        proc = subprocess.run(cmd)
        if proc.returncode == 0:
            return 0
        restarts += 1
        if restarts > max_restarts:
            return proc.returncode
        print(f"[supervisor] exit={proc.returncode}; restart "
              f"{restarts}/{max_restarts} after {backoff_s}s", flush=True)
        time.sleep(backoff_s)


def rebuild_dd(n_atoms: int, box, new_rank_count: int, rcut: float,
               force_mode: str = "owner_full", nbr_method: str = "dense",
               **suggest_kwargs):
    """The virtual decomposition re-derived for a changed rank count.

    Defaults to the dense assembly oracle: a mid-run rebuild has no
    guarantee that the configuration matches the mean-density cell sizing.
    Pass ``nbr_method="cells"`` with ``coords=<current positions>`` to size
    the cell capacities from the occupancy instead."""
    from ..core.ddinfer import suggest_config
    return suggest_config(n_atoms, box, new_rank_count, rcut,
                          force_mode=force_mode, nbr_method=nbr_method,
                          **suggest_kwargs)


def main():
    """Supervise a training run: the arguments go to the driver as given."""
    code = supervise([sys.executable, "-m", "repro_torch.launch.train"]
                     + sys.argv[1:])
    sys.exit(code)


if __name__ == "__main__":
    main()
