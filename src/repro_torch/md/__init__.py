"""Classical MD substrate of the port (the "GROMACS" layer)."""
from . import cells  # noqa: F401
from .system import System, Topology, build_water_box, build_solvated_protein, mark_nn_group  # noqa: F401
from .neighbors import NeighborList, build_neighbor_list, brute_force_neighbor_list  # noqa: F401
from .forcefield import ForceFieldConfig, classical_energy, classical_forces  # noqa: F401
from .integrators import MDState, leapfrog_step, init_velocities  # noqa: F401
from .engine import MDEngine, EngineConfig  # noqa: F401
