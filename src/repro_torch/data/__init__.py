"""Synthetic training data and the deterministic loader (port of ``repro/data``)."""
from .synthetic import Dataset, make_dataset, oracle_energy, oracle_energy_and_forces  # noqa: F401
from .loader import DeterministicLoader, LoaderConfig  # noqa: F401
