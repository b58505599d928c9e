"""Deep Potential models (DPA-1 / DP-SE) and training in PyTorch."""
from . import precision  # noqa: F401
from .common import EnvStats, compute_env_stats, env_matrix, switch_fn  # noqa: F401
from .descriptors import DescriptorConfig, apply_descriptor, init_descriptor  # noqa: F401
from .model import DPConfig, DPModel, paper_dpa1_config  # noqa: F401
from .train import TrainConfig, train, force_rmse, fit_env_stats  # noqa: F401
