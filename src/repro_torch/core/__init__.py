"""DP inference: single domain, the virtual domain decomposition on one
device, the force pipeline and the force provider."""
from .ddinfer import (DDConfig, DDState, make_padded_batch_fn,  # noqa: F401
                      make_batched_assembly_fn, make_batched_check_fn,
                      make_batched_evaluation_fn, make_batched_force_fn,
                      masked_neighbor_list, single_domain_forces,
                      single_domain_forces_batched,
                      single_domain_forces_nlist, single_domain_state,
                      suggest_config)
from .domain import (VirtualGrid, atom_costs, balanced_planes,  # noqa: F401
                     factor_grid, interior_fraction_estimate,
                     partition_costs, uniform_grid)
from .nnpot import DeepmdForceProvider, UnitConversion  # noqa: F401
from .pipeline import ForcePipeline  # noqa: F401
from ..backend import (ForceBackend, ForceRequest, ForceResult,  # noqa: F401
                       StatefulForceBackend)
