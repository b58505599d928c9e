"""Single-domain DP inference and the force provider."""
from .ddinfer import (make_padded_batch_fn, masked_neighbor_list,  # noqa: F401
                      single_domain_forces, single_domain_forces_batched,
                      single_domain_forces_nlist, single_domain_state)
from .nnpot import DeepmdForceProvider, UnitConversion  # noqa: F401
from ..backend import (ForceBackend, ForceRequest, ForceResult,  # noqa: F401
                       StatefulForceBackend)
