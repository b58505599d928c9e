"""Optimizers and schedules (port of ``repro/optim``)."""
from .adam import (Optimizer, adam, adamw, adam8bit, sgd, apply_updates,  # noqa: F401
                   clip_by_global_norm, global_norm)
from .schedule import exponential_decay, cosine_with_warmup, deepmd_prefactors  # noqa: F401
