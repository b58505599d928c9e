"""LM substrate of the port (``repro/lm``): layers, model assembly, prefill
and decode, and the training step; ``make_lm_mesh`` builds the
``("data", "model")`` process mesh they run over."""
from ..launch.mesh import LMMesh, make_lm_mesh  # noqa: F401
from . import layers, model, serve_lib, train_lib  # noqa: F401
