"""LM substrate of the port (``repro/lm``): layers, model assembly, prefill
and decode, and the training step."""
from . import layers, model, serve_lib, train_lib  # noqa: F401
