"""LM substrate of the port: the attention and dense-MLP families of
``repro/lm`` (layers, model assembly, prefill and decode)."""
from . import layers, model, serve_lib  # noqa: F401
