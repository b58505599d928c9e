"""Entry points of the port (``repro/launch``): ``serve`` (LM token and DP
force serving), ``train`` (LM training) and its supervisor ``elastic``,
``train_dpa1``, ``protein_md`` and ``remd``."""
