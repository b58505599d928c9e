"""Carry JAX-side parameters, stats and configs over to the port.

Takes numpy in (the caller does ``jax.device_get`` / ``np.asarray`` on its
side), so this module never imports JAX.  The parameter trees keep the JAX
pytrees' layouts: the DP model's ``descriptor.{type_embed, embed[i].{w,b},
attn[l].{wq,wk,wv,wo,ln.{gamma,beta}}}``, ``fitting[i].{w,b}``, ``bias``
(:func:`params_to_torch`, fp32), and the LM's ``embed``, ``final_norm``,
``prefix[i]``, ``pattern[j]`` (:func:`lm_params_to_torch`, dtypes kept).
The MD side carries a ``System`` (:func:`system_to_torch`) and an
``MDState`` (:func:`md_state_to_torch`) field for field; training carries
an optimizer's state (:func:`opt_state_to_torch`) and a ``Dataset``
(:func:`dataset_to_torch`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .configs.base import ArchConfig
from .core.ddinfer import DDConfig
from .data.synthetic import Dataset
from .device import resolve_device
from .dp.common import EnvStats
from .dp.descriptors import DescriptorConfig
from .dp.model import DPConfig
from .md.integrators import MDState
from .md.system import System, Topology


def params_to_torch(tree, device="cuda"):
    """Nested dicts/lists of arrays -> the same nesting of fp32 tensors."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_to_torch(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_torch(v, dev) for v in tree]
    return torch.tensor(np.asarray(tree, np.float32), device=dev)


def stats_to_torch(stats, device="cuda") -> EnvStats:
    """An ``EnvStats``-like object (``davg``, ``dstd`` arrays) -> EnvStats."""
    dev = resolve_device(device)
    return EnvStats(
        davg=torch.tensor(np.asarray(stats.davg, np.float32), device=dev),
        dstd=torch.tensor(np.asarray(stats.dstd, np.float32), device=dev))


def config_to_torch(cfg) -> DPConfig:
    """A JAX ``DPConfig`` -> the port's, field for field.

    ``DescriptorConfig.use_pallas`` is dropped: in the port the tensors'
    device selects the kernels (CUDA) or their plain versions (CPU).
    """
    d = {f.name: getattr(cfg.descriptor, f.name)
         for f in dataclasses.fields(DescriptorConfig)}
    return DPConfig(descriptor=DescriptorConfig(**d),
                    fitting_neuron=tuple(cfg.fitting_neuron), dtype=cfg.dtype)


def dd_config_to_torch(cfg) -> DDConfig:
    """A JAX ``DDConfig`` -> the port's, field for field.  ``use_pallas`` is
    dropped (the tensors' device picks kernel or plain version); the port's
    own checks apply (``k_eval <= 128``, no ``overlap``)."""
    return DDConfig(**{f.name: getattr(cfg, f.name)
                       for f in dataclasses.fields(DDConfig)})


def _leaf_to_torch(a, dev) -> torch.Tensor:
    """One array, its dtype kept; bf16 (``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` rejects) goes through an int16 view, bit for bit."""
    a = np.array(a)    # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(dev)


def lm_params_to_torch(tree, device="cuda"):
    """A JAX LM parameter tree (``repro.lm.model.init_params``, as numpy) ->
    the same nesting of tensors, each leaf keeping its dtype."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: lm_params_to_torch(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [lm_params_to_torch(v, dev) for v in tree]
    return _leaf_to_torch(tree, dev)


def arch_config_to_torch(cfg) -> ArchConfig:
    """A JAX ``ArchConfig`` -> the port's, field for field."""
    return ArchConfig(**{f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(ArchConfig)})


def _field_tensors(obj, cls, dev, skip=()) -> dict:
    return {f.name: _leaf_to_torch(getattr(obj, f.name), dev)
            for f in dataclasses.fields(cls) if f.name not in skip}


def system_to_torch(system, device="cuda") -> System:
    """A JAX ``System`` (its leaves as numpy) -> the port's, field for
    field, dtypes kept."""
    dev = resolve_device(device)
    return System(topology=Topology(**_field_tensors(system.topology,
                                                     Topology, dev)),
                  **_field_tensors(system, System, dev, skip=("topology",)))


def md_state_to_torch(state, device="cuda", seed: int = 0) -> MDState:
    """A JAX ``MDState`` (positions, velocities, forces, step; as numpy) ->
    the port's.  A JAX PRNG key has no torch counterpart: ``rng`` is the
    state of a generator on ``device`` seeded ``seed``."""
    dev = resolve_device(device)
    return MDState(
        **{k: _leaf_to_torch(getattr(state, k), dev)
           for k in ("positions", "velocities", "forces", "step")},
        rng=torch.Generator(device=dev).manual_seed(seed).get_state())


def opt_state_to_torch(state, device="cuda"):
    """A JAX optimizer state (``repro.optim``'s ``adam``/``adamw``,
    ``sgd`` or ``adam8bit``, as numpy) -> the port's, each leaf keeping
    its dtype: fp32 moments, the int32 ``count``, ``adam8bit``'s int8
    codes, fp32 scales and bf16 second moments."""
    return lm_params_to_torch(state, device)


def dataset_to_torch(data) -> Dataset:
    """A JAX ``Dataset`` -> the port's (numpy fields, dtypes kept)."""
    return Dataset(**{f.name: np.array(getattr(data, f.name))
                      for f in dataclasses.fields(Dataset)})
