"""Tanh MLPs with DeePMD-style ResNet skips (port of ``repro/dp/networks.py``).

Embedding nets grow 32 -> 64 -> 128 with the concat skip when the width
doubles; fitting nets use identity skips on equal widths.  Parameters are
lists of ``{"w", "b"}`` dicts of tensors, the JAX pytree's layout.
"""
from __future__ import annotations

from typing import Sequence

import math

import torch

from .precision import round_operand


def mlp_init(generator: torch.Generator, sizes: Sequence[int],
             final_bias: float = 0.0, device="cpu") -> list[dict]:
    """N(0, 1/din) weights and zero (or ``final_bias``) biases, drawn on the
    CPU from ``generator`` and moved to ``device``."""
    params = []
    for din, dout in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((din, dout), generator=generator) / math.sqrt(din)
        b = torch.full((dout,), final_bias if dout == sizes[-1] else 0.0)
        params.append({"w": w.to(device), "b": b.to(device)})
    return params


def mlp_apply(params: list[dict], x: torch.Tensor, activation=torch.tanh,
              resnet: bool = True, final_linear: bool = True,
              compute_dtype=None) -> torch.Tensor:
    """``compute_dtype`` (bf16) rounds the matmul operands only; the
    product accumulates in fp32 and activations/skips stay fp32.  None keeps
    the plain fp32 path."""
    n = len(params)
    for i, layer in enumerate(params):
        if compute_dtype is not None:
            y = (round_operand(x, compute_dtype)
                 @ round_operand(layer["w"], compute_dtype)) + layer["b"]
        else:
            y = x @ layer["w"] + layer["b"]
        if i == n - 1 and final_linear:
            return y
        y = activation(y)
        if resnet:
            din, dout = layer["w"].shape
            if dout == din:
                y = y + x
            elif dout == 2 * din:
                y = y + torch.cat([x, x], dim=-1)
        x = y
    return x


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * gamma + beta


def layer_norm_init(dim: int, device="cpu") -> dict:
    return {"gamma": torch.ones((dim,), device=device),
            "beta": torch.zeros((dim,), device=device)}


def count_params(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel()
    items = tree.values() if isinstance(tree, dict) else tree
    return sum(count_params(t) for t in items)
