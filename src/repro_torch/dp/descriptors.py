"""DP-SE and DPA-1 descriptors (port of ``repro/dp/descriptors.py``).

DP-SE : D^i = (G^i)^T R~ (R~)^T G^i_<           (bilinear reduction)
DPA-1 : the same reduction, with G^i refined by l_a gated self-attention
        layers over the neighbour axis (se_attention_v2).

The default route is the JAX kernel path (``_env_planes_pallas``): the
env-matrix planes come from :func:`repro_torch.kernels.ops.env_mat_op` and
the attention stack from ``nbr_attention_stack_op``; the tensors' device
picks the Hopper kernels (CUDA) or their plain versions (CPU).  JAX's
``DescriptorConfig.use_pallas`` therefore does not exist here.  The
kernels' autograd Functions are differentiable once, so the caller that
needs a second derivative (force-matching training) asks for
``second_order=True``: the reference's own training route, its jnp path
(:func:`~repro_torch.dp.common.env_matrix_shifted` and
:func:`~repro_torch.kernels.ref.nbr_attention_stack_ref`) under autograd.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from . import precision
from .common import EnvStats, _guarded_env, env_matrix_shifted, type_rows
from .networks import layer_norm_init, mlp_apply, mlp_init
from ..kernels.ops import env_mat_op, nbr_attention_stack_op
from ..kernels.ref import nbr_attention_stack_ref


@dataclasses.dataclass(frozen=True)
class DescriptorConfig:
    kind: str = "dpa1"            # "dpse" | "dpa1"
    rcut: float = 0.6             # nm
    rcut_smth: float = 0.2
    sel: int = 64                 # neighbour capacity K
    ntypes: int = 4
    neuron: tuple = (32, 64, 128)  # embedding net widths
    axis_neuron: int = 16         # M2: columns of G kept for the right factor
    type_embed_dim: int = 8
    attn_layers: int = 3          # l_a
    attn_hidden: int = 256
    attn_heads: int = 1           # attn_hidden % attn_heads == 0

    @property
    def m1(self) -> int:
        return self.neuron[-1]

    @property
    def out_dim(self) -> int:
        return self.m1 * self.axis_neuron

    def validate(self) -> None:
        if self.kind == "dpa1" and self.attn_hidden % self.attn_heads:
            raise ValueError(
                f"attn_hidden {self.attn_hidden} not divisible by "
                f"attn_heads {self.attn_heads}")


def init_descriptor(generator: torch.Generator, cfg: DescriptorConfig,
                    device="cpu") -> dict:
    """Same structure and scales as the JAX initialiser, drawn from a
    ``torch.Generator`` on the CPU and moved to ``device``."""
    cfg.validate()
    params: dict = {}
    params["type_embed"] = (0.1 * torch.randn(
        (cfg.ntypes, cfg.type_embed_dim), generator=generator)).to(device)
    params["embed"] = mlp_init(generator, (1 + cfg.type_embed_dim,)
                               + tuple(cfg.neuron), device=device)
    if cfg.kind == "dpa1" and cfg.attn_layers > 0:
        d, h = cfg.m1, cfg.attn_hidden
        randn = lambda *s: torch.randn(s, generator=generator)
        params["attn"] = [{
            "wq": (randn(d, h) / math.sqrt(d)).to(device),
            "wk": (randn(d, h) / math.sqrt(d)).to(device),
            "wv": (randn(d, h) / math.sqrt(d)).to(device),
            "wo": (randn(h, d) / math.sqrt(h)).to(device),
            "ln": layer_norm_init(d, device=device),
        } for _ in range(cfg.attn_layers)]
    return params


def _stack_params(layers: list[dict]):
    """Per-layer param dicts -> the (L, ...) stacked layout of the kernel."""
    get = lambda name: torch.stack([l[name] for l in layers])
    return (get("wq"), get("wk"), get("wv"), get("wo"),
            torch.stack([l["ln"]["gamma"] for l in layers]),
            torch.stack([l["ln"]["beta"] for l in layers]))


def _env_planes(coords_center, coords_nbr, nbr_mask, cfg: DescriptorConfig):
    """Env-matrix planes + gate inputs.  The four (s, s*x/r, ...) planes come
    from the env-matrix kernel; dist/r_hat for the angular gate come from
    ``_guarded_env`` (the shared zero-distance clamp), so gradients flow
    through both, as on the JAX kernel path."""
    dr = coords_nbr - coords_center[:, None, :]
    s, sx, sy, sz = env_mat_op(dr[..., 0], dr[..., 1], dr[..., 2], nbr_mask,
                               cfg.rcut_smth, cfg.rcut)
    R = torch.stack([s, sx, sy, sz], dim=-1)
    dist, _, r_hat = _guarded_env(dr, nbr_mask, cfg.rcut_smth, cfg.rcut)
    return R, r_hat * nbr_mask[..., None], dist, s


def apply_descriptor(params: dict, cfg: DescriptorConfig, stats: EnvStats,
                     coords_center, coords_nbr, types_center, types_nbr,
                     nbr_mask, dtype: str = "float32",
                     second_order: bool = False) -> torch.Tensor:
    """D^i for every centre atom: coords_center (N, 3); coords_nbr (N, K, 3)
    pre-gathered with image shifts applied; types (-1 padding); nbr_mask
    (N, K).  Returns (N, M1*M2) fp32 — ``dtype`` only lowers the matmul
    operand precision inside.

    ``second_order=True`` computes the env matrix and the attention stack
    in plain PyTorch under autograd (the reference's jnp path, which its
    training takes), so the result can be differentiated twice; the
    default takes the kernels, whose Functions raise when asked to."""
    cfg.validate()
    cd = precision.compute_dtype(dtype)
    if second_order:
        R, r_hat, dist, sw = env_matrix_shifted(coords_center, coords_nbr,
                                                nbr_mask, cfg.rcut_smth,
                                                cfg.rcut)
    else:
        R, r_hat, dist, sw = _env_planes(coords_center, coords_nbr, nbr_mask,
                                         cfg)
    R = stats.normalize(R, types_center) * nbr_mask[..., None]

    t_emb = (type_rows(params["type_embed"], types_nbr) if second_order
             else params["type_embed"][types_nbr.clamp_min(0)])
    feat = torch.cat([sw[..., None], t_emb * nbr_mask[..., None]], -1)
    g = mlp_apply(params["embed"], feat, compute_dtype=cd)   # (N, K, M1)
    g = g * nbr_mask[..., None]

    if cfg.kind == "dpa1" and cfg.attn_layers > 0:
        sw_env = sw * dist  # the [0, 1] polynomial envelope from s(r)
        stack = nbr_attention_stack_ref if second_order else \
            nbr_attention_stack_op
        g = stack(
            g, r_hat[..., 0], r_hat[..., 1], r_hat[..., 2], sw_env, nbr_mask,
            *_stack_params(params["attn"]), heads=cfg.attn_heads,
            compute_dtype=dtype)

    # bilinear G^T R R^T G reduction: always fp32 (force-critical)
    k_norm = 1.0 / cfg.sel
    gr = torch.einsum("nkm,nka->nma", g, R) * k_norm       # (N, M1, 4)
    d = torch.einsum("nma,npa->nmp", gr, gr[:, : cfg.axis_neuron, :])
    return d.reshape(d.shape[0], -1)
