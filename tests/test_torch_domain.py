"""The virtual domain decomposition of the port against the JAX package, on
the 160-atom system of ``tests/parity_support.py`` (L = 3.5, 8 ranks).

Integer outputs equal exactly: ``suggest_config``'s capacities, the planes
of uniform / balanced / rebalanced grids (bit for bit), and per rank the
JAX ``_assemble_rank``'s local and ghost index sets, integer shifts, masks,
buffer types, subdomain neighbour lists, counts and overflow flags, for the
dense and the cell-list paths in both force modes.  The JAX function runs
rank by rank outside ``shard_map`` (as ``tests/test_partition_costs.py``
does), vmapped over the rank index under one jit per configuration."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ddinfer as jdd
from repro.core import domain as jdom
from repro_torch import bridge
from repro_torch.core import ddinfer as tdd
from repro_torch.core import domain as tdom

# small CPU tensors: one intra-op thread keeps parallel test workers
# from oversubscribing the cores
torch.set_num_threads(1)

T = torch.tensor
RCUT, SKIN, RANKS = 0.6, 0.05, 8
_rng = np.random.default_rng(7)
N, L = 160, 3.5
BOX = np.array([L, L, L], np.float32)
POS = _rng.uniform(0, L, (N, 3)).astype(np.float32)
TYPES = _rng.integers(0, 4, N).astype(np.int32)
GRID_MODES = ("uniform", "balanced", "rebalanced")
CASES = [(fm, method, gm) for fm in ("owner_full", "ghost_reduce")
         for method in ("dense", "cells") for gm in GRID_MODES]


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def _configs(fm, method, gm, pos=POS):
    kw = dict(nbr_capacity=48, slack=2.5, skin=SKIN, force_mode=fm,
              nbr_method=method, balanced=gm == "balanced",
              rebalance=gm == "rebalanced", coords=pos)
    return (jdd.suggest_config(len(pos), BOX, RANKS, RCUT, **kw),
            tdd.suggest_config(len(pos), BOX, RANKS, RCUT, **kw))


def _jax_ranks(jc, grid):
    """Every rank's JAX ``_assemble_rank`` (vmapped over the rank index)."""
    c, t, b = jnp.asarray(POS), jnp.asarray(TYPES), jnp.asarray(BOX)
    fn = jax.jit(jax.vmap(lambda r: jdd._assemble_rank(c, t, b, grid, jc,
                                                       RCUT, r, N)))
    return jax.device_get(fn(jnp.arange(RANKS)))


@pytest.fixture(scope="module")
def jax_assembly():
    """Per configuration: the JAX config, grid and every rank's assembly."""
    out = {}
    for case in CASES:
        jc, _ = _configs(*case)
        grid = jdd._make_grid(jnp.asarray(POS), jnp.asarray(BOX), jc, N)
        out[case] = (jc, grid, _jax_ranks(jc, grid))
    return out


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_suggest_config_equals_jax(case):
    jc, tc = _configs(*case)
    assert bridge.dd_config_to_torch(jc) == tc


@pytest.mark.parametrize("grid_mode", GRID_MODES)
@pytest.mark.parametrize("config", ["random", "clustered"])
def test_planes_equal_jax_bitwise(grid_mode, config):
    pos = POS
    if config == "clustered":
        rng = np.random.default_rng(3)
        blob = rng.normal(L / 4, 0.4, (120, 3))
        pos = np.mod(np.concatenate([blob, rng.uniform(0, L, (40, 3))]),
                     L).astype(np.float32)
    jc, tc = _configs("ghost_reduce", "cells", grid_mode, pos)
    jg = jdd._make_grid(jnp.asarray(pos), jnp.asarray(BOX), jc, len(pos))
    tg = tdd._make_grid(T(pos), T(BOX), tc, len(pos))
    assert tg.dims == jg.dims
    for a in "xyz":
        _eq(getattr(tg, "planes_" + a), getattr(jg, "planes_" + a), a)
    _eq(tg.rank_of(T(pos)), jg.rank_of(jnp.asarray(pos)))
    halo = tc.halo_eff
    _eq(tdom.partition_costs(T(pos), T(BOX), tg, halo),
        jdom.partition_costs(jnp.asarray(pos), BOX, jg, halo))
    _eq(tdom.atom_costs(T(pos), T(BOX), tg, halo),
        jdom.atom_costs(jnp.asarray(pos), BOX, jg, halo))


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_assemble_rank_equals_jax(jax_assembly, case):
    jc, jgrid, want = jax_assembly[case]
    tc = bridge.dd_config_to_torch(jc)
    grid = tdd._make_grid(T(POS), T(BOX), tc, N)
    got = tdd._assemble_ranks(T(POS), T(TYPES), T(BOX), grid, tc, RCUT,
                              range(RANKS), N)
    got.pop("buf_coords")
    assert set(got) == set(want)
    for key, val in want.items():
        _eq(got[key], val, key)
    assert not want["overflow"].any()
    assert want["nbr_mask"].sum() > 0
    # the single-rank entry point gives each rank's slice
    one = tdd._assemble_rank(T(POS), T(TYPES), T(BOX), grid, tc, RCUT, 5, N)
    for key, val in one.items():
        _eq(val, want[key][5], key)


@pytest.mark.parametrize("method", ["dense", "cells"])
def test_assembly_flags_overflow_like_jax(jax_assembly, method):
    jc, jgrid, _ = jax_assembly[("ghost_reduce", method, "uniform")]
    jc = dataclasses.replace(jc, ghost_capacity=40, nbr_capacity=6,
                             nbr_capacity_eval=6)
    tc = bridge.dd_config_to_torch(jc)
    grid = tdd._make_grid(T(POS), T(BOX), tc, N)
    got = tdd._assemble_ranks(T(POS), T(TYPES), T(BOX), grid, tc, RCUT,
                              range(RANKS), N)
    want = _jax_ranks(jc, jgrid)
    for key in ("overflow", "local_count", "ghost_count", "l_idx", "g_idx"):
        _eq(got[key], want[key], key)
    assert got["overflow"].all()


def test_dense_and_cell_selection_agree():
    _, tc = _configs("owner_full", "cells", "balanced")
    grid = tdd._make_grid(T(POS), T(BOX), tc, N)
    table = tdom.bin_atoms(T(POS), T(BOX), tc.cell_dims, tc.cell_capacity)
    for r in (0, 3, 7):
        dense = tdom.select_ghosts(T(POS), T(BOX), grid, r, tc.halo_eff,
                                   tc.ghost_capacity)
        cells = tdom.select_ghosts_cells(T(POS), T(BOX), grid, r,
                                         tc.halo_eff, tc.ghost_capacity,
                                         table, tc.ghost_region)
        for a, b in zip(cells[:4], dense):
            _eq(a, b)
        dl = tdom.select_local(T(POS), grid, r, tc.local_capacity)
        cl = tdom.select_local_cells(T(POS), grid, r, tc.local_capacity,
                                     table, tc.local_region, T(BOX))
        for a, b in zip(cl[:3], dl):
            _eq(a, b)


def test_padding_helpers_equal_jax():
    n_pad = 168
    jc, jt = jdd._pad_atoms(jnp.asarray(POS), n_pad, BOX, jnp.asarray(TYPES))
    tc, tt = tdd._pad_atoms(T(POS), n_pad, T(BOX), T(TYPES))
    _eq(tc, jc)
    _eq(tt, jt)
    mask = (np.arange(40) % 3 > 0).astype(np.float32)
    _eq(tdd._park(T(POS[:40]), T(mask), T(BOX)),
        jdd._park(jnp.asarray(POS[:40]), jnp.asarray(mask), BOX))
    assert tdom.factor_grid(8, BOX) == jdom.factor_grid(8, BOX)
    assert tdom.factor_grid(6, np.array([4.0, 2.0, 1.0])) == \
        jdom.factor_grid(6, np.array([4.0, 2.0, 1.0]))
    assert (tdom.interior_fraction_estimate(BOX, (2, 2, 2), 0.6)
            == jdom.interior_fraction_estimate(BOX, (2, 2, 2), 0.6))
    _eq(tdom.IMAGE_SHIFTS, jdom.IMAGE_SHIFTS)
