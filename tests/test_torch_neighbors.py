"""Neighbour lists of the port against the JAX package: idx, mask and
overflow must be exactly equal (integer outputs), and so must the Verlet
skin rebuild flag."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ddinfer import masked_neighbor_list as j_masked
from repro.md import neighbors as jnb
from repro_torch.core.ddinfer import masked_neighbor_list as t_masked
from repro_torch.md import neighbors as tnb

# small CPU tensors: one intra-op thread keeps parallel test workers
# from oversubscribing the cores
torch.set_num_threads(1)

N, L = 96, 2.2
BOX = np.array([L, L, L], np.float32)
POS = np.random.default_rng(4).uniform(0, L, (N, 3)).astype(np.float32)
T = torch.tensor


def _assert_equal(tl, jl):
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("capacity", [48, 6], ids=["fits", "overflows"])
@pytest.mark.parametrize("half", [False, True])
def test_brute_force_list_equals_jax(capacity, half):
    jl = jnb.brute_force_neighbor_list(jnp.asarray(POS), jnp.asarray(BOX),
                                       0.6, capacity, half=half)
    tl = tnb.brute_force_neighbor_list(T(POS), T(BOX), 0.6, capacity,
                                       half=half)
    assert tl.idx.dtype == torch.int32
    _assert_equal((tl.idx, tl.mask, tl.overflow),
                  (jl.idx, jl.mask, jl.overflow))
    assert bool(tl.overflow) == (capacity == 6)


def test_row_chunking_changes_nothing(monkeypatch):
    full = tnb.brute_force_neighbor_list(T(POS), T(BOX), 0.6, 40)
    monkeypatch.setattr(tnb, "ROW_CHUNK", 7)
    chunked = tnb.brute_force_neighbor_list(T(POS), T(BOX), 0.6, 40)
    _assert_equal((chunked.idx, chunked.mask, chunked.overflow),
                  (full.idx, full.mask, full.overflow))


@pytest.mark.parametrize("capacity", [48, 6], ids=["fits", "overflows"])
def test_masked_list_equals_jax(capacity):
    valid = (np.random.default_rng(5).random(N) > 0.25).astype(np.float32)
    jl = j_masked(jnp.asarray(POS), jnp.asarray(BOX), 0.6, capacity,
                  jnp.asarray(valid))
    tl = t_masked(T(POS), T(BOX), 0.6, capacity, T(valid))
    _assert_equal(tl, jl)
    idx = tl[0].numpy()
    assert not np.isin(idx[idx >= 0], np.flatnonzero(valid == 0)).any()
    assert (idx[valid == 0] == -1).all()


@pytest.mark.parametrize("drift", [0.01, 0.04])
def test_needs_rebuild_equals_jax(drift):
    skin = 0.05
    moved = POS.copy()
    moved[3] += np.float32(drift)            # |d| = drift * sqrt(3)
    jl = jnb.brute_force_neighbor_list(jnp.asarray(POS), jnp.asarray(BOX),
                                       0.65, 64)
    tl = tnb.brute_force_neighbor_list(T(POS), T(BOX), 0.65, 64)
    jf = bool(jnb.needs_rebuild(jl, jnp.asarray(moved), jnp.asarray(BOX),
                                skin))
    tf = bool(tnb.needs_rebuild(tl, T(moved), T(BOX), skin))
    assert tf == jf == (drift * np.sqrt(3) > skin / 2)


def test_minimum_image_rounds_half_to_even():
    dr = np.array([[1.1, -1.1, 3.3], [0.5, 1.5, 2.5]], np.float32)
    box = np.array([2.2, 2.2, 2.2], np.float32)
    np.testing.assert_array_equal(
        tnb.minimum_image(T(dr), T(box)).numpy(),
        np.asarray(jnb.minimum_image(jnp.asarray(dr), jnp.asarray(box))))
    np.testing.assert_array_equal(
        tnb.pair_displacements(T(POS), T(BOX)).numpy(),
        np.asarray(jnb.pair_displacements(jnp.asarray(POS), jnp.asarray(BOX))))
