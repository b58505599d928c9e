"""Cell lists and the cell-filter kernel's plain version against the JAX
package.  Integer outputs (cell tables, 27-cell candidates, neighbour lists)
and the {0, 1} cutoff flags must be exactly equal, including pairs placed
at the cutoff and one ulp to either side of it (the ``cell_filter`` kernel
itself is held to its plain version on the card by
``tests/test_torch_card.py`` and ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.md import cells as jcells
from repro.md import neighbors as jnb
from repro_torch.core import ddinfer as tdd
from repro_torch.kernels import cell_filter as tcf
from repro_torch.kernels import ref as tref
from repro_torch.md import cells as tcells
from repro_torch.md import neighbors as tnb

# small CPU tensors: one intra-op thread keeps parallel test workers
# from oversubscribing the cores
torch.set_num_threads(1)

T = torch.tensor
N, L = 160, 3.5                     # the 160-atom system of parity_support
BOX = np.array([L, L, L], np.float32)
POS = np.random.default_rng(7).uniform(0, L, (N, 3)).astype(np.float32)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def cutoff_pairs(rcut: float, n: int, seed: int):
    """Pairs (p, q) whose float32 d^2 = (dx*dx + dy*dy) + dz*dz lands on
    fp32(rcut*rcut) and on the float32 values one ulp below and above it.
    Returns (p (m, 3), q (m, 3), d2 (m,)) float32."""
    thr = np.float32(rcut * rcut)
    targets = {np.nextafter(thr, np.float32(0)), thr,
               np.nextafter(thr, np.float32(np.inf))}
    rng = np.random.default_rng(seed)
    ps, qs, d2s = [], [], []
    while len(ps) < n:
        p = rng.uniform(0.5, 2.5, 3).astype(np.float32)
        u = rng.normal(size=3)
        q = (p + rcut * u / np.linalg.norm(u)).astype(np.float32)
        for step in range(-64, 65):
            qq = q.copy()
            qq[0] = q[0] + np.float32(step) * np.spacing(q[0])
            d = qq - p
            d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
            if d2 in targets:
                ps.append(p)
                qs.append(qq)
                d2s.append(d2)
    return np.array(ps[:n]), np.array(qs[:n]), np.array(d2s[:n], np.float32)


# ---------------------------------------------------------------------------
# cell tables and candidates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["roomy", "tight", "overflows"])
def test_cell_table_equals_jax(case):
    rng = np.random.default_rng(11)
    dims = (3, 4, 2)
    n_cells = int(np.prod(dims))
    ids = rng.integers(0, n_cells + 1, 300).astype(np.int32)   # incl. spill
    counts = np.bincount(ids, minlength=n_cells + 1)[:n_cells]
    cap = {"roomy": 40, "tight": int(counts.max()),
           "overflows": int(counts.max()) - 3}[case]
    jt = jcells.build_cell_table(jnp.asarray(ids), dims, cap)
    tt = tcells.build_cell_table(T(ids), dims, cap)
    assert tt.table.dtype == torch.int32
    _eq(tt.counts, jt.counts)
    assert bool(tt.overflow) == bool(jt.overflow) == (case == "overflows")
    # each (cell, slot) below the last is written once on both sides; an
    # overflowing cell's last slot is a duplicate write in the JAX scatter
    last = cap - 1 if case == "overflows" else cap
    _eq(tt.table[:, :last], np.asarray(jt.table)[:, :last])
    assert (tt.table[-1] == -1).all()


@pytest.mark.parametrize("dims", [(4, 5, 3), (2, 3, 1)],
                         ids=["regular", "degenerate"])
@pytest.mark.parametrize("periodic", [True, False])
def test_neighborhood_candidates_equal_jax(dims, periodic):
    rng = np.random.default_rng(12)
    n_cells = int(np.prod(dims))
    ids = rng.integers(0, n_cells, 80).astype(np.int32)
    frac = rng.integers(0, dims, (25, 3)).astype(np.int32)
    jt = jcells.build_cell_table(jnp.asarray(ids), dims, 12)
    tt = tcells.build_cell_table(T(ids), dims, 12)
    jc = jcells.neighborhood_candidates(jt, jnp.asarray(frac), periodic)
    tc = tcells.neighborhood_candidates(tt, T(frac), periodic)
    _eq(tc, jc)
    _eq(tcells.dedupe_mask(T(ids[:30])),
        jcells.dedupe_mask(jnp.asarray(ids[:30])))


def test_grid_helpers_equal_jax():
    for edge in (0.6, 0.65, 1.3, 4.0):
        assert tcells.grid_dims(BOX, edge) == jcells.grid_dims(BOX, edge)
    assert (tcells.suggest_cell_capacity(30.0, 0.27)
            == jcells.suggest_cell_capacity(30.0, 0.27))
    ids, valid = np.arange(6, dtype=np.int32), np.array([1, 0, 1, 1, 0, 1],
                                                        bool)
    _eq(tcells.route_invalid(T(ids), T(valid), 9),
        jcells.route_invalid(jnp.asarray(ids), jnp.asarray(valid), 9))


# ---------------------------------------------------------------------------
# cell-list neighbour lists
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity", [64, 4], ids=["fits", "overflows"])
@pytest.mark.parametrize("half", [False, True])
def test_cell_list_equals_jax_and_brute_force(capacity, half):
    jl = jnb.build_neighbor_list(jnp.asarray(POS), jnp.asarray(BOX), 0.6,
                                 capacity, half=half, skin=0.05)
    tl = tnb.build_neighbor_list(T(POS), T(BOX), 0.6, capacity, half=half,
                                 skin=0.05)
    assert min(tnb._cell_grid(BOX, 0.65)) >= 3       # the cell path ran
    for a, b in ((tl.idx, jl.idx), (tl.mask, jl.mask),
                 (tl.overflow, jl.overflow)):
        _eq(a, b)
    bf = tnb.brute_force_neighbor_list(T(POS), T(BOX), 0.65, capacity,
                                       half=half)
    for a, b in ((tl.idx, bf.idx), (tl.mask, bf.mask),
                 (tl.overflow, bf.overflow)):
        _eq(a, b)
    assert bool(tl.overflow) == (capacity == 4)


def test_front_door_small_box_takes_brute_force():
    pos = POS[:40] * np.float32(1.5 / L)
    box = np.full(3, 1.5, np.float32)
    jl = jnb.build_neighbor_list(jnp.asarray(pos), jnp.asarray(box), 0.6, 32)
    tl = tnb.build_neighbor_list(T(pos), T(box), 0.6, 32)
    _eq(tl.idx, jl.idx)
    _eq(tl.mask, jl.mask)


# ---------------------------------------------------------------------------
# the cell filter: plain versions against JAX, the kernel against its plain
# version on the card
# ---------------------------------------------------------------------------

def _filter_planes(rcut, seed):
    """Random displacement planes plus rows of pairs placed on the cutoff."""
    rng = np.random.default_rng(seed)
    c, m = 24, 40
    d = rng.normal(0, rcut, (3, c, m)).astype(np.float32)
    valid = (rng.random((c, m)) > 0.2).astype(np.float32)
    p, q, _ = cutoff_pairs(rcut, c * 8, seed)
    d[:, :, :8] = (q - p).T.reshape(3, c, 8)
    return d[0], d[1], d[2], valid


@pytest.mark.parametrize("rcut", [0.6, 0.65, 1.3])
def test_cell_filter_ref_equals_jax_bitwise(rcut):
    dx, dy, dz, valid = _filter_planes(rcut, 3)
    want = np.asarray(jref.cell_filter_ref(*map(jnp.asarray,
                                                (dx, dy, dz, valid)), rcut))
    got = tref.cell_filter_ref(T(dx), T(dy), T(dz), T(valid), rcut)
    assert got.dtype == torch.float32
    _eq(got, want)
    # the placed pairs straddle the cutoff: some in, some out
    placed = want[:, :8][valid[:, :8] > 0]
    assert 0 < placed.sum() < placed.size


def _buffer(rcut):
    """A buffer with parked rows and candidate lists that hold cutoff pairs
    (every other row's partner sits on the cutoff)."""
    rng = np.random.default_rng(5)
    p, q, _ = cutoff_pairs(rcut, 30, 6)
    xyz = np.concatenate([p, q, rng.uniform(0, 3, (40, 3))]).astype(np.float32)
    mask = np.ones(len(xyz), np.float32)
    mask[-5:] = 0.0
    r = len(xyz)
    idx = rng.integers(-1, r, (r, 50)).astype(np.int32)
    idx[:30, 0] = np.arange(30) + 30        # row i's partner on the cutoff
    idx[:30, 1] = np.arange(30)             # the row itself: never a pair
    return xyz, idx, mask


@pytest.mark.parametrize("rcut", [0.6, 0.65])
def test_cell_filter_plain_equals_jax_gathered_filter(rcut):
    xyz, idx, mask = _buffer(rcut)
    safe = np.where(idx >= 0, idx, 0)
    dr = jnp.asarray(xyz)[safe] - jnp.asarray(xyz)[:, None, :]
    valid = ((idx >= 0) & (idx != np.arange(len(xyz))[:, None])
             & (mask[:, None] > 0)).astype(np.float32)
    want = np.asarray(jref.cell_filter_ref(dr[..., 0], dr[..., 1], dr[..., 2],
                                           jnp.asarray(valid), rcut)) > 0
    before = tcf.cell_filter.launches
    got = tcf.cell_filter(T(xyz), T(idx), T(mask), rcut)   # CPU: plain
    assert got.dtype == torch.bool and tcf.cell_filter.launches == before
    _eq(got, want)
    assert not got[:30, 1].any()


def test_subdomain_cell_list_equals_dense_list():
    rng = np.random.default_rng(9)
    g, c = 2, 70
    buf = rng.uniform(0, 2.0, (g, c, 3)).astype(np.float32)
    mask = (rng.random((g, c)) > 0.2).astype(np.float32)
    buf_t = tdd._park(T(buf), T(mask), T(BOX))
    origin = torch.full((g, 3), -0.2)
    dense = tdd._subdomain_nbr_list(buf_t, T(mask), 0.65, 24)
    cells = tdd._subdomain_nbr_list_cells(buf_t, T(mask), 0.65, 24, origin,
                                          (5, 5, 5), 30)
    for a, b in zip(cells, dense):
        _eq(a, b)
    assert dense[1].sum() > 0
