"""Card-only tests of the port's kernels (marked ``cuda``; they skip without
an NVIDIA card).  No JAX here, so the card's machine runs them:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_card.py

* ``cell_filter``: flags equal the plain version bit for bit, on random
  candidates and on pairs placed at the cutoff and one ulp either side;
* the attention stack at K = 64, 82 and 128 (the backward's shared-memory
  and device-workspace instances) against its plain version: forward atol
  1e-4 x max|out|, backward atol 1e-4 x max|grad| per output, parameter
  gradients included;
* the force-path attention backward (no parameter gradients; compacted
  rows) at K = 64, 82 and 128 with atoms of 0, 1 and K valid slots and a
  non-prefix mask in one batch: atol 1e-4 x max|grad| per output (fp32;
  2e-2 with bf16 operands, as the forward's bf16 gate), exact zeros at the
  masked slots, the same bits on a repeat;
* the forward on compacted rows at K = 64, 82 and 128, heads 2 and bf16
  operands, with large g at the masked slots: out and stash atol 1e-4 x
  max (2e-2 in bf16), stash layer 0 equal to g, exact zeros at the masked
  slots, the same bits with and without a stash; an atom's bits the same
  wherever it lands (atoms permuted; small passes, so other GEMM tiles and
  attention CTAs of 128 threads instead of 256); an all-masked input and
  N = 0; autograd through ``NbrAttentionStack`` with and without
  parameter gradients against the plain backward;
* ``cell_filter``'s row kernel on widths M that are not multiples of 4
  and on index rows that do not start on a 16-byte boundary: flags equal
  the plain version bit for bit;
* the attention kernels on reduced widths whose head width is not a
  multiple of 4 (or H not one of 8): the wrapper pads the heads; forward,
  force-path backward and autograd with parameter gradients against the
  plain version, atol 1e-4 x max, parameter gradients at the true shapes;
* ``force_scatter`` (the neighbour gather's backward) against its plain
  version bit for bit at K = 64, 82 and 128, with the atoms relabelled;
  all slots masked and N = 0; grad-of-grad through ``neighbor_gather``
  against the CPU (atol 1e-6 x max); the DD force reduction through it
  equal to the CPU bit for bit;
* the force scatter's list, built on the card by the hand-written radix
  sort, equal to ``reverse_list`` element for element, and its sums equal
  to ``force_scatter_plain`` bit for bit (and on a repeat), with int32 and
  int64 indices, on a pair-table-shaped input, a pile-up (every valid slot
  on one atom), segments of 0, 1, 31, 32, 33 and 1,025 entries, K = 1 with
  80% of the atoms empty, and n at 65,535, 65,536 and 65,537 (the digit
  count changes above 65,536); no ``torch.sort``, ``argsort`` or
  ``searchsorted`` runs in a call on the card; 2^31 slots raise;
* the MD engine on the solvated 5-residue protein with the paper's DPA-1
  (random weights, seed 0): 10 steps on the card against the CPU (positions
  atol 1e-5 nm, the CPU tests' gate against JAX); scan == step and a
  repeat bit for bit; the peak memory of 20 steps that of the first
  window within 1%; the classical forces' gathers launch the force scatter
  (one per bonded term and one for the pair table) and never PyTorch's indexing
  backward; the classical forces' bits the same at list capacities 96 and
  384 (either side of the card's split-reduction threshold of 256);
* PME on the card: the charge mesh equal to the CPU's bit for bit, the
  reciprocal energy (rtol 1e-5) and its forces (atol 1e-5 x max|F|)
  against the CPU, and the same bits on a repeat;
* ``flash_attention`` against its plain version (the five cases of the
  reference's flash tests, unmasked keys past a ragged Sk, decode against a
  cache view, every head dimension the kernel has; in bf16 also the wgmma
  prefill's edges: GQA groups 1, 2, 6 and 8, Sq and Sk off the 64- and
  128-row and -key tiles, rows with no visible key, cache views with
  strides at every (D, DV) instance, one KV head among them): atol 1e-4 x max|plain| in fp32, 1e-2 x max|plain| in bf16 (the
  output is rounded to bf16 on both sides, and the bf16 kernel rounds the
  probabilities to bf16 for the PV product); a repeated call gives the
  same bits;
* ``flash_decode`` (the decode kernel over a whole cache, the position a
  device tensor) against its plain version: GQA groups 1, 2 and 8 (and two
  queries a step), fp32 and bf16, lengths 1, 63, 64, 65 and the capacity,
  window and softcap, at the same gates; the split count (the grid) the
  same at every length, a repeat the same bits; the decode instance of
  ``flash_attention`` gives exactly 0 for a row with no visible key;
* a reduced gemma2 decode step captured as a CUDA graph (``launch/serve.py
  ::DecodeGraph``) gives the eager step's tokens and logits bit for bit;
  so does every registry architecture at a reduced width in bf16 (rwkv6's
  and jamba's recurrent state restored after the graph's warm-up step;
  MLA, MoE, cross-attention and the encoder among them);
* MLA's (D, DV) = (192, 128) instance of ``flash_attention`` against its
  plain version in fp32 and bf16 at Sq <= 16 (the prefill kernels, not the
  decode kernel) and Sq > 16, causal and not, at the gates above, a repeat
  the same bits; a (D, DV) without an instance raises on CUDA tensors;
* the attention kernels at embedding widths M = 30 and 62 (padded to a
  multiple of 4 by the wrappers): forward and force-path backward against
  the plain version, atol 1e-4 x max, exact zeros at the masked slots;
* guarded MD on the solvated 20-residue protein (326 atoms): an injected
  ``nan_force`` (engine-level, and rank-level on 8 virtual ranks) recovers
  to the fault-free run bit for bit in both loop modes, every DP kernel
  launched in the faulted run; guards quiet == unguarded; an
  ``AsyncCheckpointer`` restart falls back past a truncated checkpoint and
  resumes bit for bit; non-finite positions through the cell lists, the DD
  assembly and PME raise no device-side assert; an instrumented run with a
  ``torch.profiler`` capture keeps its bits and the trace holds the
  engine's spans and the device kernels;
* the env matrix's autograd Function raises when a backward is asked to
  build a graph (``create_graph=True``);
* DPA-1 training on a narrow model: two steps of the second-order route on
  the card against the CPU (loss rtol 1e-5, each gradient leaf atol 2e-5 x
  max|leaf|), a step launching the force scatter once and no model
  kernel, ``force_rmse`` launching each single-domain kernel once per 16
  frames; ``train`` restored from a mid-run checkpoint ending with the
  uninterrupted run's parameters bit for bit;
* LM training: the attention's autograd Function (the prefill kernels
  with the row log-sum-exp, the plain chunked backward) against autograd
  through ``attention_ref`` in fp32 and bf16 (GQA, window, softcap,
  offset, MLA's (192, 128), 6 rows per KV head, rows with no visible key),
  a repeat the same bits; the kernels with the LSE give the serving
  call's output bits, the LSE against ``attention_lse_ref``; two train
  steps of a reduced qwen2 on the card against the CPU; every registry
  arch's train step (reduced, bf16) under
  ``torch.use_deterministic_algorithms(True, warn_only=True)`` warning of
  no nondeterministic op and repeating bit for bit;
* the step accounting: every registry arch's train step, prefill and
  decode step (reduced, bf16) counted on the card equal to the count on
  ``meta``, the live-bytes peak within 1% of ``max_memory_allocated``
  above the inputs.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.kernels import cell_filter as cf
from repro_torch.kernels import flash_attn, nbr_attn, ref
from repro_torch.kernels import force_scatter as fs


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _cutoff_pairs(rcut, n, seed):
    """(p, q) pairs whose float32 d^2 = (dx*dx + dy*dy) + dz*dz is
    fp32(rcut*rcut) or one ulp either side of it."""
    thr = np.float32(rcut * rcut)
    targets = {np.nextafter(thr, np.float32(0)), thr,
               np.nextafter(thr, np.float32(np.inf))}
    rng = np.random.default_rng(seed)
    ps, qs = [], []
    while len(ps) < n:
        p = rng.uniform(0.5, 2.5, 3).astype(np.float32)
        u = rng.normal(size=3)
        q = (p + rcut * u / np.linalg.norm(u)).astype(np.float32)
        for step in range(-64, 65):
            qq = q.copy()
            qq[0] = q[0] + np.float32(step) * np.spacing(q[0])
            d = qq - p
            if d[0] * d[0] + d[1] * d[1] + d[2] * d[2] in targets:
                ps.append(p)
                qs.append(qq)
    return np.array(ps[:n]), np.array(qs[:n])


@pytest.mark.cuda
@pytest.mark.parametrize("rcut", [0.6, 0.65])
def test_cell_filter_kernel_equals_plain(card, rcut):
    rng = np.random.default_rng(1)
    p, q = _cutoff_pairs(rcut, 500, 2)
    xyz = np.concatenate([p, q, rng.uniform(0, 3, (400, 3))]).astype(np.float32)
    r = len(xyz)
    idx = rng.integers(-1, r, (r, 300)).astype(np.int32)
    idx[:500, 0] = np.arange(500) + 500
    mask = (rng.random(r) > 0.1).astype(np.float32)
    args = [torch.tensor(a) for a in (xyz, idx, mask)]
    before = cf.cell_filter.launches
    got = cf.cell_filter(*[a.to(card) for a in args], rcut)
    assert cf.cell_filter.launches == before + 1
    assert torch.equal(got.cpu(), cf.cell_filter_plain(*args, rcut))


@pytest.mark.cuda
@pytest.mark.parametrize("m,offset", [(82, 0), (83, 0), (3, 0), (128, 1),
                                      (85, 3)])
def test_cell_filter_rows_of_any_width(card, m, offset):
    """The row kernel's head, int4 body and tail: every M mod 4, and a
    contiguous index view that starts ``offset`` entries into its buffer,
    so its rows are not 16-byte aligned (entry-wise path)."""
    rng = np.random.default_rng(m + offset)
    r = 700
    xyz = rng.uniform(0, 2, (r, 3)).astype(np.float32)
    flat = torch.tensor(rng.integers(-1, r, r * m + offset).astype(np.int32))
    mask = (rng.random(r) > 0.2).astype(np.float32)
    args = [torch.tensor(xyz), flat[offset:].view(r, m), torch.tensor(mask)]
    idx = flat.to(card)[offset:].view(r, m)
    assert idx.is_contiguous()
    assert (idx.data_ptr() % 16 != 0) == (offset % 4 != 0)
    got = cf.cell_filter(args[0].to(card), idx, args[2].to(card), 0.6)
    want = cf.cell_filter_plain(*args, 0.6)
    assert bool(want.any()) and torch.equal(got.cpu(), want)


def _stack_args(card, seed, n, k, p_valid, m=128, h=256, layers=3):
    """(args of the stack at the path's widths, a randn on its generator)."""
    gen = torch.Generator(device=card).manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, device=card, generator=gen)
    rx, ry, rz = (0.5 * rnd(n, k) for _ in range(3))
    sw = torch.rand(n, k, device=card, generator=gen)
    mask = (torch.rand(n, k, device=card, generator=gen) < p_valid).float()
    weights = [0.05 * rnd(layers, m, h) for _ in range(3)]
    weights += [0.05 * rnd(layers, h, m), 1 + 0.1 * rnd(layers, m),
                0.1 * rnd(layers, m)]
    return [rnd(n, k, m), rx, ry, rz, sw, mask, *weights], rnd


def _edge_atoms(mask):
    k = mask.shape[1]
    mask[0] = 0.0                     # no valid neighbour
    mask[1] = 0.0
    mask[1, k // 2] = 1.0             # one, mid-row
    mask[2] = 1.0                     # all K valid


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 82, 128])
def test_attention_stack_on_card_up_to_k128(card, k):
    n, m = 48, 128
    args, rnd = _stack_args(card, k, n, k, 0.6)
    out, stash = nbr_attn.nbr_attention_stack_fwd(*args, stash=True)
    want, want_stash = ref.nbr_attention_stack_ref(*args, stash=True)
    torch.testing.assert_close(out, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))
    dout = rnd(n, k, m)
    got = nbr_attn.nbr_attention_stack_bwd(want_stash, *args[1:], dout)
    exp = ref.nbr_attention_stack_bwd_ref(want_stash, *args[1:], dout)
    for a, b in zip(got, exp):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))
    assert nbr_attn.uses_workspace(k, m) == (k > 89)


@pytest.mark.cuda
@pytest.mark.parametrize("k,heads,dtype", [
    (64, 1, "float32"), (82, 1, "float32"), (128, 1, "float32"),
    (82, 2, "float32"), (82, 1, "bfloat16")])
def test_force_path_backward_on_compacted_rows(card, k, heads, dtype):
    n, m = 40, 128
    args, rnd = _stack_args(card, k + heads, n, k, 0.4)
    mask = args[5]
    _edge_atoms(mask)
    opts = dict(heads=heads, compute_dtype=dtype)
    _, stash = ref.nbr_attention_stack_ref(*args, stash=True, **opts)
    dout = rnd(n, k, m)
    before = nbr_attn.nbr_attention_stack_bwd.launches
    got = nbr_attn.nbr_attention_stack_bwd(stash, *args[1:], dout,
                                           param_grads=False, **opts)
    assert nbr_attn.nbr_attention_stack_bwd.launches == before + 1
    assert all(p is None for p in got[5:])
    exp = ref.nbr_attention_stack_bwd_ref(stash, *args[1:], dout, **opts)
    tol = 1e-4 if dtype == "float32" else 2e-2
    again = nbr_attn.nbr_attention_stack_bwd(stash, *args[1:], dout,
                                             param_grads=False, **opts)
    masked = mask == 0
    for a, b, c in zip(got[:5], exp[:5], again[:5]):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=tol * float(b.abs().max()))
        assert not bool(a[masked].any())
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("k,heads,dtype", [
    (64, 1, "float32"), (82, 1, "float32"), (128, 1, "float32"),
    (82, 2, "float32"), (82, 1, "bfloat16")])
def test_forward_on_compacted_rows(card, k, heads, dtype):
    args, _ = _stack_args(card, 3 * k + heads, 40, k, 0.4)
    mask = args[5]
    _edge_atoms(mask)
    masked = mask == 0
    args[0][masked] = 1e6             # must reach no valid row
    opts = dict(heads=heads, compute_dtype=dtype)
    before = nbr_attn.nbr_attention_stack_fwd.launches
    out, stash = nbr_attn.nbr_attention_stack_fwd(*args, stash=True, **opts)
    assert nbr_attn.nbr_attention_stack_fwd.launches == before + 1
    want, want_stash = ref.nbr_attention_stack_ref(*args, stash=True, **opts)
    tol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out, want, rtol=0,
                               atol=tol * float(want.abs().max()))
    assert torch.equal(stash[0], args[0])
    torch.testing.assert_close(stash[1:], want_stash[1:], rtol=0,
                               atol=tol * float(want_stash[1:].abs().max()))
    assert not bool(out[masked].any())
    assert not bool(stash[1:, masked].any())
    assert torch.equal(out, nbr_attn.nbr_attention_stack_fwd(*args, **opts))
    again, rs = nbr_attn.nbr_attention_stack_fwd(*args, stash="rows", **opts)
    assert torch.equal(out, again)
    assert rs.x.shape == (3, int(mask.sum()), 128)
    assert torch.equal(nbr_attn.dense_stash(args[0], rs.x, rs.rows), stash)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [82, 128])
def test_forward_bits_do_not_depend_on_an_atoms_place(card, k, monkeypatch):
    n = 64
    args, _ = _stack_args(card, 5 * k, n, k, 0.5)
    _edge_atoms(args[5])
    out = nbr_attn.nbr_attention_stack_fwd(*args)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(k))
    perm = perm.to(card)
    moved = nbr_attn.nbr_attention_stack_fwd(*[a[perm] for a in args[:6]],
                                             *args[6:])
    assert torch.equal(moved, out[perm])
    # passes of ~200 rows: the atoms in other GEMM tiles, and those of at
    # most 64 valid slots in attention CTAs of 128 threads instead of 256
    counts = args[5].sum(1).sort(descending=True).values.long().cpu()
    assert len(nbr_attn.row_passes(counts, 200)) > 10
    assert int(counts[0]) > 64 >= int(counts[-2])
    monkeypatch.setattr(nbr_attn, "ROW_PASS", 200)
    assert torch.equal(nbr_attn.nbr_attention_stack_fwd(*args), out)


@pytest.mark.cuda
def test_forward_all_masked_and_empty(card):
    args, _ = _stack_args(card, 9, 16, 82, 0.0)
    before = nbr_attn.nbr_attention_stack_fwd.launches
    out, stash = nbr_attn.nbr_attention_stack_fwd(*args, stash=True)
    assert nbr_attn.nbr_attention_stack_fwd.launches == before
    assert not bool(out.any()) and not bool(stash[1:].any())
    assert torch.equal(stash[0], args[0])
    empty = [a[:0] for a in args[:6]] + args[6:]
    out = nbr_attn.nbr_attention_stack_fwd(*empty)
    assert out.shape == (0, 82, 128)
    g = args[0].clone().requires_grad_()
    nbr_attn.nbr_attention_stack(g, *args[1:]).sum().backward()
    assert not bool(g.grad.any())


@pytest.mark.cuda
@pytest.mark.parametrize("param_grads", [True, False])
def test_autograd_through_the_stack(card, param_grads):
    """Training (parameter gradients: dense stash, the parameter-gradient
    backward) and the force path (compacted stash handed over) against the
    plain backward."""
    args, rnd = _stack_args(card, 21 + param_grads, 32, 82, 0.4)
    _edge_atoms(args[5])
    grads = [i for i in range(12) if i != 5 and (param_grads or i < 5)]
    leaves = [a.clone().requires_grad_(i in grads) for i, a in enumerate(args)]
    dout = rnd(*args[0].shape)
    fb, bb = (nbr_attn.nbr_attention_stack_fwd.launches,
              nbr_attn.nbr_attention_stack_bwd.launches)
    nbr_attn.nbr_attention_stack(*leaves).backward(dout)
    assert nbr_attn.nbr_attention_stack_fwd.launches == fb + 1
    assert nbr_attn.nbr_attention_stack_bwd.launches == bb + 1
    _, stash = ref.nbr_attention_stack_ref(*args, stash=True)
    exp = ref.nbr_attention_stack_bwd_ref(stash, *args[1:], dout)
    for i, want in zip([0, 1, 2, 3, 4, *range(6, 12)], exp):
        if i in grads:
            torch.testing.assert_close(leaves[i].grad, want, rtol=0,
                                       atol=1e-4 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("h,heads", [(32, 2), (12, 2), (20, 1)])
def test_attention_kernels_pad_the_head_width(card, h, heads):
    """Reduced widths (M = 16; head widths 16, 6 and 20 with H = 32, 12
    and 20): the forward, the force-path backward and autograd with
    parameter gradients against the plain version."""
    n, k, m = 40, 82, 16
    args, rnd = _stack_args(card, h + heads, n, k, 0.4, m=m, h=h, layers=2)
    _edge_atoms(args[5])
    opts = dict(heads=heads)
    out, stash = nbr_attn.nbr_attention_stack_fwd(*args, stash=True, **opts)
    want, want_stash = ref.nbr_attention_stack_ref(*args, stash=True, **opts)
    torch.testing.assert_close(out, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))
    dout = rnd(n, k, m)
    got = nbr_attn.nbr_attention_stack_bwd(want_stash, *args[1:], dout,
                                           param_grads=False, **opts)
    exp = ref.nbr_attention_stack_bwd_ref(want_stash, *args[1:], dout, **opts)
    for a, b in zip(got[:5], exp[:5]):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))
    leaves = [a.clone().requires_grad_(i != 5) for i, a in enumerate(args)]
    nbr_attn.nbr_attention_stack(*leaves, **opts).backward(dout)
    for i, b in zip([0, 1, 2, 3, 4, *range(6, 12)], exp):
        assert leaves[i].grad.shape == args[i].shape
        torch.testing.assert_close(leaves[i].grad, b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))


def _scatter_args(seed, n, k, p_valid, device="cpu"):
    """Cotangent rows g (N, K, 3), a -1 padded idx (N, K) and a {0, 1}
    mask, with large cotangents on the masked slots."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, (n, k)).astype(np.int32)
    idx[rng.random((n, k)) < 0.2] = -1
    mask = ((rng.random((n, k)) < p_valid) & (idx >= 0)).astype(np.float32)
    g = rng.normal(0, 1, (n, k, 3)).astype(np.float32)
    g[mask == 0] = 1e6
    return [torch.tensor(a, device=device) for a in (g, idx, mask)]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 82, 128])
def test_force_scatter_kernel_equals_plain(card, k):
    n = 3000
    g, idx, mask = _scatter_args(k, n, k, 0.35)
    before = fs.force_scatter.launches
    got = fs.force_scatter(g.to(card), idx.to(card), mask.to(card), n)
    assert fs.force_scatter.launches == before + 1
    want = fs.force_scatter_plain(g, idx, mask, n)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(fs.force_scatter(g.to(card), idx.to(card),
                                        mask.to(card), n), got)
    # atoms relabelled: each atom's sum keeps its bits
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(k))
    moved = torch.where(idx >= 0, perm[idx.long().clamp_min(0)].int(), idx)
    got_m = fs.force_scatter(g.to(card), moved.to(card), mask.to(card), n)
    assert torch.equal(got_m.cpu()[perm], want)


@pytest.mark.cuda
def test_dd_force_reduction_equals_the_cpu_bitwise(card):
    """The DD force reduction (``pipeline._scatter_rows``) runs the force
    scatter: 200,000 rows onto 50 atoms, the same bits as on the CPU."""
    from repro_torch.core import pipeline
    rng = np.random.default_rng(3)
    rows = torch.tensor(rng.integers(0, 50, 200_000))
    vals = torch.tensor(rng.normal(0, 1e3, (200_000, 3)).astype(np.float32))
    before = fs.force_scatter.launches
    got = pipeline._scatter_rows(50, rows.to(card), vals.to(card))
    assert fs.force_scatter.launches == before + 1
    assert torch.equal(got.cpu(), pipeline._scatter_rows(50, rows, vals))


@pytest.mark.cuda
def test_force_scatter_all_masked_and_empty(card):
    g, idx, mask = (a.to(card) for a in _scatter_args(5, 200, 82, 0.0))
    assert not bool(fs.force_scatter(g, idx, mask, 200).any())
    out = fs.force_scatter(g[:0], idx[:0], mask[:0], 0)
    assert out.shape == (0, 3)


def _list_case(case, seed):
    """(idx, mask, n) for the card's list: the shapes its stable sort has to
    get right."""
    rng = np.random.default_rng(seed)
    if case == "pair_table":             # (N, 2K), own half masked too
        n, k = 3000, 96
        nbr = rng.integers(0, n, (n, k))
        nbr[rng.random((n, k)) < 0.45] = -1
        m = (rng.random((n, k)) < 0.8) & (nbr >= 0)
        own = np.broadcast_to(np.arange(n)[:, None], (n, k))
        return (np.stack([own, nbr], -1).reshape(n, 2 * k),
                np.repeat(m, 2, 1), n)
    if case == "pile_up":                # every valid slot on one atom
        n = 500
        idx = np.where(rng.random((4000, 82)) < 0.3, -1, 321)
        return idx, (rng.random(idx.shape) < 0.8) & (idx >= 0), n
    if case == "segments":               # atoms 0-5 hold exactly these
        n, lengths = 2000, (0, 1, 31, 32, 33, 1025)
        idx = rng.integers(len(lengths), n, 60_000)
        spots = rng.permutation(len(idx))
        start = 0
        for atom, length in enumerate(lengths):
            idx[spots[start:start + length]] = atom
            start += length
        return idx[:, None], np.ones((len(idx), 1), bool), n
    if case == "k1_sparse":              # the DD force reduction's shape
        n = 125_376
        idx = rng.choice(n, n // 5, replace=False)
        return idx[:, None], np.ones((len(idx), 1), bool), n
    n = int(case[1:])                    # n at the digit-count boundary
    idx = np.where(rng.random((3000, 40)) < 0.5, n - 1 - rng.integers(
        0, 300, (3000, 40)), rng.integers(0, n, (3000, 40)))
    idx[rng.random(idx.shape) < 0.2] = -1
    return idx, (rng.random(idx.shape) < 0.7) & (idx >= 0), n


LIST_CASES = ["pair_table", "pile_up", "segments", "k1_sparse", "n65535",
              "n65536", "n65537"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", LIST_CASES)
def test_force_scatter_list_and_sums_on_card(card, case, dtype):
    """The card's list is ``reverse_list`` element for element, and the
    sums over it are the plain version's bits, on a repeat too."""
    idx, mask, n = _list_case(case, LIST_CASES.index(case))
    rng = np.random.default_rng(7)
    g = rng.normal(0, 1, (*idx.shape, 3)).astype(np.float32)
    g[~mask] = 1e6
    idx = torch.tensor(idx, dtype=dtype)
    mask = torch.tensor(mask, dtype=torch.float32)
    g = torch.tensor(g)
    want_perm, want_off = fs.reverse_list(idx, mask, n)
    perm, off = fs._build_list(idx.to(card), mask.to(card), n)
    assert perm.dtype == off.dtype == torch.int32
    assert torch.equal(off.cpu().long(), want_off)
    valid = int(want_off[-1])
    assert torch.equal(perm[:valid].cpu().long(), want_perm[:valid])
    if case == "segments":
        assert want_off[1:7].tolist() == [0, 1, 32, 64, 97, 1122]
    before = fs.force_scatter.launches
    got = fs.force_scatter(g.to(card), idx.to(card), mask.to(card), n)
    assert fs.force_scatter.launches == before + 1
    assert torch.equal(got.cpu(), fs.force_scatter_plain(g, idx, mask, n))
    assert torch.equal(fs.force_scatter(g.to(card), idx.to(card),
                                        mask.to(card), n), got)


@pytest.mark.cuda
def test_force_scatter_on_card_runs_no_library_sort(card, monkeypatch):
    """The list is the hand-written kernels' alone: a call on the card with
    ``torch.sort``, ``argsort`` and ``searchsorted`` made to raise gives the
    plain version's bits."""
    g, idx, mask = _scatter_args(11, 3000, 82, 0.35)
    want = fs.force_scatter_plain(g, idx, mask, 3000)
    args = (g.to(card), idx.to(card), mask.to(card))

    def refuse(*a, **kw):
        raise AssertionError("a library sort ran on the card path")

    for owner in (torch, torch.Tensor):
        for name in ("sort", "argsort", "searchsorted"):
            if hasattr(owner, name):
                monkeypatch.setattr(owner, name, refuse)
    got = fs.force_scatter(*args, 3000)
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_force_scatter_refuses_2_31_slots(card):
    """List entries are 32-bit: 2^31 slots (stride-0 views, nothing
    allocated) raise before any launch."""
    c, k = 2 ** 16, 2 ** 15
    g = torch.zeros(1, 1, 3, device=card).expand(c, k, 3)
    idx = torch.zeros(1, 1, dtype=torch.int32, device=card).expand(c, k)
    mask = torch.ones(1, 1, device=card).expand(c, k)
    before = fs.force_scatter.launches
    with pytest.raises(ValueError, match="2\\^31"):
        fs.force_scatter(g, idx, mask, 10)
    assert fs.force_scatter.launches == before


@pytest.mark.cuda
def test_neighbor_gather_double_backward_on_card(card):
    """Forces and a force-matching gradient (grad of grad) through the
    gather on the card against the CPU."""
    n, k = 500, 82
    _, idx, mask = _scatter_args(9, n, k, 0.35)
    rng = np.random.default_rng(10)
    x = torch.tensor(rng.normal(0, 1, (n, 3)).astype(np.float32))
    w = torch.tensor(rng.normal(0, 1, (n, k, 3)).astype(np.float32))
    v = torch.tensor(rng.normal(0, 1, (n, 3)).astype(np.float32))
    res = {}
    for dev in ("cpu", card):
        c = x.to(dev).requires_grad_(True)
        m = mask.to(dev)
        y = fs.neighbor_gather(c, idx.to(dev), m)
        e = (w.to(dev) * y * y * m[..., None]).sum()
        (f,) = torch.autograd.grad(e, c, create_graph=True)
        (h,) = torch.autograd.grad((f * v.to(dev)).sum(), c)
        res[str(dev)] = (f.detach().cpu(), h.cpu())
    for a, b in zip(res["cuda"], res["cpu"]):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-6 * float(b.abs().max()))


FLASH_CASES = [  # b, hq, hkv, sq, sk, d, causal, window, cap, off
    (2, 4, 2, 128, 128, 64, True, 0, 0.0, 0),
    (1, 8, 2, 200, 200, 64, True, 128, 30.0, 0),
    (1, 4, 4, 1, 256, 64, False, 0, 0.0, 255),
    (2, 2, 1, 96, 160, 32, True, 0, 0.0, 64),
    (1, 2, 2, 64, 64, 128, True, 32, 50.0, 0),
    (1, 4, 2, 72, 200, 64, False, 0, 0.0, 0),
    (2, 8, 4, 300, 300, 256, True, 128, 50.0, 0),
    (1, 4, 1, 9, 400, 256, True, 0, 50.0, 391),
    # decode with the keys split over CTAs and merged by a second kernel
    (4, 8, 4, 1, 3000, 256, True, 1024, 50.0, 2999),
    (3, 2, 2, 1, 777, 128, False, 0, 0.0, 776),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window,cap,off",
                         FLASH_CASES)
def test_flash_attention_kernel_equals_plain(card, dtype, b, hq, hkv, sq, sk,
                                             d, causal, window, cap, off):
    gen = torch.Generator(device=card).manual_seed(sq + sk + d)
    rnd = lambda *s: torch.randn(*s, device=card, generator=gen).to(dtype)
    q, k, v = rnd(b, hq, sq, d), rnd(b, hkv, sk, d), rnd(b, hkv, sk, d)
    before = flash_attn.flash_attention.launches
    got = flash_attn.flash_attention(q, k, v, causal, window, cap, off)
    assert flash_attn.flash_attention.launches == before + 1
    want = ref.attention_ref(q, k, v, causal, window, cap, off)
    assert got.dtype == dtype
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=tol * float(want.float().abs().max()))
    again = flash_attn.flash_attention(q, k, v, causal, window, cap, off)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_flash_attention_reads_a_cache_view(card):
    """Decode against a cache sliced to its filled length: the kernel takes
    the view's strides, no copy, and equals the plain version."""
    gen = torch.Generator(device=card).manual_seed(7)
    cache = torch.randn(2, 2, 2, 512, 256, device=card, generator=gen)
    cache = cache.to(torch.bfloat16)      # {k, v} x (B, Hkv, S_max, D)
    k, v = cache[0, :, :, :301], cache[1, :, :, :301]
    assert not k.is_contiguous()
    q = torch.randn(2, 8, 1, 256, device=card, generator=gen).to(torch.bfloat16)
    got = flash_attn.flash_attention(q, k, v, True, 128, 50.0, 300)
    want = ref.attention_ref(q, k, v, True, 128, 50.0, 300)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=1e-2 * float(want.float().abs().max()))


BF16_PREFILL_CASES = [  # b, hq, hkv, sq, sk, d, causal, window, cap, off
    (2, 4, 4, 100, 100, 64, True, 0, 0.0, 0),       # group 1, Sq off the tile
    (1, 8, 4, 130, 70, 128, False, 0, 50.0, 0),     # group 2, Sk < Sq, ragged
    (1, 8, 1, 75, 75, 256, True, 40, 50.0, 0),      # group 8, window, softcap
    (2, 4, 2, 33, 200, 256, True, 0, 0.0, 150),     # q_offset
    (1, 4, 2, 64, 50, 64, True, 20, 0.0, 40),       # rows with no visible key
    (1, 16, 2, 257, 300, 128, True, 96, 30.0, 43),  # group 8, all at once
    # GQA group 6 (qwen2's); Sq and Sk off the 128-row and -key tiles
    (1, 12, 2, 200, 333, 32, True, 0, 0.0, 133),
    (2, 6, 1, 257, 257, 64, True, 96, 50.0, 0),
    (1, 12, 2, 130, 129, 128, False, 0, 50.0, 0),
    (1, 6, 1, 300, 385, 256, True, 0, 50.0, 85),
    (1, 12, 2, 64, 50, 128, True, 20, 0.0, 40),     # group 6, no visible key
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window,cap,off",
                         BF16_PREFILL_CASES)
def test_flash_attention_bf16_tensor_core_prefill(card, b, hq, hkv, sq, sk,
                                                  d, causal, window, cap,
                                                  off):
    gen = torch.Generator(device=card).manual_seed(sq * sk + d)
    rnd = lambda *s: torch.randn(*s, device=card, generator=gen).to(
        torch.bfloat16)
    q, k, v = rnd(b, hq, sq, d), rnd(b, hkv, sk, d), rnd(b, hkv, sk, d)
    got = flash_attn.flash_attention(q, k, v, causal, window, cap, off)
    want = ref.attention_ref(q, k, v, causal, window, cap, off)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=1e-2 * float(want.float().abs().max()))
    vis = ref.attention_visible(sq, sk, causal, window, off, card).any(1)
    assert not bool(got[:, :, ~vis].any())        # no visible key: exactly 0
    assert torch.equal(got, flash_attn.flash_attention(q, k, v, causal,
                                                       window, cap, off))


@pytest.mark.cuda
@pytest.mark.parametrize("d,dv", flash_attn.QK_V_DIMS)
@pytest.mark.parametrize("hkv", [4, 1])
def test_flash_attention_bf16_prefill_reads_a_cache_view(card, d, dv, hkv):
    """K and V sliced from caches of 512 rows (the tensor map takes the
    views' head and batch strides; one KV head too), every instance."""
    gen = torch.Generator(device=card).manual_seed(11 + d + hkv)
    rnd = lambda *s: torch.randn(*s, device=card, generator=gen).to(
        torch.bfloat16)
    k = rnd(2, hkv, 512, d)[:, :, :200]     # (B, Hkv, S_max, D) caches
    v = rnd(2, hkv, 512, dv)[:, :, :200]
    assert not k.is_contiguous() and flash_attn._tma_ok(k)
    q = rnd(2, 8, 96, d)
    got = flash_attn.flash_attention(q, k, v, True, 64, 50.0, 104)
    want = ref.attention_ref(q, k, v, True, 64, 50.0, 104)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=1e-2 * float(want.float().abs().max()))
    assert torch.equal(got, flash_attn.flash_attention(q, k, v, True, 64,
                                                       50.0, 104))


DECODE_CASES = [  # hq, hkv, sq, window, cap
    (4, 4, 1, 0, 0.0),          # group 1
    (8, 4, 1, 0, 50.0),         # group 2: gemma2-2b's global layers
    (8, 4, 1, 4096, 50.0),      # and its local ones
    (8, 1, 1, 96, 30.0),        # group 8
    (4, 2, 2, 0, 50.0),         # two queries a step
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,sq,window,cap", DECODE_CASES)
def test_flash_decode_kernel_equals_plain(card, monkeypatch, dtype, hq, hkv,
                                          sq, window, cap):
    """A cache of 6,176 rows (gemma2-2b's S_max), the queries at the end of
    the first 1, 63, 64, 65 and 6,176 keys; the rows past them hold data
    that must not count.  One grid for every length; a repeat, the same
    bits."""
    b, s_max, d = 2, 6176, 256
    gen = torch.Generator(device=card).manual_seed(hq * 10 + sq + window)
    rnd = lambda *s: torch.randn(*s, device=card, generator=gen).to(dtype)
    kc, vc = rnd(b, hkv, s_max, d), rnd(b, hkv, s_max, d)
    splits = []
    real = flash_attn.decode_splits
    monkeypatch.setattr(flash_attn, "decode_splits",
                        lambda *a: splits.append(real(*a)) or splits[-1])
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for length in (1, 63, 64, 65, s_max):
        if length < sq:
            continue
        q = rnd(b, hq, sq, d)
        pos = torch.tensor(length - sq, device=card)
        before = flash_attn.flash_decode.launches
        got = flash_attn.flash_decode(q, kc, vc, pos, window, cap)
        assert flash_attn.flash_decode.launches == before + 1
        want = ref.decode_ref(q, kc, vc, pos, window, cap)
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=tol * float(want.float().abs().max()))
        assert torch.equal(got, flash_attn.flash_decode(q, kc, vc, pos,
                                                        window, cap))
    assert len(set(splits)) == 1 and splits[0] > 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_decode_row_without_visible_key_is_zero(card, dtype):
    """Window 4 at q_offset 10 over 6 keys: query i (position 10 + i) would
    see keys 7 + i .. 10 + i, none of which exist, so every row is exactly
    0; then a window that cuts the keys, against the plain version."""
    gen = torch.Generator(device=card).manual_seed(3)
    rnd = lambda *s: torch.randn(*s, device=card, generator=gen).to(dtype)
    q, k, v = rnd(1, 4, 3, 64), rnd(1, 2, 6, 64), rnd(1, 2, 6, 64)
    out = flash_attn.flash_attention(q, k, v, True, 4, 0.0, 10)
    assert torch.equal(out, torch.zeros_like(out))
    q, k, v = rnd(2, 8, 2, 64), rnd(2, 4, 40, 64), rnd(2, 4, 40, 64)
    out = flash_attn.flash_attention(q, k, v, True, 8, 50.0, 38)
    want = ref.attention_ref(q, k, v, True, 8, 50.0, 38)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), want.float(), rtol=0,
                               atol=tol * float(want.float().abs().max()))


@pytest.mark.cuda
def test_captured_decode_step_equals_eager(card):
    """Reduced gemma2 (bf16, 4 layers): a request whose decode steps replay
    a captured CUDA graph gives the eager request's tokens and every
    step's logits bit for bit; the graph launches the decode kernel once a
    layer per replay, counted."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve_tokens
    from repro_torch.lm import model as LM
    cfg = get_arch("gemma2-2b").reduced(n_layers=4, d_model=256, d_ff=512,
                                        vocab=1024, dtype="bfloat16")
    params = LM.init_params(cfg, torch.Generator(device=card).manual_seed(0),
                            device=card)
    tok = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab,
                                                         (2, 70)), device=card)
    eager = serve_tokens(cfg, params, tok, 9, graph=False)
    before = flash_attn.flash_decode.launches
    graphed = serve_tokens(cfg, params, tok, 9)
    assert graphed["graph_launches"] == {"flash_decode": 4}
    # 8 replays of 4 launches, and the warm-up step's 4
    assert flash_attn.flash_decode.launches == before + 4 * 9
    assert torch.equal(graphed["tokens"], eager["tokens"])
    assert all(torch.equal(a, b) for a, b in zip(graphed["logits"],
                                                 eager["logits"]))


MLA_CASES = [  # b, h, sq, sk, causal, q_offset
    (2, 8, 1, 1, True, 0),        # one token: the prefill kernel, not decode
    (1, 4, 13, 13, True, 0),      # Sq <= 16 with Hq = Hkv
    (2, 4, 16, 40, True, 24),     # 16 rows, a cache prefix before them
    (1, 8, 200, 200, True, 0),    # Sq > 16, off the 64-row tile
    (2, 2, 100, 1601, False, 0),  # non-causal, Sk off the 64-key block
    (2, 4, 129, 300, True, 171),  # off the 128-row tile and key block
    (1, 2, 257, 129, False, 0),   # Sk < Sq, both off the tiles
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,sq,sk,causal,off", MLA_CASES)
def test_flash_attention_mla_instance(card, dtype, b, h, sq, sk, causal, off):
    """MLA's (D, DV) = (192, 128) instance (qk_nope 128 + qk_rope 64,
    v_head_dim 128) against the plain version at Sq <= 16 and Sq > 16: the
    prefill kernels at every Sq, scale 1/sqrt(192), output (B, H, Sq, 128);
    the fp32 and bf16 gates; a repeat, the same bits."""
    gen = torch.Generator(device=card).manual_seed(b * sq + sk)
    rnd = lambda *s: torch.randn(*s, device=card, generator=gen).to(dtype)
    q, k, v = rnd(b, h, sq, 192), rnd(b, h, sk, 192), rnd(b, h, sk, 128)
    before = flash_attn.flash_attention.launches
    got = flash_attn.flash_attention(q, k, v, causal, 0, 0.0, off)
    assert flash_attn.flash_attention.launches == before + 1
    want = ref.attention_ref(q, k, v, causal, 0, 0.0, off)
    assert got.shape == (b, h, sq, 128) and got.dtype == dtype
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=tol * float(want.float().abs().max()))
    assert torch.equal(got, flash_attn.flash_attention(q, k, v, causal, 0,
                                                       0.0, off))


@pytest.mark.cuda
@pytest.mark.parametrize("dk,dv", [(16, 8), (192, 64), (128, 192), (160, 128)])
def test_flash_attention_without_instance_raises_on_card(card, dk, dv):
    """A (D, DV) the kernel has no instance for raises on CUDA tensors (the
    reduced tests' MLA widths 16/8 among them); no plain fallback."""
    q = torch.randn(1, 2, 20, dk, device=card)
    k = torch.randn(1, 2, 20, dk, device=card)
    v = torch.randn(1, 2, 20, dv, device=card)
    with pytest.raises(ValueError, match="instances for"):
        flash_attn.flash_attention(q, k, v, True, 0, 0.0, 0)
    with pytest.raises(ValueError, match="instances for"):
        flash_attn.flash_decode(q[:, :, :1], k, v,
                                torch.tensor(3, device=card), 0, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_captured_decode_equals_eager_for_every_arch(card, arch):
    """Every registry architecture at a reduced width in bf16 (head width
    64; deepseek's MLA at (192, 128); the vision model with 5 layers, so
    its cross-attention layer is in the stack) serves on the card: the
    graphed request gives the eager one's tokens and every step's logits
    bit for bit.  Among them rwkv6 and jamba carry recurrent state
    (``S``/``shift``/``cmix_shift``, ``conv``/``ssm``) that the graph's
    warm-up step would advance a second time; ``DecodeGraph`` restores it
    before the capture."""
    from repro_torch.launch.serve import context_stub, serve_tokens
    from repro_torch.lm import model as LM
    over = dict(n_layers=5 if arch == "llama-3.2-vision-90b" else 4,
                d_model=256, d_ff=512, vocab=1024, dtype="bfloat16")
    if ARCHS[arch].mla:
        over.update(qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128)
    cfg = ARCHS[arch].reduced(**over)
    params = LM.init_params(cfg, torch.Generator(device=card).manual_seed(0),
                            device=card)
    rng = np.random.default_rng(0)
    tok = torch.tensor(rng.integers(0, cfg.vocab, (2, 40)), device=card)
    ctx = context_stub(cfg, 2, rng, card)
    eager = serve_tokens(cfg, params, tok, 9, graph=False, context=ctx)
    graphed = serve_tokens(cfg, params, tok, 9, context=ctx)
    assert torch.equal(graphed["tokens"], eager["tokens"])
    assert all(torch.equal(a, b) for a, b in zip(graphed["logits"],
                                                 eager["logits"]))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [30, 62])
def test_attention_kernels_take_any_embedding_width(card, m):
    """M = 30 and 62 (not multiples of 4): the wrappers pad M, the
    LayerNorm kernels normalise over the true M; forward and force-path
    backward against the plain version, exact zeros at the masked slots."""
    n, k = 40, 82
    args, rnd = _stack_args(card, m, n, k, 0.4, m=m, h=64, layers=2)
    _edge_atoms(args[5])
    masked = args[5] == 0
    before = nbr_attn.nbr_attention_stack_fwd.launches
    out, stash = nbr_attn.nbr_attention_stack_fwd(*args, stash=True, heads=2)
    assert nbr_attn.nbr_attention_stack_fwd.launches == before + 1
    want, want_stash = ref.nbr_attention_stack_ref(*args, stash=True,
                                                   heads=2)
    assert out.shape == want.shape and stash.shape == want_stash.shape
    torch.testing.assert_close(out, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))
    torch.testing.assert_close(stash, want_stash, rtol=0,
                               atol=1e-4 * float(want_stash.abs().max()))
    assert not bool(out[masked].any())
    dout = rnd(n, k, m)
    got = nbr_attn.nbr_attention_stack_bwd(want_stash, *args[1:], dout,
                                           heads=2, param_grads=False)
    exp = ref.nbr_attention_stack_bwd_ref(want_stash, *args[1:], dout,
                                          heads=2)
    assert got[0].shape == (n, k, m)
    for a, b in zip(got[:5], exp[:5]):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))
        assert not bool(a[masked].any())
    # the force path through autograd: the forward's padded row stash
    leaves = [a.clone().requires_grad_(i < 5) for i, a in enumerate(args)]
    nbr_attn.nbr_attention_stack(*leaves, heads=2).backward(dout)
    for i in range(5):
        torch.testing.assert_close(leaves[i].grad, exp[i], rtol=0,
                                   atol=1e-4 * float(exp[i].abs().max()))


def _md_small(device, sp_skin=0.08):
    """The solvated 5-residue protein, marked, with a DPA-1 provider
    (``sel=32``, weights from seed 0 made on the CPU) on ``device``."""
    from repro_torch.core import DeepmdForceProvider
    from repro_torch.dp import DPModel, paper_dpa1_config
    from repro_torch.md import build_solvated_protein, mark_nn_group
    system, pos, nn = build_solvated_protein(5, 1.5, device=device)
    system = mark_nn_group(system, nn)
    cfg = paper_dpa1_config(ntypes=4, rcut=0.6, sel=32)
    params = DPModel(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    params = _to(params, device)
    prov = DeepmdForceProvider(DPModel(cfg, device=device), params, nn,
                               system.types, system.box, system.n_atoms,
                               nbr_capacity=48, skin=sp_skin, device=device)
    return system, pos, prov


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _md_engine(device, **cfg):
    from repro_torch.md import EngineConfig, MDEngine
    system, pos, prov = _md_small(device)
    eng = MDEngine(system, EngineConfig(cutoff=0.9, neighbor_capacity=96,
                                        dt=0.0005, thermostat_t=200.0, **cfg),
                   special_force=prov)
    return eng, pos


def _md_run(device, n, **cfg):
    eng, pos = _md_engine(device, **cfg)
    return eng.run(eng.init_state(pos, 200.0), n)


def _same_state(a, b):
    return all(torch.equal(getattr(a, k), getattr(b, k))
               for k in ("positions", "velocities", "forces", "step"))


@pytest.mark.cuda
def test_md_engine_card_equals_cpu(card):
    import dataclasses
    eng_card, pos = _md_engine(card)
    st0 = eng_card.init_state(pos, 200.0)
    eng_cpu, _ = _md_engine("cpu")
    # the card's Maxwell-Boltzmann draw carried to the CPU
    st0_cpu = dataclasses.replace(
        st0, rng=torch.Generator().manual_seed(0).get_state(),
        **{k: getattr(st0, k).cpu()
           for k in ("positions", "velocities", "forces", "step")})
    got, want = eng_card.run(st0, 10), eng_cpu.run(st0_cpu, 10)
    assert bool(torch.isfinite(got.positions).all())
    assert eng_card.diagnostics == eng_cpu.diagnostics
    torch.testing.assert_close(got.positions.cpu(), want.positions, rtol=0,
                               atol=1e-5)


@pytest.mark.cuda
def test_md_engine_scan_equals_step_and_repeats_on_card(card):
    a = _md_run(card, 12)
    b = _md_run(card, 12)
    c = _md_run(card, 12, loop_mode="step")
    assert _same_state(a, b) and _same_state(a, c)


@pytest.mark.cuda
def test_md_engine_peak_memory_stays_at_the_first_window(card):
    eng, pos = _md_engine(card)
    st = eng.init_state(pos, 200.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    st = eng.run(st, 10)
    first = torch.cuda.max_memory_allocated()
    eng.run(st, 20)
    assert torch.cuda.max_memory_allocated() <= 1.01 * first


def _classical(device, capacity=96):
    from repro_torch.md import build_neighbor_list, build_solvated_protein
    from repro_torch.md.forcefield import ForceFieldConfig, classical_forces
    system, pos, _ = build_solvated_protein(40, device=device)
    nl = build_neighbor_list(pos, system.box, 0.9, capacity, half=True,
                             skin=0.1)
    return lambda: classical_forces(pos, system, nl,
                                    ForceFieldConfig(cutoff=0.9)), nl


@pytest.mark.cuda
def test_classical_gathers_launch_the_force_scatter(card):
    from torch.profiler import ProfilerActivity, profile
    fn, nl = _classical(card)
    before = fs.force_scatter.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        e, f = fn()
        torch.cuda.synchronize()
    # bond, angle and dihedral one scatter each, and one for the pair
    # table LJ and Coulomb share
    assert fs.force_scatter.launches == before + 4
    names = [ev.name for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA]
    assert names and not any("indexing_backward" in n for n in names)
    assert torch.equal(fn()[1], f)
    fn_cpu, nl_cpu = _classical("cpu")
    assert torch.equal(nl.idx.cpu(), nl_cpu.idx)
    f_cpu = fn_cpu()[1]
    torch.testing.assert_close(f.cpu(), f_cpu, rtol=0,
                               atol=1e-5 * float(f_cpu.abs().max()))


@pytest.mark.cuda
def test_classical_forces_do_not_depend_on_capacity_on_card(card):
    assert torch.equal(_classical(card, 96)[0]()[1],
                       _classical(card, 384)[0]()[1])


@pytest.mark.cuda
def test_pme_on_card_equals_cpu(card):
    """The PME charge mesh (the ordered force scatter of 320,000 stencil
    entries) equal to the CPU's bit for bit; the reciprocal energy and its
    forces against the CPU (rtol 1e-5, atol 1e-5 x max|F|: the FFTs differ)
    and bit for bit on a repeat."""
    from repro_torch.md import pme
    rng = np.random.default_rng(4)
    box = np.array([2.0, 2.5, 3.0], np.float32)
    pos = (rng.uniform(0, 1, (5000, 3)) * box).astype(np.float32)
    q = rng.uniform(-1, 1, 5000).astype(np.float32)

    def run(device):
        p = torch.tensor(pos, device=device, requires_grad=True)
        qq, bb = torch.tensor(q, device=device), torch.tensor(box,
                                                              device=device)
        mesh = pme.charge_spread(p.detach(), qq, bb, (16, 16, 16))
        e = pme.pme_reciprocal_energy(p, qq, bb, (16, 16, 16), 4, 3.0)
        (g,) = torch.autograd.grad(e, p)
        return mesh, e.detach(), -g

    before = fs.force_scatter.launches
    mesh, e, f = run(card)
    assert fs.force_scatter.launches > before
    again = run(card)
    assert all(torch.equal(a, b) for a, b in zip((mesh, e, f), again))
    mesh_cpu, e_cpu, f_cpu = run("cpu")
    assert torch.equal(mesh.cpu(), mesh_cpu)
    torch.testing.assert_close(e.cpu(), e_cpu, rtol=1e-5, atol=0)
    torch.testing.assert_close(f.cpu(), f_cpu, rtol=0,
                               atol=1e-5 * float(f_cpu.abs().max()))


# -- guarded MD: NaN recovery and checkpoint restart on the card ---------------

def _guarded_md(device, ranks=0, hook=None, residues=20):
    """The solvated 20-residue protein (326 atoms, 80 in the DP group),
    marked, with the paper's DPA-1 (``sel=32``, weights from seed 0 made on
    the CPU) on one domain (skin 0.08) or ``ranks`` virtual ranks (skin
    0.04, ``fault_hook`` threaded in)."""
    from repro_torch.core import DeepmdForceProvider, suggest_config
    from repro_torch.dp import DPModel, paper_dpa1_config
    from repro_torch.md import build_solvated_protein, mark_nn_group
    system, pos, nn = build_solvated_protein(residues, device=device)
    system = mark_nn_group(system, nn)
    cfg = paper_dpa1_config(ntypes=4, rcut=0.6, sel=32)
    params = _to(DPModel(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0)), device)
    box = system.box.cpu().numpy()
    dd = None
    if ranks:
        dd = suggest_config(len(nn), box, ranks, 0.6, nbr_capacity=48,
                            slack=2.5, skin=0.04, force_mode="ghost_reduce",
                            coords=pos.cpu().numpy()[nn])
    prov = DeepmdForceProvider(DPModel(cfg, device=device), params, nn,
                               system.types, box, system.n_atoms,
                               nbr_capacity=48, skin=0.08, dd_config=dd,
                               device=device, fault_hook=hook)
    return system, pos, prov


def _guarded_run(device, n, mode="scan", ranks=0, plan=None, guard=False,
                 **cfg):
    from repro_torch.health import GuardConfig
    from repro_torch.md import EngineConfig, MDEngine
    hook = plan.pipeline_hook() if plan is not None and ranks else None
    system, pos, prov = _guarded_md(device, ranks, hook)
    eng = MDEngine(system, EngineConfig(cutoff=0.9, neighbor_capacity=96,
                                        dt=0.0005, thermostat_t=200.0,
                                        loop_mode=mode, **cfg),
                   special_force=prov, faults=plan,
                   guard=GuardConfig(enabled=guard))
    return eng, eng.run(eng.init_state(pos, 200.0), n)


@pytest.mark.cuda
@pytest.mark.parametrize("ranks", [0, 8])
@pytest.mark.parametrize("mode", ["scan", "step"])
def test_guarded_md_nan_recovers_bitwise_on_card(card, mode, ranks):
    """An engine-level ``nan_force`` (and on 8 ranks a rank-3 one through
    the pipeline's fault hook) inside a window: the rest of the window runs
    every kernel on non-finite positions, the guard trips, and the replay
    equals the fault-free run bit for bit."""
    from repro_torch import kernels
    from repro_torch.health import FaultPlan, FaultSpec
    _, ref_st = _guarded_run(card, 8, mode, ranks)
    specs = [FaultSpec("nan_force", step=3)]
    if ranks:
        specs.append(FaultSpec("nan_force", step=3, rank=3))
    for spec in specs:
        plan = FaultPlan([spec])
        kernels.reset_launch_counts()
        eng, out = _guarded_run(card, 8, mode, ranks, plan, guard=True)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert plan.faults[0].fired
        assert eng.diagnostics["guard_trips"] == 1
        assert eng.diagnostics["guard_rollbacks"] == 1
        assert _same_state(out, ref_st), spec
        want = ("env_mat_fwd", "env_mat_bwd", "nbr_attention_stack_fwd",
                "nbr_attention_stack_bwd", "force_scatter") + (
            ("cell_filter",) if ranks else ())
        assert all(counts[k] > 0 for k in want), counts


@pytest.mark.cuda
def test_guards_quiet_and_checkpoint_restart_on_card(card, tmp_path):
    """Guards on and quiet == unguarded; checkpoints every 4 steps with the
    newest (step 8) truncated: the restore falls back to step 4, and 4 more
    steps from there on the card equal the uninterrupted 8, bit for bit."""
    import os
    import warnings
    from repro_torch.ckpt import AsyncCheckpointer
    from repro_torch.health import FaultPlan, FaultSpec
    from repro_torch.md import MDEngine
    from repro_torch.md.engine import state_tree
    _, ref_st = _guarded_run(card, 8)
    _, quiet = _guarded_run(card, 8, guard=True)
    assert _same_state(quiet, ref_st)
    plan = FaultPlan([FaultSpec("truncate_ckpt", step=8)])
    ck = AsyncCheckpointer(str(tmp_path), keep=5, fault_plan=plan)
    from repro_torch.md import EngineConfig
    system, pos, prov = _guarded_md(card)
    eng = MDEngine(system, EngineConfig(cutoff=0.9, neighbor_capacity=96,
                                        dt=0.0005, thermostat_t=200.0,
                                        checkpoint_every=4),
                   special_force=prov, checkpointer=ck)
    start = eng.init_state(pos, 200.0)
    full = eng.run(start, 8)
    assert _same_state(full, ref_st)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tree, step = ck.restore_latest(state_tree(start))
    assert plan.faults[0].fired and step == 4
    assert tree["positions"].device == start.positions.device
    mid = MDEngine.restore(os.path.join(str(tmp_path), "step_000000004"),
                           device=card)
    assert torch.equal(mid.positions, tree["positions"])
    assert mid.rng.device.type == "cpu"
    eng2 = MDEngine(system, EngineConfig(cutoff=0.9, neighbor_capacity=96,
                                         dt=0.0005, thermostat_t=200.0,
                                         checkpoint_every=4),
                    special_force=_guarded_md(card)[2])
    assert _same_state(eng2.run(mid, 4), ref_st)


@pytest.mark.cuda
def test_nonfinite_positions_stay_in_range_on_card(card):
    """The classical cell list, the DD assembly and evaluate (cells), and
    the PME spread at positions with NaN and Inf entries on the card: no
    device-side assert (which would poison the context for any rollback)."""
    from repro_torch.md import build_neighbor_list, pme
    system, pos, prov = _guarded_md(card, ranks=8)
    bad = pos.clone()
    bad[3] = float("nan")
    bad[7, 1] = float("inf")
    for x in (bad, torch.full_like(pos, float("nan"))):
        nl = build_neighbor_list(x, system.box, 0.9, 96, half=True, skin=0.1)
        st = prov.assemble(x)
        e, f, fl = prov.evaluate(x, st)
        q = pme.charge_spread(x, torch.ones(len(x), device=card), system.box,
                              (8, 8, 8))
        torch.cuda.synchronize()
        n = len(x)
        assert bool(((nl.idx >= -1) & (nl.idx < n)).all())
        assert f.shape == (n, 3) and q.shape == (8, 8, 8)
    # the context is still healthy
    assert float(torch.ones(4, device=card).sum()) == 4.0


@pytest.mark.cuda
def test_obs_profiler_capture_on_card(card, tmp_path):
    """An instrumented run on the card with ``xla_trace_dir``: the
    ``torch.profiler`` trace holds the engine's spans and device kernels,
    and the run's bits equal an uninstrumented run's."""
    import json
    from repro_torch.md import EngineConfig, MDEngine
    from repro_torch.obs import ObsConfig
    system, pos, prov = _guarded_md(card)
    _, ref_st = _guarded_run(card, 4)
    eng = MDEngine(system, EngineConfig(cutoff=0.9, neighbor_capacity=96,
                                        dt=0.0005, thermostat_t=200.0),
                   special_force=prov,
                   obs=ObsConfig(enabled=True, xla_trace_dir=str(tmp_path)))
    st = eng.run(eng.init_state(pos, 200.0), 4)
    assert _same_state(st, ref_st)
    events = json.load(open(tmp_path / "torch_trace.json"))["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"build", "scan_window"} <= names
    assert any(e.get("cat") == "kernel" for e in events)


@pytest.mark.cuda
def test_env_mat_second_derivative_raises_on_card(card):
    """The env matrix's backward is a kernel whose result carries no graph:
    a backward asked to build one (``create_graph=True``) raises on the
    card, as on the CPU."""
    from repro_torch.kernels import env_mat
    gen = torch.Generator(device=card).manual_seed(4)
    d = [(0.3 * torch.randn(64, 24, device=card, generator=gen))
         .requires_grad_(True) for _ in range(3)]
    mask = torch.ones(64, 24, device=card)
    s = sum(p.sum() for p in env_mat.env_mat(*d, mask, 0.3, 0.6))
    with pytest.raises(RuntimeError, match="env_mat is differentiable once"):
        torch.autograd.grad(s, d, create_graph=True)


def _train_example(device, frames=32, atoms=24, sel=16):
    """A narrow DPA-1 and its oracle data, split 0.25, on ``device``."""
    from repro_torch.data import make_dataset
    from repro_torch.dp import DescriptorConfig, DPConfig, DPModel
    from repro_torch.dp import fit_env_stats
    data = make_dataset(frames, n_atoms=atoms, seed=0, device="cpu")
    tr, va = data.split(0.25)
    cfg = DPConfig(descriptor=DescriptorConfig(
        kind="dpa1", rcut=0.6, rcut_smth=0.3, sel=sel, ntypes=4,
        neuron=(8, 16), axis_neuron=4, attn_layers=2, attn_hidden=32,
        attn_heads=2), fitting_neuron=(24, 24))
    model = DPModel(cfg, fit_env_stats(cfg, tr, device="cpu"), device=device)
    return tr, va, model


@pytest.mark.cuda
def test_training_step_on_card_equals_cpu(card):
    """Two training steps (the second-order route) on the card against the
    port on the CPU from the same parameters and batches: the loss rtol
    1e-5 and each gradient leaf atol 2e-5 x max|leaf| (the CPU tests'
    gates against JAX); a step launches the force scatter once and no
    model kernel; ``force_rmse`` (the kernel route) launches each
    single-domain kernel once per 16 frames."""
    from repro_torch import kernels
    from repro_torch.dp.train import (TrainConfig, batch_indices, force_rmse,
                                      make_train_step, prepare_batches)
    from repro_torch.optim import adam, exponential_decay
    from repro_torch.optim.adam import tree_leaves, tree_map
    tr, _, model = _train_example(card)
    cfg = TrainConfig(batch_size=4, lr0=2e-3)
    arrays = prepare_batches(tr, 0.6, 16, "cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    out = {}
    for dev in ("cpu", "cuda"):
        m = type(model)(model.cfg, model.stats, device=dev)
        lr_fn = exponential_decay(cfg.lr0, cfg.decay_steps, cfg.decay_rate)
        opt = adam(lr_fn)
        step_fn = make_train_step(m, cfg, lr_fn, opt)
        p = tree_map(lambda t: t.to(dev), params)
        st = opt.init(p)
        arr = {k: v.to(dev) for k, v in arrays.items()}
        rec = []
        for step in range(2):
            sel = torch.as_tensor(batch_indices(cfg, len(tr.energies), step),
                                  device=dev)
            kernels.reset_launch_counts()
            p, st, loss, _, _, grads = step_fn(
                p, st, {k: v[sel] for k, v in arr.items()},
                torch.tensor(step, dtype=torch.int32, device=dev))
            torch.cuda.synchronize()
            rec.append((float(loss), [g.cpu() for g in tree_leaves(grads)],
                        kernels.launch_counts()))
        out[dev] = (rec, m, p, arr)
    for (lc, gc, _), (lg, gg, counts) in zip(out["cpu"][0], out["cuda"][0]):
        assert abs(lg - lc) <= 1e-5 * abs(lc)
        for a, b in zip(gg, gc):
            torch.testing.assert_close(a, b, rtol=0,
                                       atol=2e-5 * float(b.abs().max()))
        assert counts["force_scatter"] == 1
        assert all(counts[k] == 0 for k in (
            "env_mat_fwd", "env_mat_bwd", "nbr_attention_stack_fwd",
            "nbr_attention_stack_bwd", "cell_filter"))
    _, m, p, arr = out["cuda"]
    kernels.reset_launch_counts()
    rmse = force_rmse(m, p, arr, 32)
    counts = kernels.launch_counts()
    chunks = -(-min(32, len(tr.energies)) // 16)
    assert np.isfinite(rmse)
    for k in ("env_mat_fwd", "env_mat_bwd", "nbr_attention_stack_fwd",
              "nbr_attention_stack_bwd", "force_scatter"):
        assert counts[k] == chunks


@pytest.mark.cuda
def test_training_restart_on_card_bitwise(card, tmp_path):
    """``train`` on the card, 6 steps with a checkpoint at step 3: a run
    restored from it ends with the uninterrupted run's parameters and
    last record, bit for bit."""
    import shutil
    from repro_torch.dp import TrainConfig, train
    from repro_torch.optim.adam import tree_leaves
    tr, va, model = _train_example(card)
    cfg = dict(n_steps=6, eval_every=5, batch_size=4, lr0=2e-3,
               checkpoint_every=3)
    full, hist = train(model, tr, va, TrainConfig(
        **cfg, checkpoint_dir=str(tmp_path / "a")))
    shutil.copytree(tmp_path / "a" / "step_000000003",
                    tmp_path / "b" / "step_000000003")
    resumed, hist_b = train(model, tr, va, TrainConfig(
        **cfg, checkpoint_dir=str(tmp_path / "b")))
    assert hist_b[-1] == dict(hist[-1], wall_s=hist_b[-1]["wall_s"])
    for a, b in zip(tree_leaves(resumed), tree_leaves(full)):
        assert torch.equal(a, b)


# -- LM training: the attention's autograd Function and the train step --

# (hq, hkv, sq, sk, d, dv, causal, window, softcap, q_offset)
LM_TRAIN_CASES = [
    (8, 2, 200, 200, 64, 64, True, 0, 0.0, 0),       # GQA, Sq off the tiles
    (4, 4, 96, 160, 128, 128, True, 48, 50.0, 64),   # window, softcap, offset
    (4, 2, 64, 64, 32, 32, False, 0, 0.0, 0),        # not causal
    (2, 2, 12, 12, 192, 128, True, 0, 0.0, 0),       # MLA's (192, 128)
    (4, 2, 3, 40, 64, 64, True, 0, 0.0, 37),         # 6 rows per KV head
    (4, 2, 16, 20, 256, 256, True, 4, 0.0, 10),      # rows with no key
    (12, 2, 130, 300, 128, 128, True, 0, 0.0, 170),  # group 6, ragged tiles
    (6, 1, 257, 257, 32, 32, True, 96, 50.0, 0),     # group 6, window, cap
    (2, 2, 16, 129, 192, 128, False, 0, 50.0, 0),    # MLA, 16 rows, softcap
]


def _lm_train_inputs(card, dtype, case, seed=0):
    hq, hkv, sq, sk, d, dv = case[:6]
    g = torch.Generator(device=card).manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g, device=card).to(dtype)
    return (mk(2, hq, sq, d).requires_grad_(), mk(2, hkv, sk, d).requires_grad_(),
            mk(2, hkv, sk, dv).requires_grad_(), mk(2, hq, sq, dv))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", LM_TRAIN_CASES)
def test_flash_attention_function_on_card_equals_autograd(card, dtype, case):
    """``ops.FlashAttention`` (the kernel's forward with its LSE, the plain
    chunked backward) against autograd through ``attention_ref``: output
    atol 1e-4 x max (fp32) / 1e-2 x max (bf16: the kernel rounds P to
    bf16), dq/dk/dv atol 1e-4 x max (fp32) / 2e-2 x max (bf16: the
    backward's delta = rowsum(dO o) reads that output); one launch a
    forward; a repeat the same bits."""
    from repro_torch.kernels import ops
    q, k, v, do = _lm_train_inputs(card, dtype, case)
    args = case[6:]
    before = flash_attn.flash_attention.launches
    out = ops.attention_op(q, k, v, *args)
    assert flash_attn.flash_attention.launches == before + 1
    got = (out.detach(), *torch.autograd.grad(out, (q, k, v), do))
    again = ops.attention_op(q, k, v, *args)
    again = (again.detach(), *torch.autograd.grad(again, (q, k, v), do))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = ref.attention_ref(q, k, v, *args)
    want = (want.detach(), *torch.autograd.grad(want, (q, k, v), do))
    tols = (1e-4, 1e-4) if dtype == torch.float32 else (1e-2, 2e-2)
    for i, (a, b) in enumerate(zip(got, want)):
        tol = tols[min(i, 1)]
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=tol * float(b.float().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", LM_TRAIN_CASES)
def test_flash_attention_lse_keeps_serving_bits(card, dtype, case):
    """The prefill kernels with the LSE give the output bits of the serving
    call wherever that call takes them too (the 6-row case goes to the
    decode kernel when no LSE is asked: there both are held to the plain
    version); the LSE against ``attention_lse_ref`` (atol 1e-4 x
    max(|lse|, 1)), -inf exactly at the rows with no visible key."""
    hq, hkv, sq, sk, d, dv = case[:6]
    args = case[6:]
    q, k, v, _ = (t.detach() for t in _lm_train_inputs(card, dtype, case))
    out, lse = flash_attn.flash_attention(q, k, v, *args, return_lse=True)
    serve = flash_attn.flash_attention(q, k, v, *args)
    if d != dv or (hq // hkv) * sq > flash_attn.DECODE_ROWS:
        assert torch.equal(out, serve)
    plain = ref.attention_ref(q, k, v, *args).float()
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for o in (out, serve):
        torch.testing.assert_close(o.float(), plain, rtol=0,
                                   atol=tol * float(plain.abs().max()))
    want = ref.attention_lse_ref(q, k, *args)
    fin = torch.isfinite(want)
    assert lse.dtype == torch.float32 and lse.shape == want.shape
    assert torch.equal(torch.isfinite(lse), fin)
    assert bool((lse[~fin] == float("-inf")).all())
    if fin.any():
        torch.testing.assert_close(
            lse[fin], want[fin], rtol=0,
            atol=1e-4 * max(1.0, float(want[fin].abs().max())))


def _reduced_lm(name, dtype="float32", n_layers=4):
    """A registry arch at a width the kernel has heads for (d_model 256: 4
    heads of 64; MLA 128 + 64 and 128)."""
    over = dict(n_layers=n_layers, d_model=256, d_ff=512, vocab=512,
                dtype=dtype)
    if ARCHS[name].mla:
        over.update(qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128)
    return ARCHS[name].reduced(**over)


@pytest.mark.cuda
def test_lm_train_step_on_card_equals_cpu(card):
    """qwen2 at the reduced width (2 layers, fp32, B 2 x 32): two steps on
    the card against the CPU from the same parameters and batches: the
    metrics within 1e-4 x |cpu|; Adam's first moment after each step leaf
    by leaf within 1e-4 x max|cpu leaf|; the parameters after step 1
    within 1e-4 x max|cpu leaf| plus what that gradient gate allows Adam's
    first step (-lr g / (|g| + eps)) to make of it; 2 flash_attention
    launches a step forward, 2 more recomputing (remat)."""
    from repro_torch import kernels
    from repro_torch.launch.train import make_batch
    from repro_torch.lm import model as LM
    from repro_torch.lm import train_lib as TL
    from repro_torch.optim.adam import tree_leaves, tree_map
    cfg = _reduced_lm("qwen2-1.5b", n_layers=2)
    params = LM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    hp = TL.TrainHParams()
    rec = {}
    for dev in ("cpu", "cuda"):
        step, opt = TL.make_train_step(cfg, hp)
        p = tree_map(lambda t: t.to(dev), params)
        st = opt.init(p)
        rec[dev] = []
        for i in range(2):
            kernels.reset_launch_counts()
            p, st, m = step(p, st, make_batch(cfg, i, 2, 32, dev))
            rec[dev].append(({k: float(v) for k, v in m.items()},
                             [t.cpu() for t in tree_leaves(st["m"])],
                             [t.cpu() for t in tree_leaves(p)],
                             kernels.launch_counts()))
    for i, (c, g) in enumerate(zip(rec["cpu"], rec["cuda"])):
        for key, want in c[0].items():
            assert abs(g[0][key] - want) <= 1e-4 * abs(want), (i, key)
        for a, b in zip(g[1], c[1]):
            torch.testing.assert_close(a, b, rtol=0,
                                       atol=1e-4 * float(b.abs().max()))
        assert g[3]["flash_attention"] == 4
        assert sum(g[3].values()) == 4
    for got, want, m1 in zip(rec["cuda"][0][2], rec["cpu"][0][2],
                             rec["cpu"][0][1]):
        gabs = m1.double().abs() / 0.1                     # |clipped g|
        d = 1e-4 * float(gabs.max())
        amp = hp.lr * d * 1e-8 / ((gabs - d).clamp_min(0) + 1e-8) ** 2
        err = (got.double() - want.double()).abs()
        assert bool((err <= 1e-4 * float(want.abs().max()) + amp).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_lm_train_step_repeats_bitwise_on_card(card, name):
    """Every registry arch at the reduced width in bf16 (B 2 x 32), under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``: no op of
    a step warns that it has no deterministic implementation (cuBLAS's
    workspace notice aside: it concerns several streams, a step runs on
    one), and the step run twice from one state gives the same bits
    (the restart gate of ``launch.train`` rests on it)."""
    import warnings
    from repro_torch.launch.train import make_batch
    from repro_torch.lm import model as LM
    from repro_torch.lm import train_lib as TL
    from repro_torch.optim.adam import tree_leaves
    n_layers = 5 if name == "llama-3.2-vision-90b" else 4
    cfg = _reduced_lm(name, "bfloat16", n_layers)
    params = LM.init_params(cfg, torch.Generator(device=card).manual_seed(0),
                            card)
    step, opt = TL.make_train_step(cfg, TL.TrainHParams())
    st = opt.init(params)
    batch = make_batch(cfg, 0, 2, 32, card)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            runs = [step(params, st, batch) for _ in range(2)]
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    bad = [str(w.message) for w in caught
           if "deterministic" in str(w.message)
           and "CUBLAS_WORKSPACE_CONFIG" not in str(w.message)]
    assert not bad, bad
    (p0, s0, m0), (p1, s1, m1) = runs
    assert all(torch.isfinite(v) for v in m0.values())
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    for a, b in zip(tree_leaves((p0, s0)), tree_leaves((p1, s1))):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_step_count_on_card_equals_meta(card, name):
    """``launch/roofline.py::count_step`` of every registry arch's train
    step, prefill and decode step (reduced, bf16, B 2 x 32, decode at
    position 33 of a 40-token cache) on the card equals its count on
    ``meta`` exactly: FLOPs by op, bytes, the live-bytes peak and the flash
    kernels' formulas, though the card runs the kernels and ``meta`` runs
    no wrapper at all; the live-bytes peak also equals the card's
    ``max_memory_allocated`` above the inputs within 1%."""
    from repro_torch.launch.roofline import count_step
    from repro_torch.launch.train import make_batch
    from repro_torch.lm import model as LM
    from repro_torch.lm import serve_lib as SL
    from repro_torch.lm import train_lib as TL
    from repro_torch.optim.adam import tree_map
    n_layers = 5 if name == "llama-3.2-vision-90b" else 4
    cfg = _reduced_lm(name, "bfloat16", n_layers)
    params = LM.init_params(cfg, torch.Generator(device=card).manual_seed(0),
                            card)
    meta = lambda tree: tree_map(lambda t: torch.empty_like(t, device="meta"),
                                 tree)
    batch = make_batch(cfg, 0, 2, 32, card)
    step, opt = TL.make_train_step(cfg, TL.TrainHParams())
    ctx = batch.get("context")
    prefill, serve = SL.make_prefill(cfg, max_len=40), SL.make_serve_step(cfg)
    calls = {"train": (step, (params, opt.init(params), batch),
                       (meta(params), opt.init(meta(params)), meta(batch))),
             "prefill": (prefill, (params, batch["tokens"], ctx),
                         (meta(params), meta(batch["tokens"]),
                          None if ctx is None else meta(ctx)))}
    outs = {}
    for what, (fn, args, meta_args) in calls.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got, outs[what] = count_step(fn, *args)
        torch.cuda.synchronize()
        above = torch.cuda.max_memory_allocated() - base
        want, outs["meta_" + what] = count_step(fn, *meta_args)
        assert got.to_dict() == want.to_dict(), what
        assert abs(above - got.live_peak_bytes) <= 0.01 * above, what
    logits, cache = outs["prefill"]
    tok = logits[:, -1:].argmax(-1)
    got = count_step(serve, params, cache, tok,
                     torch.tensor(33, device=card), positions=33)[0]
    want = count_step(serve, meta(params), outs["meta_prefill"][1],
                      meta(tok), torch.empty((), dtype=torch.int64,
                                             device="meta"), positions=33)[0]
    assert got.to_dict() == want.to_dict()
