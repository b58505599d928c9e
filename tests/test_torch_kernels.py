"""Kernel-module parity: the port's plain versions (what the CPU runs, and
what the Hopper kernels are held to on the card) against the JAX package —
its jnp references and its Pallas kernels in interpret mode — on the same
numpy-seeded inputs.

Tolerances: env_mat forward rtol 1e-5 (atol 1e-6 x max absorbs the
cancellation in the switch polynomial near rcut); env_mat backward
rtol 2e-4 / atol 5e-5 (rsqrt-vs-sqrt jitter at the cutoff, as JAX's own
test); attention forward rtol 1e-5 / atol 1e-5 x max|out|; attention
backward rtol 1e-4 / atol 1e-5 x max|grad| per output.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ops import env_mat_op as j_env_mat_op
from repro.kernels.ops import nbr_attention_stack_op as j_stack_op
from repro_torch import kernels
from repro_torch.kernels import env_mat as t_env_mat
from repro_torch.kernels import nbr_attn as t_nbr_attn
from repro_torch.kernels import ref as tref

# small CPU tensors: one intra-op thread keeps parallel test workers
# from oversubscribing the cores
torch.set_num_threads(1)

RCUT_SMTH, RCUT = 0.2, 0.6
T = torch.tensor


def _close(a, b, rtol, atol_rel=0.0, atol=0.0, msg=""):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=atol + atol_rel * float(np.abs(b).max()),
                               err_msg=msg)


# ---------------------------------------------------------------------------
# env_mat
# ---------------------------------------------------------------------------

def _env_inputs(seed, n=12, k=40):
    rng = np.random.default_rng(seed)
    dx, dy, dz = (rng.normal(0, 0.3, (n, k)).astype(np.float32)
                  for _ in range(3))
    mask = (rng.random((n, k)) > 0.3).astype(np.float32)
    mask[5] = 0.0                                     # fully masked row
    dx[0, 0] = dy[0, 0] = dz[0, 0] = 0.0              # coincident valid pair
    mask[0, 0] = 1.0
    cts = [rng.normal(size=(n, k)).astype(np.float32) for _ in range(4)]
    return dx, dy, dz, mask, cts


@pytest.fixture(scope="module")
def env_jax():
    """JAX references, computed once: jnp forward, Pallas forward and the
    Pallas VJP (interpret mode on the CPU)."""
    dx, dy, dz, mask, cts = _env_inputs(3)
    jx = [jnp.asarray(a) for a in (dx, dy, dz, mask)]
    pal = lambda *a: j_env_mat_op(*a, RCUT_SMTH, RCUT, use_pallas=True,
                                  interpret=True)

    def loss(dx_, dy_, dz_):
        outs = pal(dx_, dy_, dz_, jx[3])
        return sum((o * c).sum() for o, c in zip(outs, cts))

    return dict(
        inputs=(dx, dy, dz, mask, cts),
        ref=[np.asarray(o) for o in jref.env_mat_ref(*jx, RCUT_SMTH, RCUT)],
        pallas=[np.asarray(o) for o in pal(*jx)],
        grad=[np.asarray(g) for g in jax.grad(loss, (0, 1, 2))(*jx[:3])])


@pytest.mark.parametrize("oracle", ["ref", "pallas"])
def test_env_mat_ref_matches_jax(env_jax, oracle):
    dx, dy, dz, mask, _ = env_jax["inputs"]
    outs = tref.env_mat_ref(T(dx), T(dy), T(dz), T(mask), RCUT_SMTH, RCUT)
    for name, a, b in zip(("s", "sx", "sy", "sz"), outs, env_jax[oracle]):
        _close(a, b, rtol=1e-5, atol_rel=1e-6, msg=name)


def test_env_mat_bwd_ref_matches_pallas_vjp(env_jax):
    dx, dy, dz, mask, cts = env_jax["inputs"]
    grads = tref.env_mat_bwd_ref(T(dx), T(dy), T(dz), T(mask),
                                 *map(T, cts), RCUT_SMTH, RCUT)
    for a, b in zip(grads, env_jax["grad"]):
        assert bool(torch.isfinite(a).all())
        _close(a, b, rtol=2e-4, atol=5e-5)
        assert float(a[5].abs().max()) == 0.0        # masked row exactly 0


def test_env_mat_autograd_uses_analytic_backward(env_jax):
    """Autograd through the op (CPU: plain forward + analytic backward)
    equals autograd through the plain forward alone."""
    dx, dy, dz, mask, cts = env_jax["inputs"]
    cts = list(map(T, cts))

    def grads(fn):
        xs = [T(a).requires_grad_(True) for a in (dx, dy, dz)]
        outs = fn(*xs, T(mask), RCUT_SMTH, RCUT)
        return torch.autograd.grad(sum((o * c).sum() for o, c in
                                       zip(outs, cts)), xs)

    for a, b in zip(grads(t_env_mat.env_mat), grads(tref.env_mat_ref)):
        _close(a, b, rtol=2e-4, atol=5e-5)
    assert kernels.launch_counts()["env_mat_bwd"] == 0   # CPU: no kernel


# ---------------------------------------------------------------------------
# nbr_attention_stack
# ---------------------------------------------------------------------------

ATTN_CASES = [(6, 16, 16, 32, 2, 1), (7, 12, 16, 32, 2, 2)]
GRAD_NAMES = "g rx ry rz sw wq wk wv wo gamma beta".split()


def _attn_inputs(seed, n, k, m, h, layers):
    rng = np.random.default_rng(seed)
    f = lambda *s, sd=1.0: rng.normal(0, sd, s).astype(np.float32)
    g = f(n, k, m)
    rx, ry, rz = f(n, k), f(n, k), f(n, k)
    sw = rng.random((n, k)).astype(np.float32)
    mask = (rng.random((n, k)) > 0.2).astype(np.float32)
    mask[1] = 0.0                                     # isolated atom
    w = [f(layers, m, h, sd=m ** -0.5) for _ in range(3)]
    w += [f(layers, h, m, sd=h ** -0.5), 1 + f(layers, m, sd=0.1),
          f(layers, m, sd=0.1)]
    ct = f(n, k, m)
    return [g, rx, ry, rz, sw, mask] + w, ct


@pytest.fixture(scope="module")
def attn_jax():
    """Per case: jnp forward, Pallas forward + VJP (interpret), bf16 jnp."""
    out = {}
    for case in ATTN_CASES:
        *shape, heads = case
        args, ct = _attn_inputs(sum(case), *shape)
        ja = [jnp.asarray(a) for a in args]
        mask = ja[5]

        def loss(*xs):
            full = list(xs[:5]) + [mask] + list(xs[5:])
            y = j_stack_op(*full, heads=heads, use_pallas=True, interpret=True)
            return (y * ct).sum()

        diff = ja[:5] + ja[6:]
        out[case] = dict(
            args=args, ct=ct,
            ref=np.asarray(jref.nbr_attention_stack_ref(*ja, heads=heads)),
            pallas=np.asarray(j_stack_op(*ja, heads=heads, use_pallas=True,
                                         interpret=True)),
            bf16=np.asarray(jref.nbr_attention_stack_ref(
                *ja, heads=heads, compute_dtype=jnp.bfloat16)),
            grad=[np.asarray(x) for x in
                  jax.grad(loss, tuple(range(11)))(*diff)])
    return out


@pytest.mark.parametrize("case", ATTN_CASES, ids=["heads1", "heads2"])
@pytest.mark.parametrize("oracle", ["ref", "pallas"])
def test_attention_stack_ref_matches_jax(attn_jax, case, oracle):
    r = attn_jax[case]
    out = tref.nbr_attention_stack_ref(*map(T, r["args"]), heads=case[-1])
    _close(out, r[oracle], rtol=1e-5, atol_rel=1e-5)
    assert float(out[1].abs().max()) == 0.0           # isolated atom: zeros


@pytest.mark.parametrize("case", ATTN_CASES, ids=["heads1", "heads2"])
def test_attention_stack_bf16_matches_jax(attn_jax, case):
    """bf16 operands: rounding points can flip by one bf16 ulp where fp32
    sums differ in their last bits, so the bound is 2e-2 x max|out|."""
    r = attn_jax[case]
    out = tref.nbr_attention_stack_ref(*map(T, r["args"]), heads=case[-1],
                                       compute_dtype="bfloat16")
    _close(out, r["bf16"], rtol=0.0, atol_rel=2e-2)


@pytest.mark.parametrize("case", ATTN_CASES, ids=["heads1", "heads2"])
def test_attention_stack_bwd_ref_matches_pallas_vjp(attn_jax, case):
    r = attn_jax[case]
    args = list(map(T, r["args"]))
    out, stash = tref.nbr_attention_stack_ref(*args, heads=case[-1],
                                              stash=True)
    grads = tref.nbr_attention_stack_bwd_ref(stash, *args[1:], T(r["ct"]),
                                             heads=case[-1])
    for name, a, b in zip(GRAD_NAMES, grads, r["grad"]):
        _close(a, b, rtol=1e-4, atol_rel=1e-5, msg=name)


@pytest.mark.parametrize("case", ATTN_CASES, ids=["heads1", "heads2"])
def test_attention_stack_bwd_ref_matches_torch_autograd(attn_jax, case):
    """The analytic backward equals autograd through the plain forward, and
    the op's autograd.Function (CPU) returns the same gradients."""
    r = attn_jax[case]
    heads = case[-1]

    def grads(fn):
        xs = [T(a).requires_grad_(i != 5) for i, a in enumerate(r["args"])]
        y = fn(*xs, heads=heads)
        diff = xs[:5] + xs[6:]
        return torch.autograd.grad((y * T(r["ct"])).sum(), diff)

    auto = grads(tref.nbr_attention_stack_ref)
    op = grads(t_nbr_attn.nbr_attention_stack)
    for name, a, b in zip(GRAD_NAMES, op, auto):
        _close(a, b, rtol=1e-4, atol_rel=1e-5, msg=name)


def test_attention_force_path_skips_param_grads():
    """With parameters that need no gradient (the MD force path) the
    backward returns none for them; the input gradients are unchanged."""
    case = ATTN_CASES[0]
    args, ct = _attn_inputs(1, *case[:-1])
    g = T(args[0]).requires_grad_(True)
    xs = [g] + list(map(T, args[1:]))
    y = t_nbr_attn.nbr_attention_stack(*xs)
    (dg,) = torch.autograd.grad((y * T(ct)).sum(), [g])
    stash = tref.nbr_attention_stack_ref(*map(T, args), stash=True)[1]
    res = t_nbr_attn.nbr_attention_stack_bwd(stash, *map(T, args[1:]), T(ct),
                                             param_grads=False)
    assert all(p is None for p in res[5:])
    _close(dg, res[0], rtol=1e-6)
    assert sum(kernels.launch_counts().values()) == 0  # CPU: no kernel
