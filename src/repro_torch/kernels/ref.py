"""Plain PyTorch versions of every kernel of the port (the correctness contract).

The CPU runs these (the kernel wrappers take them for CPU tensors), the tests
hold them against the JAX package, and ``chip_smoke.py`` holds each kernel
against them on the card.  The forward functions transcribe
``repro/kernels/ref.py``; the analytic backward functions transcribe the
Pallas backward kernels (``repro/kernels/env_mat.py::_env_mat_bwd_kernel``,
``repro/kernels/nbr_attn.py::_layer_bwd`` and the gate expansion of
``_stack_bwd_kernel``), so the formulas the CUDA/Triton backwards implement
are checked on the CPU even though the kernels cannot run there.
"""
from __future__ import annotations

import torch

# canonical zero-distance clamp: a valid coincident pair sits at r = 1e-6
# (dp.common.switch_fn's clamp); every env-matrix path shares it
R2_MIN = 1e-12
F32 = torch.float32
NEG = torch.finfo(torch.float32).min   # masked-key score (not -inf: no NaN)
LN_EPS = 1e-5


def round_operand(x: torch.Tensor, dtype) -> torch.Tensor:
    """Round an fp32 matmul operand to ``dtype`` (bf16) and back; None or
    fp32 leaves it as it is (``repro_torch.dp.precision`` has the policy)."""
    if dtype is None or dtype == torch.float32:
        return x
    return x.to(dtype).to(torch.float32)


# ---------------------------------------------------------------------------
# env_mat
# ---------------------------------------------------------------------------

def env_mat_ref(dx, dy, dz, mask, rcut_smth: float, rcut: float):
    """(s, s*x/r, s*y/r, s*z/r) planes from (N, K) displacement planes."""
    d2 = dx * dx + dy * dy + dz * dz
    # valid coincident pairs clamp to r = 1e-6; padded entries sit at r = 1
    d2 = torch.where(mask > 0, d2.clamp_min(R2_MIN), torch.ones_like(d2))
    r = torch.sqrt(d2)
    u = (r - rcut_smth) / (rcut - rcut_smth)
    uu = u.clamp(0.0, 1.0)
    poly = uu * uu * uu * (-6 * uu * uu + 15 * uu - 10) + 1.0
    one = torch.ones_like(r)
    sw = torch.where(r < rcut, (1.0 / r) * torch.where(r < rcut_smth, one, poly),
                     torch.zeros_like(r))
    sw = sw * mask
    return sw, sw * dx / r, sw * dy / r, sw * dz / r


def cutoff2(rcut: float, device=None) -> torch.Tensor:
    """The fp32 threshold ``rcut * rcut``: the square formed in double and
    rounded once, as JAX rounds a Python-float ``rcut * rcut`` against a
    float32 array."""
    return torch.tensor(rcut * rcut, dtype=F32, device=device)


def sq_dist(dx, dy, dz):
    """``dx*dx + dy*dy + dz*dz`` summed left to right: the d^2 every
    neighbour test of the port compares with its cutoff (the reference's
    order; the ``cell_filter`` kernel rounds each step the same way)."""
    return dx * dx + dy * dy + dz * dz


def cell_filter_ref(dx, dy, dz, valid, rcut: float):
    """{0, 1} plane ``d^2 < rcut^2 and valid`` over (C, M) displacement
    planes (d^2 from :func:`sq_dist`, threshold :func:`cutoff2`)."""
    d2 = sq_dist(dx, dy, dz)
    return ((d2 < cutoff2(rcut, dx.device)) & (valid > 0)).to(dx.dtype)


def _switch_parts(r, rcut_smth: float, rcut: float):
    """h(r) (the [0, 1] polynomial envelope) and h'(r), branch-free."""
    u = (r - rcut_smth) / (rcut - rcut_smth)
    uu = u.clamp(0.0, 1.0)
    poly = uu * uu * uu * (-6.0 * uu * uu + 15.0 * uu - 10.0) + 1.0
    zero = torch.zeros_like(r)
    h = torch.where(r < rcut, torch.where(r < rcut_smth, torch.ones_like(r),
                                          poly), zero)
    dpoly = -30.0 * uu * uu * (uu - 1.0) * (uu - 1.0) / (rcut - rcut_smth)
    hp = torch.where((r >= rcut_smth) & (r < rcut), dpoly, zero)
    return h, hp


def env_mat_bwd_ref(dx, dy, dz, mask, gs, gsx, gsy, gsz,
                    rcut_smth: float, rcut: float):
    """Analytic VJP of :func:`env_mat_ref`: 8 planes in, (ddx, ddy, ddz) out.

    With h the switch polynomial, s = h/r and q = h/r^2:
    ``d = x/r * (gs*s' + A*q') + q*gsx`` with ``A = gsx*x + gsy*y + gsz*z``.
    Below the clamp r does not depend on x, so the r-chain is zeroed there
    while the direct q*g term stays (huge but finite); padded entries get
    exactly zero.
    """
    d2_raw = dx * dx + dy * dy + dz * dz
    valid = mask > 0
    d2 = torch.where(valid, d2_raw.clamp_min(R2_MIN), torch.ones_like(dx))
    inv_r = torch.rsqrt(d2)
    r = d2 * inv_r
    inv_r2 = inv_r * inv_r
    h, hp = _switch_parts(r, rcut_smth, rcut)
    ds_dr = hp * inv_r - h * inv_r2
    dq_dr = hp * inv_r2 - 2.0 * h * inv_r2 * inv_r
    q = h * inv_r2
    a = gsx * dx + gsy * dy + gsz * dz
    zero = torch.zeros_like(dx)
    live = valid & (d2_raw > R2_MIN)
    chain = torch.where(live, (gs * ds_dr + a * dq_dr) * inv_r, zero)
    return (torch.where(valid, chain * dx + q * gsx, zero),
            torch.where(valid, chain * dy + q * gsy, zero),
            torch.where(valid, chain * dz + q * gsz, zero))


# ---------------------------------------------------------------------------
# nbr_attention_stack
# ---------------------------------------------------------------------------

def attn_scale(hd: int) -> torch.Tensor:
    """1/sqrt(head width), formed in fp32 as the JAX kernel forms it."""
    return 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=F32))


def gate_mul(rx, ry, rz, sw, mask):
    """(gate, gmul): angular gate r_hat.r_hat^T and the combined score
    multiplier gate x (sw x sw) x (mask x mask), each (N, K, K)."""
    gate = (rx[:, :, None] * rx[:, None, :] + ry[:, :, None] * ry[:, None, :]
            + rz[:, :, None] * rz[:, None, :])
    gmul = gate * (sw[:, :, None] * sw[:, None, :])
    return gate, gmul * (mask[:, :, None] * mask[:, None, :])


def _ln_cols(m: int, m_true, device):
    """None, or the (M,) mask of the true columns of a width padded from
    ``m_true`` to ``m`` (the LayerNorm's statistics run over those)."""
    if m_true is None or m_true == m:
        return None
    return torch.arange(m, device=device) < m_true


def _layer_core(g, gmul, mask, wq, wk, wv, wo, heads: int, cd, m_true=None):
    """Forward intermediates of one layer (forward and backward recompute).
    With ``m_true`` < M the embedding width is zero-padded (the CUDA
    kernels' layout): the LayerNorm's statistics run over the first
    ``m_true`` columns and xhat is 0 in the others."""
    b, k, m = g.shape
    h = wq.shape[-1]
    hd = h // heads
    rc = lambda x: round_operand(x, cd)
    gc = rc(g)
    q = (gc @ rc(wq)).reshape(b, k, heads, hd)
    kk = (gc @ rc(wk)).reshape(b, k, heads, hd)
    v = (gc @ rc(wv)).reshape(b, k, heads, hd)
    scale = attn_scale(hd)
    scores = torch.einsum("bkcd,blcd->bckl", rc(q), rc(kk)) * scale
    scores = torch.where(mask[:, None, None, :] > 0, scores,
                         torch.full_like(scores, NEG))
    p = torch.softmax(scores, dim=-1)
    w = p * gmul[:, None, :, :]
    o = torch.einsum("bckl,blcd->bkcd", rc(w), rc(v)).reshape(b, k, h)
    out = rc(o) @ rc(wo)
    g1 = g + out
    cols = _ln_cols(m, m_true, g.device)
    if cols is None:
        mu = g1.mean(-1, keepdim=True)
        var = ((g1 - mu) ** 2).mean(-1, keepdim=True)
    else:
        mu = g1[..., :m_true].mean(-1, keepdim=True)
        var = ((g1[..., :m_true] - mu) ** 2).mean(-1, keepdim=True)
    inv = torch.rsqrt(var + LN_EPS)
    xhat = (g1 - mu) * inv
    if cols is not None:
        xhat = torch.where(cols, xhat, torch.zeros((), device=g.device))
    return dict(q=q, kk=kk, v=v, p=p, w=w, o=o, inv=inv, xhat=xhat,
                scale=scale, cols=cols)


def nbr_attention_stack_ref(g, rx, ry, rz, sw, mask, wq, wk, wv, wo,
                            gamma, beta, heads: int = 1,
                            compute_dtype: str = "float32",
                            stash: bool = False, m_true=None):
    """l_a gated se_attention_v2 layers over the neighbour axis.

    g (N, K, M); rx/ry/rz/sw/mask (N, K); stacked params wq/wk/wv (L, M, H),
    wo (L, H, M), gamma/beta (L, M).  ``compute_dtype`` is the matmul operand
    type (bf16 operands, fp32 accumulation; softmax, gate, residual and layer
    norm stay fp32).  With ``stash=True`` returns (out, layer inputs
    (L, N, K, M)), the residuals the analytic backward consumes.  ``m_true``
    (< M) marks inputs zero-padded from that width as the CUDA kernels run
    them (``nbr_attn.pad_embedding``): the LayerNorm then normalises over
    the true columns and the padded ones stay 0.
    """
    h = wq.shape[-1]
    if h % heads:
        raise ValueError(f"attn_hidden {h} not divisible by heads {heads}")
    cd = torch.bfloat16 if compute_dtype == "bfloat16" else None
    _, gmul = gate_mul(rx, ry, rz, sw, mask)
    inputs = []
    for l in range(wq.shape[0]):
        inputs.append(g)
        c = _layer_core(g, gmul, mask, wq[l], wk[l], wv[l], wo[l], heads, cd,
                        m_true)
        g = (c["xhat"] * gamma[l] + beta[l]) * mask[..., None]
    if stash:
        return g, torch.stack(inputs)
    return g


def _layer_bwd(g_in, dg, gmul, mask, wq, wk, wv, wo, gamma, heads: int, cd,
               m_true=None):
    """Analytic backward of one layer (``repro/kernels/nbr_attn.py::
    _layer_bwd``): recomputes the forward, contracts in fp32."""
    c = _layer_core(g_in, gmul, mask, wq, wk, wv, wo, heads, cd, m_true)
    b, k, m = g_in.shape
    h = wq.shape[-1]
    hd = h // heads
    dln = dg * mask[..., None]
    dgamma = (dln * c["xhat"]).sum((0, 1))
    dbeta = dln.sum((0, 1))
    dxhat = dln * gamma
    if c["cols"] is None:
        mean = lambda t: t.mean(-1, keepdim=True)
    else:
        mean = lambda t: t[..., :m_true].mean(-1, keepdim=True)
    dg1 = c["inv"] * (dxhat - mean(dxhat) - c["xhat"] * mean(dxhat * c["xhat"]))
    if c["cols"] is not None:
        dg1 = torch.where(c["cols"], dg1, torch.zeros((), device=dg1.device))
    dwo = torch.einsum("bkh,bkm->hm", c["o"], dg1)
    do_h = (dg1 @ wo.T).reshape(b, k, heads, hd)
    dw = torch.einsum("bkcd,blcd->bckl", do_h, c["v"])
    dv = torch.einsum("bckl,bkcd->blcd", c["w"], do_h).reshape(b, k, h)
    dp = dw * gmul[:, None, :, :]
    dgmul = (dw * c["p"]).sum(1)
    ds = c["p"] * (dp - (dp * c["p"]).sum(-1, keepdim=True)) * c["scale"]
    dq = torch.einsum("bckl,blcd->bkcd", ds, c["kk"]).reshape(b, k, h)
    dk = torch.einsum("bckl,bkcd->blcd", ds, c["q"]).reshape(b, k, h)
    dwq = torch.einsum("bkm,bkh->mh", g_in, dq)
    dwk = torch.einsum("bkm,bkh->mh", g_in, dk)
    dwv = torch.einsum("bkm,bkh->mh", g_in, dv)
    dgin = dg1 + dq @ wq.T + dk @ wk.T + dv @ wv.T
    return dgin, dgmul, dwq, dwk, dwv, dwo, dgamma, dbeta


def nbr_attention_stack_bwd_ref(stash, rx, ry, rz, sw, mask, wq, wk, wv, wo,
                                gamma, beta, dout, heads: int = 1,
                                compute_dtype: str = "float32", m_true=None):
    """Analytic VJP of the stack from its layer-input stash (L, N, K, M).

    Returns (dg, drx, dry, drz, dsw, dwq, dwk, dwv, dwo, dgamma, dbeta), all
    fp32; the mask gets no cotangent.  ``m_true``: as in the forward (dg is
    0 in the padded columns).
    """
    cd = torch.bfloat16 if compute_dtype == "bfloat16" else None
    gate, gmul = gate_mul(rx, ry, rz, sw, mask)
    dg = dout
    dgmul_acc = torch.zeros_like(gmul)
    grads = [[None] * wq.shape[0] for _ in range(6)]
    for l in reversed(range(wq.shape[0])):
        dg, dgmul, *pg = _layer_bwd(stash[l], dg, gmul, mask, wq[l], wk[l],
                                    wv[l], wo[l], gamma[l], heads, cd, m_true)
        dgmul_acc = dgmul_acc + dgmul
        for acc, x in zip(grads, pg):
            acc[l] = x
    # gmul = gate * (sw x sw) * (mask x mask): expand the accumulated
    # cotangent onto the direction planes and the envelope
    mm = mask[:, :, None] * mask[:, None, :]
    swsw = sw[:, :, None] * sw[:, None, :]
    dgate = dgmul_acc * swsw * mm
    hsw = dgmul_acc * gate * mm
    dsw = (hsw * sw[:, None, :]).sum(2) + (hsw * sw[:, :, None]).sum(1)
    sym = dgate + dgate.transpose(1, 2)
    drx = (sym * rx[:, None, :]).sum(2)
    dry = (sym * ry[:, None, :]).sum(2)
    drz = (sym * rz[:, None, :]).sum(2)
    return (dg, drx, dry, drz, dsw) + tuple(torch.stack(a) for a in grads)


# ---------------------------------------------------------------------------
# blockwise (flash) attention of the LM substrate
# ---------------------------------------------------------------------------

ATTN_MASKED = -1e30   # masked score (the reference's)


def attention_visible(sq: int, sk: int, causal: bool, window: int,
                      q_offset: int, device=None) -> torch.Tensor:
    """(Sq, Sk) bool: key j is visible to query i (absolute position
    ``q_offset + i``) under the causal and window masks."""
    q_pos = q_offset + torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos >= k_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    return mask


def attention_ref(q, k, v, causal: bool = True, window: int = 0,
                  softcap: float = 0.0, q_offset: int = 0):
    """Dense attention with the GQA broadcast and fp32 accumulation
    (``repro/kernels/ref.py::attention_ref``): q (B, Hq, Sq, D), k
    (B, Hkv, Sk, D), v (B, Hkv, Sk, DV) with Hq % Hkv == 0, any Sq and Sk
    (DV may differ from D, as in MLA); scores scaled by 1/sqrt(D),
    optionally soft-capped; a row with no visible key gives 0.  Returns
    (B, Hq, Sq, DV) in q's dtype."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    group = hq // hkv
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(F32), k.to(F32)) / d ** 0.5
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    mask = attention_visible(sq, sk, causal, window, q_offset, q.device)
    s = torch.where(mask, s, torch.full((), ATTN_MASKED, device=q.device))
    w = torch.softmax(s, dim=-1)
    w = torch.where(mask.any(-1)[:, None], w, torch.zeros((), device=q.device))
    return torch.einsum("bhqk,bhkd->bhqd", w, v.to(F32)).to(q.dtype)


def attention_lse_ref(q, k, causal: bool = True, window: int = 0,
                      softcap: float = 0.0, q_offset: int = 0):
    """The log-sum-exp of each query row's visible scores in
    :func:`attention_ref` (scaled by 1/sqrt(D), soft-capped), fp32
    (B, Hq, Sq); -inf for a row with no visible key."""
    b, hq, sq, d = q.shape
    k = k.repeat_interleave(hq // k.shape[1], dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(F32), k.to(F32)) / d ** 0.5
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    mask = attention_visible(sq, k.shape[2], causal, window, q_offset,
                             q.device)
    s = torch.where(mask, s, torch.full((), float("-inf"), device=q.device))
    return torch.logsumexp(s, dim=-1)


def attention_bwd_ref(q, k, v, o, lse, do, causal: bool = True,
                      window: int = 0, softcap: float = 0.0,
                      q_offset: int = 0, chunk: int = 512):
    """The attention's backward (dq, dk, dv) from its forward output ``o``
    and row log-sum-exp ``lse`` (:func:`attention_lse_ref`, or the prefill
    kernels' ``return_lse``): the flash-attention backward as a plain
    recompute over KV chunks of ``chunk`` keys, the counterpart of the JAX
    LM's checkpointed chunk scan (``repro/lm/layers.py::chunked_attention``).

    Per chunk, in fp32, over the query rows that can see one of its keys
    (causal: from the chunk's first key on; window: up to its last key +
    window): the scores s from q and k (soft-capped as the forward caps
    them), P = exp(s - lse) at the visible pairs (0 elsewhere), dV = P^T dO,
    dP = dO V^T, dS = P (dP - rowsum(dO o)), times 1 - tanh^2 under the
    softcap, dQ += dS K, dK = dS^T Q, both scaled by 1/sqrt(D).  dK and dV
    of a KV head sum its GQA group's q heads in one product (a fixed
    order); dQ sums the chunks in order.  The transient is a few (B, Hq,
    rows, chunk) fp32 tensors: the (Sq, Sk) matrix is never formed.  A row
    with no visible key gives zero gradients.  Returns the grads in the
    inputs' dtypes."""
    b, hq, sq, d = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[3]
    g = hq // hkv
    scale = 1.0 / d ** 0.5
    qf = q.to(F32).reshape(b, hkv, g, sq, d)
    kf, vf = k.to(F32), v.to(F32)
    dof = do.to(F32).reshape(b, hkv, g, sq, dv)
    delta = (dof * o.to(F32).reshape(b, hkv, g, sq, dv)).sum(-1, keepdim=True)
    lse = lse.to(F32).reshape(b, hkv, g, sq, 1)
    lse = torch.where(torch.isfinite(lse), lse, 0.0)  # rows with no key
    vis = attention_visible(sq, sk, causal, window, q_offset, q.device)
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dvv = torch.zeros_like(vf)
    for c0 in range(0, sk, chunk):
        c1 = min(sk, c0 + chunk)
        r0 = max(0, c0 - q_offset) if causal else 0
        r1 = sq if window <= 0 else max(0, min(sq, c1 - 1 + window - q_offset))
        if r1 <= r0:
            continue
        qc, kc, vc = qf[:, :, :, r0:r1], kf[:, :, c0:c1], vf[:, :, c0:c1]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qc, kc) * scale
        if softcap > 0:
            t = torch.tanh(s / softcap)
            s = softcap * t
        p = torch.where(vis[r0:r1, c0:c1], torch.exp(s - lse[..., r0:r1, :]),
                        0.0)
        doc = dof[..., r0:r1, :]
        dvv[:, :, c0:c1] = torch.einsum("bhgqk,bhgqd->bhkd", p, doc)
        ds = p * (torch.einsum("bhgqd,bhkd->bhgqk", doc, vc)
                  - delta[..., r0:r1, :])
        if softcap > 0:
            ds = ds * (1.0 - t * t)
        ds = ds * scale
        dq[..., r0:r1, :] += torch.einsum("bhgqk,bhkd->bhgqd", ds, kc)
        dk[:, :, c0:c1] = torch.einsum("bhgqk,bhgqd->bhkd", ds, qc)
    return (dq.reshape(b, hq, sq, d).to(q.dtype), dk.to(k.dtype),
            dvv.to(v.dtype))


def decode_ref(q, k_cache, v_cache, pos, window: int = 0,
               softcap: float = 0.0, kv_base: int = 0,
               return_lse: bool = False):
    """``flash_decode``'s plain version: q (B, Hq, Sq, D) at positions
    pos .. pos + Sq - 1 against the cache's keys < pos + Sq, causal; ``pos``
    a 0-d integer tensor (read on the host) or an int.  Cache row j is key
    ``kv_base + j``; with ``return_lse`` also the rows' fp32 log-sum-exp
    (:func:`attention_lse_ref`), -inf where a row sees no key of the
    slice (its output 0)."""
    p = int(pos) - int(kv_base)                 # the position in the slice
    n = max(0, min(k_cache.shape[2], p + q.shape[2]))
    k, v = k_cache[:, :, :n], v_cache[:, :, :n]
    out = attention_ref(q, k, v, True, window, softcap, p)
    if not return_lse:
        return out
    return out, attention_lse_ref(q, k, True, window, softcap, p)


def decode_split_ranges(sq: int, kv_len: int, q_offset: int, causal: bool,
                        window: int, splits: int, block: int = 64):
    """The decode kernel's key range [k0, k1) for each of ``splits`` CTAs
    (``csrc/flash_attn.cu::split_range``): the ``block``-key blocks that
    hold the keys some query sees, divided evenly and in order; an empty
    range (k0 >= k1) where a split has none."""
    lo = max(0, q_offset - window + 1) if window > 0 else 0
    hi = min(kv_len, q_offset + sq) if causal else kv_len
    jb0 = lo // block
    jb1 = -(-hi // block) if hi > lo else jb0
    per = -(-(jb1 - jb0) // splits)
    out = []
    for s in range(splits):
        b0 = jb0 + s * per
        out.append((max(lo, b0 * block), min(hi, min(jb1, b0 + per) * block)))
    return out


def attention_split_ref(q, k, v, causal: bool, window: int, softcap: float,
                        q_offset: int, splits: int):
    """Plain split-and-merge attention, the decode kernel's structure: each
    split's unnormalised (acc, m, l) over its key range
    (:func:`decode_split_ranges`), merged in split order as the combine
    kernel merges them (m = max m_s, l = sum l_s e^(m_s - m), the same for
    acc).  An empty split contributes (0, -inf, 0); a row no split sees
    gives 0.  Same arguments as :func:`attention_ref`."""
    b, hq, sq, d = q.shape
    group = hq // k.shape[1]
    k = k.repeat_interleave(group, dim=1).to(F32)
    v = v.repeat_interleave(group, dim=1).to(F32)
    vis = attention_visible(sq, k.shape[2], causal, window, q_offset,
                            q.device)
    parts = []
    for k0, k1 in decode_split_ranges(sq, k.shape[2], q_offset, causal,
                                      window, splits):
        if k1 <= k0:
            parts.append((q.new_zeros((b, hq, sq, d), dtype=F32),
                          q.new_full((b, hq, sq, 1), float("-inf"), dtype=F32),
                          q.new_zeros((b, hq, sq, 1), dtype=F32)))
            continue
        s = torch.einsum("bhqd,bhkd->bhqk", q.to(F32), k[:, :, k0:k1]) / d ** 0.5
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        s = torch.where(vis[:, k0:k1], s,
                        torch.full((), float("-inf"), device=q.device))
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - torch.where(m > float("-inf"), m, 0.0))
        parts.append((torch.einsum("bhqk,bhkd->bhqd", p, v[:, :, k0:k1]), m,
                      p.sum(-1, keepdim=True)))
    m = torch.stack([pm for _, pm, _ in parts]).amax(0)
    m0 = torch.where(m > float("-inf"), m, 0.0)
    acc = torch.zeros_like(parts[0][0])
    l = torch.zeros_like(parts[0][2])
    for pa, pm, pl in parts:
        f = torch.exp(pm - m0)
        acc, l = acc + pa * f, l + pl * f
    out = torch.where(l > 0, acc / torch.where(l > 0, l, 1.0), 0.0)
    return out.to(q.dtype)
