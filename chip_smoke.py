#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's DP force path once on one card.

    python3 chip_smoke.py

Builds the kernels from ``src/repro_torch/kernels`` (nvcc for the CUDA
sources, Triton at first launch), then runs four phases on the paper's
DPA-1 at full width (``paper_dpa1_config(ntypes=4, rcut=0.6, sel=64)``,
fp32, random weights from a seed) over uniform random atoms at 30 atoms/nm^3:

1. kernels: each kernel against its plain PyTorch version on the card, at the
   shapes and on the data the force path gives it (N = 15,668 atoms), with
   timings (median of 10 runs, CUDA events, L2 flushed before each run);
2. path parity: the provider on the card against the port on the CPU at
   2,048 atoms, and one launch of each kernel per force call;
3. requests: ``DeepmdForceProvider(skin=0.05).compute`` on the 15,668-atom
   1HCI-sized system (8 drifts inside skin/4, then one that rebuilds);
4. a ``kernels`` JSON line, then the result line.

Any failed check raises, and the script exits non-zero.  It needs one CUDA
card and the repository's ``src/`` beside it; it imports no JAX.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parent / "src"
DENSITY = 30.0            # atoms / nm^3 (benchmarks/dp_inference.py)
N_PATH = 15_668           # the paper's 1HCI DP group
N_PARITY = 2_048
DEVICE = "cuda"
SKIN = 0.05
SEED = 0
REPS = 10
F32_PEAK = 67e12          # H100 SXM fp32 FLOP/s outside the tensor cores
HBM_RATE = 3.35e12        # H100 SXM bytes/s
TPU_SOURCES = {
    "env_mat_fwd": "src/repro/kernels/env_mat.py:66",
    "env_mat_bwd": "src/repro/kernels/env_mat.py:90",
    "nbr_attention_stack_fwd": "src/repro/kernels/nbr_attn.py:145",
    "nbr_attention_stack_bwd": "src/repro/kernels/nbr_attn.py:164",
}
TPU_FUNCTIONS = {
    "env_mat_fwd": "src/repro/kernels/env_mat.py::_env_mat_kernel",
    "env_mat_bwd": "src/repro/kernels/env_mat.py::_env_mat_bwd_kernel",
    "nbr_attention_stack_fwd": "src/repro/kernels/nbr_attn.py::_stack_fwd_kernel",
    "nbr_attention_stack_bwd": "src/repro/kernels/nbr_attn.py::_stack_bwd_kernel",
}
PORT_SOURCES = {
    "env_mat_fwd": ("triton", "src/repro_torch/kernels/env_mat_triton.py"),
    "env_mat_bwd": ("triton", "src/repro_torch/kernels/env_mat_triton.py"),
    "nbr_attention_stack_fwd": ("cuda", "src/repro_torch/kernels/csrc/nbr_attn.cu"),
    "nbr_attention_stack_bwd": ("cuda", "src/repro_torch/kernels/csrc/nbr_attn.cu"),
}


def fail(msg):
    raise RuntimeError(msg)


def check(name, got, want, rtol=0.0, atol=0.0):
    """|got - want| <= atol + rtol |want| everywhere; returns max |err|."""
    err = (got - want).abs()
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite output")
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        fail(f"{name}: {int(bad.sum())} entries out of tolerance "
             f"(max err {float(err.max()):.3e}, rtol {rtol}, atol {atol:.3e})")
    return float(err.max())


_FLUSH = None


def time_ms(fn):
    """Median over REPS runs after two warm-ups; L2 (50 MB) flushed first."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 * 2 ** 20, device=DEVICE)
    for _ in range(2):
        fn()
    times = []
    for _ in range(REPS):
        _FLUSH.zero_()
        # keep the card busy while the host enqueues, so the events time
        # the kernel and not the host's launch latency
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def system(n, seed):
    rng = np.random.default_rng(seed)
    side = (n / DENSITY) ** (1.0 / 3.0)
    coords = rng.uniform(0, side, (n, 3)).astype(np.float32)
    types = rng.integers(0, 4, n).astype(np.int32)
    return coords, types, np.full(3, side, np.float32)


def path_inputs(model, params, coords, types, box, nlist):
    """The tensors the force path hands to each kernel (the steps of
    ``DPModel._atomic_e`` and ``apply_descriptor`` up to the attention
    stack), from a real skin-widened list re-filtered to the cutoff."""
    from repro_torch.dp.common import _guarded_env
    from repro_torch.dp.descriptors import _stack_params
    from repro_torch.dp.networks import mlp_apply
    from repro_torch.kernels.ref import env_mat_ref
    from repro_torch.md.neighbors import minimum_image
    cfg = model.cfg.descriptor
    idx = nlist.idx.long()
    safe = torch.where(idx >= 0, idx, torch.zeros_like(idx))
    dr = minimum_image(coords[safe] - coords[:, None, :], box)
    mask = nlist.mask * ((dr * dr).sum(-1) < cfg.rcut ** 2)
    planes = [dr[..., i].contiguous() for i in range(3)]
    s = env_mat_ref(*planes, mask, cfg.rcut_smth, cfg.rcut)[0]
    dist, _, r_hat = _guarded_env(dr, mask, cfg.rcut_smth, cfg.rcut)
    r_hat = r_hat * mask[..., None]
    pd = params["descriptor"]
    feat = torch.cat([s[..., None],
                      pd["type_embed"][types[safe]] * mask[..., None]], -1)
    g = mlp_apply(pd["embed"], feat) * mask[..., None]
    attn = [g.contiguous()] + [r_hat[..., i].contiguous() for i in range(3)]
    attn += [(s * dist).contiguous(), mask.contiguous()]
    attn += [w.contiguous() for w in _stack_params(pd["attn"])]
    return (*planes, mask.contiguous()), attn


def env_bound(n_planes, numel):
    return n_planes * numel * 4 / HBM_RATE * 1e3, "bytes"


def attn_bound(attn, backward):
    """Least time for the stack: FLOPs the valid neighbours need (per atom
    with n valid of K: forward 8nMH + 4n^2 H per layer; backward without
    parameter gradients, recompute included, 16nMH + 12n^2 H) at the fp32
    peak, against each input read once and each output written once."""
    g, mask = attn[0], attn[5]
    layers, m, h = attn[6].shape
    nv = mask.sum(1).double()
    per = (16 * nv * m * h + 12 * nv * nv * h) if backward else \
        (8 * nv * m * h + 4 * nv * nv * h)
    flops = float(layers * per.sum())
    weights = sum(w.numel() for w in attn[6:])
    # forward: g + 5 planes in, out + stash out; backward: stash + dout +
    # 5 planes in, dg + 4 planes out
    words = ((2 + layers) * g.numel() + 5 * mask.numel() if not backward
             else (2 + layers) * g.numel() + 9 * mask.numel())
    nbytes = 4 * (words + weights)
    t_ops, t_bytes = flops / F32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_kernels(model, params, skin):
    """Every kernel against its plain version at the shapes and on the data
    of the force path whose list has this skin (K = sel at skin 0, the
    skin-widened capacity of the provider otherwise)."""
    from repro_torch.core.ddinfer import single_domain_state
    from repro_torch.kernels import env_mat, nbr_attn, ref
    cfg = model.cfg.descriptor
    coords, types, box = system(N_PATH, SEED)
    coords, types, box = (torch.tensor(a, device=DEVICE)
                          for a in (coords, types, box))
    capacity = int(np.ceil(cfg.sel * ((cfg.rcut + skin) / cfg.rcut) ** 3))
    nlist = single_domain_state(model, coords, box, capacity, skin)
    env_in, attn = path_inputs(model, params, coords, types, box, nlist)
    n, k = env_in[3].shape
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    rand = lambda *s: torch.randn(*s, device=DEVICE, generator=gen)
    results = {}

    def report(name, err, tol, kernel_ms, plain_ms, bound):
        line = {"phase": "kernels", "name": name, "K": k, "N": n,
                "tpu_source": TPU_FUNCTIONS[name], "max_err": err, "tol": tol,
                "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1]}
        print(json.dumps(line), flush=True)
        results[name] = line

    rs, rc = cfg.rcut_smth, cfg.rcut
    out = env_mat.env_mat_fwd(*env_in, rs, rc)
    want = ref.env_mat_ref(*env_in, rs, rc)
    err = max(check(f"env_mat_fwd[{i}]", o, w, rtol=1e-5,
                    atol=1e-6 * float(w.abs().max()))
              for i, (o, w) in enumerate(zip(out, want)))
    report("env_mat_fwd", err, "rtol 1e-5, atol 1e-6*max",
           time_ms(lambda: env_mat.env_mat_fwd(*env_in, rs, rc)),
           time_ms(lambda: ref.env_mat_ref(*env_in, rs, rc)),
           env_bound(8, n * k))

    cts = [rand(n, k) for _ in range(4)]
    out = env_mat.env_mat_bwd(*env_in, *cts, rs, rc)
    want = ref.env_mat_bwd_ref(*env_in, *cts, rs, rc)
    err = max(check(f"env_mat_bwd[{i}]", o, w, rtol=2e-4, atol=5e-5)
              for i, (o, w) in enumerate(zip(out, want)))
    report("env_mat_bwd", err, "rtol 2e-4, atol 5e-5",
           time_ms(lambda: env_mat.env_mat_bwd(*env_in, *cts, rs, rc)),
           time_ms(lambda: ref.env_mat_bwd_ref(*env_in, *cts, rs, rc)),
           env_bound(11, n * k))

    out, stash = nbr_attn.nbr_attention_stack_fwd(*attn, stash=True)
    want, want_stash = ref.nbr_attention_stack_ref(*attn, stash=True)
    scale = float(want.abs().max())
    err = check("nbr_attention_stack_fwd", out, want, atol=1e-4 * scale)
    check("nbr_attention_stack_fwd stash", stash, want_stash,
          atol=1e-4 * float(want_stash.abs().max()))
    report("nbr_attention_stack_fwd", err, "atol 1e-4*max|out|",
           time_ms(lambda: nbr_attn.nbr_attention_stack_fwd(*attn, stash=True)),
           time_ms(lambda: ref.nbr_attention_stack_ref(*attn, stash=True)),
           attn_bound(attn, backward=False))
    del out, want, stash

    dout = rand(*attn[0].shape)
    got = nbr_attn.nbr_attention_stack_bwd(want_stash, *attn[1:], dout,
                                           param_grads=False)
    want = ref.nbr_attention_stack_bwd_ref(want_stash, *attn[1:], dout)
    err = max(check(f"nbr_attention_stack_bwd[{nm}]", a, b,
                    atol=1e-4 * float(b.abs().max()))
              for nm, a, b in zip("dg drx dry drz dsw".split(), got, want))
    report("nbr_attention_stack_bwd", err, "atol 1e-4*max|grad| per output",
           time_ms(lambda: nbr_attn.nbr_attention_stack_bwd(
               want_stash, *attn[1:], dout, param_grads=False)),
           time_ms(lambda: ref.nbr_attention_stack_bwd_ref(
               want_stash, *attn[1:], dout)),
           attn_bound(attn, backward=True))
    del got, want, want_stash

    # bf16 operands at the path's shapes; heads=2 and parameter gradients
    # at a small shape (the force path uses neither)
    out = nbr_attn.nbr_attention_stack_fwd(*attn, compute_dtype="bfloat16")
    want = ref.nbr_attention_stack_ref(*attn, compute_dtype="bfloat16")
    err = check("nbr_attention_stack_fwd bf16", out, want,
                atol=2e-2 * float(want.abs().max()))
    print(json.dumps({"phase": "kernels", "name": "nbr_attention_stack_fwd",
                      "case": "bfloat16 operands", "max_err": err,
                      "tol": "atol 2e-2*max|out|"}), flush=True)
    small = [a[:64] for a in attn[:6]] + attn[6:]
    for heads in (1, 2):
        out, st = nbr_attn.nbr_attention_stack_fwd(*small, heads=heads,
                                                   stash=True)
        want, wst = ref.nbr_attention_stack_ref(*small, heads=heads,
                                                stash=True)
        err = check(f"fwd heads={heads}", out, want,
                    atol=1e-4 * float(want.abs().max()))
        d = rand(*out.shape)
        got = nbr_attn.nbr_attention_stack_bwd(wst, *small[1:], d,
                                               heads=heads, param_grads=True)
        exp = ref.nbr_attention_stack_bwd_ref(wst, *small[1:], d, heads=heads)
        names = "dg drx dry drz dsw dwq dwk dwv dwo dgamma dbeta".split()
        err_b = max(check(f"bwd heads={heads} [{nm}]", a, b,
                          atol=1e-4 * float(b.abs().max()))
                    for nm, a, b in zip(names, got, exp))
        print(json.dumps({"phase": "kernels", "case": f"N=64 heads={heads}, "
                          "parameter gradients", "fwd_max_err": err,
                          "bwd_max_err": err_b,
                          "tol": "atol 1e-4*max per output"}), flush=True)
    print(f"[kernels] N={n} K={k}: all four kernels within tolerance",
          flush=True)
    return results


def phase_parity(model, params):
    """Provider on the card vs the port on the CPU, same params and coords."""
    from repro_torch import kernels
    from repro_torch.backend import ForceRequest
    from repro_torch.core import DeepmdForceProvider
    from repro_torch.dp import DPModel
    coords, types, box = system(N_PARITY, SEED + 1)
    nn = np.arange(N_PARITY)
    cpu_model = DPModel(model.cfg, device="cpu")
    cpu_params = _tree(params, lambda t: t.cpu())
    res = {}
    for dev, mdl, prm in ((DEVICE, model, params), ("cpu", cpu_model,
                                                      cpu_params)):
        prov = DeepmdForceProvider(mdl, prm, nn, types, box, N_PARITY,
                                   nbr_capacity=model.cfg.descriptor.sel,
                                   skin=SKIN, device=dev)
        kernels.reset_launch_counts()
        res[dev] = prov.compute(ForceRequest(positions=torch.tensor(coords)))
        counts = kernels.launch_counts()
        want = 1 if mdl is model else 0
        if any(c != want for c in counts.values()):
            fail(f"{dev} force call launched {counts}, expected {want} each")
    e_gpu, e_cpu = float(res[DEVICE].energy), float(res["cpu"].energy)
    if abs(e_gpu - e_cpu) > 1e-5 * abs(e_cpu):
        fail(f"path parity: E card {e_gpu} vs cpu {e_cpu}")
    f_cpu = res["cpu"].forces
    err = check("path parity forces", res[DEVICE].forces.cpu(), f_cpu,
                atol=1e-4 * float(f_cpu.abs().max()))
    print(json.dumps({"phase": "parity", "atoms": N_PARITY, "E_card": e_gpu,
                      "E_cpu": e_cpu, "F_max_abs_err": err,
                      "F_tol": "atol 1e-4*max|F|",
                      "launches_per_force_call": 1}), flush=True)


def _tree(t, fn):
    if isinstance(t, dict):
        return {k: _tree(v, fn) for k, v in t.items()}
    if isinstance(t, list):
        return [_tree(v, fn) for v in t]
    return fn(t)


def phase_requests(model, params):
    """The main path: 8 evaluate-only requests and one rebuild."""
    from repro_torch import kernels
    from repro_torch.backend import ForceRequest
    from repro_torch.core import DeepmdForceProvider
    coords, types, box = system(N_PATH, SEED)
    rng = np.random.default_rng(SEED + 2)
    prov = DeepmdForceProvider(model, params, np.arange(N_PATH), types, box,
                               N_PATH, nbr_capacity=model.cfg.descriptor.sel,
                               skin=SKIN, device=DEVICE)
    requests = []
    for _ in range(8):
        d = rng.normal(0, 1, coords.shape)
        d *= rng.uniform(0, SKIN / 4, (N_PATH, 1)) / np.linalg.norm(
            d, axis=1, keepdims=True)
        requests.append((coords + d).astype(np.float32))
    far = coords.copy()
    far[0] += np.float32(SKIN)
    requests.append(far)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times, state = [], None
    for i, pos in enumerate(requests):
        x = torch.tensor(pos, device=DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = prov.compute(ForceRequest(positions=x, req_id=i))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        kind = ("assemble+evaluate" if state is None else
                "rebuild" if prov._state is not state else "evaluate")
        state = prov._state
        f = r.forces
        fsum = float(f.sum(0).abs().max())
        fabs = float(f.abs().sum(0).max())
        if not (bool(torch.isfinite(f).all()) and bool(torch.isfinite(r.energy))):
            fail(f"request {i}: non-finite result")
        if r.diagnostics["overflow"] or prov.growths:
            fail(f"request {i}: neighbour capacity overflow")
        if fsum > 1e-4 * fabs:
            fail(f"request {i}: |sum F| {fsum} > 1e-4 sum|F| {fabs}")
        times.append((kind, ms))
        print(json.dumps({"phase": "requests", "req": i, "kind": kind,
                          "ms": ms, "energy": float(r.energy),
                          "sum_F": fsum, "sum_abs_F": fabs}), flush=True)
    counts = kernels.launch_counts()
    profile_request(prov, requests[-1])         # evaluate-only after rebuild
    if times[-1][0] != "rebuild":
        fail("the last drift did not trigger a rebuild")
    if any(c == 0 for c in counts.values()):
        fail(f"a kernel of the path was never launched: {counts}")
    evals = [ms for kind, ms in times if kind == "evaluate"]
    print(json.dumps({"phase": "requests", "atoms": N_PATH,
                      "K": prov.nbr_capacity,
                      "evaluate_ms_median": statistics.median(evals),
                      "rebuild_ms": times[-1][1],
                      "first_ms": times[0][1],
                      "max_memory_allocated_MiB":
                          torch.cuda.max_memory_allocated() / 2 ** 20,
                      "launches": counts}), flush=True)
    return counts


def profile_request(prov, pos):
    """One more evaluate-only request under ``torch.profiler``: device time
    by kernel (device-side events only) and the device's idle share of the
    request's wall time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.backend import ForceRequest
    x = torch.tensor(pos, device=DEVICE)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prov.compute(ForceRequest(positions=x))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.name] = kernels.get(ev.name, 0.0) + \
                ev.time_range.elapsed_us() / 1e3
    rows = sorted(((ms, k) for k, ms in kernels.items()), reverse=True)
    busy = sum(ms for ms, _ in rows)
    print(json.dumps({
        "phase": "profile", "wall_ms_profiled": wall_ms,
        "device_busy_ms": busy if rows else "not measured",
        "idle_share": 1 - busy / wall_ms if rows else "not measured",
        "top": [{"name": k[:90], "ms": ms} for ms, k in rows[:12]]}),
        flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC}/repro_torch not found", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.dp import DPModel, paper_dpa1_config
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    logs = build.build("nbr_attn")
    print(f"[build] nvcc: {time.perf_counter() - t0:.1f} s", flush=True)
    for line in logs.get("nbr_attn", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}", flush=True)

    from repro_torch.kernels import nbr_attn
    print(json.dumps({"attention_max_K_at_M128": {
        "forward": nbr_attn.max_k(128, backward=False),
        "backward": nbr_attn.max_k(128, backward=True)}}), flush=True)

    model = DPModel(paper_dpa1_config(ntypes=4, rcut=0.6, sel=64),
                    device=DEVICE)
    params = model.init_params(torch.Generator().manual_seed(SEED))
    phase_kernels(model, params, 0.0)            # single_domain_forces, K = 64
    kres = phase_kernels(model, params, SKIN)    # the provider's K
    phase_parity(model, params)
    counts = phase_requests(model, params)

    rows = []
    for name, r in kres.items():
        route, source = PORT_SOURCES[name]
        rows.append({"name": name, "route": route, "source": source,
                     "replaces": TPU_SOURCES[name], "launches": counts[name],
                     "max_abs_err": r["max_err"], "ms": r["kernel_ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
