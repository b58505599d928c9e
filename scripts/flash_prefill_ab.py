#!/usr/bin/env python
"""Row 6a's bf16 prefill kernel at its path shapes for a parent tree and
this tree in one run on one card, in the order parent, tree, tree, parent.

Each run is a process of its own that puts its tree's ``src`` first on the
path (so ``repro_torch`` and its kernels are that tree's, built into that
tree's ``build/``) and runs this tree's ``chip_smoke.flash_path_times``:
the kernel as the path calls it, the kernel at softcap 0, SDPA at softcap
0 and the bound, at every shape of ``chip_smoke.FLASH_PATHS`` and at
``EXTRA`` (the (32, 32) instance, which no path calls).  Each run
also times row 6b's whole-cache decode at qwen2-1.5b's ``long_500k``
shape (B 1, 12 q heads over 2 KV heads, D 128, a cache of 524,288 keys,
the query at the last position; L2 flushed): the kernel, SDPA over the
same keys, and the bound (the K/V bytes at the memory rate).

    mkdir -p build/flash_ab/parent
    git archive <parent> | tar -x -C build/flash_ab/parent
    python3 scripts/flash_prefill_ab.py build/flash_ab/parent

Prints the card's name and power limit, then one ``RESULT`` JSON line a
run.
"""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LONG = dict(b=1, hq=12, hkv=2, s=524_288, d=128)
# the (32, 32) instance, which no registry architecture calls, at a
# prefill shape of its own (as chip_smoke.FLASH_PATHS's entries)
EXTRA = (("(32, 32) instance, no registry path", 4, 16, 4, 2048, 2048, 32,
          32, True, 0, 0.0, False),)


def long_decode(c):
    """Row 6b's whole-cache decode at ``LONG``: kernel, SDPA, bound (ms)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attn
    b, hq, hkv, s, d = (LONG[k] for k in ("b", "hq", "hkv", "s", "d"))
    g = torch.Generator(device="cuda").manual_seed(5)
    rnd = lambda *sh: torch.randn(*sh, device="cuda", generator=g).to(
        torch.bfloat16)
    q, k, v = rnd(b, hq, 1, d), rnd(b, hkv, s, d), rnd(b, hkv, s, d)
    pos = torch.tensor(s - 1, device="cuda")
    kern = lambda: flash_attn.flash_decode(q, k, v, pos, 0, 0.0)
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True)
    want = sdpa().float()
    err = c.check("long decode vs sdpa", kern().float(), want,
                  atol=1e-2 * float(want.abs().max()))
    nbytes = 2 * (2 * b * hkv * s * d + 2 * b * hq * d)
    return {"case": "flash_decode whole cache, qwen2-1.5b long_500k",
            "q": [b, hq, 1, d], "kv": [b, hkv, s, d], "pos": s - 1,
            "max_err_vs_sdpa": err, "kernel_ms": c.time_ms(kern),
            "sdpa_ms": c.time_ms(sdpa), "bound_ms": nbytes / c.HBM_RATE * 1e3,
            "bound_by": "bytes"}


def child(tree: str) -> int:
    sys.path[:0] = [str(Path(tree).resolve() / "src"), str(ROOT)]
    import torch
    import chip_smoke as c
    from repro_torch.kernels import build
    build.build("flash_attn")
    with torch.no_grad():
        res = {"tree": tree,
               "paths": c.flash_path_times(c.FLASH_PATHS + EXTRA),
               "long_decode": long_decode(c)}
    print("RESULT " + json.dumps(res), flush=True)
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--child"]:
        return child(sys.argv[2])
    parent = sys.argv[1]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for tree in (parent, str(ROOT), str(ROOT), parent):
        run = subprocess.run([sys.executable, __file__, "--child", tree],
                             capture_output=True, text=True)
        print("\n".join(line for line in run.stdout.splitlines()
                        if line.startswith("RESULT")), flush=True)
        if run.returncode != 0:
            print(run.stdout[-4000:], run.stderr[-4000:], file=sys.stderr)
            return run.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
