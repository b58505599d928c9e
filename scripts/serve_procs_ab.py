#!/usr/bin/env python
"""Force serving over four cards, with and without the served mesh's
header group and keep-alive thread, in one run: the ``serve_procs`` phase's
case (iii) of ``chip_smoke.py`` (four NCCL processes as a ``(2, 2)``
``(replica x dd)`` mesh, 4 client MD threads on process 0) for a variant
of this tree and for the tree itself, in the order variant, tree, tree,
variant.

The variant is a copy of ``src/`` and ``chip_smoke.py`` under
``build/serve_procs_ab/variant`` whose ``serve/server.py`` broadcasts each
dispatch's header on the default group and starts no keep-alive thread.
Each run builds its tree's kernels first.  Prints, per run, the clients'
requests/s, latency, ms per dispatch and the collectives' ms per dispatch
(process 0).

    python3 scripts/serve_procs_ab.py     # needs four cards
"""
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VARIANT = ROOT / "build" / "serve_procs_ab" / "variant"
PATCHES = (
    ('''        self.group = dist.new_group(
            **({} if follow_timeout is None else {"timeout": follow_timeout}))''',
     "        self.group = None"),
    ("        if self.rank == 0:\n            threading.Thread(",
     "        if False:\n            threading.Thread("),
)

RUN = r'''
import json, shutil, sys
sys.path.insert(0, "src")
import chip_smoke as c
from repro_torch.kernels import build
build.build("nbr_attn", "cell_filter", "flash_attn", "force_scatter")
shutil.rmtree(c.SERVE_PROCS_DIR, ignore_errors=True)
c.SERVE_PROCS_DIR.mkdir(parents=True)
outs = c.serve_procs_spawn("nccl_4_cards", 4, "nccl", [0, 1, 2, 3],
                           c.SERVE_STEPS)
cl = outs[0]["clients"]
print("RESULT " + json.dumps({k: cl[k] for k in (
    "requests_per_s", "latency_ms", "ms_per_dispatch_median",
    "collective_ms_per_dispatch_by_tag_process0")}))
'''


def make_variant() -> None:
    shutil.rmtree(VARIANT, ignore_errors=True)
    VARIANT.mkdir(parents=True)
    shutil.copytree(ROOT / "src", VARIANT / "src")
    shutil.copy(ROOT / "chip_smoke.py", VARIANT / "chip_smoke.py")
    server = VARIANT / "src" / "repro_torch" / "serve" / "server.py"
    text = server.read_text()
    for old, new in PATCHES:
        if old not in text:
            raise SystemExit(f"serve/server.py no longer holds {old!r}")
        text = text.replace(old, new)
    server.write_text(text)


def main() -> int:
    make_variant()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.splitlines()[0], flush=True)
    failed = 0
    for label, root in (("variant", VARIANT), ("tree", ROOT),
                        ("tree", ROOT), ("variant", VARIANT)):
        r = subprocess.run([sys.executable, "-c", RUN], cwd=root,
                           capture_output=True, text=True)
        got = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")]
        failed += r.returncode != 0 or not got
        print(label, r.returncode, got[-1][7:] if got else
              r.stdout[-2000:] + r.stderr[-3000:], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
