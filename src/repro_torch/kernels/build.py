"""Build the CUDA C++ kernels with ``nvcc`` at first use and load them.

Sources come from ``csrc/`` only; each ``<name>.cu`` becomes one shared
library with a plain C interface, compiled for ``sm_90a`` into
``build/repro_torch_kernels/`` at the repository root and loaded with
ctypes.  The library's file name carries a hash of its source and flags, so
an edited source is rebuilt and a built one is reused.  Every launch
function returns ``cudaGetLastError()``; :func:`check` raises on anything
but 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built from source at first use")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(*names: str) -> dict[str, str]:
    """Compile every named source that is not built yet, one ``nvcc`` per
    source, all started together.  Returns the compiler output per name
    (``-Xptxas=-v`` lists registers, shared memory and spills); raises on a
    failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd,
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    logs = {}
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
        os.replace(tmp, lib)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` (building it first if needed)."""
    if name not in _LIBS:
        build(name)
        _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return _LIBS[name]


def check(err: int, lib: ctypes.CDLL, what: str) -> None:
    """Raise when a launch function returned a CUDA error."""
    if err != 0:
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
