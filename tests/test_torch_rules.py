"""Rules of the port: no JAX and nothing of ``repro`` in ``repro_torch`` or
``chip_smoke.py``; no silent CPU fallback at the entry points; the kernel
package imports on a machine without ``triton`` or ``nvcc``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax_and_nothing_of_repro(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch import bridge
    from repro_torch.core import DeepmdForceProvider
    from repro_torch.dp import DPConfig, DPModel, EnvStats
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DPModel(DPConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EnvStats.identity(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bridge.params_to_torch({"w": np.zeros(2)})
    model = DPModel(DPConfig(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeepmdForceProvider(model, {}, np.arange(4), np.zeros(4, int),
                            np.ones(3), 4)


def test_kernels_import_without_triton_or_nvcc(tmp_path):
    code = ("import sys; sys.modules['triton'] = None\n"
            "import repro_torch.kernels as k, repro_torch.kernels.ops\n"
            "assert 'repro_torch.kernels.env_mat_triton' not in sys.modules\n"
            "assert sum(k.launch_counts().values()) == 0\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), PATH=str(tmp_path),
               CUDA_HOME=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
