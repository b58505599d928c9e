"""Rules of the port: no JAX and nothing of ``repro`` in ``repro_torch`` (every
module, the decomposition layer included) or ``chip_smoke.py``; no silent
CPU fallback at the entry points, single-domain or distributed; kernel
wrappers dispatch by the tensors' device; the kernel package imports on a
machine without ``triton`` or ``nvcc``."""
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
DD_MODULES = ("core/domain.py", "core/pipeline.py", "core/ddinfer.py",
              "md/cells.py", "kernels/cell_filter.py", "launch/mesh.py",
              "launch/protein_md.py")


def test_rule_covers_the_decomposition_modules():
    names = {str(p.relative_to(ROOT / "src" / "repro_torch"))
             for p in PORT_FILES[:-1]}
    assert set(DD_MODULES) <= names


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
    from repro_torch.core import DeepmdForceProvider, suggest_config
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
    # the distributed provider follows the same rule
    box = np.full(3, 4.0)
    cfg = suggest_config(64, box, 8, 0.6, nbr_capacity=32, skin=0.05)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeepmdForceProvider(model, {}, np.arange(64), np.zeros(64, int), box,
                            64, dd_config=cfg)


def test_cell_filter_wrapper_dispatches_by_device():
    """CPU tensors take the plain version and count no launch; the kernel
    module needs no card to import."""
    from repro_torch.kernels import cell_filter, launch_counts
    before = launch_counts()["cell_filter"]
    xyz = torch.rand(6, 3)
    idx = torch.tensor([[1, -1], [0, 2], [5, 3], [2, 2], [0, 1], [4, 4]],
                       dtype=torch.int32)
    flags = cell_filter.cell_filter(xyz, idx, torch.ones(6), 2.0)
    assert flags.dtype == torch.bool and flags[0, 0] and not flags[0, 1]
    assert launch_counts()["cell_filter"] == before


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


def test_lm_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch import bridge
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.lm import model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("gemma2-2b").reduced(n_layers=2, d_model=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--reduced"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bridge.lm_params_to_torch({"embed": np.zeros((4, 2), np.float32)})
    params = model.init_params(cfg, torch.Generator(), device="cpu")
    assert params["embed"].device.type == "cpu"
    res = serve.main(["--reduced", "--device", "cpu", "--batch", "1",
                      "--prompt-len", "5", "--new", "2"])
    assert tuple(res["tokens"].shape) == (1, 2)


def test_lm_unported_parts_raise():
    """LM training and the accounting are ported: ``forward(remat="full")``
    runs on the CPU, ``launch/train.py``'s and ``lm/train_lib.py``'s
    counterparts import, and so do ``lm/sharding.py``, ``launch/mesh.py``,
    ``launch/roofline.py`` and ``launch/dryrun.py``.  A layout of one device
    runs ``make_prefill``, ``make_serve_step`` and ``make_train_step`` as no
    mesh; a layout of more than one device raises, naming the multi-card
    item (ROADMAP Queue 1 item 14).  The six architectures that needed the
    rest of the LM (MLA, MoE, Mamba, RWKV6, cross-attention, the encoder and
    modality stubs, MTP) build and serve on the CPU through the entry
    point."""
    import importlib

    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import MeshLayout, make_card_mesh
    from repro_torch.launch.train import make_batch
    from repro_torch.lm import model, serve_lib, train_lib
    cfg = get_arch("qwen3-8b").reduced(n_layers=2, d_model=32)
    params = model.init_params(cfg, torch.Generator(), device="cpu")
    tok = torch.zeros((1, 4), dtype=torch.int64)
    logits, _ = model.forward(params, cfg, tok, remat="full")
    assert logits.shape == (1, 4, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    for name in ("repro_torch.launch.train", "repro_torch.lm.train_lib",
                 "repro_torch.launch.elastic", "repro_torch.lm.sharding",
                 "repro_torch.launch.mesh", "repro_torch.launch.roofline",
                 "repro_torch.launch.dryrun"):
        importlib.import_module(name)
    card = make_card_mesh()
    last, cache = serve_lib.make_prefill(cfg, max_len=6, mesh=card)(
        params, tok)
    step_logits, _ = serve_lib.make_serve_step(cfg, mesh=card)(
        params, cache, last.argmax(-1), 4)
    assert step_logits.shape == (1, 1, cfg.vocab)
    step, opt = train_lib.make_train_step(cfg, train_lib.TrainHParams(),
                                          mesh=card)
    _, _, metrics = step(params, opt.init(params),
                         make_batch(cfg, 0, 1, 4, "cpu"))
    assert bool(torch.isfinite(metrics["loss"]))
    two = MeshLayout((2, 1), ("data", "model"))
    for make in (lambda: serve_lib.make_prefill(cfg, mesh=two),
                 lambda: serve_lib.make_serve_step(cfg, mesh=two),
                 lambda: train_lib.make_train_step(
                     cfg, train_lib.TrainHParams(), mesh=two)):
        with pytest.raises(NotImplementedError,
                           match="multi-card execution.*item 14"):
            make()
    for name in ("deepseek-v3-671b", "jamba-1.5-large-398b",
                 "llama4-scout-17b-a16e", "llama-3.2-vision-90b", "rwkv6-3b",
                 "whisper-medium"):
        res = serve.main(["--arch", name, "--reduced", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "5", "--new", "3"])
        assert tuple(res["tokens"].shape) == (2, 3), name
        assert all(bool(torch.isfinite(lg).all()) for lg in res["logits"])
    # DP force serving is ported: the CPU run serves its client's steps
    res = serve.main(["--backend", "force", "--device", "cpu", "--reduced",
                      "--clients", "1", "--steps", "1"])
    assert res["totals"]["completed"] == res["totals"]["submitted"] == 1


def test_flash_wrapper_dispatches_by_device():
    """CPU tensors take the plain version, at any head dimension (48 has
    no kernel instance), and count no launch."""
    from repro_torch.kernels import flash_attn, launch_counts
    before = launch_counts()["flash_attention"]
    q, k = torch.randn(1, 2, 3, 48), torch.randn(1, 1, 5, 48)
    out = flash_attn.flash_attention(q, k, k, True, 0, 0.0, 2)
    assert out.shape == q.shape
    assert launch_counts()["flash_attention"] == before


def test_md_entry_points_raise_without_cuda(monkeypatch):
    """The system constructors, the bridge and the MD entry point default
    to the card; the engine runs where its system lies."""
    from repro_torch import bridge
    from repro_torch.launch import protein_md
    from repro_torch.md import (EngineConfig, MDEngine, build_solvated_protein,
                                build_water_box)
    from repro_torch.md.system import empty_topology
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: build_water_box(3),
                 lambda: build_solvated_protein(2),
                 lambda: empty_topology(4),
                 lambda: protein_md.main(["--residues", "2", "--steps", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    system, pos = build_water_box(3, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bridge.system_to_torch(system)
    eng = MDEngine(system, EngineConfig(cutoff=0.3, neighbor_capacity=16))
    assert eng.device.type == "cpu"
    assert eng.init_state(pos, 100.0).positions.device.type == "cpu"


def test_make_dd_mesh_raises_without_a_process_group():
    """The process mesh starts no group of its own."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_dd_mesh
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group first"):
        make_dd_mesh(8, device="cpu")


def test_process_mesh_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """Inside a process group, the mesh, the distributed provider and the
    MD launcher still default to the card and raise without one."""
    import datetime

    import torch.distributed as dist

    from repro_torch.core import DeepmdForceProvider, suggest_config
    from repro_torch.dp import DPConfig, DPModel
    from repro_torch.launch import protein_md
    from repro_torch.launch.mesh import make_dd_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_dd_mesh(8, backend="gloo")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            protein_md.main(["--backend", "gloo", "--residues", "2",
                             "--steps", "1"])
        mesh = make_dd_mesh(8, device="cpu")
        box = np.full(3, 4.0)
        cfg = suggest_config(64, box, 8, 0.6, nbr_capacity=32, skin=0.05)
        model = DPModel(DPConfig(), device="cpu")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DeepmdForceProvider(model, {}, np.arange(64), np.zeros(64, int),
                                box, 64, dd_config=cfg, mesh=mesh)
    finally:
        dist.destroy_process_group()
