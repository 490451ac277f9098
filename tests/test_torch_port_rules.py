"""Rules of the port: it never imports JAX or the JAX package, its entry
points run on CUDA unless asked for the CPU, and its CUDA wrappers never
fall back to the plain version for CUDA work."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import dispatch
from repro_torch.core.qtensor import quantize_tree
from repro_torch.kernels import sorted_matmul
from repro_torch.models.model import build_model

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "quickstart_torch.py",
    ROOT / "examples" / "overflow_analysis_torch.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_imports_no_jax(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch, repro_torch.serving, "
            "repro_torch.convert, repro_torch.kernels.ops, "
            "repro_torch.core.papernets, repro_torch.optim, "
            "repro_torch.runtime, repro_torch.overflow_analysis; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'repro imported'")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda(monkeypatch):
    _no_cuda(monkeypatch)
    cfg = get_config("qwen2-1.5b", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quantize_tree({"w": torch.zeros((256, 256))})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"ln_f": torch.zeros(4).numpy()})
    model = build_model(cfg, device="cpu")  # asked for: runs on the CPU
    assert model.device.type == "cpu"
    from repro_torch.serving import ServingEngine

    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model, model.init(0), num_slots=1, max_len=8)
    from repro_torch import quickstart

    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.main()


def test_paper_path_entry_points_default_to_cuda(monkeypatch):
    """The paper nets, their conversion, the overflow-analysis session
    and quantize_and_certify raise without a card unless asked for the
    CPU."""
    _no_cuda(monkeypatch)
    from repro_torch import overflow_analysis
    from repro_torch.configs.paper import MLP1
    from repro_torch.convert import papernet_layers_from_numpy
    from repro_torch.core.papernets import train_papernet
    from repro_torch.core.pqs import PQSConfig
    from repro_torch.data import synth_mnist
    from repro_torch.runtime import quantize_and_certify

    data = synth_mnist(n=160, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_papernet(MLP1, PQSConfig(), data, epochs=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        overflow_analysis.main()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quantize_and_certify({"w": torch.zeros((64, 64))}, 16)
    zero = torch.zeros(()).numpy()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        papernet_layers_from_numpy([{
            "w": zero, "b": zero, "mask": zero,
            "act_range": {"lo": zero, "hi": zero, "n": 0.0, "decay": 0.99}}])
    res = train_papernet(MLP1, PQSConfig(), data, epochs=1, device="cpu")
    assert res.layers[0]["w"].device.type == "cpu"


def test_wide_wrappers_never_take_plain_versions_off_the_cpu(monkeypatch):
    """ops.quant_matmul and ops.nm_spmm on tensors that are not on the CPU
    (meta tensors here, as no card is present) go to the card's operand
    checks and raise there: the plain versions are never called."""
    from repro_torch.kernels import nm_spmm, ops, quant_matmul

    def refuse(*args, **kwargs):
        raise AssertionError("plain version called for off-CPU tensors")

    monkeypatch.setattr(quant_matmul, "quant_matmul_ref", refuse)
    monkeypatch.setattr(nm_spmm, "nm_spmm_ref", refuse)
    x = torch.zeros((2, 32), dtype=torch.int8, device="meta")
    w = torch.zeros((32, 3), dtype=torch.int8, device="meta")
    vals = torch.zeros((3, 2, 8), dtype=torch.int8, device="meta")
    idx = torch.zeros((3, 2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.quant_matmul(x, w)
    with pytest.raises(ValueError, match="CUDA"):
        ops.nm_spmm(x, vals, idx, m_group=16)
    with pytest.raises(ValueError, match="CUDA"):  # mixed devices
        ops.quant_matmul(x, torch.zeros((32, 3), dtype=torch.int8))
    assert quant_matmul.quant_matmul.launches == 0
    assert nm_spmm.nm_spmm.launches == 0


def test_cuda_backend_refuses_cpu_tensors():
    x = torch.zeros((2, 8), dtype=torch.int8)
    w = torch.zeros((3, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        dispatch.pqs_dot(x, w, backend="cuda")
    assert sorted_matmul.seq_policy_matmul(x, w).shape == (2, 3)  # plain


def test_unported_engine_options_raise():
    from repro_torch.serving import ServingEngine

    model = build_model(get_config("qwen2-1.5b", smoke=True), device="cpu")
    params = model.init(0)
    for kw in ({"page_size": 8}, {"prefill_mode": "steps"}):
        with pytest.raises(NotImplementedError):
            ServingEngine(model, params, num_slots=1, max_len=8,
                          device="cpu", **kw)
