"""The PyTorch port stands alone: no module of it (nor chip_smoke.py)
imports jax or the JAX package, and its entry points refuse to fall back to
the CPU when no device was asked for and no GPU exists."""

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "localai_tpu")


def _port_files():
    files = sorted((ROOT / "localai_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_never_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 10 and (ROOT / "chip_smoke.py").exists()
    names = {str(p.relative_to(ROOT)) for p in files}
    assert {"localai_tpu_torch/ops/paged_flash.py", "localai_tpu_torch/ops/ptable.py",
            "localai_tpu_torch/profile_engine.py"} <= names
    bad = [
        (str(p.relative_to(ROOT)), mod)
        for p in files
        for mod in _imports(p)
        if mod.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad


def test_entry_points_raise_without_cuda(monkeypatch):
    from localai_tpu_torch.engine.engine import Engine
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer
    from localai_tpu_torch.engine.weights import load_hf_checkpoint, params_from_numpy
    from localai_tpu_torch.models import get_arch
    from localai_tpu_torch.models.llama import KVCache, init_params, paged_cache_zeros

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("tiny")
    params = init_params(cfg, device="cpu")  # asking for the CPU by name works
    for call in (
        lambda: init_params(cfg),
        lambda: KVCache.zeros(cfg, 1, 8),
        lambda: paged_cache_zeros(cfg, 4, 16),
        lambda: Engine(cfg, params, ByteTokenizer()),
        lambda: params_from_numpy(cfg, {}),
        lambda: load_hf_checkpoint(cfg, "/nonexistent"),
        lambda: init_params(cfg, device="cuda"),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
