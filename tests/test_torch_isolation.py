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


def _env_reads(path):
    """(line, key) of every environment access in a file: os.environ[...],
    os.environ.get(...), os.getenv(...); key is None when not a literal."""
    tree = ast.parse(path.read_text(), filename=str(path))
    parents = {child: node for node in ast.walk(tree) for child in ast.iter_child_nodes(node)}

    def literal(node):
        return node.value if isinstance(node, ast.Constant) else None

    for node in ast.walk(tree):
        if not (isinstance(node, ast.Attribute) and node.attr in ("environ", "getenv")):
            continue
        up = parents.get(node)
        if node.attr == "getenv" and isinstance(up, ast.Call):
            yield node.lineno, literal(up.args[0]) if up.args else None
        elif isinstance(up, ast.Subscript):
            yield node.lineno, literal(up.slice)
        elif isinstance(up, ast.Attribute) and isinstance(parents.get(up), ast.Call):
            call = parents[up]
            yield node.lineno, literal(call.args[0]) if call.args else None
        else:
            yield node.lineno, None


def test_port_reads_no_environment_variable_but_cuda_home():
    """No env var or knob routes the port's work: the only variable it reads
    is CUDA_HOME, to find nvcc (kernels.py)."""
    reads = {(str(p.relative_to(ROOT)), line, key)
             for p in _port_files() for line, key in _env_reads(p)}
    assert {key for _f, _l, key in reads} == {"CUDA_HOME"}, sorted(reads, key=str)
    assert {f for f, _l, _k in reads} == {"localai_tpu_torch/kernels.py"}
