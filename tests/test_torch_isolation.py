"""The PyTorch port stands alone: no module of it (nor chip_smoke.py)
imports jax, the JAX package or ml_dtypes (its bf16 casts are torch's), and
its entry points refuse to fall back to the CPU when no device was asked
for and no GPU exists."""

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "localai_tpu", "ml_dtypes")


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
            "localai_tpu_torch/profile_engine.py", "localai_tpu_torch/ops/lora_matmul.py",
            "localai_tpu_torch/config/app_config.py", "localai_tpu_torch/config/model_config.py",
            "localai_tpu_torch/templates/evaluator.py", "localai_tpu_torch/server/app.py",
            "localai_tpu_torch/server/manager.py", "localai_tpu_torch/server/openai_api.py",
            "localai_tpu_torch/__main__.py", "localai_tpu_torch/engine/gguf.py",
            "localai_tpu_torch/engine/bpe_fast.py", "localai_tpu_torch/native.py",
            "localai_tpu_torch/models/latent_diffusion.py", "localai_tpu_torch/models/flux.py",
            "localai_tpu_torch/models/video_diffusion.py", "localai_tpu_torch/models/diffusion.py",
            "localai_tpu_torch/engine/image_engine.py", "localai_tpu_torch/server/image_api.py",
            "localai_tpu_torch/utils/video_io.py"} <= names
    bad = [
        (str(p.relative_to(ROOT)), mod)
        for p in files
        for mod in _imports(p)
        if mod.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from localai_tpu_torch.config import ApplicationConfig
    from localai_tpu_torch.engine.engine import Engine
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer
    from localai_tpu_torch.engine.weights import load_hf_checkpoint, params_from_numpy
    from localai_tpu_torch.models import get_arch
    from localai_tpu_torch.models.llama import KVCache, init_params, paged_cache_zeros
    from localai_tpu_torch.server.manager import ModelManager
    from localai_tpu_torch.models import diffusion as D
    from localai_tpu_torch.models import flux as FX
    from localai_tpu_torch.models import latent_diffusion as LD
    from localai_tpu_torch.models import video_diffusion as VD

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
        lambda: ModelManager(ApplicationConfig(models_dir=str(tmp_path))),
        lambda: ModelManager(ApplicationConfig(models_dir=str(tmp_path)), device="cuda"),
        lambda: LD.load_pipeline(str(tmp_path)),
        lambda: LD.save_diffusers(LD.sd15_config(), str(tmp_path / "sd")),
        lambda: FX.init_transformer(FX.FluxTransformerConfig()),
        lambda: D.init_params(D.DIFFUSION_PRESETS["dit-test"]),
        lambda: VD.load_motion_adapter(str(tmp_path)),
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


APP_CONFIG = "localai_tpu_torch/config/app_config.py"
ROUTING_WORDS = ("KERNEL", "FLASH", "PAGED", "QUANT", "LORA")


def test_port_reads_no_environment_variable_but_cuda_home():
    """No env var or knob routes the port's work. The variables it reads are
    CUDA_HOME, to find nvcc (kernels.py), and the LOCALAI_* deployment
    settings of the server's ApplicationConfig (address, port, models dir,
    keys, ...), none of which names a kernel route."""
    reads = {(str(p.relative_to(ROOT)), line, key)
             for p in _port_files() for line, key in _env_reads(p)}
    outside = {(f, k) for f, _l, k in reads if f != APP_CONFIG}
    assert outside == {("localai_tpu_torch/kernels.py", "CUDA_HOME")}, sorted(reads, key=str)
    # app_config.py reads literal LOCALAI_* names, or a name through its
    # _env(name, ...) helper, whose every call passes a literal LOCALAI_* name.
    inside = {k for f, _l, k in reads if f == APP_CONFIG}
    assert all(k is None or k.startswith("LOCALAI_") for k in inside), inside
    tree = ast.parse((ROOT / APP_CONFIG).read_text())
    helper_args = [n.args[0] for n in ast.walk(tree)
                   if isinstance(n, ast.Call) and getattr(n.func, "id", "") == "_env"]
    assert helper_args and all(isinstance(a, ast.Constant) and a.value.startswith("LOCALAI_")
                               for a in helper_args)
    names = {n.value for n in ast.walk(tree)
             if isinstance(n, ast.Constant) and isinstance(n.value, str)
             and n.value.startswith("LOCALAI_")}
    assert {"LOCALAI_ADDRESS", "LOCALAI_PORT", "LOCALAI_MODELS_PATH"} <= names
    assert not [n for n in names if any(w in n for w in ROUTING_WORDS)], names
