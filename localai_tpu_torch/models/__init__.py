"""Model families (PyTorch): the Llama-family decoder and its configs."""

from localai_tpu_torch.models.config import ArchConfig, PRESETS, get_arch  # noqa: F401
