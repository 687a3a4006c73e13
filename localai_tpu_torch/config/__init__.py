"""Configuration: per-model YAML configs and application-level settings
(copies of localai_tpu/config/, which imports no JAX).

Re-design of the reference's three-tier config system (SURVEY.md §5):
CLI flags/env → ApplicationConfig; per-model YAML → ModelConfig with
defaulting, validation and usecase flags (reference:
core/config/model_config.go:31-83, :520-538, application_config.go).
"""

from localai_tpu_torch.config.model_config import (  # noqa: F401
    LoraConfigError,
    ModelConfig,
    ModelConfigLoader,
    Usecase,
)
from localai_tpu_torch.config.app_config import ApplicationConfig  # noqa: F401
