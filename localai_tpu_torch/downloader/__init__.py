"""Artifact downloader: URI schemes, range-resume, checksum verification
(copies of localai_tpu/downloader/, which imports no JAX; the hub and
registry endpoints are parameters here, never environment reads).

Reference: pkg/downloader/uri.go (schemes huggingface://, file://, http(s)
at uri.go:27-37; `.partial` + HTTP Range resume + SHA verification at
uri.go:373-459), pkg/downloader/huggingface.go (Hub API), pkg/oci
(ollama/OCI registry pulls).
"""

from localai_tpu_torch.downloader.uri import DownloadError, download, resolve_uri  # noqa: F401
from localai_tpu_torch.downloader.hf_api import fetch_hf_model, list_repo_files  # noqa: F401
from localai_tpu_torch.downloader.oci import pull_ollama, resolve_model_uri  # noqa: F401
