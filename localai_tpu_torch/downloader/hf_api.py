"""HuggingFace Hub API client: repo file listing + whole-model fetch (a copy
of localai_tpu/downloader/hf_api.py).

Reference: pkg/downloader/huggingface.go (HF API scan for gallery entries)
and the `huggingface://` scheme. Single files go through downloader.uri;
this module adds the repo-level operations: list files via the Hub API and
fetch everything a serving checkpoint needs (config, safetensors shards,
tokenizer) into a local directory.

The API base is a parameter, `endpoint` (the public hub by default), so
air-gapped mirrors and hermetic tests work unchanged. The server passes
ApplicationConfig.hf_endpoint (LOCALAI_HF_ENDPOINT); this module reads no
environment variable (the JAX package's reads HF_ENDPOINT).
"""

from __future__ import annotations

import json
import os
import urllib.request
from typing import Callable, Optional

from localai_tpu_torch.downloader.uri import DownloadError, download

ProgressCb = Callable[[str, int, int], None]  # (filename, done, total)

# Files a serving checkpoint needs (everything else in a repo is skipped).
_WANTED_EXACT = {
    "config.json", "generation_config.json",
    "tokenizer.json", "tokenizer.model", "tokenizer_config.json",
    "special_tokens_map.json", "vocab.json", "vocab.txt", "merges.txt",
    "model.safetensors.index.json", "preprocessor_config.json",
}


DEFAULT_HF_ENDPOINT = "https://huggingface.co"


def list_repo_files(repo: str, branch: str = "main", token: Optional[str] = None,
                    endpoint: str = DEFAULT_HF_ENDPOINT) -> list[dict]:
    """[{path, size}] for a model repo via the Hub tree API."""
    url = f"{endpoint.rstrip('/')}/api/models/{repo}/tree/{branch}?recursive=true"
    headers = {"Accept": "application/json"}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(url, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            entries = json.loads(r.read())
    except Exception as e:  # noqa: BLE001
        raise DownloadError(f"HF API listing failed for {repo!r}: {e}") from None
    return [
        {"path": e["path"], "size": e.get("size", 0)}
        for e in entries
        if e.get("type") == "file"
    ]


def checkpoint_files(files: list[dict]) -> list[str]:
    """Subset of repo files a serving checkpoint needs."""
    out = []
    for f in files:
        path = f["path"]
        base = os.path.basename(path)
        if base in _WANTED_EXACT or (
            base.endswith(".safetensors") and not base.startswith("tf_")
        ):
            out.append(path)
    return out


def fetch_hf_model(
    repo: str,
    dest_dir: str,
    branch: str = "main",
    token: Optional[str] = None,
    progress: Optional[ProgressCb] = None,
    endpoint: str = DEFAULT_HF_ENDPOINT,
) -> list[str]:
    """Download a full serving checkpoint (config + weights + tokenizer)
    into dest_dir with per-file resume. Returns the local paths."""
    files = checkpoint_files(list_repo_files(repo, branch, token, endpoint))
    if not files:
        raise DownloadError(f"repo {repo!r} has no safetensors checkpoint files")
    os.makedirs(dest_dir, exist_ok=True)
    out = []
    for path in files:
        url = f"{endpoint.rstrip('/')}/{repo}/resolve/{branch}/{path}"
        local = os.path.join(dest_dir, os.path.basename(path))
        cb = (lambda done, total, _p=path: progress(_p, done, total)) if progress else None
        download(url, local, progress=cb)
        out.append(local)
    return out
