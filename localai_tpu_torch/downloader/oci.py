"""OCI registry / ollama model puller (a copy of localai_tpu/downloader/oci.py).

Reference: pkg/oci (container/ollama image pulls feeding the gallery) and
the `oci://` / `ollama://` URI schemes in pkg/downloader. Implements the
distribution-spec subset a model pull needs: anonymous token auth, manifest
fetch, layer selection by media type, blob download with digest naming.

`ollama://model[:tag]` resolves against registry.ollama.ai with the
`library/` namespace default; `oci://registry/repo:tag` fetches the largest
layer (the model blob) from any v2 registry. The ollama registry is a
parameter, `registry` (the public one by default), for mirrors and
hermetic tests. This module reads no environment variable (the JAX
package's reads OLLAMA_REGISTRY).
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.request
from typing import Callable, Optional

from localai_tpu_torch.downloader.uri import DownloadError, download

ProgressCb = Callable[[int, int], None]

OLLAMA_MODEL_MEDIA_TYPE = "application/vnd.ollama.image.model"


DEFAULT_OLLAMA_REGISTRY = "https://registry.ollama.ai"


def _get(url: str, headers: Optional[dict] = None) -> tuple[bytes, dict]:
    req = urllib.request.Request(url, headers=headers or {})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read(), dict(r.headers)


def _auth_token(base: str, repo: str) -> Optional[str]:
    """Anonymous pull token via the WWW-Authenticate dance (distribution
    spec); registries without auth just serve the manifest directly."""
    try:
        _get(f"{base}/v2/{repo}/manifests/latest",
             {"Accept": "application/vnd.docker.distribution.manifest.v2+json"})
        return None  # no auth required
    except urllib.error.HTTPError as e:
        if e.code != 401:
            return None
        challenge = e.headers.get("WWW-Authenticate", "")
    params = {}
    for part in challenge.split(" ", 1)[-1].split(","):
        if "=" in part:
            k, v = part.split("=", 1)
            params[k.strip()] = v.strip('" ')
    realm = params.get("realm")
    if not realm:
        return None
    qs = f"?service={params.get('service', '')}&scope=repository:{repo}:pull"
    body, _ = _get(realm + qs)
    return json.loads(body).get("token")


def _manifest(base: str, repo: str, tag: str, token: Optional[str]) -> dict:
    headers = {
        "Accept": "application/vnd.docker.distribution.manifest.v2+json, "
                  "application/vnd.oci.image.manifest.v1+json",
    }
    if token:
        headers["Authorization"] = f"Bearer {token}"
    try:
        body, _ = _get(f"{base}/v2/{repo}/manifests/{tag}", headers)
    except Exception as e:  # noqa: BLE001
        raise DownloadError(f"manifest fetch failed for {repo}:{tag}: {e}") from None
    return json.loads(body)


def _pick_layer(manifest: dict, media_type: Optional[str]) -> dict:
    layers = manifest.get("layers") or []
    if not layers:
        raise DownloadError("manifest has no layers")
    if media_type:
        for layer in layers:
            if layer.get("mediaType") == media_type:
                return layer
    return max(layers, key=lambda l: l.get("size", 0))  # model blob = biggest


def pull_ollama(
    name: str,
    dest_dir: str,
    progress: Optional[ProgressCb] = None,
    registry: str = DEFAULT_OLLAMA_REGISTRY,
) -> str:
    """`model[:tag]` (ollama namespace rules) → downloaded model blob path."""
    tag = "latest"
    if ":" in name:
        name, tag = name.rsplit(":", 1)
    repo = name if "/" in name else f"library/{name}"
    return pull_oci_blob(
        registry.rstrip("/"), repo, tag, dest_dir,
        media_type=OLLAMA_MODEL_MEDIA_TYPE, progress=progress,
        filename=f"{name.replace('/', '_')}-{tag}.bin",
    )


def pull_oci_blob(
    base: str,
    repo: str,
    tag: str,
    dest_dir: str,
    media_type: Optional[str] = None,
    progress: Optional[ProgressCb] = None,
    filename: Optional[str] = None,
) -> str:
    """Fetch one model layer from an OCI registry; returns the local path."""
    token = _auth_token(base, repo)
    manifest = _manifest(base, repo, tag, token)
    layer = _pick_layer(manifest, media_type)
    digest = layer["digest"]
    os.makedirs(dest_dir, exist_ok=True)
    local = os.path.join(dest_dir, filename or digest.replace(":", "_"))
    url = f"{base}/v2/{repo}/blobs/{digest}"
    # downloader.uri handles .partial staging/resume; digest gives us the
    # content hash for verification when it is sha256.
    sha = digest.split(":", 1)[1] if digest.startswith("sha256:") else None
    headers = {"Authorization": f"Bearer {token}"} if token else None
    download(url, local, sha256=sha, progress=progress, headers=headers)
    return local


def resolve_model_uri(uri: str, dest_dir: str, progress: Optional[ProgressCb] = None,
                      registry: str = DEFAULT_OLLAMA_REGISTRY) -> str:
    """Entry point for gallery installs: ollama:// and oci:// URIs."""
    if uri.startswith("ollama://"):
        return pull_ollama(uri[len("ollama://"):], dest_dir, progress, registry)
    if uri.startswith("oci://"):
        rest = uri[len("oci://"):]
        # The tag separator is the last ':' AFTER the last '/' — a colon
        # before the first slash is a registry port (oci://host:5000/repo:tag).
        idx = rest.rfind(":")
        if idx > rest.rfind("/"):
            hostrepo, tag = rest[:idx], rest[idx + 1:]
        else:
            hostrepo, tag = rest, ""
        if "/" not in hostrepo:
            raise DownloadError(f"oci:// URI needs registry/repo:tag, got {uri!r}")
        host, _, repo = hostrepo.partition("/")
        return pull_oci_blob(f"https://{host}", repo, tag or "latest", dest_dir,
                             progress=progress)
    raise DownloadError(f"unsupported OCI URI {uri!r}")
