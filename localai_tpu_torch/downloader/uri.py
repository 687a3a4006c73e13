"""Artifact downloader: URI schemes, range-resume, checksum verification (a
copy of localai_tpu/downloader/uri.py).

Reference: pkg/downloader/uri.go — scheme resolution at uri.go:27-37
(`huggingface://`, `file://`, `github:`, http(s)), download with `.partial`
staging + HTTP Range resume + SHA-256 verification at uri.go:373-459.
OCI / ollama pulls are downloader/oci.py.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import urllib.error
import urllib.request
from typing import Callable, Optional

ProgressCb = Callable[[int, int], None]  # (downloaded_bytes, total_bytes or -1)

_CHUNK = 1 << 20


class DownloadError(Exception):
    pass


def resolve_uri(uri: str) -> str:
    """Normalize gallery URI schemes into fetchable URLs.

    huggingface://owner/repo/path/file → HF resolve URL (uri.go:180-220);
    github:owner/repo/path@branch → raw.githubusercontent URL (uri.go:27-37);
    file:// and http(s) pass through.
    """
    if uri.startswith("huggingface://"):
        rest = uri[len("huggingface://"):]
        parts = rest.split("/")
        if len(parts) < 3:
            raise DownloadError(
                f"huggingface:// URI needs owner/repo/file, got {uri!r}"
            )
        owner, repo, path = parts[0], parts[1], "/".join(parts[2:])
        branch = "main"
        if "@" in repo:
            repo, branch = repo.split("@", 1)
        return f"https://huggingface.co/{owner}/{repo}/resolve/{branch}/{path}"
    if uri.startswith("github:"):
        rest = uri[len("github:"):].lstrip("/")
        branch = "main"
        if "@" in rest:
            rest, branch = rest.split("@", 1)
        parts = rest.split("/")
        if len(parts) < 3:
            raise DownloadError(f"github: URI needs owner/repo/path, got {uri!r}")
        owner, repo, path = parts[0], parts[1], "/".join(parts[2:])
        return f"https://raw.githubusercontent.com/{owner}/{repo}/{branch}/{path}"
    return uri


def _sha256_of(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            blk = f.read(_CHUNK)
            if not blk:
                break
            h.update(blk)
    return h.hexdigest()


def download(
    uri: str,
    dest: str,
    sha256: Optional[str] = None,
    progress: Optional[ProgressCb] = None,
    timeout: float = 60.0,
    headers: Optional[dict] = None,
) -> str:
    """Fetch `uri` to `dest` with resume + checksum verify; returns dest.

    Semantics mirror uri.go:373-459: data lands in `<dest>.partial`; an
    existing partial resumes via HTTP Range; the finished file is verified
    against `sha256` (when given) before an atomic rename onto `dest`. A
    pre-existing `dest` with a matching checksum short-circuits.
    """
    url = resolve_uri(uri)
    os.makedirs(os.path.dirname(os.path.abspath(dest)) or ".", exist_ok=True)

    if os.path.exists(dest):
        if sha256 is None or _sha256_of(dest) == sha256.lower():
            return dest
        os.remove(dest)  # stale/corrupt — refetch

    partial = dest + ".partial"

    if url.startswith("file://"):
        src = urllib.request.url2pathname(url[len("file://"):])
        if not os.path.exists(src):
            raise DownloadError(f"{uri}: local file {src!r} not found")
        shutil.copyfile(src, partial)
        if progress is not None:
            size = os.path.getsize(partial)
            progress(size, size)
    elif url.startswith(("http://", "https://")):
        offset = os.path.getsize(partial) if os.path.exists(partial) else 0
        hdrs = {"User-Agent": "localai-tpu", **(headers or {})}
        if offset:
            hdrs["Range"] = f"bytes={offset}-"
        req = urllib.request.Request(url, headers=hdrs)
        try:
            resp = urllib.request.urlopen(req, timeout=timeout)
        except urllib.error.HTTPError as e:
            if e.code == 416 and offset:  # partial already complete
                resp = None
            else:
                raise DownloadError(f"{uri}: HTTP {e.code} {e.reason}") from e
        except urllib.error.URLError as e:
            raise DownloadError(f"{uri}: {e.reason}") from e
        if resp is not None:
            with resp:
                if offset and resp.status != 206:
                    # Server ignored the Range request — restart from zero.
                    offset = 0
                total = -1
                clen = resp.headers.get("Content-Length")
                if clen is not None:
                    total = offset + int(clen)
                mode = "ab" if offset else "wb"
                done = offset
                with open(partial, mode) as out:
                    while True:
                        blk = resp.read(_CHUNK)
                        if not blk:
                            break
                        out.write(blk)
                        done += len(blk)
                        if progress is not None:
                            progress(done, total)
    else:
        raise DownloadError(f"unsupported URI scheme: {uri!r}")

    if sha256 is not None:
        got = _sha256_of(partial)
        if got != sha256.lower():
            os.remove(partial)  # poisoned — never resume from it
            raise DownloadError(
                f"{uri}: sha256 mismatch: got {got}, want {sha256.lower()}"
            )
    os.replace(partial, dest)
    return dest
