"""Engine flight-recorder dumps (a copy of localai_tpu/observe/postmortem.py).

When an engine loop dies (or the manager quarantines a crash-looping
model), the dying thread writes the last N journal events plus an engine
state snapshot — live slots, pool accounting, pending depth — to a JSON
file. The path rides the `loop_dead` gauge labels and the manager log, so
a silent hang becomes a five-minute read: which requests were live, what
the loop dispatched last, where the pool stood. The payload is built from
host state only, so a dump survives a device context that a real fault
poisoned.

Writes are atomic (tmp + rename) and best-effort: a full disk must never
mask the original crash.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

DEFAULT_DIRNAME = "localai-postmortems"


def default_dir() -> str:
    """Fallback postmortem directory when no `postmortem_dir` /
    LOCALAI_POSTMORTEM_DIR is configured: a stable tempdir child, so
    dumps survive the process but never litter a working tree."""
    return os.path.join(tempfile.gettempdir(), DEFAULT_DIRNAME)


def write(dirpath: str, name: str, payload: dict) -> str:
    """Atomically write one postmortem JSON; returns its path."""
    dirpath = dirpath or default_dir()
    os.makedirs(dirpath, exist_ok=True)
    safe = "".join(c if (c.isalnum() or c in "-_.") else "_" for c in name)
    fname = f"postmortem-{safe}-{int(time.time() * 1000)}-{os.getpid()}.json"
    path = os.path.join(dirpath, fname)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, default=str)
        f.write("\n")
    os.replace(tmp, path)
    return path
