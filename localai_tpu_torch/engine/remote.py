"""Out-of-process backends: a remote HTTP proxy and a supervised subprocess
(a copy of localai_tpu/engine/remote.py, spawning the port's own server).

The reference's seam is gRPC: every backend is a separate process speaking
backend.proto, spawned and respawned by the model loader
(pkg/model/initializers.go:50-154, loader.go:236-270 crash respawn). The
port keeps hot models in its own process, next to the CUDA context, and
restores the seam where it matters:

- `RemoteEngine` (backend: remote): requests for the model relay to another
  serving process's OpenAI-compatible HTTP API (the port's or the JAX
  package's server, llama.cpp, vLLM). Config: options.url,
  options.remote_model, options.api_key.
- `SubprocessEngine` (backend: subprocess): the manager spawns a child
  `python -m localai_tpu_torch run --device <the manager's device>
  --preload <name>` with its own models dir and supervises it. The child
  loads its model before it listens, so /readyz answering means the model
  is on its device (the JAX package's child loads at its first request).
  A crash of the child (a bad checkpoint, out of memory, a device fault
  that poisons its CUDA context) fails the requests it was serving, and
  the next request respawns it; the parent's context and its in-process
  models are untouched.

Both answer the lifecycle reads the manager makes of every engine: they
never report dead (`is_dead` False: a subprocess's failure is its child's
exit, which `ensure_up` handles), have no journal and no postmortem, and
hold no device state (`drop_device_state` does nothing). `stop()` of a
subprocess engine ends its child.

The child inherits the parent's environment as it is: the port reads no
variable of it. `options.env` ({name: value}) reaches the child through
POSIX `env` in front of its command, so the overrides sit on top of the
inherited environment without the parent reading it.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Optional

log = logging.getLogger("localai_tpu_torch.remote")

# The directory that holds the package: the child runs from it, so
# `-m localai_tpu_torch` finds the same package as the parent.
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class RemoteEngine:
    """Marker and transport of a proxied model. The API layer checks
    `isinstance(lm.engine, RemoteEngine)` and relays the HTTP request."""

    # The lifecycle surface the manager reads of every engine.
    is_dead = False
    postmortem_path = ""
    journal = None

    # Proxy ceiling when the caller states no budget: long enough for any
    # sane completion, short enough that a wedged peer cannot pin a server
    # thread forever.
    DEFAULT_TIMEOUT_S = 600.0

    def __init__(self, url: str, remote_model: str = "", api_key: str = ""):
        self.base_url = url.rstrip("/")
        self.remote_model = remote_model
        self.api_key = api_key
        self.m_requests = 0

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass

    def cancel_all(self) -> int:
        return 0

    def drop_device_state(self) -> None:
        """Nothing of a proxied model lives in this process."""

    def ensure_up(self) -> None:
        """Hook of the supervised variant; a plain remote assumes its peer."""

    def metrics(self) -> dict[str, float]:
        return {"requests": float(self.m_requests), "remote": 1.0}

    def request(self, path: str, body: Optional[dict], method: str = "POST",
                deadline_s: float = 0.0):
        """Forward one API call; returns the live HTTPResponse.

        `deadline_s` is the request's remaining budget (the body's
        deadline_s, else the model's) and becomes the socket timeout; 0
        falls back to DEFAULT_TIMEOUT_S."""
        self.ensure_up()
        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        data = None
        if body is not None:
            body = dict(body)
            if self.remote_model:
                body["model"] = self.remote_model
            else:
                body.pop("model", None)  # let the remote pick its default
            data = json.dumps(body).encode()
        req = urllib.request.Request(self.base_url + path, data=data, headers=headers,
                                     method=method)
        self.m_requests += 1
        timeout = deadline_s if deadline_s > 0 else self.DEFAULT_TIMEOUT_S
        return urllib.request.urlopen(req, timeout=timeout)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class SubprocessEngine(RemoteEngine):
    """A child server owning one model, supervised by the parent: spawned
    at the first request (health-gated on /readyz, which the child answers
    once its model is loaded), respawned when it has exited, ended by
    stop() (SIGTERM, then SIGKILL after 10 s). The child's output goes to
    `child.log` in its workdir."""

    STARTUP_TIMEOUT_S = 300.0  # process start, imports and the model's load

    def __init__(self, name: str, child_config: dict[str, Any], workdir: str,
                 device: str = "cuda", env_extra: Optional[dict] = None):
        super().__init__(url="http://127.0.0.1:0")
        self.name = name
        self.child_config = {"name": name, **child_config}
        self.workdir = os.path.abspath(workdir)
        self.device = device
        self.env_extra = {str(k): str(v) for k, v in (env_extra or {}).items()}
        self._proc: Optional[subprocess.Popen] = None
        self._lock = threading.Lock()
        self.m_respawns = 0
        self.m_spawn_s = 0.0  # the last spawn's seconds to /readyz

    def command(self, port: int) -> list[str]:
        """The child's command line (with `env NAME=value ...` in front
        when options.env sets any)."""
        cmd = [sys.executable, "-m", "localai_tpu_torch", "run",
               "--address", "127.0.0.1", "--port", str(port),
               "--models-path", self.workdir, "--device", self.device,
               "--preload", self.child_config["name"]]
        if self.env_extra:
            cmd = ["env", *(f"{k}={v}" for k, v in self.env_extra.items()), *cmd]
        return cmd

    def _spawn_locked(self) -> None:
        import yaml

        if self.device.startswith("cuda"):
            # The parent's caching allocator gives its free blocks back to
            # the card before the child claims its own.
            import torch

            torch.cuda.empty_cache()
        port = _free_port()
        os.makedirs(self.workdir, exist_ok=True)
        with open(os.path.join(self.workdir, f"{self.name}.yaml"), "w") as f:
            yaml.safe_dump(self.child_config, f)
        t0 = time.monotonic()
        with open(os.path.join(self.workdir, "child.log"), "ab") as out:
            self._proc = subprocess.Popen(self.command(port), cwd=_PACKAGE_ROOT,
                                          stdin=subprocess.DEVNULL, stdout=out,
                                          stderr=subprocess.STDOUT)
        self.base_url = f"http://127.0.0.1:{port}"
        deadline = t0 + self.STARTUP_TIMEOUT_S
        while time.monotonic() < deadline:
            if self._proc.poll() is not None:
                raise RuntimeError(f"backend subprocess for {self.name!r} exited "
                                   f"rc={self._proc.returncode} (see {self.workdir}/child.log)")
            try:
                with urllib.request.urlopen(self.base_url + "/readyz", timeout=2):
                    self.m_spawn_s = time.monotonic() - t0
                    log.info("backend subprocess %s ready at %s in %.1fs", self.name,
                             self.base_url, self.m_spawn_s)
                    return
            except (urllib.error.URLError, ConnectionError, OSError):
                time.sleep(0.2)
        self._kill_locked()
        raise RuntimeError(f"backend subprocess for {self.name!r} did not become ready in "
                           f"{self.STARTUP_TIMEOUT_S:.0f}s")

    def ensure_up(self) -> None:
        with self._lock:
            if self._proc is None:
                self._spawn_locked()
            elif self._proc.poll() is not None:
                # Crash containment: the child died; respawn it (the
                # reference loader's respawn on crash).
                log.warning("backend subprocess %s died rc=%s — respawning", self.name,
                            self._proc.returncode)
                self.m_respawns += 1
                self._spawn_locked()

    @property
    def pid(self) -> Optional[int]:
        return None if self._proc is None else self._proc.pid

    def _kill_locked(self) -> None:
        if self._proc is not None and self._proc.poll() is None:
            # SIGTERM, then SIGKILL after 10 s: a child wedged in device
            # teardown must not block the parent, and stop() never raises.
            self._proc.terminate()
            try:
                self._proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                log.warning("backend subprocess %s ignored SIGTERM for 10 s — SIGKILL",
                            self.name)
                self._proc.kill()
                try:
                    self._proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    log.error("backend subprocess %s survived SIGKILL — abandoning it",
                              self.name)
        self._proc = None

    def stop(self) -> None:
        with self._lock:
            self._kill_locked()

    def metrics(self) -> dict[str, float]:
        alive = self._proc is not None and self._proc.poll() is None
        return {"requests": float(self.m_requests), "subprocess_alive": float(alive),
                "respawns": float(self.m_respawns), "spawn_s": self.m_spawn_s}
