"""Agent jobs: persistent scheduled prompts run through the agent loop (a
copy of localai_tpu/services/agent_jobs.py).

Reference: core/services/agent_jobs.go (1,382 LoC — a JSON-persisted job
store with cron scheduling and run history, driving agentic prompts). Same
contract here: jobs persist across restarts, fire on `@every Ns`/`@every Nm`
intervals or a 5-field cron subset, keep bounded history, and can be
triggered manually.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
import uuid
from typing import Any, Callable, Optional

log = logging.getLogger("localai_tpu_torch.agent_jobs")

HISTORY_LIMIT = 50


def _parse_every(s: str) -> Optional[float]:
    """`@every 30s` / `@every 5m` / `@every 1h` → seconds."""
    if not s.startswith("@every "):
        return None
    v = s[len("@every "):].strip()
    mult = {"s": 1.0, "m": 60.0, "h": 3600.0}.get(v[-1:])
    if mult is None:
        raise ValueError(f"invalid @every duration {v!r}")
    return float(v[:-1]) * mult


def _cron_field_matches(field: str, value: int) -> bool:
    for part in field.split(","):
        if part == "*":
            return True
        if part.startswith("*/"):
            if value % int(part[2:]) == 0:
                return True
        elif "-" in part:
            lo, hi = part.split("-")
            if int(lo) <= value <= int(hi):
                return True
        elif part.isdigit() and int(part) == value:
            return True
    return False


def cron_matches(expr: str, t: time.struct_time) -> bool:
    """5-field cron subset: minute hour dom month dow (*, */n, a-b, lists)."""
    fields = expr.split()
    if len(fields) != 5:
        raise ValueError(f"cron expression needs 5 fields: {expr!r}")
    minute, hour, dom, mon, dow = fields
    return (
        _cron_field_matches(minute, t.tm_min)
        and _cron_field_matches(hour, t.tm_hour)
        and _cron_field_matches(dom, t.tm_mday)
        and _cron_field_matches(mon, t.tm_mon)
        and _cron_dow_matches(dow, t.tm_wday)
    )


def _cron_dow_matches(field: str, tm_wday: int) -> bool:
    # cron day-of-week is 0=Sunday (7 also accepted as Sunday); python
    # tm_wday is 0=Monday. Convert, and let Sunday match either spelling.
    v = (tm_wday + 1) % 7
    return _cron_field_matches(field, v) or (
        v == 0 and _cron_field_matches(field, 7)
    )


@dataclasses.dataclass
class AgentJob:
    id: str
    name: str
    model: str
    prompt: str
    schedule: str  # "@every 30s" | "m h dom mon dow" | "" (manual only)
    enabled: bool = True
    created_at: float = 0.0
    last_run: float = 0.0
    history: list = dataclasses.field(default_factory=list)

    def validate(self) -> None:
        if not self.name:
            raise ValueError("job name required")
        if not self.prompt:
            raise ValueError("job prompt required")
        if self.schedule and _parse_every(self.schedule) is None:
            cron_matches(self.schedule, time.localtime())  # raises if invalid

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


Runner = Callable[[AgentJob], str]


class AgentJobService:
    """JSON-persisted job store + scheduler thread."""

    def __init__(self, store_path: str, runner: Runner, tick_s: float = 1.0):
        self.store_path = store_path
        self.runner = runner
        self.tick_s = tick_s
        self._jobs: dict[str, AgentJob] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_cron_minute = -1
        self._load()

    # ------------------------------------------------------------------ #
    # Persistence
    # ------------------------------------------------------------------ #

    def _load(self) -> None:
        if not os.path.exists(self.store_path):
            return
        try:
            with open(self.store_path) as f:
                data = json.load(f)
            for j in data.get("jobs", []):
                job = AgentJob(**j)
                self._jobs[job.id] = job
        except (json.JSONDecodeError, TypeError, KeyError) as e:
            log.warning("could not load agent jobs from %s: %s", self.store_path, e)

    def _save_locked(self) -> None:
        os.makedirs(os.path.dirname(self.store_path) or ".", exist_ok=True)
        tmp = self.store_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"jobs": [j.to_dict() for j in self._jobs.values()]}, f, indent=1)
        os.replace(tmp, self.store_path)

    # ------------------------------------------------------------------ #
    # CRUD
    # ------------------------------------------------------------------ #

    def list(self) -> list[AgentJob]:
        with self._lock:
            return sorted(self._jobs.values(), key=lambda j: j.created_at)

    def get(self, job_id: str) -> Optional[AgentJob]:
        with self._lock:
            return self._jobs.get(job_id)

    def create(self, name: str, model: str, prompt: str, schedule: str = "",
               enabled: bool = True) -> AgentJob:
        job = AgentJob(
            id=uuid.uuid4().hex[:12], name=name, model=model, prompt=prompt,
            schedule=schedule, enabled=enabled, created_at=time.time(),
        )
        job.validate()
        with self._lock:
            self._jobs[job.id] = job
            self._save_locked()
        return job

    def update(self, job_id: str, **patch) -> Optional[AgentJob]:
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                return None
            for k, v in patch.items():
                if k in ("name", "model", "prompt", "schedule", "enabled") and v is not None:
                    setattr(job, k, v)
            job.validate()
            self._save_locked()
            return job

    def delete(self, job_id: str) -> bool:
        with self._lock:
            if self._jobs.pop(job_id, None) is None:
                return False
            self._save_locked()
            return True

    # ------------------------------------------------------------------ #
    # Execution
    # ------------------------------------------------------------------ #

    def run_now(self, job_id: str) -> Optional[dict]:
        job = self.get(job_id)
        if job is None:
            return None
        return self._execute(job)

    def _execute(self, job: AgentJob) -> dict:
        t0 = time.time()
        entry: dict[str, Any] = {"started_at": t0}
        try:
            entry["result"] = self.runner(job)
            entry["ok"] = True
        except Exception as e:  # noqa: BLE001 — recorded, scheduler survives
            entry["ok"] = False
            entry["error"] = f"{type(e).__name__}: {e}"
            log.warning("agent job %s (%s) failed: %s", job.name, job.id, e)
        entry["duration_s"] = time.time() - t0
        with self._lock:
            job.last_run = t0
            job.history.append(entry)
            del job.history[:-HISTORY_LIMIT]
            self._save_locked()
        return entry

    # ------------------------------------------------------------------ #
    # Scheduler
    # ------------------------------------------------------------------ #

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="agent-jobs")
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.tick_s):
            now = time.time()
            lt = time.localtime(now)
            cron_minute = lt.tm_min if self._last_cron_minute != lt.tm_min else None
            for job in self.list():
                if not job.enabled or not job.schedule:
                    continue
                try:
                    every = _parse_every(job.schedule)
                except ValueError:
                    continue
                due = False
                if every is not None:
                    due = now - job.last_run >= every
                elif cron_minute is not None:
                    try:
                        due = cron_matches(job.schedule, lt) and now - job.last_run >= 60
                    except ValueError:
                        due = False
                if due:
                    self._execute(job)
            if cron_minute is not None:
                self._last_cron_minute = lt.tm_min
