"""MCP agent endpoint + agent-jobs CRUD (a copy of
localai_tpu/server/mcp_api.py).

Reference: endpoints/localai/mcp.go (POST /mcp/v1/chat/completions — chat
with an MCP tool-calling loop) and the agent-jobs routes over
core/services/agent_jobs.go.
"""

from __future__ import annotations

from typing import Optional

from localai_tpu_torch.config import Usecase
from localai_tpu_torch.server.app import ApiError, Request, Response, Router
from localai_tpu_torch.server.manager import ModelManager
from localai_tpu_torch.server.openai_api import OpenAIApi, _fingerprint, _now
from localai_tpu_torch.services.agent_jobs import AgentJob, AgentJobService


class McpApi:
    def __init__(self, manager: ModelManager, base: OpenAIApi,
                 jobs: Optional[AgentJobService] = None):
        self.manager = manager
        self._base = base
        self.jobs = jobs

    def register(self, r: Router) -> None:
        r.add("POST", "/mcp/v1/chat/completions", self.mcp_chat)
        r.add("POST", "/mcp/chat/completions", self.mcp_chat)
        if self.jobs is not None:
            r.add("GET", "/agent-jobs", self.list_jobs)
            r.add("POST", "/agent-jobs", self.create_job)
            r.add("GET", "/agent-jobs/:id", self.get_job)
            r.add("PUT", "/agent-jobs/:id", self.update_job)
            r.add("DELETE", "/agent-jobs/:id", self.delete_job)
            r.add("POST", "/agent-jobs/:id/run", self.run_job)
            r.add("GET", "/agent-jobs/:id/history", self.job_history)

    # ------------------------------------------------------------------ #
    # MCP chat
    # ------------------------------------------------------------------ #

    def mcp_chat(self, req: Request) -> Response:
        from localai_tpu_torch.mcp import agent_loop
        from localai_tpu_torch.mcp.agent import make_engine_chat_fn
        from localai_tpu_torch.mcp.client import clients_from_config

        body = req.body or {}
        messages = body.get("messages")
        if not messages or not isinstance(messages, list):
            raise ApiError(400, "messages is required and must be a non-empty array")
        lm, lease = self._base._resolve(req, Usecase.CHAT)
        clients = []
        try:
            mcp_cfg = lm.cfg.options.get("mcp") or {}
            clients = clients_from_config(mcp_cfg)
            chat_fn = make_engine_chat_fn(
                lm,
                max_tokens=int(body.get("max_tokens") or lm.cfg.max_tokens),
                temperature=body.get("temperature"),
            )
            result = agent_loop(
                chat_fn, messages, clients,
                max_iterations=int(body.get("max_iterations") or 10),
            )
        finally:
            lease.release()
            for c in clients:
                if hasattr(c, "close"):
                    c.close()
        return Response(body={
            "id": f"mcpcmpl-{_now()}",
            "object": "chat.completion",
            "created": _now(),
            "model": lm.cfg.name,
            "system_fingerprint": _fingerprint(),
            "choices": [{
                "index": 0,
                "message": result["message"],
                "finish_reason": "stop",
            }],
            "agent": {
                "iterations": result["iterations"],
                "tool_calls": result["tool_calls"],
            },
        })

    # ------------------------------------------------------------------ #
    # Agent jobs
    # ------------------------------------------------------------------ #

    def _job(self, req: Request) -> AgentJob:
        job = self.jobs.get(req.params["id"])
        if job is None:
            raise ApiError(404, f"agent job {req.params['id']!r} not found")
        return job

    @staticmethod
    def _render(job: AgentJob, with_history: bool = False) -> dict:
        d = job.to_dict()
        if not with_history:
            d["history_len"] = len(d.pop("history"))
        return d

    def list_jobs(self, req: Request) -> Response:
        """List agent jobs."""
        return Response(body={"jobs": [self._render(j) for j in self.jobs.list()]})

    def create_job(self, req: Request) -> Response:
        """Create an agent job ({name, model, prompt, schedule, enabled})."""
        body = req.body or {}
        try:
            job = self.jobs.create(
                name=body.get("name", ""),
                model=body.get("model", ""),
                prompt=body.get("prompt", ""),
                schedule=body.get("schedule", ""),
                enabled=bool(body.get("enabled", True)),
            )
        except ValueError as e:
            raise ApiError(400, str(e)) from None
        return Response(status=201, body=self._render(job))

    def get_job(self, req: Request) -> Response:
        return Response(body=self._render(self._job(req), with_history=True))

    def update_job(self, req: Request) -> Response:
        body = req.body or {}
        try:
            job = self.jobs.update(req.params["id"], **{
                k: body.get(k) for k in ("name", "model", "prompt", "schedule", "enabled")
            })
        except ValueError as e:
            raise ApiError(400, str(e)) from None
        if job is None:
            raise ApiError(404, f"agent job {req.params['id']!r} not found")
        return Response(body=self._render(job))

    def delete_job(self, req: Request) -> Response:
        if not self.jobs.delete(req.params["id"]):
            raise ApiError(404, f"agent job {req.params['id']!r} not found")
        return Response(body={"status": "deleted"})

    def run_job(self, req: Request) -> Response:
        """Trigger a job immediately; returns the history entry."""
        entry = self.jobs.run_now(req.params["id"])
        if entry is None:
            raise ApiError(404, f"agent job {req.params['id']!r} not found")
        return Response(body=entry)

    def job_history(self, req: Request) -> Response:
        return Response(body={"history": self._job(req).history})


def make_job_runner(manager: ModelManager):
    """Default job runner: agent loop over the job's model (MCP tools from
    the model's config)."""

    def run(job: AgentJob) -> str:
        from localai_tpu_torch.mcp import agent_loop
        from localai_tpu_torch.mcp.agent import make_engine_chat_fn
        from localai_tpu_torch.mcp.client import clients_from_config

        lm, lease = manager.lease(job.model)
        clients = []
        try:
            clients = clients_from_config(lm.cfg.options.get("mcp") or {})
            result = agent_loop(
                make_engine_chat_fn(lm),
                [{"role": "user", "content": job.prompt}],
                clients,
            )
            return result["message"].get("content") or ""
        finally:
            lease.release()
            for c in clients:
                if hasattr(c, "close"):
                    c.close()

    return run
