"""Application services (reference: core/services — gallery installs, agent
jobs, metrics; copies of localai_tpu/services/)."""

from localai_tpu_torch.services.agent_jobs import AgentJob, AgentJobService  # noqa: F401
