"""HTTP API server: the OpenAI-compatible text routes over the port's engine.

Stdlib ThreadingHTTPServer (server/app.py), a model manager with virtual
models for runtime LoRA tenants (server/manager.py) and the chat /
completions routes (server/openai_api.py). Start it with
`python -m localai_tpu_torch run`.
"""

from localai_tpu_torch.server.app import Router, create_server  # noqa: F401
from localai_tpu_torch.server.manager import ModelManager  # noqa: F401
from localai_tpu_torch.server.openai_api import OpenAIApi  # noqa: F401
