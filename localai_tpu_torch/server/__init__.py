"""HTTP API server: the OpenAI-compatible text routes over the port's engine.

Stdlib ThreadingHTTPServer (server/app.py), a model manager with virtual
models for runtime LoRA tenants (server/manager.py), the chat /
completions / embeddings routes (server/openai_api.py), rerank
(server/rerank_api.py) and the vector stores (server/stores_api.py).
Start it with `python -m localai_tpu_torch run`.
"""

from localai_tpu_torch.server.app import Router, create_server  # noqa: F401
from localai_tpu_torch.server.manager import ModelManager  # noqa: F401
from localai_tpu_torch.server.openai_api import OpenAIApi  # noqa: F401
