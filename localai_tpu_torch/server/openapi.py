"""OpenAPI 3.0 document generated from the live routing table (a copy of
localai_tpu/server/openapi.py; the body schemas of routes the port does not
serve yet are kept and apply only once such a route is declared).

Reference: the swagger module (core/http/app.go mounts /swagger with
generated docs). Here the doc is built from Router.declared at request time
— every registered route appears, summaries come from handler docstrings,
and known OpenAI-compatible paths carry request-body schemas.
"""

from __future__ import annotations

from typing import Any

from localai_tpu_torch.server.app import Request, Response, Router

_BODY_SCHEMAS: dict[str, dict[str, Any]] = {
    "/v1/chat/completions": {
        "required": ["messages"],
        "properties": {
            "model": {"type": "string"},
            "messages": {"type": "array", "items": {"type": "object"}},
            "stream": {"type": "boolean"},
            "max_tokens": {"type": "integer"},
            "temperature": {"type": "number"},
            "top_p": {"type": "number"},
            "n": {"type": "integer"},
            "logprobs": {"type": "boolean"},
            "top_logprobs": {"type": "integer"},
            "tools": {"type": "array", "items": {"type": "object"}},
            "response_format": {"type": "object"},
            "seed": {"type": "integer"},
            "stop": {"type": "array", "items": {"type": "string"}},
            "grammar": {"type": "string",
                        "description": "raw GBNF grammar constraining output"},
        },
    },
    "/v1/completions": {
        "required": ["prompt"],
        "properties": {
            "model": {"type": "string"},
            "prompt": {"oneOf": [{"type": "string"}, {"type": "array"}]},
            "stream": {"type": "boolean"},
            "max_tokens": {"type": "integer"},
            "n": {"type": "integer"},
            "logprobs": {"type": "integer"},
            "echo": {"type": "boolean"},
            "grammar": {"type": "string",
                        "description": "raw GBNF grammar constraining output"},
        },
    },
    "/v1/embeddings": {
        "required": ["input"],
        "properties": {
            "model": {"type": "string"},
            "input": {"oneOf": [{"type": "string"}, {"type": "array"}]},
        },
    },
    "/v1/images/generations": {
        "required": ["prompt"],
        "properties": {
            "model": {"type": "string"}, "prompt": {"type": "string"},
            "n": {"type": "integer"}, "size": {"type": "string"},
            "steps": {"type": "integer"}, "seed": {"type": "integer"},
            "response_format": {"type": "string", "enum": ["url", "b64_json"]},
            "control_image": {"type": "string",
                              "description": "base64 PNG/JPEG ControlNet condition"},
            "control_scale": {"type": "number"},
            "image": {"type": "string",
                      "description": "base64 img2img source (alias: src)"},
            "strength": {"type": "number"},
        },
    },
    "/v1/videos": {
        "required": ["prompt"],
        "properties": {
            "model": {"type": "string"}, "prompt": {"type": "string"},
            "n_frames": {"type": "integer"}, "steps": {"type": "integer"},
            "seed": {"type": "integer"},
            "negative_prompt": {"type": "string"},
            "image": {"type": "string",
                      "description": "base64 image→video source (aliases: "
                                     "file, src)"},
            "strength": {"type": "number"},
            "format": {"type": "string", "enum": ["mp4", "gif"]},
            "frame_ms": {"type": "integer"},
        },
    },
    "/v1/sound-generation": {
        "required": ["text"],
        "properties": {
            "model_id": {"type": "string"}, "text": {"type": "string"},
            "duration_seconds": {"type": "number"},
            "prompt_influence": {"type": "number"},
            "do_sample": {"type": "boolean"}, "seed": {"type": "integer"},
            "response_format": {"type": "string", "enum": ["wav", "pcm"]},
        },
    },
    "/v1/audio/speech": {
        "required": ["input"],
        "properties": {
            "model": {"type": "string"}, "input": {"type": "string"},
            "voice": {"type": "string"},
            "response_format": {"type": "string", "enum": ["wav", "pcm"]},
        },
    },
    "/v1/rerank": {
        "required": ["query", "documents"],
        "properties": {
            "model": {"type": "string"}, "query": {"type": "string"},
            "documents": {"type": "array"}, "top_n": {"type": "integer"},
        },
    },
}


def build_openapi(router: Router, title: str = "localai-tpu-torch") -> dict[str, Any]:
    from localai_tpu_torch import __version__

    paths: dict[str, dict[str, Any]] = {}
    for method, pattern, handler in router.declared:
        # OpenAPI path templating: `:name` → `{name}`
        path = "/".join(
            "{" + seg[1:] + "}" if seg.startswith(":") else seg
            for seg in pattern.split("/")
        )
        doc = (handler.__doc__ or "").strip().splitlines()
        summary = doc[0] if doc else ""
        op: dict[str, Any] = {
            "summary": summary,
            "responses": {"200": {"description": "success"}},
        }
        params = [seg[1:] for seg in pattern.split("/") if seg.startswith(":")]
        if params:
            op["parameters"] = [
                {"name": p, "in": "path", "required": True, "schema": {"type": "string"}}
                for p in params
            ]
        schema = _BODY_SCHEMAS.get(pattern)
        if schema and method == "POST":
            op["requestBody"] = {
                "required": True,
                "content": {"application/json": {"schema": {"type": "object", **schema}}},
            }
        paths.setdefault(path, {})[method.lower()] = op
    return {
        "openapi": "3.0.3",
        "info": {
            "title": title,
            "version": __version__,
            "description": "LocalAI-compatible API on one NVIDIA GPU",
        },
        "paths": dict(sorted(paths.items())),
    }


def register_openapi(router: Router) -> None:
    def swagger_json(req: Request) -> Response:
        """OpenAPI 3.0 document for every registered route."""
        return Response(body=build_openapi(router))

    def swagger_html(req: Request) -> Response:
        """Interactive API browser (no external assets)."""
        return Response(body=_SWAGGER_HTML, content_type="text/html; charset=utf-8")

    router.add("GET", "/swagger.json", swagger_json)
    router.add("GET", "/swagger", swagger_html)


_SWAGGER_HTML = """<!doctype html><html><head><meta charset="utf-8">
<title>localai-tpu-torch API</title><style>
body{font-family:system-ui,sans-serif;margin:2rem;max-width:960px}
.op{border:1px solid #ddd;border-radius:6px;margin:.5rem 0;padding:.6rem 1rem}
.m{display:inline-block;min-width:4rem;font-weight:700}
.m.get{color:#0a7} .m.post{color:#07a} .m.delete{color:#a33}
code{background:#f5f5f5;padding:.1rem .3rem;border-radius:3px}
pre{background:#f8f8f8;padding:.6rem;border-radius:4px;overflow-x:auto}
</style></head><body><h1>localai-tpu-torch API</h1><div id="ops">loading…</div>
<script>
fetch('/swagger.json').then(r=>r.json()).then(doc=>{
  const el=document.getElementById('ops');el.innerHTML='';
  for(const [path,ops] of Object.entries(doc.paths)){
    for(const [m,op] of Object.entries(ops)){
      const d=document.createElement('div');d.className='op';
      let html=`<span class="m ${m}">${m.toUpperCase()}</span> <code>${path}</code>`;
      if(op.summary) html+=`<div>${op.summary}</div>`;
      if(op.requestBody){
        const s=op.requestBody.content['application/json'].schema;
        html+=`<pre>${JSON.stringify(s,null,1)}</pre>`;
      }
      d.innerHTML=html;el.appendChild(d);
    }
  }
});
</script></body></html>"""
