"""Template evaluation for chat / completion / edit prompts (a copy of
localai_tpu/templates/evaluator.py).

Selection order per request type (reference: evaluator.go:58-90 per-type
selection; :96-230 message loop):

  chat:       tokenizer chat template (use_tokenizer_template)
            → custom `template.chat` (jinja2 over the whole conversation)
            → custom `template.chat_message` (jinja2 per message, joined)
            → built-in `template.family` (llama3 / chatml / mistral / alpaca)
            → plain role-prefixed fallback
  completion: custom `template.completion` → prompt as-is
  edit:       custom `template.edit` → instruction+input fallback

Tool/function definitions are injected as a system-prompt suffix
(`tools_prompt`), the moral equivalent of the reference's function-grammar
injection into the Functions template (evaluator.go:96-230).
"""

from __future__ import annotations

from typing import Any, Optional

import jinja2

from localai_tpu_torch.config.model_config import ModelConfig

_ENV = jinja2.Environment(
    loader=jinja2.BaseLoader(),
    undefined=jinja2.ChainableUndefined,
    trim_blocks=True,
    lstrip_blocks=True,
)

# Built-in conversation templates for common model families. Each receives
# `messages` (normalized role/content dicts) and `add_generation_prompt`.
FAMILY_TEMPLATES: dict[str, str] = {
    "llama3": (
        "{% for m in messages %}"
        "<|start_header_id|>{{ m.role }}<|end_header_id|>\n\n{{ m.content }}<|eot_id|>"
        "{% endfor %}"
        "{% if add_generation_prompt %}<|start_header_id|>assistant<|end_header_id|>\n\n{% endif %}"
    ),
    "chatml": (
        "{% for m in messages %}"
        "<|im_start|>{{ m.role }}\n{{ m.content }}<|im_end|>\n"
        "{% endfor %}"
        "{% if add_generation_prompt %}<|im_start|>assistant\n{% endif %}"
    ),
    "mistral": (
        "{% for m in messages %}"
        "{% if m.role == 'user' %}[INST] {{ m.content }} [/INST]"
        "{% elif m.role == 'assistant' %}{{ m.content }}</s>"
        "{% else %}{{ m.content }}\n{% endif %}"
        "{% endfor %}"
    ),
    "alpaca": (
        "{% for m in messages %}"
        "{% if m.role == 'system' %}{{ m.content }}\n\n"
        "{% elif m.role == 'user' %}### Instruction:\n{{ m.content }}\n\n"
        "{% else %}### Response:\n{{ m.content }}\n\n{% endif %}"
        "{% endfor %}"
        "{% if add_generation_prompt %}### Response:\n{% endif %}"
    ),
}


def normalize_messages(messages: list[dict[str, Any]]) -> list[dict[str, str]]:
    """Flatten OpenAI message content (string or content-part list) to text.

    Reference: core/schema/message.go content-part parsing. Image/audio parts
    are dropped here; multimodal models consume them separately.
    """
    out = []
    for m in messages:
        content = m.get("content")
        if isinstance(content, list):
            texts = [p.get("text", "") for p in content if isinstance(p, dict) and p.get("type") == "text"]
            content = "\n".join(t for t in texts if t)
        elif content is None:
            content = ""
        role = m.get("role", "user")
        if m.get("tool_calls"):
            calls = [
                f'{{"name": "{tc["function"]["name"]}", "arguments": {tc["function"]["arguments"]}}}'
                for tc in m["tool_calls"]
                if "function" in tc
            ]
            content = (content + "\n" if content else "") + "\n".join(calls)
        out.append({"role": role, "content": str(content)})
    return out


class Evaluator:
    """Renders final prompt strings for one model's configuration."""

    def __init__(self, cfg: ModelConfig, tokenizer=None):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self._cache: dict[str, jinja2.Template] = {}

    def _tmpl(self, source: str) -> jinja2.Template:
        if source not in self._cache:
            self._cache[source] = _ENV.from_string(source)
        return self._cache[source]

    def template_messages(
        self,
        messages: list[dict[str, Any]],
        tools_prompt: str = "",
        add_generation_prompt: bool = True,
    ) -> str:
        msgs = normalize_messages(messages)
        if self.cfg.system_prompt and not any(m["role"] == "system" for m in msgs):
            msgs = [{"role": "system", "content": self.cfg.system_prompt}] + msgs
        if tools_prompt:
            for m in msgs:
                if m["role"] == "system":
                    m["content"] = m["content"] + "\n" + tools_prompt
                    break
            else:
                msgs = [{"role": "system", "content": tools_prompt}] + msgs

        t = self.cfg.template
        if t.use_tokenizer_template and getattr(self.tokenizer, "chat_template", None):
            return self.tokenizer.apply_chat_template(
                msgs, add_generation_prompt=add_generation_prompt
            )
        if t.chat:
            return self._tmpl(t.chat).render(
                messages=msgs, add_generation_prompt=add_generation_prompt
            )
        if t.chat_message:
            rendered = [
                self._tmpl(t.chat_message).render(
                    role=m["role"], content=m["content"], index=i
                )
                for i, m in enumerate(msgs)
            ]
            text = "\n".join(rendered)
            return text + ("\n" if add_generation_prompt else "")
        family = t.family or "chatml"
        if family in FAMILY_TEMPLATES:
            return self._tmpl(FAMILY_TEMPLATES[family]).render(
                messages=msgs, add_generation_prompt=add_generation_prompt
            )
        # Plain fallback.
        text = "\n".join(f"{m['role']}: {m['content']}" for m in msgs)
        return text + ("\nassistant: " if add_generation_prompt else "")

    def template_completion(self, prompt: str) -> str:
        t = self.cfg.template
        if t.completion:
            return self._tmpl(t.completion).render(input=prompt, prompt=prompt)
        return prompt

    def template_edit(self, instruction: str, input_text: str) -> str:
        t = self.cfg.template
        if t.edit:
            return self._tmpl(t.edit).render(instruction=instruction, input=input_text)
        return (
            f"Below is an instruction that describes a task, paired with an input.\n\n"
            f"### Instruction:\n{instruction}\n\n### Input:\n{input_text}\n\n### Response:\n"
        )

    def stop_sequences(self) -> list[str]:
        """Family-implied stop strings merged with configured ones."""
        stops = list(self.cfg.stop)
        fam = self.cfg.template.family
        extra = {
            "llama3": ["<|eot_id|>"],
            "chatml": ["<|im_end|>"],
            "mistral": ["</s>"],
            "alpaca": ["### Instruction:"],
        }.get(fam or "", [])
        for s in extra:
            if s not in stops:
                stops.append(s)
        return stops
