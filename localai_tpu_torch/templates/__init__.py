"""Prompt templating (a copy of localai_tpu/templates/, which imports no JAX).

Python re-design of the reference's Go text/template evaluator
(core/templates/evaluator.go:58-230; 5 template types, per-message loop,
function-grammar injection) using jinja2 — the same engine HF chat templates
use, so custom templates and tokenizer templates share one mental model.
"""

from localai_tpu_torch.templates.evaluator import Evaluator, FAMILY_TEMPLATES  # noqa: F401
