"""Tool-calling: tool→prompt rendering and function-call parsing.

Reference: pkg/functions (2,436 LoC — grammar generation in grammars/,
ParseFunctionCall in parse.go:16-376). TPU-native difference (SURVEY.md §7
build plan item 6): instead of GBNF inside the engine, constrained decoding is
token-mask biasing computed host-side and applied in the jitted sample step
(see localai_tpu_torch.functions.jsonschema).
"""

from localai_tpu_torch.functions.parse import parse_function_calls, tools_prompt_for  # noqa: F401
