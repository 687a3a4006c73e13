"""The port's copies of the grammar modules (localai_tpu_torch/functions)
against the JAX package's on the CPU: for the schemas and probes of
test_grammar_dfa.py and the grammars of test_gbnf.py, the char DFAs and the
token tables (mask_bits, trans, tok_cls, accept, next_tok) are equal bit for
bit, the machines accept and reject the same probes, and parse_function_calls
(JSON, `<function=...>` and regex mode) and tools_prompt_for give the same
calls and prompt. ops/grammar's three functions equal the JAX engine's
static methods (_dfa_allowed, _dfa_next_state, _dfa_advance) on the same
numpy inputs, in both modes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tpu.config.model_config import ModelConfig as JaxModelConfig
from localai_tpu.engine.engine import Engine as JaxEngine
from localai_tpu.functions import dfa as jdfa
from localai_tpu.functions import gbnf as jgbnf
from localai_tpu.functions import jsonschema as jjs
from localai_tpu.functions import parse as jparse
from localai_tpu_torch.config.model_config import ModelConfig
from localai_tpu_torch.functions import dfa as tdfa
from localai_tpu_torch.functions import gbnf as tgbnf
from localai_tpu_torch.functions import jsonschema as tjs
from localai_tpu_torch.functions import parse as tparse
from localai_tpu_torch.ops import grammar as tgr

from test_gbnf import ARITH, CHESS
from test_grammar_dfa import PROBES, SCHEMAS, TOOL_SCHEMA

GRAMMARS = [CHESS, 'root ::= "yes" | "no"', r'root ::= [^\x00-\x1f"]*',
            'root ::= ("ab" | [0-9]{1,3} "," )+']
GBNF_PROBES = ["1+2=3\n", "Ka1xb2=Q", "yes", "no\n", 'hi "there', "é∂ß", "x*(y+2)=z\n",
               "aa", "", "ab12,", "Nb1c3 e2e4=Q", "12,ab"]

# A byte vocabulary plus multi-char tokens (one past MAX_TOK_LEN) and EOS.
TOK_STRS = ([chr(c) for c in range(256)]
            + ['{"', 'get_weather', '", "', " " * 40, "[1", ", 2", "true", "Ka1", "e4",
               '"a": ', ""])
EOS = {len(TOK_STRS) - 1}


def _tables_equal(a, b):
    for f in ("mask_bits", "trans", "tok_cls", "accept"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert (a.next_tok is None) == (b.next_tok is None)
    if a.next_tok is not None:
        assert a.next_tok.dtype == b.next_tok.dtype and np.array_equal(a.next_tok, b.next_tok)
    assert a.init_state == b.init_state


def _char_dfas_equal(a, b):
    assert np.array_equal(a.trans, b.trans) and np.array_equal(a.accept, b.accept)
    for ch in "{}[]\":, 0123456789-.eEtrufalsn\\\x02\tabcxyzKQ=é∂":
        assert a.class_of(ch) == b.class_of(ch), ch


@pytest.mark.parametrize("i", range(len(SCHEMAS)), ids=[f"schema{i}" for i in range(len(SCHEMAS))])
def test_schema_tables_equal_the_reference(i):
    jd, td = jdfa.compile_schema_dfa(SCHEMAS[i]), tdfa.compile_schema_dfa(SCHEMAS[i])
    _char_dfas_equal(jd, td)
    _tables_equal(jdfa.build_token_tables(jd, TOK_STRS, EOS, len(TOK_STRS)),
                  tdfa.build_token_tables(td, TOK_STRS, EOS, len(TOK_STRS)))


@pytest.mark.parametrize("gram", GRAMMARS, ids=["chess", "alt", "negclass", "repeat"])
def test_gbnf_tables_equal_the_reference(gram):
    jd, td = jgbnf.compile_gbnf_dfa(gram), tgbnf.compile_gbnf_dfa(gram)
    _char_dfas_equal(jd, td)
    _tables_equal(jdfa.build_token_tables(jd, TOK_STRS, EOS, len(TOK_STRS)),
                  tdfa.build_token_tables(td, TOK_STRS, EOS, len(TOK_STRS)))
    # The engine's marker path: tables_for a {"__gbnf__": ...} schema.
    _tables_equal(
        jdfa.tables_for({"__gbnf__": gram}, TOK_STRS, EOS, len(TOK_STRS), tokenizer_id="fn-t"),
        tdfa.tables_for({"__gbnf__": gram}, TOK_STRS, EOS, len(TOK_STRS), tokenizer_id="fn-t"))


def test_recursive_grammar_and_state_budget_fail_alike():
    for mod in (jgbnf, tgbnf):
        with pytest.raises(Exception) as e:
            mod.compile_gbnf_dfa(ARITH)
        assert type(e.value).__name__ == "DfaUnsupported"
    for mod in (jdfa, tdfa):
        with pytest.raises(mod.DfaUnsupported):
            mod.compile_schema_dfa(TOOL_SCHEMA, max_states=16)
        assert mod.tables_for({"__gbnf__": ARITH}, ["a"], set(), 1, tokenizer_id="fn-a") is None
    assert (tdfa.MAX_TOK_LEN, tdfa.NEXT_TOK_MAX_STATES) == (jdfa.MAX_TOK_LEN,
                                                            jdfa.NEXT_TOK_MAX_STATES)


def _walk_machine(make, text):
    """(per-char verdicts, complete, strictly complete) of a constraint fed
    `text` one character at a time."""
    g = make()
    verdicts = []
    for ch in text:
        ok = g.allowed(ch)
        verdicts.append(ok)
        if not ok:
            break
        g.advance(ch)
    return verdicts, g.complete(), g.strictly_complete()


@pytest.mark.parametrize("i", range(len(SCHEMAS)), ids=[f"schema{i}" for i in range(len(SCHEMAS))])
def test_schema_machines_accept_the_same_probes(i):
    for text in PROBES:
        assert jjs.JsonSchemaMachine(SCHEMAS[i]).feed_text(text) == \
            tjs.JsonSchemaMachine(SCHEMAS[i]).feed_text(text), text
        assert _walk_machine(lambda: jjs.GrammarConstraint(SCHEMAS[i]), text) == \
            _walk_machine(lambda: tjs.GrammarConstraint(SCHEMAS[i]), text), text


@pytest.mark.parametrize("gram", GRAMMARS + [ARITH],
                         ids=["chess", "alt", "negclass", "repeat", "arith"])
def test_gbnf_machines_accept_the_same_probes(gram):
    jg, tg = jgbnf.CompiledGrammar(gram), tgbnf.CompiledGrammar(gram)
    for text in GBNF_PROBES:
        assert _walk_machine(lambda: jgbnf.GbnfConstraint(jg), text) == \
            _walk_machine(lambda: tgbnf.GbnfConstraint(tg), text), text
    assert tgbnf.GbnfConstraint(tg).schema == jgbnf.GbnfConstraint(jg).schema


def test_tool_call_schema_equals_the_reference():
    tools = [{"type": "function", "function": {"name": "get_weather", "parameters":
              {"type": "object", "properties": {"city": {"type": "string"}}}}},
             {"type": "function", "function": {"name": "search", "parameters": {}}}]
    for sel in (tools, tools[:1]):
        assert tjs.tool_call_schema(sel) == jjs.tool_call_schema(sel)


TOOLS = [{"type": "function", "function": {"name": "get_weather", "description": "Weather",
                                           "parameters": {"type": "object", "properties": {
                                               "city": {"type": "string"}}}}},
         {"name": "search", "description": "Search the web", "parameters": {}}]


def test_tools_prompt_equals_the_reference():
    assert tparse.tools_prompt_for(TOOLS) == jparse.tools_prompt_for(TOOLS)


def _calls(calls):
    return [(c["type"], c["function"]["name"], c["function"]["arguments"]) for c in calls]


@pytest.mark.parametrize("mode, text, options", [
    ("json", 'Sure: {"name": "get_weather", "arguments": {"city": "Paris"}} and '
             '{"function": "search", "parameters": {"q": "x"}} {"bad": 1} {"name": ', {}),
    ("llama31", 'x <function=get_weather>{"city": "Oslo"}</function> '
                '<function=search></function><function=raw>not json</function>', {}),
    ("regex", "CALL get_weather WITH {\"city\": \"Rome\"}; CALL search WITH {}",
     {"function_response_regex": r"CALL (?P<name>\w+) WITH (?P<arguments>\{[^;]*\})"}),
], ids=["json", "llama31", "regex"])
def test_parse_function_calls_equals_the_reference(mode, text, options):
    tcfg = ModelConfig(name="m", options=dict(options))
    jcfg = JaxModelConfig(name="m", options=dict(options))
    got, want = tparse.parse_function_calls(text, tcfg), jparse.parse_function_calls(text, jcfg)
    assert want and _calls(got) == _calls(want)
    assert all(c["id"].startswith("call_") for c in got)


def _device_tables(schema):
    tables = tdfa.build_token_tables(tdfa.compile_schema_dfa(schema), TOK_STRS, EOS,
                                     len(TOK_STRS))
    rng = np.random.default_rng(3)
    S1 = tables.trans.shape[0]
    state = rng.integers(0, S1, 64).astype(np.int32)
    state[:4] = [0, 1, S1 - 1, 0]  # FREE, the start, the last state
    legal = np.unpackbits(tables.mask_bits[state], axis=1, bitorder="little")[:, :len(TOK_STRS)]
    # Mostly legal tokens (what the masked sampler emits), some arbitrary.
    tok = np.array([rng.choice(np.flatnonzero(row)) if row.any() and k % 4 else
                    rng.integers(0, len(TOK_STRS)) for k, row in enumerate(legal)], np.int32)
    return tables, state, tok


@pytest.mark.parametrize("fn", ["allowed", "next_state", "advance_fast", "advance_walk"])
def test_ops_grammar_equals_the_jax_engine(fn):
    V = len(TOK_STRS)
    tables, state, tok = _device_tables(SCHEMAS[1] if fn == "advance_fast" else TOOL_SCHEMA)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in
         (("mask", tables.mask_bits), ("trans", tables.trans), ("cls", tables.tok_cls),
          ("state", state), ("tok", tok))}
    if fn == "allowed":
        got = tgr.dfa_allowed(t["mask"], t["state"], V).numpy()
        want = np.asarray(JaxEngine._dfa_allowed(jnp.asarray(tables.mask_bits),
                                                 jnp.asarray(state), V))
        assert got.dtype == want.dtype == bool
    elif fn == "next_state":
        got = tgr.dfa_next_state(t["trans"], t["cls"], t["state"], t["tok"]).numpy()
        want = np.asarray(JaxEngine._dfa_next_state(
            jnp.asarray(tables.trans), jnp.asarray(tables.tok_cls), jnp.asarray(state),
            jnp.asarray(tok)))
    else:
        mode = fn.split("_")[1]
        table = tables.next_tok if mode == "fast" else tables.trans
        assert table is not None
        got = tgr.dfa_advance(mode, torch.from_numpy(table), t["cls"], t["state"],
                              t["tok"]).numpy()
        want = np.asarray(JaxEngine._dfa_advance(mode, jnp.asarray(table),
                                                 jnp.asarray(tables.tok_cls),
                                                 jnp.asarray(state), jnp.asarray(tok)))
    assert got.dtype == want.dtype and np.array_equal(got, want)
