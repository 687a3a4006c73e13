"""The port's observability layer against the JAX package's on the CPU.

The journal, the trace store, the Chrome-trace timeline and the postmortem
writer are copies of the JAX package's modules: the same event sequence,
appended with fixed times, gives equal snapshots and equal timeline JSON,
the wire tables (CODES, FAULT_EVENTS, LOOP_PHASES) are equal, traceparent
headers parse and format alike, and a RequestTrace built the same way
derives the same span tree. The port's own pieces: the CUDA-event fence
reads 0.0 on the CPU, a torch.profiler window exports one Chrome trace
and admits one caller at a time, and the engine journals a request's
lifecycle and its loop windows, records its span tree, and costs little.
Static checks stand in for the JAX package's lint passes, which do not
scan the port: every fault site fires somewhere or waits on a named item,
FAULT_EVENTS mirrors SITES, and the copied modules import no torch. Last,
the HTTP routes: /debug/trace, /debug/timeline, /debug/profile, /system,
/backend/monitor and /backend/shutdown."""

import ast
import dataclasses
import json
import pathlib
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
import yaml

from localai_tpu.observe import journal as jjournal
from localai_tpu.observe import postmortem as jpostmortem
from localai_tpu.observe import timeline as jtimeline
from localai_tpu.observe import trace as jtrace
from localai_tpu.engine import runtime as jruntime
from localai_tpu_torch.config import ApplicationConfig
from localai_tpu_torch.engine import runtime as pruntime
from localai_tpu_torch.engine.engine import Engine, EngineConfig
from localai_tpu_torch.engine.tokenizer import ByteTokenizer
from localai_tpu_torch.models import get_arch
from localai_tpu_torch.models.llama import init_params
from localai_tpu_torch.observe import journal as pjournal
from localai_tpu_torch.observe import postmortem as ppostmortem
from localai_tpu_torch.observe import profile as pprofile
from localai_tpu_torch.observe import timeline as ptimeline
from localai_tpu_torch.observe import trace as ptrace
from localai_tpu_torch.observe.fence import DeviceFence
from localai_tpu_torch.server import ModelManager, OpenAIApi, Router, create_server
from localai_tpu_torch.testing import faults

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "localai_tpu_torch"


# --------------------------------------------------------------------- #
# Copies: journal, timeline, trace, postmortem
# --------------------------------------------------------------------- #


def test_wire_tables_equal_the_jax_package():
    assert pjournal.BASE_EVENTS == jjournal.BASE_EVENTS
    assert pjournal.FAULT_EVENTS == jjournal.FAULT_EVENTS
    assert pjournal.CODES == jjournal.CODES
    assert pjournal.LOOP_PHASES == jjournal.LOOP_PHASES
    assert pjournal._DTYPE == jjournal._DTYPE
    # The loop's phase names: the writer's tuple and the observe copy.
    assert pruntime.LOOP_PHASES == pjournal.LOOP_PHASES == jruntime.LOOP_PHASES


def _event_stream(seed: int, n: int):
    rng = np.random.default_rng(seed)
    names = pjournal.EVENTS
    out = []
    t = 100.0
    for k in range(n):
        t += float(rng.uniform(0.0001, 0.01))
        ev = names[int(rng.integers(len(names)))]
        phases = None
        if ev == "loop_iter":
            phases = [float(x) for x in rng.uniform(0, 3, len(pjournal.LOOP_PHASES)).round(3)]
        out.append((t, ev, f"r{k % 5}" if k % 3 else "", int(rng.integers(-1, 4)),
                    float(rng.integers(0, 600)), float(rng.uniform(0, 40)), phases))
    return out


@pytest.mark.parametrize("capacity, n", [(64, 40), (8, 30)], ids=["fits", "wraps"])
def test_journal_and_timeline_equal_the_jax_package(capacity, n):
    journals = []
    for mod in (jjournal, pjournal):
        j = mod.EventJournal(capacity)
        j.t0_mono, j.t0_wall = 100.0, 1.7e9
        for rec in _event_stream(7, n):
            j._append_raw(*rec)
        # Two staged events, at fixed times (what stage() records).
        j._staged.append((100.5, "queued", "s0", -1, 12.0, 0.0))
        j._staged.append((100.6, "span_export", "s1", -1, 3.0, 0.0))
        journals.append(j)
    js, ps = journals[0].snapshot(), journals[1].snapshot()
    assert ps == js
    assert journals[1].snapshot(last=5) == journals[0].snapshot(last=5)
    jt = jtimeline.chrome_trace({"a": journals[0]})
    pt = ptimeline.chrome_trace({"a": journals[1]})
    assert json.dumps(pt, sort_keys=True) == json.dumps(jt, sort_keys=True)
    for j in journals:
        j.drain_staged()
    assert journals[1].snapshot() == journals[0].snapshot()


def test_journal_stage_drops_past_its_cap():
    j = pjournal.EventJournal(16)
    for _ in range(pjournal._STAGED_CAP + 3):
        j.stage("queued", rid="x")
    assert j.dropped_staged == 3
    j.drain_staged()
    assert j.n == pjournal._STAGED_CAP


@pytest.mark.parametrize("header", [
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-4BF92F3577B34DA6A3CE929D0E0E4736-00F067AA0BA902B7-01",
    " 00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-00 ",
    "00-00000000000000000000000000000000-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-0000000000000000-01",
    "garbage", "", "00-4bf92f-00f067aa0ba902b7-01",
], ids=["plain", "upper", "spaces", "zero-trace", "zero-span", "garbage", "empty", "short"])
def test_traceparent_round_trips_as_in_the_jax_package(header):
    assert ptrace.parse_traceparent(header) == jtrace.parse_traceparent(header)
    parsed = ptrace.parse_traceparent(header)
    if parsed is not None:
        out = ptrace.format_traceparent(*parsed)
        assert out == jtrace.format_traceparent(*parsed)
        assert ptrace.parse_traceparent(out) == parsed
    minted = ptrace.new_traceparent()
    assert jtrace.parse_traceparent(minted) is not None


def _fixed_trace(mod, tp):
    tr = mod.RequestTrace("req-1", traceparent=tp, engine="tiny")
    t = 50.0
    for name, attrs in (("queued", {"prompt_tokens": 9}), ("admitted", {}),
                        ("prefix_hit", {"matched_tokens": 32}), ("first_token", {}),
                        ("preempt", {"policy": "swap", "ctx_rows": 40}), ("swap_in", {}),
                        ("resumed", {})):
        t += 0.0125
        tr.events.append((t, name, attrs or None))
    tr.completed = True
    tr.events.append((t + 0.5, "terminal", {"kind": "done", "finish_reason": "length",
                                           "completion_tokens": 12}))
    tr.events.append((t + 0.6, "terminal", {"kind": "done"}))  # ignored after the first
    return tr


@pytest.mark.parametrize("tp", ["00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01", ""],
                         ids=["client", "minted"])
def test_request_trace_spans_equal_the_jax_package(tp):
    j, p = _fixed_trace(jtrace, tp), _fixed_trace(ptrace, tp)
    assert p.spans() == j.spans()
    jj, pj = j.to_json(), p.to_json()
    for d in (jj, pj):
        d.pop("span_id")
        d.pop("traceparent")
        if not tp:
            d.pop("trace_id")
    assert pj == jj
    assert [s["name"] for s in pj["spans"]] == ["queue", "admit", "decode", "preempted",
                                                 "admit", "decode"]
    # The spans tile the leg's wall clock.
    assert abs(sum(s["duration_ms"] for s in pj["spans"]) - pj["wall_ms"]) < 1e-2


def test_trace_store_retires_on_terminal_only():
    store = ptrace.TraceStore(keep=2)
    tr = ptrace.RequestTrace("a")
    store.register(tr)
    store.annotate("a", "note", k=1)
    assert store.get_json("a")["legs"][0]["complete"] is False
    for _ in range(2):  # the done ring keeps the newest two
        other = ptrace.RequestTrace("b")
        store.register(other)
        store.retire(other)
    assert [t.request_id for t in store.get("a")] == ["a"]
    assert store.get_json("nope") is None


def test_postmortem_writes_the_jax_packages_file(tmp_path):
    payload = {"reason": "engine loop died: X", "slots": [{"slot": 0, "rid": "r"}],
               "journal": [{"event": "loop_dead"}], "pool": {"free_pages": 3}}
    a = jpostmortem.write(str(tmp_path / "jax"), "m/odel x", payload)
    b = ppostmortem.write(str(tmp_path / "port"), "m/odel x", payload)
    assert pathlib.Path(a).read_text() == pathlib.Path(b).read_text()
    assert pathlib.Path(b).name.startswith("postmortem-m_odel_x-")
    assert ppostmortem.default_dir() == jpostmortem.default_dir()


# --------------------------------------------------------------------- #
# The port's own: fence, profile windows
# --------------------------------------------------------------------- #


def test_fence_reads_zero_on_the_cpu():
    f = DeviceFence(torch.device("cpu"))
    f.begin()
    f.end()
    assert f.elapsed_ms() == 0.0


def test_profile_window_exports_one_trace_and_admits_one_caller(tmp_path):
    out = pprofile.capture(str(tmp_path / "prof"), 0.15)
    assert set(out) == {"dir", "file", "seconds"}
    assert out["seconds"] >= 0.15
    trace = json.loads(pathlib.Path(out["file"]).read_text())
    assert "traceEvents" in trace
    assert pprofile.capture(str(tmp_path), 0.0)["seconds"] >= 0.1  # clamped up
    with pprofile._capture_lock:  # a capture in flight
        with pytest.raises(RuntimeError, match="already running"):
            pprofile.capture(str(tmp_path), 0.1)


# --------------------------------------------------------------------- #
# Static checks (the JAX package's lint passes do not scan the port)
# --------------------------------------------------------------------- #


def _fire_sites() -> set:
    """Sites named by a literal faults.fire("...") call in the port."""
    out = set()
    for path in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "fire"
                    and isinstance(node.func.value, ast.Name) and node.func.value.id == "faults"):
                assert node.args and isinstance(node.args[0], ast.Constant), \
                    f"{path}:{node.lineno}: fire() needs a literal site"
                out.add(node.args[0].value)
    return out


def test_every_fault_site_fires_or_waits_on_a_named_item():
    fired = _fire_sites()
    waiting = dict(faults.WAITING_SITES)
    assert fired <= set(faults.SITES), fired - set(faults.SITES)
    assert not fired & set(waiting), fired & set(waiting)
    assert fired | set(waiting) == set(faults.SITES), set(faults.SITES) - fired - set(waiting)
    assert all(item.split(",")[0] in ("12", "14") for item in waiting.values()), waiting
    # The port's SITES are the JAX package's, whole and in order.
    from localai_tpu.testing import faults as jfaults
    assert faults.SITES == jfaults.SITES


def test_fault_events_mirror_sites_both_ways():
    assert [f"fault_{s}" for s in faults.SITES] == list(pjournal.FAULT_EVENTS)
    assert {e[len("fault_"):] for e in pjournal.FAULT_EVENTS} == set(faults.SITES)


@pytest.mark.parametrize("name", ["journal", "trace", "timeline", "postmortem"])
def test_copied_observe_modules_import_no_torch(name):
    tree = ast.parse((PORT / "observe" / f"{name}.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module.split(".")[0])
    assert not mods & {"torch", "localai_tpu", "localai_tpu_torch"}, mods


# --------------------------------------------------------------------- #
# The engine: journal, traces, loop windows
# --------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def tiny():
    cfg = dataclasses.replace(get_arch("tiny"), dtype="float32")
    return cfg, init_params(cfg, seed=0, device="cpu")


def _engine(tiny, **kw):
    cfg, params = tiny
    base = dict(max_slots=2, max_seq=256, min_prefill_bucket=16)
    base.update(kw)
    eng = Engine(cfg, params, ByteTokenizer(cfg.vocab_size), engine_cfg=EngineConfig(**base),
                 device="cpu")
    eng.start()
    return eng


def test_engine_journals_a_request_and_records_its_span_tree(tiny):
    eng = _engine(tiny, kv_pages=16, kv_page_size=32, trace_fence=True)
    try:
        tp = ptrace.new_traceparent()
        text, final = eng.generate(list(range(3, 40)), max_new_tokens=20, ignore_eos=True,
                                   request_id="obs-1", traceparent=tp)
        assert final.kind == "done" and final.completion_tokens == 20
        data = ptrace.STORE.get_json("obs-1")
        assert data["trace_ids"] == [ptrace.parse_traceparent(tp)[0]]
        leg = data["legs"][-1]
        assert leg["complete"] and leg["terminal_events"] == 1
        assert [s["name"] for s in leg["spans"]] == ["queue", "admit", "decode"]
        assert abs(sum(s["duration_ms"] for s in leg["spans"]) - leg["wall_ms"]) < 0.01
        # TTFT by the trace = the engine's queue wait + prompt processing.
        ttft = leg["spans"][0]["duration_ms"] + leg["spans"][1]["duration_ms"]
        assert abs(ttft - 1000 * (final.timing_queue_wait
                                  + final.timing_prompt_processing)) < 5.0
        eng.generate([5, 6, 7], max_new_tokens=2)  # untraced: a journal id only
        assert ptrace.STORE.get_json("h0") is None
        time.sleep(0.05)
        snap = eng.journal.snapshot()
        mine = [e["event"] for e in snap if e["rid"] == "obs-1"]
        assert mine == ["queued", "admitted", "first_token", "terminal"], mine
        blocks = [e for e in snap if e["event"] == "decode_block"]
        assert blocks and sum(e["a"] for e in blocks) >= 19
        windows = [e for e in snap if e["event"] == "loop_iter"]
        assert windows and all("phases" in e for e in windows)
        assert set().union(*(e["phases"] for e in windows)) <= set(pruntime.LOOP_PHASES)
        m = eng.metrics()
        assert m["journal_events"] == eng.journal.n and m["journal_dropped"] == 0
        assert m["loop_blocks"] >= 1 and m["loop_host_overhead_per_block_ms"] > 0
        tl = ptimeline.chrome_trace({"tiny": eng.journal})
        assert tl["traceEvents"][0]["args"] == {"name": "tiny"}
    finally:
        eng.stop()


def test_journal_off_and_validation(tiny):
    with pytest.raises(ValueError, match="trace_journal_events"):
        _engine(tiny, trace_journal_events=-1)
    eng = _engine(tiny, trace_journal_events=0)
    try:
        assert eng.journal is None
        assert eng.generate([1, 2, 3], max_new_tokens=3)[1].kind == "done"
        assert "journal_events" not in eng.metrics()
    finally:
        eng.stop()


def test_journal_overhead_within_noise(tiny):
    """The JAX package's gate (tests/test_observe.py): a 96-token round
    with the journal on takes at most twice the round with it off + 50 ms."""
    eng = _engine(tiny)
    try:
        eng.generate([1, 2, 3], max_new_tokens=8, ignore_eos=True)

        def round_(n_tokens=96):
            t0 = time.monotonic()
            _, ev = eng.generate([4, 5, 6], max_new_tokens=n_tokens, ignore_eos=True)
            assert ev.kind == "done"
            return time.monotonic() - t0

        saved = eng._journal
        assert saved is not None  # on by default
        eng._journal = None
        off = min(round_() for _ in range(3))
        eng._journal = saved
        on = min(round_() for _ in range(3))
        assert on <= off * 2.0 + 0.05, (on, off)
    finally:
        eng.stop()


# --------------------------------------------------------------------- #
# HTTP routes
# --------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def api(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    (d / "tiny-obs.yaml").write_text(yaml.safe_dump({
        "name": "tiny-obs", "model": "tiny", "context_size": 128, "max_slots": 2,
        "max_tokens": 8, "temperature": 0.0, "trace_journal_events": 512}))
    out = {}
    for label, prof in (("open", str(tmp_path_factory.mktemp("prof"))), ("closed", "")):
        app = ApplicationConfig(address="127.0.0.1", port=0, models_dir=str(d),
                                profile_dir=prof)
        manager = ModelManager(app, device="cpu")
        router = Router()
        OpenAIApi(manager).register(router)
        server = create_server(app, router)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        out[label] = (f"http://127.0.0.1:{server.server_address[1]}", manager, server)
    yield out
    for _base, manager, server in out.values():
        server.shutdown()
        manager.shutdown()


def _post(base, path, payload, headers=None):
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return json.loads(r.read())


def _status(fn, *args):
    with pytest.raises(urllib.error.HTTPError) as e:
        fn(*args)
    return e.value.code


def test_http_trace_and_timeline(api):
    base, manager, _s = api["closed"]
    tp = ptrace.new_traceparent()
    out = _post(base, "/v1/chat/completions", {
        "model": "tiny-obs", "max_tokens": 6, "n": 2,
        "messages": [{"role": "user", "content": "hello"}]}, headers={"traceparent": tp})
    rid = out["id"]
    for key in (rid, f"{rid}-1"):  # choice i > 0 gets -i, one trace id for both
        data = _get(base, f"/debug/trace/{key}")
        assert data["request_id"] == key
        assert data["trace_ids"] == [ptrace.parse_traceparent(tp)[0]]
        leg = data["legs"][-1]
        assert leg["complete"] and leg["terminal_events"] == 1
        assert [s["name"] for s in leg["spans"]][:2] == ["queue", "admit"]
    # A completion with no traceparent gets a minted one.
    cid = _post(base, "/v1/completions", {"model": "tiny-obs", "prompt": "x",
                                          "max_tokens": 3})["id"]
    assert len(_get(base, f"/debug/trace/{cid}")["trace_ids"][0]) == 32
    assert _status(_get, base, "/debug/trace/no-such-request") == 404
    tl = _get(base, "/debug/timeline")
    names = {e["args"].get("name") for e in tl["traceEvents"] if e["ph"] == "M"}
    assert "tiny-obs" in names
    assert {e["name"] for e in tl["traceEvents"]} >= {"queued", "admitted", "terminal"}
    assert _get(base, "/debug/timeline?model=tiny-obs")["traceEvents"]
    assert _status(_get, base, "/debug/timeline?model=nope") == 404
    assert manager.get("tiny-obs").engine.journal.capacity == 512


def test_http_profile_gated_and_windowed(api):
    base, _m, _s = api["closed"]
    assert _status(_post, base, "/debug/profile", {"seconds": 0.1}) == 403
    base, manager, _s = api["open"]
    manager.get("tiny-obs")
    out = _post(base, "/debug/profile", {"seconds": 0.1})
    assert out["status"] == "ok" and pathlib.Path(out["file"]).is_file()
    with pprofile._capture_lock:
        assert _status(_post, base, "/debug/profile", {"seconds": 0.1}) == 409
    time.sleep(0.1)  # the loop drains the staged profile event
    j = manager.peek("tiny-obs").engine.journal
    assert "profile" in [e["event"] for e in j.snapshot()]


def test_http_system_and_backend_routes(api):
    base, manager, _s = api["closed"]
    manager.get("tiny-obs")
    sysinfo = _get(base, "/system")
    assert sysinfo["loaded_models"] == ["tiny-obs"]
    assert "tiny-obs" in sysinfo["configured_models"]
    assert sysinfo["recommended_mesh"]["tp"] == 1 and sysinfo["sysinfo"]["cpu_count"]
    assert sysinfo["backends"]["tiny-obs"]["loop_dead"] == 0.0
    mon = _post(base, "/backend/monitor", {"model": "tiny-obs"})
    assert mon["supervision"]["restarts_total"] == 0 and mon["in_flight"] == 0
    assert _status(_post, base, "/backend/monitor", {}) == 400
    assert _status(_post, base, "/backend/monitor", {"model": "nope"}) == 404
    assert _post(base, "/backend/shutdown", {"model": "tiny-obs"}) == {"status": "ok"}
    assert manager.peek("tiny-obs") is None
    assert _status(_post, base, "/backend/shutdown", {"model": "tiny-obs"}) == 404
