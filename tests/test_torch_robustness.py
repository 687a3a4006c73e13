"""Crash-only robustness of the port against the JAX package's on the CPU
(the JAX package's tests/test_robustness.py and tests/test_observe.py are
the models).

- The fault schedule: for seeds 0-7 the port's FaultSchedule and
  ChaosScript make the JAX package's decisions at every site, and
  `parse_env` of the same strings gives equal schedules.
- Loop death (the `engine_loop` fault) on the tiny paged engine releases
  the pool and the host tier before any caller unblocks, writes a
  postmortem with the JAX payload's keys, and journals the dead requests'
  events in the JAX engine's order.
- The manager restarts a dead engine, quarantines after its restart
  budget (HTTP 503 with Retry-After), reaps with no traffic, evicts on a
  YAML change, and contains a `manager_load` fault.
- A fault sweep over fixed seeds on the tiny dense and paged engines
  (dispatch, allocator, swap, control-commit and loop faults), a
  prompt-lookup engine (`spec_verify`), one LoRA tenant (`adapter_fetch`)
  and fork groups (`slot_fork`): every request ends, the pool and host
  tier are accounted at quiesce, a surviving engine serves again, and the
  journal holds one fault_<site> event per injected fault.
"""

import dataclasses
import json
import os
import threading
import time

import jax
import numpy as np
import pytest
import yaml

from localai_tpu.engine import ByteTokenizer as JaxByteTokenizer
from localai_tpu.engine import Engine as JaxEngine
from localai_tpu.engine import EngineConfig as JaxEngineConfig
from localai_tpu.engine import GenRequest as JaxGenRequest
from localai_tpu.models import llama as jl
from localai_tpu.testing import faults as jfaults
from localai_tpu_torch.config import ApplicationConfig
from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest, QueueFullError
from localai_tpu_torch.engine.tokenizer import ByteTokenizer
from localai_tpu_torch.engine.weights import params_from_numpy, random_lora_adapter
from localai_tpu_torch.models import get_arch
from localai_tpu_torch.server import ModelManager
from localai_tpu_torch.server.app import ApiError, Request
from localai_tpu_torch.server.manager import ModelQuarantinedError
from localai_tpu_torch.server.openai_api import OpenAIApi
from localai_tpu_torch.testing import faults

PAGE = 16
PM_DIR = [""]  # set per module run: postmortems of the sweep's loop deaths


@pytest.fixture(scope="module", autouse=True)
def _postmortem_dir(tmp_path_factory):
    PM_DIR[0] = str(tmp_path_factory.mktemp("postmortems"))


# --------------------------------------------------------------------- #
# The schedule: the JAX package's decisions
# --------------------------------------------------------------------- #


def _decisions(sched, calls):
    return [sched.should_fire(site) for site in calls]


def _calls(seed):
    rng = np.random.default_rng(seed)
    return [faults.SITES[int(i)] for i in rng.integers(len(faults.SITES), size=400)]


@pytest.mark.parametrize("seed", range(8))
def test_fault_schedule_decides_as_the_jax_package(seed):
    calls = _calls(seed)
    for kw in (dict(rate=0.3), dict(rate=0.5, max_faults=4),
               dict(rate=0.2, sites=("page_alloc", "engine_loop", "slot_fork"),
                    site_rates={"slot_fork": 0.9})):
        p, j = faults.FaultSchedule(seed, **kw), jfaults.FaultSchedule(seed, **kw)
        assert _decisions(p, calls) == _decisions(j, calls), kw
        assert (p.calls, p.fired, p.total_fired()) == (j.calls, j.fired, j.total_fired())
        assert repr(p) == repr(j)
    phases = [("page_alloc", 3, 1.0, 2), ("engine_loop", 10, 0.5, 1), ("page_alloc", 20, 1.0, 1)]
    p = faults.ChaosScript(seed, [faults.ChaosPhase(*ph) for ph in phases])
    j = jfaults.ChaosScript(seed, [jfaults.ChaosPhase(*ph) for ph in phases])
    assert _decisions(p, calls) == _decisions(j, calls)
    assert p.exhausted() == j.exhausted() and repr(p) == repr(j)


@pytest.mark.parametrize("spec", ["seed:7,rate:0.5,max:3,sites:engine_loop|page_alloc",
                                  " seed:2 , rate:0.05 ", "seed:0,sites:slot_fork", ""])
def test_parse_env_gives_the_jax_packages_schedule(spec):
    p, j = faults.parse_env(spec), jfaults.parse_env(spec)
    if not spec:
        assert p is None and j is None
        return
    assert (p.seed, p.rate, p.sites, p.max_faults) == (j.seed, j.rate, j.sites, j.max_faults)
    calls = _calls(p.seed)
    assert _decisions(p, calls) == _decisions(j, calls)


@pytest.mark.parametrize("spec", ["rate:0.5", "seed:1,bogus:2", "seed:1,sites:nope"])
def test_bad_schedules_fail_loudly_as_in_the_jax_package(spec):
    with pytest.raises(ValueError):
        jfaults.parse_env(spec)
    with pytest.raises(ValueError):
        faults.parse_env(spec)


def test_fire_scoping_and_ensure_installed():
    me = threading.get_ident()
    with faults.active(faults.FaultSchedule(1, rate=1.0, sites=("page_alloc",),
                                            max_faults=2, threads={me + 1})):
        faults.fire("page_alloc")  # another thread's schedule: invisible here
    fired = 0
    with faults.active(faults.FaultSchedule(1, rate=1.0, sites=("page_alloc",),
                                            max_faults=2)):
        for _ in range(5):
            try:
                faults.fire("page_alloc")
            except faults.InjectedFault:
                fired += 1
        faults.fire("device_dispatch")  # not in sites
    assert fired == 2
    faults.fire("page_alloc")  # nothing active
    assert not issubclass(faults.InjectedFault, RuntimeError)
    faults.ensure_installed("")  # empty spec: nothing armed
    assert faults._active is None
    try:
        faults.ensure_installed("seed:3,rate:0.25,sites:page_alloc")
        assert (faults._active.seed, faults._active.sites) == (3, ("page_alloc",))
        faults.ensure_installed("seed:4")  # one schedule at a time
        assert faults._active.seed == 3
    finally:
        faults.uninstall()


# --------------------------------------------------------------------- #
# Loop death
# --------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def tiny():
    cfg = dataclasses.replace(get_arch("tiny"), dtype="float32")
    jp = jl.init_params(cfg, jax.random.key(0))
    return cfg, jp, params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")


def _port(tiny, **kw):
    cfg, _jp, tp = tiny
    base = dict(max_slots=2, max_seq=256, min_prefill_bucket=16, postmortem_dir=PM_DIR[0])
    base.update(kw)
    eng = Engine(cfg, tp, ByteTokenizer(cfg.vocab_size), engine_cfg=EngineConfig(**base),
                 device="cpu")
    eng.start()
    return eng


def _kill(eng, sched_mod=faults, timeout=60.0):
    """Kill the loop through the engine_loop site, scoped to its thread."""
    with sched_mod.active(sched_mod.FaultSchedule(0, rate=1.0, sites=("engine_loop",),
                                                  max_faults=1,
                                                  threads={eng._thread.ident})):
        eng._wake.set()
        deadline = time.monotonic() + timeout
        while not eng.is_dead and time.monotonic() < deadline:
            time.sleep(0.01)
    assert eng.is_dead, "the engine_loop fault did not kill the loop"
    eng._thread.join(timeout=timeout)


def _assert_pool_accounted(eng):
    P = eng.ecfg.kv_pages
    if P:
        refs = np.zeros(P, np.int64)
        for pages in eng._slot_pages:
            for p in pages:
                if p >= 0:
                    refs[p] += 1
        for e in eng._prefix_entries:
            for p in e.get("pages", []):
                refs[p] += 1
        assert (refs == eng._page_refs[:P]).all(), "refcount drift"
        free = eng._free_pages
        assert len(set(free)) == len(free) and all(refs[p] == 0 for p in free)
        assert set(free) | {p for p in range(P) if refs[p]} == set(range(P)), "leaked pages"
    assert eng._host_bytes == sum(e.get("bytes", 0) for e in eng._prefix_host)
    assert not eng._adapter_refs.any() or eng.h_active.any()


def _dead_request_events(snapshot, rid):
    return [e["event"] for e in snapshot if e["rid"] == rid]


def test_loop_death_releases_state_before_callers_unblock(tiny, tmp_path):
    cfg, jp, _tp = tiny
    kw = dict(max_slots=2, max_seq=256, min_prefill_bucket=16, kv_pages=16,
              kv_page_size=PAGE)
    prompts = [list(range(1 + i, 30 + i)) for i in range(3)]
    out = {}
    for side in ("jax", "port"):
        if side == "jax":
            eng = JaxEngine(cfg, jp, JaxByteTokenizer(cfg.vocab_size),
                            engine_cfg=JaxEngineConfig(postmortem_dir=str(tmp_path / side),
                                                       prefix_admit_async_compile=False, **kw))
            eng.start()
            G, mod = JaxGenRequest, jfaults
        else:
            eng = _port(tiny, postmortem_dir=str(tmp_path / side), **kw)
            G, mod = GenRequest, faults
        try:
            handles = [eng.submit(G(prompt_ids=p, max_new_tokens=10_000, ignore_eos=True,
                                    request_id=f"pm-{i}")) for i, p in enumerate(prompts)]
            seen = []

            def consume(h):
                evs = list(h)
                # What a caller sees the moment it unblocks.
                seen.append((evs[-1].kind, len(eng._free_pages), eng._host_bytes))

            threads = [threading.Thread(target=consume, args=(h,)) for h in handles]
            for t in threads:
                t.start()
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline and sum(
                    len(s.generated) > 0 for s in eng.slots if s is not None) < 2:
                time.sleep(0.01)
            _kill(eng, mod)
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            if side == "port":
                assert seen == [("error", eng.ecfg.kv_pages, 0)] * 3, seen
                _assert_pool_accounted(eng)
                assert eng.metrics()["loop_dead"] == 1.0
                assert list(eng.submit(G(prompt_ids=[1], max_new_tokens=2)))[-1].kind == "error"
            with open(eng.postmortem_path) as f:
                pm = json.load(f)
            assert "engine loop died" in pm["reason"]
            assert pm["pool"]["free_pages"] == eng.ecfg.kv_pages
            events = {f"pm-{i}": _dead_request_events(pm["journal"], f"pm-{i}")
                      for i in range(3)}
            tail = [e["event"] for e in pm["journal"]]
            assert tail[-2:] == ["loop_dead", "fault_engine_loop"], tail[-4:]
            out[side] = (pm, events)
        finally:
            eng.stop()
    (jpm, jev), (ppm, pev) = out["jax"], out["port"]
    assert set(ppm) == set(jpm)
    for key in ("pool", "config"):
        assert set(ppm[key]) == set(jpm[key]), key
    assert ppm["config"]["tensor_parallel"] == 1
    assert {s["rid"] for s in ppm["slots"]} | set(ppm["pending"]) == {"pm-0", "pm-1", "pm-2"}
    assert pev == jev, (pev, jev)
    assert pev["pm-0"] == ["queued", "admitted", "first_token"]


# --------------------------------------------------------------------- #
# The manager: restart, quarantine, watchdog, config watcher, load faults
# --------------------------------------------------------------------- #


def _manager(tmp_path, **app_kw):
    d = tmp_path / "models"
    d.mkdir(exist_ok=True)
    (d / "m.yaml").write_text(yaml.safe_dump({
        "name": "m", "model": "tiny", "context_size": 64, "max_slots": 2, "max_tokens": 4}))
    return ModelManager(ApplicationConfig(models_dir=str(d), **app_kw), device="cpu")


def _serves(lm):
    _, ev = lm.engine.generate([65, 66], max_new_tokens=2, ignore_eos=True)
    return ev.kind == "done"


def test_manager_restarts_then_quarantines(tmp_path):
    mgr = _manager(tmp_path, restart_budget=1, restart_window_s=60.0, quarantine_s=3.0)
    try:
        lm = mgr.get("m")
        assert _serves(lm)
        _kill(lm.engine)
        lm2 = mgr.get("m")  # the first death restarts transparently
        assert lm2 is not lm and _serves(lm2)
        assert lm.engine.params is None or lm.engine.is_dead
        stats = mgr.restart_stats("m")
        assert (stats["restarts_total"], stats["quarantines_total"]) == (1, 0)
        gauges = {(n, tuple(sorted(lb.items()))): v for n, lb, v in mgr.health_gauges()}
        assert gauges[("localai_model_restarts", (("model", "m"),))] == 1.0
        _kill(lm2.engine)
        with pytest.raises(ModelQuarantinedError) as exc:
            mgr.get("m")
        assert exc.value.retry_after_s >= 1 and exc.value.deaths == 2
        assert mgr.restart_stats("m")["quarantines_total"] == 1
        deadline = time.monotonic() + 30
        while mgr.restart_stats("m")["quarantined_for_s"] > 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert mgr.restart_stats("m")["quarantined_for_s"] == 0
        assert _serves(mgr.get("m"))  # the quarantine expired
    finally:
        mgr.shutdown()


def test_watchdog_reaps_a_dead_engine_without_traffic(tmp_path):
    mgr = _manager(tmp_path, watchdog_busy_timeout_s=3600.0, watchdog_interval_s=0.1)
    try:
        assert mgr._wd_thread is not None
        _kill(mgr.get("m").engine)
        deadline = time.monotonic() + 15
        while mgr.peek("m") is not None and time.monotonic() < deadline:
            time.sleep(0.05)
        assert mgr.peek("m") is None, "the watchdog never reaped the dead engine"
        assert mgr.restart_stats("m")["restarts_total"] == 1
    finally:
        mgr.shutdown()


def test_watchdog_evicts_idle_and_wedged_models(tmp_path):
    mgr = _manager(tmp_path)
    try:
        lm = mgr.get("m")
        mgr.app_cfg.watchdog_idle_timeout_s = 5.0
        mgr._watchdog_tick(now=time.monotonic() + 10)
        assert mgr.peek("m") is None
        lm = mgr.get("m")
        mgr.app_cfg.watchdog_idle_timeout_s = 0.0
        mgr.app_cfg.watchdog_busy_timeout_s = 1.0
        lease = lm.lease()
        h = lm.engine.submit(GenRequest(prompt_ids=[1, 2], max_new_tokens=10_000,
                                        ignore_eos=True))
        mgr._watchdog_tick(now=time.monotonic() + 5)
        assert mgr.peek("m") is None
        assert list(h)[-1].finish_reason == "stop"
        lease.release()
    finally:
        mgr.shutdown()


def test_config_watcher_evicts_on_a_yaml_change(tmp_path):
    mgr = _manager(tmp_path, watch_configs=True, config_watch_interval_s=0.1)
    try:
        lm = mgr.get("m")
        path = tmp_path / "models" / "m.yaml"
        doc = yaml.safe_load(path.read_text())
        doc["max_tokens"] = 9
        path.write_text(yaml.safe_dump(doc))
        os.utime(path, (time.time() + 5, time.time() + 5))
        deadline = time.monotonic() + 15
        while mgr.peek("m") is lm and time.monotonic() < deadline:
            time.sleep(0.05)
        assert mgr.peek("m") is None
        assert mgr.get("m").cfg.max_tokens == 9
        assert mgr.reload_configs() == 0  # unchanged: nothing evicted
    finally:
        mgr.shutdown()


def test_manager_load_fault_is_contained(tmp_path):
    mgr = _manager(tmp_path)
    try:
        with faults.active(faults.FaultSchedule(5, rate=1.0, sites=("manager_load",),
                                                max_faults=1,
                                                threads={threading.get_ident()})):
            with pytest.raises(RuntimeError, match="failed to load"):
                mgr.get("m")
        assert _serves(mgr.get("m"))
    finally:
        mgr.shutdown()


def test_http_quarantine_maps_to_503_with_retry_after(tmp_path):
    mgr = _manager(tmp_path, restart_budget=0, restart_window_s=60.0, quarantine_s=30.0)
    api = OpenAIApi(mgr)
    try:
        _kill(mgr.get("m").engine)  # budget 0: the first death quarantines
        with pytest.raises(ApiError) as exc:
            api.chat(Request(method="POST", path="/v1/chat/completions", params={}, query={},
                             headers={}, body={"model": "m", "max_tokens": 2,
                                               "messages": [{"role": "user", "content": "x"}]}))
        assert exc.value.status == 503
        assert int(exc.value.to_response().headers["Retry-After"]) >= 1
        assert ("localai_model_quarantined", {"model": "m"}, 1.0) in api.engine_gauges()
    finally:
        mgr.shutdown()


# --------------------------------------------------------------------- #
# Fault sweep
# --------------------------------------------------------------------- #


def _churn(eng, n_req, seed, adapter=None, fork=False, repeat=False, long=False):
    """Mixed traffic; returns each request's final event kind. Nothing may
    hang: every stream ends with done or error. `long` requests outgrow
    their admission's pages, so a small pool preempts (and swaps)."""
    outcomes = [None] * n_req

    def one(i):
        ids = [(seed * 131 + i * 37 + j) % 255 + 1 for j in range(4 + (i * 7) % 40)]
        bias = {}
        if repeat:  # a pinned stream: prompt lookup drafts every round
            ids, bias = [ids[0]] * 40, {ids[0]: 100.0}
        new = 30 + (i % 3) * 15 if long else 4 + (i % 3) * 8
        req = GenRequest(prompt_ids=ids, max_new_tokens=new, ignore_eos=True,
                         deadline_s=60.0, temperature=0.8 if i % 3 == 0 else 0.0, seed=i,
                         adapter=adapter if adapter and i % 2 else None, logit_bias=bias)
        try:
            if fork and i % 2 == 0:
                hs = eng.submit_fork([dataclasses.replace(req, seed=i * 10 + k)
                                      for k in range(3)])
            else:
                hs = [eng.submit(req)]
        except QueueFullError:
            outcomes[i] = "shed"
            return
        if i % 5 == 4:
            time.sleep(0.02)
            hs[0].cancel()  # a client going away mid-stream
        kinds = [list(h)[-1].kind for h in hs]
        outcomes[i] = "error" if "error" in kinds else "done"

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n_req)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "a request never ended"
    assert all(o in ("done", "error", "shed") for o in outcomes), outcomes
    return outcomes


def _quiesce(eng, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if eng.is_dead:
            return
        with eng._pending_lock:
            idle = not eng._pending
        if idle and not eng.h_active.any() and not eng._chunkings \
                and not any(s is not None for s in eng.slots):
            time.sleep(0.05)  # the loop finishes its iteration
            return
        time.sleep(0.02)
    raise AssertionError("the engine did not quiesce")


def _sweep(eng, seed, sites, rate, max_faults=3, n_req=6, site_rates=None, **churn):
    sched = faults.FaultSchedule(seed, rate=rate, sites=sites, max_faults=max_faults,
                                 site_rates=site_rates, threads={eng._thread.ident})
    try:
        with faults.active(sched):
            outcomes = _churn(eng, n_req, seed, **churn)
            _quiesce(eng)
        if sched.fired["engine_loop"]:
            eng._thread.join(timeout=60)
            assert eng.is_dead
        if eng.is_dead:
            assert len(eng._free_pages) == eng.ecfg.kv_pages and eng._host_bytes == 0
        else:
            _quiesce(eng)
            _assert_pool_accounted(eng)
            _, ev = eng.generate([65, 66], max_new_tokens=2, ignore_eos=True)
            assert ev.kind == "done"  # the engine serves after the faults
            _quiesce(eng)
        _assert_pool_accounted(eng)
        snap = eng.journal.snapshot()
        for site in faults.SITES:
            got = sum(e["event"] == f"fault_{site}" for e in snap)
            assert got == sched.fired[site], (site, got, sched.fired[site])
        return outcomes, sched
    finally:
        eng.stop()


SWEEP_SITES = ("device_dispatch", "page_alloc", "host_swap", "control_commit", "engine_loop")
SWEEP_RATES = {"engine_loop": 0.01, "device_dispatch": 0.08, "control_commit": 0.25,
               "host_swap": 0.6, "page_alloc": 0.15}


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_fault_sweep_fixed_seeds(tiny, paged):
    # A pool of 8 pages under long requests preempts, and swaps.
    kw = dict(max_pending=16, block_sizes=(4, 1))  # short blocks: many commits
    if paged:
        # Three long requests outgrow a pool of 8 pages: preemption swaps.
        kw.update(max_slots=3, kv_pages=8, kv_page_size=PAGE)
    fired = {}
    for seed in (3, 11, 29, 41):
        # The loop site is called every iteration and dispatch twice an
        # admission: lower rates there let every site fire within the
        # schedule's budget.
        _outcomes, sched = _sweep(_port(tiny, **kw), seed, SWEEP_SITES, rate=0.2, long=paged,
                                  max_faults=4, site_rates=SWEEP_RATES)
        for site, n in sched.fired.items():
            fired[site] = fired.get(site, 0) + n
    want = ("device_dispatch", "control_commit")
    assert all(fired.get(site) for site in want), {k: v for k, v in fired.items() if v}


@pytest.mark.parametrize("edge", ["swap_out", "swap_in"])
def test_host_swap_faults_are_contained(tiny, edge):
    """Two requests that each need 9 of a 12-page pool's pages: the younger
    is preempted and swapped (tests/test_torch_swap.py's setup). A failed
    swap-out preempts by recompute instead (both requests end done); a
    failed swap-in ends the victim with an error event. Either way the pool
    and the host tier are accounted, and the journal holds the fault."""
    eng = _port(tiny, kv_pages=12, kv_page_size=PAGE, block_sizes=(8,), kv_preempt="swap",
                prefix_cache_entries=0)
    pa = [(j * 7) % 250 + 1 for j in range(40)]
    pb = [(j * 3) % 250 + 1 for j in range(41)]
    try:
        after = 0 if edge == "swap_out" else 1
        with faults.active(faults.ChaosScript(0, [faults.ChaosPhase("host_swap", after)],
                                              threads={eng._thread.ident})) as sched:
            ha = eng.submit(GenRequest(prompt_ids=pa, max_new_tokens=100, ignore_eos=True))
            time.sleep(0.05)  # a older than b: b is the victim
            hb = eng.submit(GenRequest(prompt_ids=pb, max_new_tokens=100, ignore_eos=True))
            kinds = [list(h)[-1].kind for h in (ha, hb)]
            _quiesce(eng)
        assert sched.fired["host_swap"] == 1
        m = eng.metrics()
        if edge == "swap_out":
            assert kinds == ["done", "done"] and m["kv_preempt_recomputes"] >= 1
        else:
            assert "error" in kinds and m["kv_preempt_swaps"] >= 1
        _assert_pool_accounted(eng)
        assert eng._host_bytes == 0 and len(eng._free_pages) == eng.ecfg.kv_pages
        assert sum(e["event"] == "fault_host_swap" for e in eng.journal.snapshot()) == 1
    finally:
        eng.stop()


def _one_fault(eng, site, reqs):
    """Run `reqs` (lists of GenRequests: a list of several is one fork
    group) with `site` failing at its first call; returns each handle's
    final event kind."""
    with faults.active(faults.ChaosScript(0, [faults.ChaosPhase(site, 0)],
                                          threads={eng._thread.ident})) as sched:
        hs = [h for r in reqs for h in (eng.submit_fork(r) if isinstance(r, list)
                                        else [eng.submit(r)])]
        kinds = [list(h)[-1].kind for h in hs]
        _quiesce(eng)
    assert sched.fired[site] == 1, sched.calls[site]
    _assert_pool_accounted(eng)
    assert sum(e["event"] == f"fault_{site}" for e in eng.journal.snapshot()) == 1
    return kinds


def test_fault_sweep_spec_verify(tiny):
    # A stream pinned to one token: prompt lookup drafts at the first
    # block, so the first round fails; the engine then serves.
    eng = _port(tiny, kv_pages=16, kv_page_size=PAGE, spec_mode="prompt_lookup")
    try:
        rep = GenRequest(prompt_ids=[5] * 32, max_new_tokens=12, ignore_eos=True,
                         logit_bias={5: 100.0})
        assert _one_fault(eng, "spec_verify", [rep]) == ["error"]
        assert list(eng.submit(rep))[-1].kind == "done"
    finally:
        eng.stop()
    for seed in (1, 2):
        _sweep(_port(tiny, kv_pages=16, kv_page_size=PAGE, spec_mode="prompt_lookup"),
               seed, ("spec_verify", "device_dispatch"), rate=0.2, repeat=True)


def test_fault_sweep_adapter_fetch(tiny, tmp_path):
    cfg = tiny[0]
    random_lora_adapter(cfg, str(tmp_path / "t0"), 4, 4, ("wq", "wv"), seed=1, scale=0.04)

    def engine():
        # No host image is kept, so every promote fetches.
        e = _port(tiny, kv_pages=16, kv_page_size=PAGE, adapter_cache_bytes=0)
        e.register_adapter("t0", str(tmp_path / "t0"))
        return e

    eng = engine()
    try:
        req = GenRequest(prompt_ids=[3, 4, 5], max_new_tokens=6, adapter="t0")
        base = GenRequest(prompt_ids=[3, 4, 5], max_new_tokens=6)
        # The tenant's request fails its admission; the base's is served.
        assert _one_fault(eng, "adapter_fetch", [req, base]) == ["error", "done"]
        assert list(eng.submit(req))[-1].kind == "done"
        assert not eng._adapter_refs.any()
    finally:
        eng.stop()
    for seed in (1, 4):
        _sweep(engine(), seed, ("adapter_fetch",), rate=0.4, adapter="t0")


def test_fault_sweep_slot_fork(tiny):
    eng = _port(tiny, max_slots=4, kv_pages=24, kv_page_size=PAGE)
    try:
        group = [GenRequest(prompt_ids=list(range(1, 40)), max_new_tokens=8, ignore_eos=True,
                            temperature=0.8, seed=k) for k in range(3)]
        # The first branch's fork fails: it admits as a clone; all end done.
        assert _one_fault(eng, "slot_fork", [group]) == ["done"] * 3
        m = eng.metrics()
        assert m["fork_clone_fallbacks"] == 1 and m["fork_branches"] == 1
    finally:
        eng.stop()
    for seed in (2, 5):
        _sweep(_port(tiny, max_slots=4, kv_pages=24, kv_page_size=PAGE), seed,
               ("slot_fork", "page_alloc"), rate=0.3, fork=True)
