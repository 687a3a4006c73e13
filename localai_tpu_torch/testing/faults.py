"""Deterministic fault injection at the engine/manager seams (a copy of
localai_tpu/testing/faults.py).

The reference LocalAI gets crash-only robustness for free from its process
model (watchdog.go kills a wedged backend, the next request respawns it) and
never needed a fault harness; an in-process server does. This module makes
failure a first-class, *seeded* input: a `FaultSchedule` decides —
reproducibly, per site — when a hook point raises `InjectedFault`, so a
randomized churn test (tests/test_torch_robustness.py) can drive many
distinct failure interleavings and assert the invariant that matters: every
submitted request terminates and the page pool + host tier stay fully
accounted. SITES is the JAX package's list, whole and in order, so a
schedule makes the same decisions in both packages; the sites whose
producers the port does not have yet (the cluster's, collective_dispatch)
stay listed and never fire.

Hook sites (each is one `faults.fire(SITE)` call in production code):

  device_dispatch  — entry of Engine._run_block / _dispatch_admit /
                     _dispatch_admit_pinned / _dispatch_admit_cached /
                     _dispatch_chunk, in host code before any graph capture
                     or replay. Raising here exercises the per-request
                     containment paths (the loop catches, posts error
                     events, keeps serving).
  engine_loop      — top of the Engine._loop iteration. Raising here is an
                     UNCAUGHT loop death: exercises _loop_guard's drain +
                     state release and the manager's restart/quarantine path.
  page_alloc       — entry of Engine._pages_alloc (before any mutation, so
                     accounting stays exact). Depending on the call path this
                     either fails one admission or kills the loop.
  host_swap        — entry of the swap-tier D2H/H2D copies
                     (Engine._swap_out_slot_span / _dispatch_resume_swap):
                     a failed swap-out preempts by recompute instead, a
                     failed swap-in ends that request with an error event.
  manager_load     — entry of ModelManager._load: exercises the failed-load
                     containment (RuntimeError to that one caller).
  collective_dispatch — fired by Engine._dispatch_admit/_dispatch_block
                     ONLY when the engine runs on a multi-device mesh
                     (tensor parallel), just before the sharded
                     program launch. Stands in for an ICI/collective
                     failure mid-dispatch: the containment contract is the
                     same as device_dispatch (error events, never a hung
                     caller), and a schedule that combines it with
                     engine_loop must still leave the GLOBAL page
                     allocator fully accounted after _release_all_state —
                     the host-side allocator/refcounts are shared by every
                     shard, so a mid-collective death may not strand any
                     shard's pages.
  cluster_dispatch — entry of ClusterClient._run_inner (cluster/scheduler).
                     Raising here exercises the cluster layer's terminal-
                     event containment: the caller gets a typed error event,
                     never a hung stream.
  span_transfer    — entry of cluster.transfer encode_span/decode_span.
                     Raising here fails a prefill→decode KV handoff; the
                     contract is silent fallback to recompute on the decode
                     replica.
  host_partition   — chunk boundaries of the networked span stream
                     (cluster.netspan encode/fetch): the peer
                     dropped off the network mid-transfer. The client sees
                     a resumable connection failure; past its resume budget
                     the transfer fails TYPED (SpanTransferError) and the
                     caller recomputes/reroutes — never a hung caller, and
                     the importing engine's pool/host-tier stay accounted.
  slow_network     — same chunk boundaries, but the failure mode is TIME:
                     the hook stalls SLOW_NETWORK_DELAY_S instead of
                     raising, standing in for a congested/flapping DCN
                     link. The caller's socket timeout converts the stall
                     into the same typed-failure path as host_partition.
  adapter_fetch    — host-tier adapter fetch (Engine._adapter_image: disk →
                     host-RAM LRU) and device promote
                     (Engine._adapter_acquire: host image → stacked device
                     factors). Raising here fails THAT request's
                     admission with a typed error event; the engine keeps
                     serving every other tenant and the per-slot adapter
                     refcounts stay fully accounted at quiesce.
  page_spill       — the cold-page spill/restore edges of windowed+sink
                     long-context serving (Engine._spill_cold_pages /
                     Engine._restore_spilled). Raising at the
                     spill edge leaves that slot's pages HOT (exact
                     attention continues untouched); raising at the restore
                     edge degrades the consumer (prefix save skipped, span
                     export refused) — in every case zero hung callers and
                     the pool + host tier fully accounted at quiesce.
  spec_verify      — entry of Engine._run_spec_round, just
                     before a speculative verify round launches (any draft
                     source: draft_model / prompt_lookup / self_draft). The
                     containment contract matches device_dispatch (error
                     events to the affected slots, the engine keeps
                     serving) and additionally the acceptance EWMAs and the
                     page-pool accounting must be intact at quiesce — a
                     failed verify round may not leave a slot's draft
                     bookkeeping half-updated.
  gauge_scrape     — the per-replica gauge refresh call in
                     ClusterScheduler.refresh (cluster/scheduler.py), fired
                     just before the replica's gauge callable runs (outside
                     the scheduler lock). Stands in for a slow or flapping
                     /metrics endpoint. The containment contract:
                     ONE failed scrape must NOT mark the replica dead — only
                     `gauge_fail_threshold` consecutive failures (or a
                     loop_dead gauge) transition it, and routing continues
                     on the last-good gauges in between.
  control_commit   — the H2D control commit of a decode block or round
                     (Engine._stage_block: the pack, the page table and the
                     adapter rows copied into the graph's buffers). Raising
                     here fails the block BEFORE
                     any device state mutated or any slot's `scheduled`
                     advanced, so the containment contract is
                     device_dispatch's: the loop catches, posts typed error
                     events to the affected slots, releases them, and keeps
                     serving — zero hung callers, pool fully accounted.

Activation:
  - programmatic: `with faults.active(FaultSchedule(seed=7)): ...`
  - deployment:   LOCALAI_FAULTS="seed:7[,rate:0.05][,max:4]
                  [,sites:engine_loop|page_alloc]", which
                  config/app_config.py reads (the port reads environment
                  variables there only) and ModelManager arms at
                  construction through ensure_installed(spec).

Determinism: each site gets its own RNG seeded from (seed, site), so the
injection pattern at a site depends only on how many times that site has
fired — not on cross-thread interleaving between sites.

Consistency: FaultSchedule rejects site names outside SITES at construction
(a typo'd `sites:` spec fails loudly), and tests/test_torch_observe.py
verifies the other direction — every SITES entry has at least one literal
`faults.fire(...)` call in localai_tpu_torch/ or waits in one named tuple
of sites whose module is not ported yet — so a renamed or deleted hook
cannot leave a site that schedules target but that silently never fires.
"""

from __future__ import annotations

import contextlib
import random
import threading
from typing import Iterable, Iterator, Optional, Sequence

SITES = (
    "device_dispatch",
    "engine_loop",
    "page_alloc",
    "host_swap",
    "manager_load",
    "cluster_dispatch",
    "span_transfer",
    "host_partition",
    "slow_network",
    "collective_dispatch",
    "adapter_fetch",
    "spec_verify",
    "page_spill",
    "control_commit",
    "slot_fork",
    "gauge_scrape",
)

# Sites whose producers the port has not ported yet, with the ROADMAP
# Queue A item that brings each: they stay in SITES (the same order, so a
# schedule draws the same per-site streams as the JAX package's) and never
# fire. tests/test_torch_observe.py holds every other site to a literal
# fire() call.
WAITING_SITES = (
    ("cluster_dispatch", "12, cluster"),
    ("span_transfer", "12, cluster"),
    ("host_partition", "12, cluster"),
    ("slow_network", "12, cluster"),
    ("gauge_scrape", "12, cluster"),
    ("collective_dispatch", "14, multi-GPU"),
)

DEFAULT_RATE = 0.05


class InjectedFault(Exception):
    """Raised by fire() when the active schedule says this call fails.

    Deliberately NOT a RuntimeError: containment code distinguishes its own
    typed RuntimeErrors (re-raised verbatim) from generic backend failures
    (wrapped) — an injected fault must take the generic-failure path, like
    the XLA/device error it stands in for."""


class FaultSchedule:
    """Seed-driven decision source: which fire() calls raise.

    rate        — per-call injection probability (site_rates overrides
                  per site).
    sites       — sites eligible for injection (default: all).
    max_faults  — total injections before the schedule goes quiet
                  (None = unbounded). Bounding it lets churn tests assert
                  RECOVERY, not just failure: traffic after the last
                  injection must succeed.
    threads     — thread idents eligible for injection (None = all).
                  fire() calls from other threads are invisible to the
                  schedule: not counted, no draw consumed. Scoping matters
                  when unrelated engines share the process (module-scoped
                  fixture engines idle in the background and their loops
                  also call fire()): an unscoped max_faults=1 schedule can
                  be eaten by a bystander instead of the engine under test.
    """

    def __init__(
        self,
        seed: int,
        rate: float = DEFAULT_RATE,
        sites: Optional[Sequence[str]] = None,
        max_faults: Optional[int] = None,
        site_rates: Optional[dict[str, float]] = None,
        threads: Optional[Iterable[int]] = None,
    ) -> None:
        self.seed = int(seed)
        self.rate = float(rate)
        self.sites = tuple(sites) if sites is not None else SITES
        unknown = set(self.sites) - set(SITES)
        if unknown:
            raise ValueError(f"unknown fault sites {sorted(unknown)} — use {SITES}")
        self.max_faults = max_faults
        self.site_rates = dict(site_rates or {})
        self.threads = frozenset(threads) if threads is not None else None
        self._lock = threading.Lock()
        self._rngs = {s: random.Random(f"{self.seed}:{s}") for s in SITES}
        self.calls: dict[str, int] = {s: 0 for s in SITES}
        self.fired: dict[str, int] = {s: 0 for s in SITES}

    def total_fired(self) -> int:
        with self._lock:
            return sum(self.fired.values())

    def should_fire(self, site: str) -> bool:
        # Thread scoping happens BEFORE call accounting: a scoped schedule
        # sees exactly the call sequence its target threads produce, so
        # bystander loops can't skew the (seed, site, call index) pattern.
        if (self.threads is not None
                and threading.get_ident() not in self.threads):
            return False
        with self._lock:
            self.calls[site] = self.calls.get(site, 0) + 1
            # Draw BEFORE eligibility filters so the per-site decision
            # sequence is a pure function of (seed, site, call index) —
            # narrowing `sites` or exhausting max_faults never reshuffles
            # the pattern at other sites.
            draw = self._rngs[site].random()
            if site not in self.sites:
                return False
            if self.max_faults is not None and sum(self.fired.values()) >= self.max_faults:
                return False
            if draw >= self.site_rates.get(site, self.rate):
                return False
            self.fired[site] = self.fired.get(site, 0) + 1
            return True

    def __repr__(self) -> str:  # shows up in InjectedFault messages/logs
        scope = ("" if self.threads is None
                 else f", threads={sorted(self.threads)}")
        return (
            f"FaultSchedule(seed={self.seed}, rate={self.rate}, "
            f"sites={self.sites}, max_faults={self.max_faults}{scope})"
        )


_active: Optional[FaultSchedule] = None
_install_lock = threading.Lock()


def install(schedule: Optional[FaultSchedule]) -> None:
    """Make `schedule` the process-wide active schedule (None deactivates)."""
    global _active
    with _install_lock:
        _active = schedule


def uninstall() -> None:
    install(None)


@contextlib.contextmanager
def active(schedule: FaultSchedule) -> Iterator[FaultSchedule]:
    """Scoped activation for tests; restores the previous schedule."""
    global _active
    with _install_lock:
        prev = _active
        _active = schedule
    try:
        yield schedule
    finally:
        with _install_lock:
            _active = prev


def parse_env(spec: str) -> Optional[FaultSchedule]:
    """Parse a LOCALAI_FAULTS string ("seed:7,rate:0.1,max:4,sites:a|b");
    None for an empty one."""
    spec = (spec or "").strip()
    if not spec:
        return None
    kw: dict = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        key, _, val = part.partition(":")
        key = key.strip().lower()
        val = val.strip()
        if key == "seed":
            kw["seed"] = int(val)
        elif key == "rate":
            kw["rate"] = float(val)
        elif key == "max":
            kw["max_faults"] = int(val)
        elif key == "sites":
            kw["sites"] = tuple(s.strip() for s in val.split("|") if s.strip())
        else:
            raise ValueError(f"LOCALAI_FAULTS: unknown key {key!r} in {spec!r}")
    if "seed" not in kw:
        raise ValueError(f"LOCALAI_FAULTS needs seed:N (got {spec!r})")
    return FaultSchedule(**kw)


def ensure_installed(spec: str) -> None:
    """Arm the schedule a LOCALAI_FAULTS string names (ApplicationConfig.
    faults) when no schedule is active — the counterpart of the JAX
    package's ensure_env_installed, which reads the variable itself."""
    global _active
    schedule = parse_env(spec)
    if schedule is None:
        return
    with _install_lock:
        if _active is None:
            _active = schedule


class ChaosPhase:
    """One scripted injection window inside a ChaosScript.

    A phase targets ONE site and arms only after that site has been called
    `after_calls` times — "kill the engine loop at block 40", "partition
    the THIRD span-transfer chunk" — which is what the randomized
    FaultSchedule cannot express. While armed it injects with `rate`
    (default: always) until it has fired `max_faults` times, then goes
    quiet forever. Phases are independent: each keeps its own fired count,
    and several phases may script the same site at different depths.
    """

    def __init__(self, site: str, after_calls: int = 0, rate: float = 1.0,
                 max_faults: int = 1) -> None:
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r} — use {SITES}")
        self.site = site
        self.after_calls = int(after_calls)
        self.rate = float(rate)
        self.max_faults = int(max_faults)
        self.fired = 0

    def __repr__(self) -> str:
        return (f"ChaosPhase({self.site!r}, after_calls={self.after_calls}, "
                f"rate={self.rate}, max_faults={self.max_faults}, "
                f"fired={self.fired})")


class ChaosScript(FaultSchedule):
    """Phase-scheduled multi-site fault script — the chaos-harness side of
    the FaultSchedule coin. Where FaultSchedule answers "fail ~5% of calls
    at these sites", a ChaosScript answers "fail call #N at site A, then
    calls #M..M+2 at site B": deterministic placement for the scenarios
    the JAX package's tools/chaos_run.py drives (kill-at-block-N, slow-gauge,
    partition-during-transfer, join-under-load).

    Drop-in wherever a FaultSchedule goes (install/active machinery,
    thread scoping, call accounting). The per-site RNG draw is
    still consumed on EVERY counted call, exactly like the parent, so a
    rate<1.0 phase sees the same (seed, site, call-index) decision sequence
    a FaultSchedule would — phases narrow WHERE faults land, never
    reshuffle the underlying pattern.
    """

    def __init__(self, seed: int, phases: Sequence[ChaosPhase],
                 threads: Optional[Iterable[int]] = None) -> None:
        phases = list(phases)
        super().__init__(
            seed,
            rate=0.0,  # nothing fires outside a scripted phase
            sites=tuple(dict.fromkeys(p.site for p in phases)) or None,
            threads=threads,
        )
        self.phases = phases

    def should_fire(self, site: str) -> bool:
        if (self.threads is not None
                and threading.get_ident() not in self.threads):
            return False
        with self._lock:
            self.calls[site] = self.calls.get(site, 0) + 1
            calls = self.calls[site]
            # Draw unconditionally — see class docstring.
            draw = self._rngs[site].random()
            for phase in self.phases:
                if (phase.site == site
                        and calls > phase.after_calls
                        and phase.fired < phase.max_faults
                        and draw < phase.rate):
                    phase.fired += 1
                    self.fired[site] = self.fired.get(site, 0) + 1
                    return True
            return False

    def exhausted(self) -> bool:
        """True once every phase has fired its full budget — the moment a
        chaos run can start asserting recovery instead of failure."""
        with self._lock:
            return all(p.fired >= p.max_faults for p in self.phases)

    def __repr__(self) -> str:
        scope = ("" if self.threads is None
                 else f", threads={sorted(self.threads)}")
        return f"ChaosScript(seed={self.seed}, phases={self.phases}{scope})"


def fire(site: str) -> None:
    """Hook point: raise InjectedFault when the active schedule says so.

    Disabled cost: one global load + None check.
    """
    s = _active
    if s is None:
        return
    if s.should_fire(site):
        raise InjectedFault(
            f"injected fault at {site} "
            f"(call #{s.calls.get(site, 0)}, seed {s.seed})"
        )
