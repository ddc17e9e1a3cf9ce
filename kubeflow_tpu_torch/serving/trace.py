"""Request-lifecycle tracing: phase-attributed latency for the serving path.

The platform's mechanisms are deep (paged KV -> migration -> QoS doors ->
elastic resize -> KV tiering) but latency was only observable END TO END:
when a token is slow nothing could say whether the time went to the
router's QoS queue, the engine admission queue, a prefill chunk, a verify
dispatch, a COW copy, a host-tier spill, or a mid-stream resize.  Both
Tenplex (PAPERS.md — a resize cost is only schedulable once decomposed
into drain/reshard/resume) and the Gemma-on-TPU serving comparison
(PAPERS.md — TTFT/ITL *breakdowns*, not means, are the comparable
quantities) argue that per-phase attribution is the unit of serving
performance analysis; ROADMAP item 2's predictive autoscaler needs
exactly this signal (queue depth and stall CAUSES, not totals).

Design, pure stdlib and sampling by construction:

- :class:`Span` — monotonic start/end, parent id, structured attrs.
  Plain ``__slots__`` objects; opening/closing one is two clock reads
  and a list append.
- :class:`Trace` — one request's span tree, assembled LOCK-FREE on
  whichever thread currently owns the request's lifecycle: span/phase
  appends are single ``list.append`` calls (GIL-atomic), and ownership
  hands off at the same seams the engine already defines (HTTP thread
  -> scheduler thread via ``submit``, scheduler -> migration worker via
  the mailbox).  The PHASE TRACK is the load-bearing invariant: phases
  are sequential and CONTIGUOUS — ``phase(name)`` closes the current
  phase and opens the next at the same timestamp — so the per-phase
  durations of a trace tile its root span and sum to the end-to-end
  latency (pinned within 5% by tests/test_observability.py).  Detail
  spans (each prefill chunk, each decode/verify dispatch with its
  program family + warmed rung, a COW copy, a migration export) overlap
  freely underneath, parented to the phase active when they opened.
- :class:`TraceSink` — bounded ring buffer of COMPLETED traces plus the
  phase-latency histograms (``kft_phase_seconds{phase=...}`` with
  exemplar trace ids).  Finalization (histogram observation + ring
  append) runs on the FINISHING caller's thread — the HTTP worker that
  delivered the response, never the engine scheduler's dispatch path:
  the scheduler only ever stamps timestamps into already-allocated
  structures.
- :class:`Tracer` — the sampling front door (``sample`` in [0, 1],
  ``ring`` completed traces retained).  An unsampled request carries
  ``trace=None`` end to end and every instrumentation site is guarded
  by that None check, so ``sample=0`` allocates nothing on the dispatch
  path (asserted by test).
- Context propagation: ``X-KFT-Trace: <trace_id>:<parent_span>:<flag>``
  over HTTP (router -> replica), the same triple as a ``trace`` dict
  riding the ``kv_migrate``/``reshard`` wire headers and the gang
  ``kv_import`` replay meta — one trace follows a request through the
  router door, affinity pick, replica door, engine queue, prefill
  chunks, a disaggregation handoff, decode/verify dispatches,
  preemption park/unpark, migration, resize freeze/cutover, and
  hibernate/thaw.
- :meth:`TraceSink.summary` — the host API the future autoscaler
  consumes (ROADMAP item 2): per-tenant-class queue-wait / stall-cause
  aggregates over a sliding window, computed from the ring on demand.

The port's copy of ``kubeflow_tpu/serving/trace.py``, device-free like
it, with the same names; it imports nothing of the reference package.
"""

from __future__ import annotations

import json
import random
import threading
import time
from typing import Any, Optional

#: HTTP propagation header: "<trace_id>:<parent_span_id>:<sampled>"
TRACE_HEADER = "X-KFT-Trace"

#: spans retained per trace — a pathological request (thousands of
#: decode dispatches) must not grow one sampled trace without bound;
#: the drop is counted on the trace, never silent
MAX_SPANS_PER_TRACE = 512

#: phase-latency histogram bucket upper bounds, seconds.  Wide on
#: purpose: the same buckets must resolve a 2 ms decode dispatch and a
#: 30 s queue wait (fixed buckets are the scrape contract — Prometheus
#: cannot aggregate dynamic ones across replicas).
PHASE_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

def _new_id() -> str:
    """Process-unique hex id (trace ids add a random component so two
    replicas can never mint the same id)."""
    return f"{random.getrandbits(48):012x}"


class Span:
    """One timed operation inside a trace."""

    __slots__ = ("name", "span_id", "parent_id", "start", "end", "attrs")

    def __init__(self, name: str, span_id: str, parent_id: Optional[str],
                 start: float, attrs: Optional[dict] = None):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = start
        self.end: Optional[float] = None
        self.attrs = attrs

    def done(self, at: Optional[float] = None, **attrs) -> "Span":
        if self.end is None:  # first close wins; re-closing is a no-op
            self.end = time.perf_counter() if at is None else at
            if attrs:
                self.set(**attrs)
        return self

    def set(self, **attrs) -> "Span":
        if self.attrs is None:
            self.attrs = {}
        self.attrs.update(attrs)
        return self

    @property
    def duration_s(self) -> float:
        return (self.end if self.end is not None
                else time.perf_counter()) - self.start

    def to_dict(self) -> dict:
        d = {"name": self.name, "span_id": self.span_id,
             "parent_id": self.parent_id,
             "start_s": round(self.start, 6),
             "duration_s": round(self.duration_s, 6)}
        if self.attrs:
            # COPY: a disconnect can finish (and serialize) a trace
            # while the scheduler still stamps late attrs on the live
            # Span — the ring entry must be immutable once taken
            d["attrs"] = dict(self.attrs)
        return d


class Trace:
    """One request's span tree + contiguous phase track.

    Thread contract: appends are GIL-atomic list/attr writes and the
    phase track is only advanced by the thread that currently owns the
    request lifecycle (the same ownership handoffs the engine already
    serializes), so no lock is needed or taken on any hot path.
    """

    __slots__ = ("trace_id", "root", "spans", "phases", "_cur_phase",
                 "meta", "dropped_spans", "finished_at")

    def __init__(self, trace_id: Optional[str] = None,
                 parent_id: Optional[str] = None, name: str = "request",
                 **attrs):
        self.trace_id = trace_id or _new_id()
        self.root = Span(name, _new_id(), parent_id,
                         time.perf_counter(), attrs or None)
        #: detail spans (the root is spans[0]; phases live separately)
        self.spans: list[Span] = [self.root]
        #: the contiguous phase track: each entry closes when the next
        #: opens, so durations tile the root span
        self.phases: list[Span] = []
        self._cur_phase: Optional[Span] = None
        #: structured request-scoped facts (tenant, shed reason, model)
        self.meta: dict[str, Any] = {}
        self.dropped_spans = 0
        self.finished_at: Optional[float] = None

    # -- spans -------------------------------------------------------------

    def begin(self, name: str, parent: Optional[Span] = None,
              **attrs) -> Span:
        """Open a detail span (caller closes with ``.done()``); parent
        defaults to the phase active right now, else the root."""
        if len(self.spans) >= MAX_SPANS_PER_TRACE:
            self.dropped_spans += 1
            return _NULL_SPAN
        p = parent if parent is not None else (self._cur_phase or self.root)
        sp = Span(name, _new_id(), p.span_id, time.perf_counter(),
                  attrs or None)
        self.spans.append(sp)
        return sp

    def span(self, name: str, **attrs) -> "_SpanCtx":
        return _SpanCtx(self.begin(name, **attrs))

    # -- the phase track ---------------------------------------------------

    def phase(self, name: str, **attrs) -> Span:
        """Advance the phase track: close the current phase and open
        ``name`` at the SAME timestamp (contiguity is what makes phase
        durations sum to the end-to-end latency)."""
        now = time.perf_counter()
        cur = self._cur_phase
        if cur is not None:
            if cur.name == name:
                return cur  # already there (idempotent re-entry)
            cur.done(now)
        sp = Span(name, _new_id(), self.root.span_id, now, attrs or None)
        self.phases.append(sp)
        self._cur_phase = sp
        return sp

    def end_phase(self, **attrs) -> None:
        cur = self._cur_phase
        if cur is not None:
            cur.done(**attrs)
            self._cur_phase = None

    @property
    def current_phase(self) -> Optional[Span]:
        return self._cur_phase

    # -- lifecycle ---------------------------------------------------------

    def finish(self) -> "Trace":
        """Close the phase track and the root (idempotent)."""
        if self.finished_at is None:
            self.end_phase()
            self.root.done()
            self.finished_at = time.time()
        return self

    @property
    def duration_s(self) -> float:
        return self.root.duration_s

    def phase_totals(self) -> dict[str, float]:
        """Phase name -> summed seconds (a phase may recur: decode ->
        preempted -> decode)."""
        out: dict[str, float] = {}
        for p in self.phases:
            out[p.name] = out.get(p.name, 0.0) + p.duration_s
        return out

    # -- propagation -------------------------------------------------------

    def header(self) -> str:
        """Value for the ``X-KFT-Trace`` HTTP header."""
        return f"{self.trace_id}:{self.root.span_id}:1"

    def wire_context(self) -> dict:
        """JSON-able context for the kv_migrate/reshard wire headers and
        the gang replay meta."""
        return {"id": self.trace_id, "parent": self.root.span_id}

    # -- export ------------------------------------------------------------

    def to_dict(self) -> dict:
        d = {
            "trace_id": self.trace_id,
            "root": self.root.to_dict(),
            "duration_s": round(self.duration_s, 6),
            "phases": [p.to_dict() for p in self.phases],
            "spans": [s.to_dict() for s in self.spans[1:]],
            # copied like span attrs: the ring entry must not alias
            # dicts a still-live thread may stamp after finish
            "meta": dict(self.meta),
        }
        if self.finished_at is not None:
            d["finished_at"] = self.finished_at
        if self.dropped_spans:
            d["dropped_spans"] = self.dropped_spans
        return d


class _SpanCtx:
    __slots__ = ("span",)

    def __init__(self, span: Span):
        self.span = span

    def __enter__(self) -> Span:
        return self.span

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None:
            self.span.set(error=f"{type(exc).__name__}: {exc}")
        self.span.done()


#: shared do-nothing span for over-budget begins: callers may .done()/
#: .set() it freely; it is never recorded
_NULL_SPAN = Span("dropped", "0", None, 0.0)


def parse_header(value: Optional[str]) -> Optional[tuple[str, str]]:
    """``X-KFT-Trace`` value -> (trace_id, parent_span_id), or None for
    absent/unsampled/malformed (malformed context starts a fresh
    decision, never an error — tracing must not fail requests)."""
    if not value:
        return None
    parts = str(value).split(":")
    if len(parts) != 3 or parts[2] != "1" or not parts[0] or not parts[1]:
        return None
    return parts[0], parts[1]


def parse_wire_context(ctx) -> Optional[tuple[str, str]]:
    """Wire-header ``trace`` dict -> (trace_id, parent_span_id)."""
    if not isinstance(ctx, dict):
        return None
    tid, parent = ctx.get("id"), ctx.get("parent")
    if not tid or not parent:
        return None
    return str(tid), str(parent)


class TraceSink:
    """Bounded ring of completed traces + the phase histograms.

    ``finish`` is the ONE finalization site: it closes the trace,
    observes every phase into the fixed-bucket histograms (keeping the
    slowest observation's trace id as the family's exemplar) and
    appends to the ring — O(phases) work on the finishing caller's
    thread.  ``observe_phase`` ingests engine-level phase durations
    that have no request trace (a host-tier spill, a resize stage)."""

    def __init__(self, ring: int = 256):
        from collections import deque

        self.ring = int(ring)
        if self.ring < 1:
            raise ValueError("ring must be >= 1")
        self._traces: "deque[dict]" = deque(maxlen=self.ring)
        self._mu = threading.Lock()
        #: phase -> [bucket counts..., +inf count]
        self._counts: dict[str, list[int]] = {}
        self._sums: dict[str, float] = {}
        #: phase -> (duration, trace_id): the exemplar is the slowest
        #: observation since the last scrape-side reset (never reset
        #: here — exemplars are hints, not counters)
        self._exemplar: dict[str, tuple[float, str]] = {}
        self.finished_total = 0

    # -- finalization ------------------------------------------------------

    def finish(self, trace: Optional[Trace]) -> None:
        if trace is None:
            return
        trace.finish()
        d = trace.to_dict()
        with self._mu:
            self.finished_total += 1
            self._traces.append(d)
            for p in trace.phases:
                self._observe_locked(p.name, p.duration_s, trace.trace_id)

    def observe_phase(self, phase: str, seconds: float,
                      trace_id: str = "") -> None:
        with self._mu:
            self._observe_locked(phase, float(seconds), trace_id)

    def _observe_locked(self, phase: str, seconds: float,
                        trace_id: str) -> None:
        counts = self._counts.get(phase)
        if counts is None:
            counts = self._counts[phase] = [0] * (len(PHASE_BUCKETS) + 1)
            self._sums[phase] = 0.0
        for i, b in enumerate(PHASE_BUCKETS):
            if seconds <= b:
                counts[i] += 1
                break
        else:
            counts[-1] += 1
        self._sums[phase] += seconds
        if trace_id:
            best = self._exemplar.get(phase)
            if best is None or seconds > best[0]:
                self._exemplar[phase] = (seconds, trace_id)

    # -- read side ---------------------------------------------------------

    def traces(self) -> list[dict]:
        with self._mu:
            return list(self._traces)

    def slowest(self, n: int = 10) -> list[dict]:
        return sorted(self.traces(), key=lambda d: -d["duration_s"])[:n]

    def jsonl(self, slowest: Optional[int] = None) -> str:
        rows = self.slowest(slowest) if slowest else self.traces()
        return "".join(json.dumps(r) + "\n" for r in rows)

    def phase_metrics(self, name: str = "kft_phase_seconds",
                      base_labels: str = "",
                      exemplars: bool = False) -> list[str]:
        """Prometheus text lines for the phase histograms: one
        ``# TYPE <name> histogram`` header, then per-phase ``_bucket``
        (cumulative), ``_count`` and ``_sum`` — rendered through the
        ONE shared histogram renderer
        (:func:`~.traffic.prom_histogram_lines`).  Empty list when
        nothing was observed (no noise families on idle replicas).

        ``exemplars=True`` attaches the slowest observation's trace id
        to the +Inf bucket in OpenMetrics exemplar syntax.  Callers
        must pass it ONLY on a scrape that negotiated
        ``application/openmetrics-text`` (Accept header): the classic
        ``text/plain`` parser reads the trailer as a malformed
        timestamp and fails the whole page."""
        from .traffic import prom_histogram_lines, prom_label

        with self._mu:
            items = [(ph, list(c), self._sums[ph], self._exemplar.get(ph))
                     for ph, c in sorted(self._counts.items())]
        if not items:
            return []
        lines = [f"# TYPE {name} histogram"]
        for ph, counts, s, ex in items:
            lbl = f'{base_labels},' if base_labels else ""
            lines.extend(prom_histogram_lines(
                name, f'{lbl}phase="{prom_label(ph)}"',
                PHASE_BUCKETS, counts, s,
                exemplar=(ex if exemplars else None)))
        return lines

    def summary(self, window_s: float = 60.0) -> dict:
        """The autoscaler-facing aggregate (ROADMAP item 2): per-class
        phase latency sums/counts/max and stall-cause counts over the
        trailing ``window_s`` of COMPLETED traces.  ``queue_wait_s``
        isolates the two admission queues (router door + engine queue)
        because that — with the shed counts the traffic plane already
        exports — is the predictive-scaling input."""
        cutoff = time.time() - float(window_s)
        out: dict[str, Any] = {"window_s": float(window_s), "classes": {}}
        queue_phases = ("router.door", "replica.door", "engine.queue")
        for d in self.traces():
            if d.get("finished_at", 0.0) < cutoff:
                continue
            cls = str(d.get("meta", {}).get("class")
                      or d.get("meta", {}).get("tenant") or "default")
            c = out["classes"].setdefault(cls, {
                "traces": 0, "e2e_sum_s": 0.0, "e2e_max_s": 0.0,
                "queue_wait_sum_s": 0.0, "phases": {}, "stalls": {}})
            c["traces"] += 1
            c["e2e_sum_s"] += d["duration_s"]
            c["e2e_max_s"] = max(c["e2e_max_s"], d["duration_s"])
            for p in d.get("phases", ()):
                ph = c["phases"].setdefault(
                    p["name"], {"count": 0, "sum_s": 0.0, "max_s": 0.0})
                ph["count"] += 1
                ph["sum_s"] += p["duration_s"]
                ph["max_s"] = max(ph["max_s"], p["duration_s"])
                if p["name"] in queue_phases:
                    c["queue_wait_sum_s"] += p["duration_s"]
            stall = d.get("meta", {}).get("stall")
            if stall:
                c["stalls"][stall] = c["stalls"].get(stall, 0) + 1
        return out

    def stats(self) -> dict:
        with self._mu:
            return {"traces_finished_total": self.finished_total,
                    "traces_retained": len(self._traces)}


def parse_slowest(path: str):
    """``/traces[?slowest=N]`` query -> (ok, N or None).  Shared by
    the router and ModelServer handlers so the query contract cannot
    drift between the two surfaces."""
    from urllib.parse import parse_qs, urlsplit

    q = parse_qs(urlsplit(path).query)
    if not q.get("slowest"):
        return True, None
    try:
        return True, max(1, int(q["slowest"][0]))
    except ValueError:
        return False, None


def traces_body(sinks, slowest: Optional[int] = None) -> str:
    """Merged JSONL for one /traces response: rows from every sink,
    sorted/sliced ONCE across them when ``slowest`` is set (a
    multi-model server must answer N rows total, not N per model)."""
    rows: list[dict] = []
    for s in sinks:
        rows.extend(s.traces())
    if slowest is not None:
        rows = sorted(rows, key=lambda d: -d["duration_s"])[:slowest]
    return "".join(json.dumps(r) + "\n" for r in rows)


class Tracer:
    """Sampling front door + sink, one per serving surface (a model
    runtime, the router).  ``sample`` is the fraction of NEW requests
    traced; a propagated ``X-KFT-Trace`` context is always honored (the
    router already paid the sampling decision for the whole path)."""

    #: adopted-trace watch list bound — a replica that only ever
    #: imports (and whose scrape surfaces are never read) must not
    #: grow the list without limit; overflow finishes the oldest
    MAX_WATCHED = 512

    def __init__(self, sample: float = 0.0, ring: int = 256):
        self.sample = float(sample)
        if not (0.0 <= self.sample <= 1.0):
            raise ValueError(f"sample must be in [0, 1], got {sample}")
        self.sink = TraceSink(ring=ring)
        self.started_total = 0
        self._rng = random.Random()
        #: (done_event, trace) pairs for ADOPTED traces (wire imports
        #: onto fresh handles): no door owns their finalization, so
        #: the read surfaces reap them lazily (finish-on-done happens
        #: on the scrape/read caller's thread — never the scheduler's)
        self._watched: list[tuple[Any, Trace]] = []
        self._watch_mu = threading.Lock()

    def start(self, header: Optional[str] = None, name: str = "request",
              **attrs) -> Optional[Trace]:
        """A new Trace (continued from ``header`` when one rode in,
        freshly sampled otherwise), or None when unsampled — the
        None flows through every instrumentation guard untouched."""
        ctx = parse_header(header)
        if ctx is not None:
            tr = Trace(trace_id=ctx[0], parent_id=ctx[1], name=name,
                       **attrs)
        elif self.sample > 0.0 and self._rng.random() < self.sample:
            tr = Trace(name=name, **attrs)
        else:
            return None
        self.started_total += 1
        return tr

    def adopt(self, ctx) -> Optional[Trace]:
        """Continue a trace from a WIRE context dict (kv_migrate /
        reshard header ``trace`` field) — always honored, like the
        HTTP header."""
        parsed = parse_wire_context(ctx)
        if parsed is None:
            return None
        self.started_total += 1
        return Trace(trace_id=parsed[0], parent_id=parsed[1])

    def watch(self, done_event, trace: Optional[Trace]) -> None:
        """Register an adopted trace for lazy finalization: no serving
        door owns a fresh-handle wire import's trace, so ``reap()``
        (called by the read surfaces) finishes it once the request's
        done event is set — without this, cross-replica continued
        traces never reach the ring or the phase histograms."""
        if trace is None:
            return
        overflow: list[Trace] = []
        with self._watch_mu:
            self._watched.append((done_event, trace))
            while len(self._watched) > self.MAX_WATCHED:
                overflow.append(self._watched.pop(0)[1])
        for tr in overflow:  # finish outside the lock
            self.sink.finish(tr)

    def reap(self) -> int:
        """Finish every watched trace whose request completed; returns
        how many finalized.  Runs on the CALLER's thread (a /traces or
        /metrics scrape, a stats read) — the lazy half of the
        finalization-off-the-scheduler contract."""
        ready: list[Trace] = []
        with self._watch_mu:
            kept: list[tuple[Any, Trace]] = []
            for done, tr in self._watched:
                if done.is_set():
                    ready.append(tr)
                else:
                    kept.append((done, tr))
            self._watched = kept
        for tr in ready:
            self.sink.finish(tr)
        return len(ready)

    def finish(self, trace: Optional[Trace]) -> None:
        self.sink.finish(trace)

    def stats(self) -> dict:
        self.reap()  # scrape-driven finalization of adopted traces
        return {"traces_started_total": self.started_total,
                "trace_sample_rate": self.sample,
                **self.sink.stats()}


def validate_tracing(spec) -> dict:
    """``{"sample": f, "ring": n}`` -> normalized kwargs; raises
    ``ValueError`` naming the offending field.  The ONE validation
    site: conf-freeze (the ISvc controller) and runtime construction
    (text.py, the router) must reject identically."""
    if not isinstance(spec, dict):
        raise ValueError(
            f"tracing must be a mapping {{sample, ring}}, got "
            f"{type(spec).__name__}")
    unknown = set(spec) - {"sample", "ring"}
    if unknown:
        raise ValueError(
            f"tracing keys {sorted(unknown)} unknown "
            "(allowed: ['ring', 'sample'])")
    try:
        sample = float(spec.get("sample", 0.1))
    except (TypeError, ValueError) as e:
        raise ValueError(f"tracing.sample: {e}") from e
    if not (0.0 <= sample <= 1.0):
        raise ValueError(
            f"tracing.sample {sample} must be in [0, 1]")
    try:
        ring = int(spec.get("ring", 256))
    except (TypeError, ValueError) as e:
        raise ValueError(f"tracing.ring: {e}") from e
    if ring < 1:
        raise ValueError(f"tracing.ring {ring} must be >= 1")
    return {"sample": sample, "ring": ring}
