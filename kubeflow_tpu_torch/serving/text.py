"""Text-in/text-out LLM serving: tokenizer in the server + OpenAI-style
completions. The port of ``kubeflow_tpu/serving/text.py``: the same
classes and contract over the port's engines (``continuous.py``); only
``TextGenerator.load`` differs (it builds the engine on the device the
config's ``"device"`` names, the CUDA card when absent, and refuses a
prebuilt engine that is not one of the port's in-process engines).

[upstream: kserve -> python/huggingfaceserver] — the reference's LLM
runtime tokenizes inside the server (clients send text) and exposes the
OpenAI completions API in front of its vLLM/transformers backends.  This
module is that surface over the generation engines:

- ``TextGenerator``: a self-batching Model wrapping ContinuousEngine —
  string prompts in, continuations out, with the tokenizer resolved from
  config (``bytes`` needs nothing; ``hf`` loads a local HuggingFace
  tokenizer directory, e.g. an ``hf://`` snapshot resolved by the
  storage initializer);
- ``ByteTokenizer``: UTF-8 bytes <-> ids — zero-asset, works with any
  vocab >= 256 (the tiny test model's vocab is exactly 256);
- ``HfTokenizer``: ``transformers.AutoTokenizer`` over a LOCAL directory
  (zero-egress deployment: snapshots come from $KFT_HF_HOME);
- the OpenAI completions contract (``openai_completions``), served by
  ModelServer at ``POST /openai/v1/completions``.
"""

from __future__ import annotations

from typing import Any, Optional

from .model import Model


class _ByteIncrementalDecoder:
    """Stateful id-stream decoder for :class:`ByteTokenizer`: feeds new
    ids only, holding incomplete UTF-8 tails instead of re-decoding the
    whole accumulated list (the O(len^2) fix in ``_StopScanner``)."""

    def __init__(self) -> None:
        import codecs

        self._dec = codecs.getincrementaldecoder("utf-8")("replace")

    def decode(self, ids) -> str:
        out: list[str] = []
        for i in ids:
            i = int(i)
            if 0 <= i < 256:
                out.append(self._dec.decode(bytes([i])))
            else:
                # mirror ByteTokenizer.decode: flush any partial char as
                # U+FFFD, then mark the out-of-range id
                out.append(self._dec.decode(b"", True))
                self._dec.reset()
                out.append("�")
        return "".join(out)


class ByteTokenizer:
    """UTF-8 bytes as token ids.  Asset-free; round-trips any text."""

    vocab_size = 256

    def incremental_decoder(self) -> _ByteIncrementalDecoder:
        return _ByteIncrementalDecoder()

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: list[int]) -> str:
        # out-of-range ids (model vocab > 256) become U+FFFD — aliasing
        # them mod 256 would return deterministic-looking garbage as if
        # it were a real completion
        out: list[str] = []
        buf = bytearray()
        for i in ids:
            i = int(i)
            if 0 <= i < 256:
                buf.append(i)
            else:
                out.append(buf.decode("utf-8", errors="replace"))
                buf = bytearray()
                out.append("�")
        out.append(buf.decode("utf-8", errors="replace"))
        return "".join(out)


class HfTokenizer:
    """HuggingFace tokenizer from a LOCAL directory (no hub egress)."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)

    @property
    def vocab_size(self) -> int:
        # len() covers added tokens beyond the base vocab; the model-vocab
        # compatibility guard in TextGenerator.load depends on this
        return len(self._tok)

    @property
    def eos_id(self) -> Optional[int]:
        return self._tok.eos_token_id

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text, add_special_tokens=False)

    def decode(self, ids: list[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)


class _StopScanner:
    """Incremental stop-sequence search over a growing token stream.

    The 20 ms stop poll used to re-decode the whole accumulated id list
    AND re-scan every stop sequence over the whole text — O(len^2) per
    request (ADVICE r5).  This keeps a decoded-prefix cursor: tokenizers
    exposing ``incremental_decoder()`` (bytes) decode only the NEW ids
    each poll, and the stop search always resumes at the scanned-text
    cursor minus a max-stop-length overlap, so each poll costs O(new
    text), not O(all text).  Tokenizers without incremental decode (HF)
    still re-decode but get the tail-only scan.
    """

    def __init__(self, tokenizer, stops: list[str]) -> None:
        self._tok = tokenizer
        self._stops = [s for s in stops if s]
        self._overlap = max((len(s) for s in self._stops), default=1) - 1
        mk = getattr(tokenizer, "incremental_decoder", None)
        self._dec = mk() if callable(mk) else None
        #: True when ``text`` is maintained by incremental decode (an
        #: exact stable prefix of the full decode, minus any held
        #: incomplete UTF-8 tail) — callers may then reuse it instead of
        #: re-decoding the whole stream
        self.incremental = self._dec is not None
        self._n_ids = 0
        self.text = ""
        self._scanned = 0

    def scan(self, ids) -> Optional[int]:
        """Feed the full id list so far; returns the char index of the
        earliest (newly visible) stop hit, else None."""
        if self._dec is not None:
            if len(ids) > self._n_ids:
                self.text += self._dec.decode(ids[self._n_ids:])
                self._n_ids = len(ids)
        else:
            self.text = self._tok.decode(ids)
        start = max(0, self._scanned - self._overlap)
        cut = None
        end = None
        for ss in self._stops:
            i = self.text.find(ss, start)
            if i >= 0 and (cut is None or i < cut):
                cut, end = i, i + len(ss)
        self._scanned = len(self.text)
        #: char index just past the matched stop (valid when a scan
        #: returned a hit) — the exact-token retirement point for
        #: multi-token bursts (speculative decoding delivers up to
        #: spec_k+1 tokens per dispatch, so a stop routinely COMPLETES
        #: mid-burst and the tail tokens after it must be dropped)
        self.last_hit_end = end
        return cut


def _ids_covering(tokenizer, ids, end_char: int) -> list:
    """Smallest prefix of ``ids`` whose decoded text reaches
    ``end_char`` — the EXACT token at which a stop sequence completed.

    With multi-token bursts (speculative decoding retires up to
    spec_k+1 tokens from one dispatch) a stop routinely completes in
    the middle of a burst; the tokens after it were decoded but never
    belonged to the completion, so token accounting (OpenAI ``usage``)
    and downstream id consumers must not see them.  Uses the
    tokenizer's incremental decoder when it has one (O(len) once per
    hit); falls back to prefix re-decodes otherwise (HF path — one-off
    at the hit, not per poll)."""
    mk = getattr(tokenizer, "incremental_decoder", None)
    if callable(mk):
        dec = mk()
        total = 0
        for i, t in enumerate(ids):
            total += len(dec.decode([t]))
            if total >= end_char:
                return list(ids[: i + 1])
        return list(ids)
    # HF prefix decodes are NOT prefix-stable: a trailing incomplete
    # multi-byte char decodes to U+FFFD, and cleanup passes (HF's
    # clean_up_tokenization_spaces collapses " ," -> ",") shift char
    # counts — a length-only test can cut a token EARLY and drop the
    # stop's tail.  A prefix covers only when its decode actually
    # begins with the scanner's text up to end_char (the scanner's
    # offsets live in the FULL decode's coordinates); when no prefix
    # ever agrees, fall through to all ids — the safe pre-burst answer.
    full = tokenizer.decode(list(ids))
    lo, hi = 0, len(ids)
    while lo < hi:  # first index whose prefix length reaches end_char
        mid = (lo + hi) // 2
        if len(tokenizer.decode(list(ids[: mid + 1]))) < end_char:
            lo = mid + 1
        else:
            hi = mid
    # cleanup can move the boundary by a joiner or two around the
    # binary-searched index, so scan a CONSTANT window around it (the
    # stop's covering token sits within a few tokens of the length
    # boundary; an extended disagreement falls through to all ids, the
    # safe over-count) — O(log n) decodes + a constant tail instead of
    # re-decoding every prefix from 0 on the API worker thread
    for i in range(max(0, lo - 4), min(len(ids), lo + 16)):
        txt = tokenizer.decode(list(ids[: i + 1]))
        if (not txt.endswith("�") and len(txt) >= end_char
                and txt.startswith(full[:end_char])):
            return list(ids[: i + 1])
    return list(ids)


def resolve_tokenizer(config: dict):
    """config["tokenizer"]: "bytes" (default) | {"type": "hf", "path": dir}
    — the hf path may come from the storage initializer (storage_path)."""
    spec = config.get("tokenizer", "bytes")
    if spec == "bytes":
        return ByteTokenizer()
    if isinstance(spec, dict) and spec.get("type") == "hf":
        path = spec.get("path") or config.get("storage_path")
        if not path:
            raise ValueError("hf tokenizer needs a local path "
                             "(tokenizer.path or storage_uri)")
        return HfTokenizer(path)
    if isinstance(spec, str) and spec not in ("bytes",):
        # a bare string is a local tokenizer directory
        return HfTokenizer(spec)
    raise ValueError(f"unknown tokenizer spec {spec!r}")


class TextGenerator(Model):
    """Text completions over the continuous-batching engine.

    config:
      params_ref:  "mem://key" holding (LlamaConfig, params)
      device:      where the engine runs ("cpu", "cuda:0"; default the
                   CUDA card — no card and no "cpu" raises)
      tokenizer:   "bytes" | {"type": "hf", "path": dir}
      max_new_tokens, num_slots, decode_chunk, temperature, eos_id,
      warmup_groups: engine knobs (see serving/continuous.py)

    Instances are prompt STRINGS (or {"prompt": str, "max_tokens": int});
    predictions are continuation strings.  Self-batching: concurrent
    requests coalesce in the engine's slot pool at token boundaries.

    Live KV migration (ISSUE 8) is invisible at this layer BY CONTRACT:
    every wait/stream path below polls the Request HANDLE (tokens list +
    done event), never an engine slot — so when the engine (a
    ``DisaggregatedPool`` handoff, a drain, a rebalance) moves the
    sequence's KV to another pool mid-stream, the same handle simply
    keeps accruing tokens from the new owner.  SSE streams survive the
    hop without a client reconnect, and ``cancel()`` keeps working
    because whichever engine currently owns the slot observes the shared
    done event at its next chunk boundary.
    """

    self_batching = True

    #: seconds of zero stream progress before an SSE comment line is
    #: emitted.  TTFT semantics under chunked prefill (``prefill_budget``
    #: > 0, serving/continuous.py): a long prompt's first token arrives
    #: only after ceil(len/budget) fused dispatches, so a streaming
    #: client may legitimately see NOTHING for the whole admission —
    #: the keep-alive comment (ignored by SSE clients by spec) stops
    #: proxies/clients from timing the connection out mid-prefill.
    KEEPALIVE_S = 15.0

    def __init__(self, name: str, config: Optional[dict[str, Any]] = None,
                 engine=None):
        super().__init__(name, config)
        #: a prebuilt in-process engine — load() then attaches only the
        #: tokenizer (the reference also takes the serving gang's rank-0
        #: GangEngine here; the port has no gang yet, ROADMAP A7)
        self.engine = engine
        self.tokenizer = None
        #: per-tenant QoS front door (serving/traffic.py) — built by
        #: load() from config["qos"]; ModelServer consults it on the
        #: OpenAI paths (429 + Retry-After sheds, priority injection)
        self.traffic = None
        #: durable-session storage tier (ISSUE 12) — built by load()
        #: from config["hibernation"] and attached to every paged
        #: engine (hibernate/thaw + the /metrics session gauges)
        self.spill_store = None
        #: idle-session reaper (ISSUE 15 satellite) — built by load()
        #: when config["hibernation"]["reap_idle_s"] is set: quiet
        #: sessions hibernate to the spill store on a clock instead of
        #: only by operator/API action
        self.reaper = None
        #: request-lifecycle tracer (ISSUE 13) — built by load() from
        #: config["tracing"] ({"sample": f, "ring": n}); ModelServer
        #: discovers it here (door spans, /traces, phase histograms)
        #: and every engine behind this runtime shares its sink
        self.tracer = None
        #: the door's trace rides a THREAD-LOCAL from ModelServer's
        #: accept_trace to the openai_* call on the same HTTP thread —
        #: never the payload dict: the async inference logger
        #: serializes that same dict off-thread, and an internal Trace
        #: object (or a pop racing json.dumps) must not leak into the
        #: CloudEvents log
        import threading as _threading

        self._door_trace = _threading.local()

    def _build_traffic(self) -> None:
        qos = self.config.get("qos")
        tokens = self.config.get("qos_tenant_tokens")
        # tokens alone still want a door: a config carrying only
        # qos_tenant_tokens must get its authenticate/401 enforcement,
        # not a silently-absent plane (the phantom-knob failure mode)
        if not qos and not tokens:
            return
        from .traffic import TrafficPlane

        self.traffic = TrafficPlane(
            qos or {}, tenants=self.config.get("qos_tenants"),
            tenant_tokens=tokens)
        if not bool(self.config.get("qos_preempt", True)):
            return
        # priority preemption needs an exportable (paged) pool AND the
        # demand + the victims in the SAME pool (the preemptor watches
        # one engine's waiting list against its own slot table): plain
        # paged engines and the tier ladder (one pool) qualify; the
        # DisaggregatedPool does not — its demand queues on prefill
        # engines while victims decode elsewhere, so evicting there
        # frees nothing the waiter can use.  Disagg still gets
        # priority-ordered admission on its prefill engines; targeted
        # preemption across the handoff is future work.
        engines = ([self.engine] if getattr(self.engine, "paged", False)
                   else [e for e in getattr(self.engine, "pools", [])
                         if getattr(e, "paged", False)
                         and getattr(e, "role", "mixed") == "mixed"])
        for eng in engines:
            self.traffic.attach_engine(eng)

    def accept_trace(self, trace) -> None:
        """ModelServer door -> runtime handoff for the request trace
        (same HTTP thread; the openai_* call takes it back)."""
        self._door_trace.trace = trace

    def _take_trace(self):
        tr = getattr(self._door_trace, "trace", None)
        self._door_trace.trace = None
        return tr

    def _build_tracing(self) -> None:
        """Build the sampling tracer from config["tracing"] and share
        it with every engine behind this runtime (engine-level phase
        observations — spills, wire-import trace adoption — land in
        the same sink the server scrapes)."""
        spec = self.config.get("tracing")
        if not spec:
            return
        from .trace import Tracer, validate_tracing

        self.tracer = Tracer(**validate_tracing(spec))
        engines = ([self.engine]
                   if not getattr(self.engine, "pools", None)
                   else list(self.engine.pools))
        for eng in engines:
            eng.tracer = self.tracer
            if hasattr(eng, "flush_warmup_trace"):
                # build_engine warmed BEFORE the tracer existed: the
                # stashed engine.warmup trace (per-family compile/
                # artifact-load spans) flushes into the sink now
                eng.flush_warmup_trace()

    def _build_hibernation(self) -> None:
        """Attach the manifest-verified spill store (ISSUE 12) to every
        paged engine behind this runtime: sessions hibernate through it
        and any replica configured with the same root can thaw them."""
        hib = self.config.get("hibernation")
        if not hib:
            return
        from .storage import KvSpillStore

        self.spill_store = KvSpillStore(
            str(hib["root"]), fsync=bool(hib.get("fsync", True)))
        for eng in self._hibernation_engines():
            eng.attach_spill_store(self.spill_store)
        reap = hib.get("reap_idle_s")
        if reap:
            from .autoscale import SessionReaper

            # the engine list is re-read every scan so an elastic
            # resize (swap_engine) retargets the clock automatically
            self.reaper = SessionReaper(
                self._hibernation_engines, float(reap),
                interval_s=float(hib.get("reap_interval_s", 1.0)),
            ).start()

    def _hibernation_engines(self) -> list:
        """The paged engines the store is attached to — for a
        DisaggregatedPool that is prefill AND decode tiers (a live
        request owns a slot on exactly one of them)."""
        if getattr(self.engine, "paged", False):
            return [self.engine]
        return [e for e in getattr(self.engine, "pools", [])
                if getattr(e, "paged", False)]

    def hibernate_session(self, req, session_id: str) -> bool:
        """Park a live request durably (engine.hibernate_sequence via
        the attached store) — the blocks spill to storage, the slot
        frees, and ``resume_session`` continues it on ANY replica
        sharing the store root (bit-identical greedy).  Tries every
        paged engine behind this runtime: under disaggregation (or
        after a migration) the sequence may live on any tier, and an
        engine that does not own it just reports nothing-to-export.
        False = the request already finished."""
        if self.spill_store is None:
            raise RuntimeError("no hibernation store configured")
        for eng in self._hibernation_engines():
            if eng.hibernate_sequence(req, session_id):
                return True
        return False

    def resume_session(self, session_id: str, req=None):
        """(req, info): thaw a hibernated session from the store.
        Prefers a decode-capable engine (a prefill-role engine would
        hand the sequence off instead of decoding it), most free
        blocks first."""
        if self.spill_store is None:
            raise RuntimeError("no hibernation store configured")
        engines = self._hibernation_engines()
        decodable = [e for e in engines
                     if getattr(e, "role", "mixed") != "prefill"]
        pool = decodable or engines
        eng = max(pool, key=lambda e: e._alloc.free_blocks)
        return eng.thaw_sequence(session_id, req=req)

    def load(self) -> None:
        from .continuous import (
            ContinuousEngine,
            DisaggregatedPool,
            TieredEngine,
            build_engine,
            resolve_model_source,
        )

        self.tokenizer = resolve_tokenizer(self.config)
        if self.engine is not None:
            if not isinstance(self.engine, (ContinuousEngine, TieredEngine,
                                            DisaggregatedPool)):
                raise NotImplementedError(
                    f"{type(self.engine).__name__}: only the in-process "
                    "engines are ported; the serving gang's GangEngine is "
                    "not (ROADMAP A7)")
            if getattr(self.tokenizer, "vocab_size", 0) > \
                    self.engine.cfg.vocab_size:
                raise ValueError(
                    f"tokenizer needs vocab {self.tokenizer.vocab_size} "
                    f"but the model has {self.engine.cfg.vocab_size}")
            if self.engine.eos_id is None:
                # the gang builds the engine before the tokenizer exists;
                # default the stop token the same way the standalone path
                # does, or gang and in-process deployments of one config
                # would stop differently
                self.engine.eos_id = getattr(self.tokenizer, "eos_id", None)
            self._build_traffic()
            self._build_hibernation()
            self._build_tracing()
            self.ready = True
            return
        cfg, params = resolve_model_source(self.config, name=self.name)
        if getattr(self.tokenizer, "vocab_size", 0) > cfg.vocab_size:
            raise ValueError(
                f"tokenizer needs vocab {self.tokenizer.vocab_size} but the "
                f"model has {cfg.vocab_size}")
        eos = self.config.get("eos_id", getattr(self.tokenizer, "eos_id", None))
        self.engine = build_engine(
            cfg, params, self.config, default_eos=eos,
            default_max_new_tokens=32, device=self.config.get("device"))
        self._build_traffic()
        self._build_hibernation()
        self._build_tracing()
        self.ready = True

    def swap_engine(self, engine) -> None:
        """Elastic-resize hook (serving/resize.py ``set_engine``):
        re-point the runtime at the new-degree engine AND migrate the
        traffic plane's preemptors — each holds an engine reference
        (its poll thread would silently watch the stopped source
        forever) and possibly PARKED snapshots, which must follow the
        pool so an evicted victim re-imports into the LIVE engine."""
        old, self.engine = self.engine, engine
        if self.tracer is not None and getattr(engine, "tracer",
                                               None) is None:
            # the tracer follows the pool like the preemptors below —
            # phase observations must not silently stop at a resize
            engine.tracer = self.tracer
        if self.traffic is None:
            return
        carried: list = []
        for p in list(self.traffic.preemptors):
            if old is not None and p.engine is old:
                p.stop(fail_parked=False)
                with p._lock:
                    carried.extend(p._parked)
                    p._parked = []
                self.traffic.preemptors.remove(p)
        if getattr(engine, "paged", False) and bool(
                self.config.get("qos_preempt", True)):
            np_ = self.traffic.attach_engine(engine)
            if carried:
                with np_._lock:
                    np_._parked.extend(carried)

    def stop(self) -> None:
        if self.reaper is not None:
            self.reaper.stop()
            self.reaper = None
        if self.traffic is not None:
            self.traffic.stop()
            self.traffic = None
        if self.engine is not None:
            self.engine.stop()
            self.engine = None
        super().stop()

    @staticmethod
    def _priority(value):
        """Payload ``priority`` ("high"/"normal"/"low" or a tier int)
        -> engine tier, None when absent (engine default)."""
        if value is None:
            return None
        from .traffic import priority_tier

        return priority_tier(value)

    def _submit(self, inst):
        # NOTE: no ``priority`` here by design — the V1/V2 predict
        # paths carry no QoS door (no ticket, no header read), so an
        # instance-level priority would be an unbounded client field
        # that outranks every classed tenant.  Priority enters through
        # the OpenAI payload (bounded by ModelServer's
        # ``bound_priority``) or direct ``engine.submit`` calls.
        if isinstance(inst, dict):
            prompt = inst.get("prompt", "")
            max_new = inst.get("max_tokens")
            temp = inst.get("temperature")
            tp, tk = inst.get("top_p"), inst.get("top_k")
        else:
            prompt, max_new, temp, tp, tk = str(inst), None, None, None, None
        return self.engine.submit(self.tokenizer.encode(prompt), max_new,
                                  temperature=temp, top_p=tp, top_k=tk)

    def predict_batch(self, instances):
        assert self.engine is not None, "model not loaded"
        reqs = [self._submit(i) for i in instances]
        return [self.tokenizer.decode(r.wait(300.0)) for r in reqs]

    # -- OpenAI completions contract (huggingfaceserver parity) -----------

    def openai_stream(self, payload: dict):
        """``stream: true`` — yield OpenAI-style SSE chunks as tokens
        land.  The engine's Request accrues tokens per decode chunk, so
        streaming polls the growing token lists (ALL prompts of the
        request, one choice index each).  A delta is emitted only while
        the re-decoded text extends what was already sent — a decode
        boundary can change how the tail decodes (a split UTF-8
        multibyte char, BPE re-merges), and that tail must be HELD until
        it stabilizes, or chunk concatenation diverges from the full
        completion.
        """
        import json as jsonlib
        import time as timelib

        prompts = payload.get("prompt", "")
        if isinstance(prompts, str):
            prompts = [prompts]
        max_tokens = payload.get("max_tokens")
        temp = payload.get("temperature")
        tp, tk = payload.get("top_p"), payload.get("top_k")
        pr = self._priority(payload.get("priority"))
        # the door's request trace rides the FIRST engine request of
        # the fan-out (one trace = one lifecycle; sibling choices share
        # the HTTP-level phases, not the engine spans)
        trace = self._take_trace()
        n = max(1, int(payload.get("n", 1)))  # same fan-out as blocking
        reqs = [
            self.engine.submit(self.tokenizer.encode(str(p)), max_tokens,
                               temperature=temp, top_p=tp, top_k=tk,
                               priority=pr,
                               trace=(trace if i == 0 else None))
            for i, p in enumerate(
                [p for p in prompts for _ in range(n)])
        ]
        sent = [""] * len(reqs)
        finished = [False] * len(reqs)
        last_event = timelib.monotonic()
        model = payload.get("model", self.name)
        stops = self._stop_sequences(payload)
        scanners = ([_StopScanner(self.tokenizer, stops) for _ in reqs]
                    if stops else None)
        try:
            while not all(finished):
                progressed = False
                for i, req in enumerate(reqs):
                    if finished[i]:
                        continue
                    done = req.done.is_set()
                    ids = list(req.tokens)
                    cut = scanners[i].scan(ids) if scanners is not None \
                        else None
                    if scanners is not None and not done:
                        # mid-stream the scanner's text IS the decode —
                        # the stable incremental prefix (bytes) or the
                        # full decode scan() just computed (HF) — so no
                        # second O(len) decode per 20 ms poll (ADVICE
                        # r5); the final flush below still uses the
                        # authoritative full decode
                        full = scanners[i].text
                    else:
                        full = self.tokenizer.decode(ids)
                    if cut is not None:
                        # OpenAI ``stop`` while streaming: truncate at the
                        # earliest stop sequence and end this choice (its
                        # slot frees at the next chunk boundary).  Never
                        # truncate BEHIND already-sent text — a stop that
                        # straddled an emitted boundary can't be unsent,
                        # so the choice just ends where it stands.
                        full = full[:cut] if cut >= len(sent[i]) \
                            else sent[i]
                        done = True
                        req.cancel()
                    if done:
                        # final decode is authoritative; flush everything
                        delta = (full[len(sent[i]):]
                                 if full.startswith(sent[i]) else full)
                        finished[i] = True
                        if req.error is not None:
                            raise req.error
                    elif full.startswith(sent[i]):
                        delta = full[len(sent[i]):]
                    else:
                        continue  # tail not stable yet: hold
                    if delta:
                        sent[i] = sent[i] + delta if not done else full
                        progressed = True
                        last_event = timelib.monotonic()
                        yield ("data: " + jsonlib.dumps({
                            "object": "text_completion.chunk",
                            "model": model,
                            "choices": [{"index": i, "text": delta}],
                        }) + "\n\n").encode()
                if not all(finished) and not progressed:
                    if timelib.monotonic() - last_event > self.KEEPALIVE_S:
                        # a long chunked prefill produces no tokens for
                        # its whole admission — prove the stream alive
                        # (SSE comment; clients ignore it by spec)
                        last_event = timelib.monotonic()
                        yield b": keep-alive\n\n"
                    timelib.sleep(0.02)
            yield b"data: [DONE]\n\n"
        finally:
            # client hung up mid-stream (BrokenPipe -> GeneratorExit) or
            # a sibling prompt errored: stop spending decode slots on a
            # stream nobody is reading
            for req in reqs:
                if not req.done.is_set():
                    req.cancel()

    def openai_completions(self, payload: dict) -> dict:
        """``POST /openai/v1/completions`` body -> response (text
        completions; served by ModelServer for models providing this)."""
        prompts = payload.get("prompt", "")
        if isinstance(prompts, str):
            prompts = [prompts]
        max_tokens = payload.get("max_tokens")
        temp = payload.get("temperature")
        tp, tk = payload.get("top_p"), payload.get("top_k")
        pr = self._priority(payload.get("priority"))
        trace = self._take_trace()
        # OpenAI ``n``: independent samples per prompt — each is its own
        # engine request, coalescing in the slot pool like any burst;
        # the door's trace rides the first (one trace = one lifecycle)
        n = max(1, int(payload.get("n", 1)))
        reqs = [
            self.engine.submit(self.tokenizer.encode(str(p)), max_tokens,
                               temperature=temp, top_p=tp, top_k=tk,
                               priority=pr,
                               trace=(trace if i == 0 else None))
            for i, p in enumerate(
                [p for p in prompts for _ in range(n)])
        ]
        try:
            return self._collect_completions(payload, reqs)
        finally:
            # one prompt's wait() raising must not leave its siblings
            # decoding to nobody (same contract as the streaming path)
            for r in reqs:
                if not r.done.is_set():
                    r.cancel()

    @staticmethod
    def _stop_sequences(payload) -> list[str]:
        stop = payload.get("stop")
        if stop is None:
            return []
        return [stop] if isinstance(stop, str) else [str(x) for x in stop]

    def _apply_stop(self, text: str, stops: list[str]):
        """OpenAI ``stop``: truncate at the EARLIEST stop sequence (the
        sequence itself excluded).  Returns (text, hit)."""
        cut = None
        for ss in stops:
            if not ss:
                continue
            i = text.find(ss)
            if i >= 0 and (cut is None or i < cut):
                cut = i
        return (text if cut is None else text[:cut]), cut is not None

    # -- OpenAI chat completions ------------------------------------------

    def _chat_prompt(self, messages: list) -> str:
        """Messages -> one prompt string: the tokenizer's own chat
        template when it has one (HF tokenizers), else a transparent
        role-tagged transcript ending with the assistant cue."""
        tok = getattr(self.tokenizer, "_tok", None)
        if tok is not None and getattr(tok, "chat_template", None):
            return tok.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=True)
        lines = [
            f"{m.get('role', 'user')}: {m.get('content', '')}"
            for m in messages
        ]
        return "\n".join(lines) + "\nassistant:"

    def openai_chat(self, payload: dict) -> dict:
        """``POST /openai/v1/chat/completions`` — rendered through the
        chat template onto the same engine path as completions (stop, n,
        temperature/top_p/top_k all apply)."""
        comp = {**payload,
                "prompt": self._chat_prompt(payload.get("messages", []))}
        out = self.openai_completions(comp)
        return {
            "object": "chat.completion",
            "model": out["model"],
            "choices": [{
                "index": c["index"],
                "message": {"role": "assistant", "content": c["text"]},
                "finish_reason": c["finish_reason"],
            } for c in out["choices"]],
            "usage": out["usage"],
        }

    def openai_chat_stream(self, payload: dict):
        """``stream: true`` chat — completions chunks re-labeled as
        chat.completion.chunk deltas."""
        import json as jsonlib

        comp = {**payload,
                "prompt": self._chat_prompt(payload.get("messages", []))}
        for chunk in self.openai_stream(comp):
            if not chunk.startswith(b"data: {"):
                yield chunk
                continue
            d = jsonlib.loads(chunk[len(b"data: "):])
            yield ("data: " + jsonlib.dumps({
                "object": "chat.completion.chunk",
                "model": d["model"],
                "choices": [{
                    "index": c["index"],
                    "delta": {"content": c["text"]},
                } for c in d["choices"]],
            }) + "\n\n").encode()

    def _wait_with_stops(self, r, stops: list[str]) -> list[int]:
        """Wait for a request, but with stop sequences the wait POLLS and
        cancels at the first hit — a stop at token 3 must not hold a
        decode slot (or the client) for the remaining max_tokens.  The
        poll is incremental (:class:`_StopScanner`): each pass decodes
        and scans only the tokens that landed since the last one."""
        if not stops:
            return r.wait(300.0)
        import time as timelib

        scanner = _StopScanner(self.tokenizer, stops)
        deadline = timelib.monotonic() + 300.0
        while True:
            done = r.done.is_set()
            ids = list(r.tokens)
            if scanner.scan(ids) is not None:
                # retire at the EXACT token where the stop completed: a
                # burst of accepted speculative tokens may carry the
                # stop mid-burst, and the tokens after it are not part
                # of this completion
                r.cancel()
                return _ids_covering(self.tokenizer, ids,
                                     scanner.last_hit_end)
            if done:
                if r.error is not None:
                    raise r.error
                return ids
            if timelib.monotonic() > deadline:
                raise TimeoutError("generation did not complete in time")
            timelib.sleep(0.02)

    def _collect_completions(self, payload, reqs) -> dict:
        stops = self._stop_sequences(payload)
        choices = []
        completion_tokens = 0
        # each prompt appears n times in reqs (one per choice) but the
        # OpenAI contract counts it ONCE
        n = max(1, int(payload.get("n", 1)))
        prompt_tokens = sum(len(r.prompt) for r in reqs) // n
        for i, r in enumerate(reqs):
            ids = self._wait_with_stops(r, stops)
            completion_tokens += len(ids)  # TOKENS, not decoded chars
            text = self.tokenizer.decode(ids)
            text, stop_hit = self._apply_stop(text, stops)
            eos_hit = (self.engine.eos_id is not None and ids
                       and ids[-1] == self.engine.eos_id)
            choices.append({
                "index": i,
                "text": text,
                "finish_reason": (
                    "stop" if (stop_hit or eos_hit) else "length"),
            })
        return {
            "object": "text_completion",
            "model": payload.get("model", self.name),
            "choices": choices,
            "usage": {"prompt_tokens": prompt_tokens,
                      "completion_tokens": completion_tokens,
                      "total_tokens": prompt_tokens + completion_tokens},
        }
