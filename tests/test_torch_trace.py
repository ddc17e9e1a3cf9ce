"""Request tracing through the port's engine and server against the
reference's, on the same ``tiny()`` weights.

- The same completions go to a traced reference server and a traced port
  server (``"tracing": {"sample": 1.0}``); each request's phase names in
  ``/traces`` (``replica.door`` -> ``engine.queue`` -> ``engine.prefill``
  -> ``engine.decode``) and the names of its detail spans must be equal.
- ``/metrics``: the ``kft_trace_*`` names are equal, the scrape passes the
  reference's own exposition lint (``test_observability.prom_lint``), and
  every ``kft_engine_*`` family the reference exports is there, less the
  ones whose mechanism the port does not have (named below).
- A migration (``export_sequence`` -> ``import_sequence`` on a fresh
  handle) carries the trace: the importer continues the exporter's trace
  id under its root, in both packages, with equal phase names.

The port's warmup records an ``engine.warmup`` trace; the reference server
here runs without warmup, so only traces named ``request`` are compared.
"""

import json
import queue
import time

import pytest

from tests.test_observability import prom_lint
from tests.test_torch_text_server import (
    WAIT_S,
    get,
    post,
    register_both,
    start_server,
    tiny_weights,
)

TRACED = {"tracing": {"sample": 1.0, "ring": 64},
          "qos": {"default": {"rate": 1000}}}

#: reference engine families with no counterpart mechanism in the port:
#: XLA recompiles (the port counts CUDA-graph captures instead, as
#: ``graph_captures_*``), the AOT program-artifact cache (ROADMAP A12) and
#: the sharded pool's mesh (A7)
NOT_PORTED = ("jit_recompiles_total", "aot_", "mesh_")


@pytest.fixture(scope="module")
def traced():
    ref_key, port_key = register_both(tiny_weights(), "torch-trace")
    ref = start_server(False, ref_key, **TRACED)
    try:
        port = start_server(True, port_key, **TRACED)
    except BaseException:
        ref.stop()
        raise
    yield ref, port
    port.stop()
    ref.stop()


def _request_rows(srv) -> dict:
    return {r["trace_id"]: r for r in map(json.loads, get(
        srv.url + "/traces").splitlines()) if r["root"]["name"] == "request"}


def _new_row(srv, before: dict) -> dict:
    """The one request trace finished since ``before`` (finalization runs
    on the handler thread after the response is written)."""
    deadline = time.time() + 10
    while True:
        rows = _request_rows(srv)
        new = [r for k, r in rows.items() if k not in before]
        if new:
            assert len(new) == 1, new
            return new[0]
        assert time.time() < deadline, "no trace finished"
        time.sleep(0.02)


REQUESTS = {
    "completion": {"prompt": "hello world", "max_tokens": 8},
    "stream": {"prompt": "stream me", "max_tokens": 8, "stream": True},
    "long_prompt": {"prompt": "a prompt longer than one chunk of 16",
                    "max_tokens": 4},
}


@pytest.mark.parametrize("kind", list(REQUESTS))
def test_phase_sequence_matches_reference(traced, kind):
    rows = []
    for srv in traced:
        before = _request_rows(srv)
        code, _, _ = post(srv.url + "/openai/v1/completions",
                          {"model": "m", **REQUESTS[kind]})
        assert code == 200
        rows.append(_new_row(srv, before))
    want, got = ([p["name"] for p in r["phases"]] for r in rows)
    assert got == want
    assert got == ["replica.door", "engine.queue", "engine.prefill",
                   "engine.decode"]
    assert {s["name"] for s in rows[1]["spans"]} == \
        {s["name"] for s in rows[0]["spans"]}
    if not REQUESTS[kind].get("stream"):
        # the phases tile the request (a stream's root closes only after
        # the last 20 ms poll that finds the request done)
        total = sum(p["duration_s"] for p in rows[1]["phases"])
        assert abs(total - rows[1]["duration_s"]) <= \
            0.05 * rows[1]["duration_s"]
    fams = {s["attrs"]["family"] for s in rows[1]["spans"]
            if s["name"] == "dispatch"}
    assert fams <= {"paged_decode", "paged_fused"} and fams
    assert rows[1]["meta"]["model"] == "m"


def _families(text: str) -> set[str]:
    return {ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE ")}


def test_metrics_match_reference_and_lint_clean(traced):
    ref, port = traced
    for srv in traced:  # at least one traced request on each
        assert post(srv.url + "/openai/v1/completions",
                    {"model": "m", "prompt": "x", "max_tokens": 2})[0] == 200
    want, text = get(ref.url + "/metrics"), get(port.url + "/metrics")
    assert prom_lint(text) == [], prom_lint(text)[:5]
    have, ref_fams = _families(text), _families(want)
    trace_fams = {f for f in have if f.startswith("kft_trace_")}
    assert trace_fams == {f for f in ref_fams if f.startswith("kft_trace_")}
    assert trace_fams
    missing = sorted(
        f for f in ref_fams - have
        if not f.startswith("kft_engine_")
        or not f[len("kft_engine_"):].startswith(NOT_PORTED))
    assert missing == []
    for prefix in ("kft_engine_", "kft_traffic_", "kft_trace_"):
        assert any(f.startswith(prefix) for f in have), prefix
    assert "kft_phase_seconds" in have
    assert 'phase="engine.decode"' in text
    assert "trace_id" not in text  # exemplars only when negotiated
    om = get(port.url + "/metrics",
             headers={"Accept": "application/openmetrics-text"})
    assert "trace_id=" in om and om.endswith("# EOF\n")


def _migrate_traced(port: bool, weights) -> dict:
    """Freeze a traced request at the end of its prefill on a prefill-role
    engine, export it, import it on a second engine with a fresh handle
    and decode it there; returns what the trace shows."""
    if port:
        import torch

        from kubeflow_tpu_torch.models import convert, llama
        from kubeflow_tpu_torch.serving.continuous import ContinuousEngine
        from kubeflow_tpu_torch.serving.trace import Tracer

        torch.set_num_threads(1)
        cfg = llama.tiny()
        params = convert.state_dict_from_jax(weights[1], cfg)
        kw = {"device": "cpu"}
    else:
        from kubeflow_tpu.serving.continuous import ContinuousEngine
        from kubeflow_tpu.serving.trace import Tracer

        cfg, params = weights
        kw = {}
    kw.update(num_slots=2, decode_chunk=2, block_size=16, prefix_cache=False)
    tracer = Tracer(sample=1.0, ring=8)
    src = ContinuousEngine(cfg, params, role="prefill", **kw)
    dst = ContinuousEngine(cfg, params, **kw)
    frozen: "queue.Queue" = queue.Queue()
    src.on_prefilled = frozen.put
    dst.tracer = tracer
    try:
        tr = tracer.start(name="request")
        req = src.submit(list(range(1, 40)), max_new_tokens=6, trace=tr)
        assert frozen.get(timeout=WAIT_S) is req
        snap = src.export_sequence(req)
        assert snap["trace"] == {"id": tr.trace_id,
                                 "parent": tr.root.span_id}
        new = dst.import_sequence(snap)  # a fresh handle: adopts the trace
        src.release_sequence(req)
        tokens = new.wait(WAIT_S)
        tracer.finish(tr)
        tracer.reap()
        rows = tracer.sink.traces()
        adopted = [r for r in rows if r["trace_id"] == tr.trace_id
                   and r["root"]["parent_id"] == tr.root.span_id]
        assert len(adopted) == 1, rows
        exporter = [p.name for p in tr.phases]
        return {"tokens": tokens,
                "exporter_phases": exporter,
                "exporter_spans": sorted({s.name for s in tr.spans[1:]}),
                "importer_phases": [p["name"] for p in adopted[0]["phases"]]}
    finally:
        src.stop()
        dst.stop()


def test_migration_carries_the_trace():
    weights = tiny_weights()
    want, got = (_migrate_traced(p, weights) for p in (False, True))
    assert got == want
    assert got["exporter_phases"][-1] == "engine.handoff"
    assert "kv.export" in got["exporter_spans"]
    assert got["importer_phases"] == ["engine.decode"]
    assert len(got["tokens"]) == 6
