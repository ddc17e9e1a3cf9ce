"""The port's QoS door and priority preemption against the reference's, on
the same ``tiny()`` weights (mirrors ``test_traffic.py``).

- The door: the same request sequence through a reference server and a
  port server with one rate-limited class and one credentialed class gives
  the same statuses, ``Retry-After`` headers and shed bodies (429 for a
  tenant over its rate, 401 for a class claim without its token).
- Priority admission: on a one-slot engine busy with a long request, a
  later high-priority request admits before two earlier low-priority ones,
  in the same order on both engines.
- Preempt and requeue: a low-priority sequence fills the only slot, a
  high-priority one arrives, the ``EnginePreemptor`` evicts the low one,
  parks its snapshot and resumes it after the high one. Both requests'
  greedy tokens equal their uninterrupted runs and the reference's, the
  preemption counters are equal, and the port's block ledger finds no leak.
"""

import json
import time

import pytest

from tests.test_torch_text_server import (
    WAIT_S,
    post,
    register_both,
    start_server,
    tiny_weights,
)

LONG = list(range(1, 65))  # 64 tokens = 4 blocks at block_size 16
HIGH = [9, 8, 7]
#: the long requests' budget and context: long enough that the reference
#: engine (about 3 ms a token here) is still decoding when the high
#: request arrives and the preemptor acts
LOW_NEW = 400
MAX_SEQ = 512


@pytest.fixture(scope="module")
def weights():
    return tiny_weights()


def _engine(port: bool, weights, **kw):
    """An engine over ``weights`` at a ``MAX_SEQ`` context (tiny()'s
    weights do not depend on it)."""
    kw = {"num_slots": 4, "decode_chunk": 2, "prefix_cache": False,
          "block_size": 16, **kw}
    if port:
        import torch

        from kubeflow_tpu_torch.models import convert, llama
        from kubeflow_tpu_torch.serving.continuous import ContinuousEngine

        torch.set_num_threads(1)
        cfg = llama.tiny(max_seq_len=MAX_SEQ)
        return ContinuousEngine(
            cfg, convert.state_dict_from_jax(weights[1], cfg),
            device="cpu", **kw)
    import dataclasses

    from kubeflow_tpu.serving.continuous import ContinuousEngine

    cfg = dataclasses.replace(weights[0], max_seq_len=MAX_SEQ)
    return ContinuousEngine(cfg, weights[1], **kw)


def _plane(port: bool):
    if port:
        from kubeflow_tpu_torch.serving.traffic import TrafficPlane
    else:
        from kubeflow_tpu.serving.traffic import TrafficPlane
    return TrafficPlane({})


DOOR = {"qos": {"default": {"rate": 0.001, "burst": 1},
                "gold": {"priority": "high"}},
        "qos_tenant_tokens": {"gold": "tok"}, "qos_preempt": False}

#: (tenant, Authorization header or None), sent in this order
DOOR_SEQUENCE = [("t1", None), ("t1", None), ("gold", None),
                 ("gold", "Bearer tok"), ("gold", "Bearer nope")]


def test_door_decisions_match_reference(weights):
    ref_key, port_key = register_both(weights, "torch-traffic-door")
    outcomes = []
    for port, key in ((False, ref_key), (True, port_key)):
        srv = start_server(port, key, max_new_tokens=2, **DOOR)
        try:
            seen = []
            for tenant, auth in DOOR_SEQUENCE:
                code, headers, raw = post(
                    srv.url + "/openai/v1/completions",
                    {"model": "m", "prompt": "x", "max_tokens": 2,
                     "user": tenant},
                    headers={"Authorization": auth} if auth else None)
                body = json.loads(raw) if raw else {}
                if code == 200:
                    body = {"object": body["object"]}
                # the wait left moves with the clock: its presence and
                # sign are what the two doors must agree on
                retry = body.pop("retry_after", None)
                after = headers.get("Retry-After")
                seen.append((code, after is not None and int(after) >= 1,
                             retry is not None and retry > 0, body))
            outcomes.append(seen)
        finally:
            srv.stop()
    assert outcomes[1] == outcomes[0]
    codes = [o[0] for o in outcomes[1]]
    assert codes == [200, 429, 401, 200, 401]
    code, retry_after, positive, body = outcomes[1][1]
    assert retry_after and positive
    assert body["reason"] == "rate_limited"
    assert body["qos_class"] == "default"
    assert outcomes[1][2][3]["reason"] == "bad_tenant_credential"


def _admission_order(port: bool, weights) -> tuple[list[int], list]:
    """(admission ranks of [low, low, high], high's tokens) on a one-slot
    engine whose slot a long request holds while the three queue."""
    eng = _engine(port, weights, num_slots=1, decode_chunk=1)
    eng.warmup()
    try:
        hog = eng.submit(LONG, max_new_tokens=LOW_NEW, priority=1)
        deadline = time.time() + WAIT_S
        while not hog.tokens:
            assert time.time() < deadline, "the long request never started"
            time.sleep(0.002)
        lows = [eng.submit(LONG[:20], max_new_tokens=4, priority=2)
                for _ in range(2)]
        high = eng.submit(HIGH, max_new_tokens=4, priority=0)
        assert not hog.done.is_set(), "the long request ended too early"
        out = high.wait(WAIT_S)
        for r in [hog, *lows]:
            r.wait(WAIT_S)
        steps = [r.admitted_step for r in [*lows, high]]
        return [sorted(steps).index(s) for s in steps], out
    finally:
        eng.stop()


def test_priority_admission_order_matches_reference(weights):
    want, got = (_admission_order(p, weights) for p in (False, True))
    assert got == want
    assert got[0] == [1, 2, 0]  # high first, then the lows in FIFO order


#: admission shapes to warm: the 64-token prompt's bucket, and one whose
#: decode climbs every attend rung the long request reaches (the port
#: counts a rung's first capture after warmup; the reference compiles it
#: then without counting)
WARM = [(1, 64), (1, 256)]


def _preempt_scenario(port: bool, weights) -> dict:
    plain = _engine(port, weights)
    plain.warmup(WARM)
    try:
        alone = {"low": plain.generate(LONG, max_new_tokens=LOW_NEW),
                 "high": plain.generate(HIGH, max_new_tokens=8)}
    finally:
        plain.stop()
    nb = -(-(len(LONG) + LOW_NEW) // 16)
    eng = _engine(port, weights, num_slots=1, num_blocks=nb)
    ledger = None
    if port:
        from kubeflow_tpu_torch.analysis.runtime import BlockLedger

        ledger = BlockLedger()
        eng.attach_block_ledger(ledger)
    eng.warmup(WARM)
    plane = _plane(port)
    pre = plane.attach_engine(eng, preempt_after_s=0.01, poll_s=0.002)
    try:
        low = eng.submit(LONG, max_new_tokens=LOW_NEW, priority=2)
        deadline = time.time() + WAIT_S
        while len(low.tokens) < 4:
            assert time.time() < deadline, "victim never started"
            time.sleep(0.002)
        high = eng.submit(HIGH, max_new_tokens=8, priority=0)
        got = {"high": high.wait(WAIT_S), "low": low.wait(WAIT_S)}
        deadline = time.time() + 10
        while eng.stats()["kv_blocks_free"] != nb:
            assert time.time() < deadline, eng.stats()
            time.sleep(0.01)
        stats = plane.stats()
        out = {"tokens": got, "alone": alone,
               "counters": {k: stats[k] for k in (
                   "qos_preemptions_total", "qos_preempt_resumes_total",
                   "qos_preempted_parked")}}
        if port:
            out["leaks"] = (eng.audit_blocks(), ledger.leaked_total,
                            eng.stats()["graph_captures_total"])
        return out
    finally:
        plane.stop()
        eng.stop()


def test_preempt_and_requeue_matches_reference(weights):
    want = _preempt_scenario(False, weights)
    got = _preempt_scenario(True, weights)
    assert got.pop("leaks") == ([], 0, 0)
    assert got == want
    assert got["tokens"] == got["alone"]
    assert got["counters"] == {"qos_preemptions_total": 1,
                               "qos_preempt_resumes_total": 1,
                               "qos_preempted_parked": 0}
