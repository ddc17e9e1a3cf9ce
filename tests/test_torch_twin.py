"""The port's digital twin (``kubeflow_tpu_torch.sim``, which drives the port's
``Router``, ``TrafficPlane`` and ``ClusterAutoscaler``) against the
reference's: the same scenario and seed must score byte-identical JSON rows,
and ``tests/test_twin.py``'s recorded-signal replay must give the same
decision stream in both packages, either package's signals replayed through
either package's autoscaler.

Both packages are imported inside the tests (the sim is stdlib-only in both).
"""

import pytest

#: (scenario, run_scenario kwargs): the short catalog rows
SCENARIOS = [
    ("smoke", {"seed": 0}),
    ("smoke", {"seed": 3}),
    ("diurnal", {"seed": 1, "replicas": 3}),
    ("noisy_neighbor", {"seed": 0}),
    ("cold_start_storm", {"seed": 0}),
    ("domain_outage", {"seed": 7, "replicas": 20}),
    ("chaos_fleet", {"seed": 1}),
]


def _sims():
    from kubeflow_tpu import sim as ref
    from kubeflow_tpu_torch import sim as port

    return ref, port


@pytest.mark.parametrize("name,kw", SCENARIOS,
                         ids=[f"{n}-{'-'.join(map(str, k.values()))}"
                              for n, k in SCENARIOS])
def test_score_json_byte_identical(name, kw):
    ref, port = _sims()
    want = ref.score_json(ref.run_scenario(name, **kw))
    got = port.score_json(port.run_scenario(name, **kw))
    assert got == want
    assert port.run_scenario.__module__.startswith("kubeflow_tpu_torch.")


def _record(pkg):
    from importlib import import_module

    scenarios = import_module(f"{pkg}.sim.scenarios")
    signals: list = []
    decisions: list = []
    score = scenarios.scenario_diurnal(seed=0, replicas=4,
                                       record_signals=signals,
                                       record_decisions=decisions)
    assert score["actuator_failures_total"] == 0
    return signals, decisions


def _replay(pkg, signals):
    """The recorded (t, signals) stream through a fresh autoscaler of
    ``pkg`` with no-op actuators (real callables: a missing channel skips
    the cooldown arming)."""
    from importlib import import_module

    autoscale = import_module(f"{pkg}.serving.autoscale")
    traces = import_module(f"{pkg}.sim.traces")
    stream = [dict(sig) for _t, sig in signals]
    replay = autoscale.ClusterAutoscaler(
        traces.diurnal_policy(),
        sensors=lambda: stream.pop(0),
        actuators={"replica_up": lambda dec: None,
                   "replica_down": lambda dec: None,
                   "zero": lambda dec: None})
    return [(round(t, 6), dec.action, dec.reason)
            for t, _ in signals for dec in [replay.tick(now=t)]]


def test_recorded_signal_replay_matches_reference():
    ref_signals, ref_decisions = _record("kubeflow_tpu")
    signals, decisions = _record("kubeflow_tpu_torch")
    assert decisions and signals
    assert signals == ref_signals
    assert decisions == ref_decisions
    # either package's signals through either package's autoscaler
    assert _replay("kubeflow_tpu_torch", signals) == decisions
    assert _replay("kubeflow_tpu_torch", ref_signals) == ref_decisions
    assert _replay("kubeflow_tpu", signals) == decisions
