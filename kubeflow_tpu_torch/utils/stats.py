"""Shared score/percentile helpers for benches and the sim twin.

One module, one definition (ISSUE 20 satellite): the nearest-rank
quantile and the median/p90 summary dict were copy-pasted across
``recovery_bench.py``, ``gang_startup_bench.py``, ``serving_bench.py``
and ``trace_bench.py`` — the PR 16 ``_percentiles["p50"]`` KeyError
was exactly the drift bug local copies invite.  Every bench and the
twin's scenario scorer import from here now, so a quantile-convention
change is one edit and every score row moves together.

Everything here is pure and deterministic (no clock, no rng) — the
twin's byte-identical-score-per-seed contract depends on that.

The port's copy of ``kubeflow_tpu/utils/stats.py``, device-free like it,
with the same names; it imports nothing of the reference package.
"""

from __future__ import annotations

import statistics


def pct(xs, q: float) -> float:
    """Nearest-rank percentile (the ONE quantile the benches share —
    three local copies drifted toward divergence before r11); 0.0 on
    an empty sample."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def percentiles(samples: list[float], digits: int = 3) -> dict:
    """The bench summary-row shape: ``value`` (median), ``p90``,
    ``min``, ``max`` — rounded, stable key order.  Raises on an empty
    sample the same way the local copies did (callers guard)."""
    samples = sorted(samples)
    return {
        "value": round(statistics.median(samples), digits),
        "p90": round(samples[int(0.9 * (len(samples) - 1))], digits),
        "min": round(samples[0], digits),
        "max": round(samples[-1], digits),
    }


def round_floats(obj, digits: int = 6):
    """Recursively round every float in a JSON-shaped object — the
    twin's score rows pass through this before ``json.dumps`` so a
    score is byte-stable against float-repr noise."""
    if isinstance(obj, float):
        return round(obj, digits)
    if isinstance(obj, dict):
        return {k: round_floats(v, digits) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [round_floats(v, digits) for v in obj]
    return obj
