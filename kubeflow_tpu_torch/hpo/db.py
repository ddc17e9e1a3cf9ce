"""Durable observation store — the katib-db-manager analog.

Katib persists observation logs in MySQL behind a gRPC facade
(``ReportObservationLog``/``GetObservationLog`` [upstream: kubeflow/katib ->
cmd/db-manager, pkg/db]) so trial history survives control-plane restarts.
Same shape here: a sqlite-backed store behind a real gRPC boundary (JSON
payloads over grpc's generic handler, matching kubeflow_tpu_torch.hpo.service's
convention since protoc stubs aren't available in this image).

Consumers:
- TrialController reports each completed trial's objective observation;
- SuggestionController folds stored observations into algorithm history;
- ExperimentController REPLAYS stored observations on restart: completed
  trials from a previous incarnation of the control plane are recreated as
  Succeeded Trial objects, so a resumed experiment keeps its full history
  and does not re-run finished work.

The port's copy of ``kubeflow_tpu/hpo/db.py``, device-free like it, with
the same names; it imports nothing of the reference package.
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
from concurrent import futures
from typing import Optional

import grpc

from ..utils.net import allocate_port

SERVICE = "kubeflow_tpu_torch.hpo.DbManager"
METHOD_REPORT = f"/{SERVICE}/ReportObservation"
METHOD_GET = f"/{SERVICE}/GetObservations"
METHOD_LOG = f"/{SERVICE}/GetObservationLog"


class ObservationDb:
    """sqlite-backed observation log (one row per completed trial)."""

    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._lock = threading.Lock()
        self._conn = sqlite3.connect(path, check_same_thread=False)
        with self._lock:
            self._conn.execute(
                """CREATE TABLE IF NOT EXISTS observations (
                    experiment TEXT NOT NULL,
                    namespace TEXT NOT NULL DEFAULT 'default',
                    trial TEXT NOT NULL,
                    assignments TEXT NOT NULL,
                    value REAL,
                    phase TEXT NOT NULL DEFAULT 'Succeeded',
                    step INTEGER NOT NULL DEFAULT -1,
                    ts REAL DEFAULT (strftime('%s', 'now')),
                    PRIMARY KEY (experiment, namespace, trial, step)
                )"""
            )
            # migrate pre-step-column DBs (PK was (exp, ns, trial)): the
            # PK can't be ALTERed, so rebuild — existing rows become the
            # final (step=-1) observations, which is exactly what they were
            cols = [r[1] for r in self._conn.execute(
                "PRAGMA table_info(observations)")]
            if "step" not in cols:
                self._conn.executescript(
                    """ALTER TABLE observations RENAME TO observations_v1;
                    CREATE TABLE observations (
                        experiment TEXT NOT NULL,
                        namespace TEXT NOT NULL DEFAULT 'default',
                        trial TEXT NOT NULL,
                        assignments TEXT NOT NULL,
                        value REAL,
                        phase TEXT NOT NULL DEFAULT 'Succeeded',
                        step INTEGER NOT NULL DEFAULT -1,
                        ts REAL DEFAULT (strftime('%s', 'now')),
                        PRIMARY KEY (experiment, namespace, trial, step)
                    );
                    INSERT INTO observations
                        (experiment, namespace, trial, assignments, value,
                         phase, step, ts)
                    SELECT experiment, namespace, trial, assignments, value,
                           phase, -1, ts FROM observations_v1;
                    DROP TABLE observations_v1;"""
                )
            self._conn.commit()

    def report(
        self,
        experiment: str,
        trial: str,
        assignments: dict,
        value: Optional[float],
        namespace: str = "default",
        phase: str = "Succeeded",
        step: int = -1,
    ) -> None:
        """``step = -1`` is the FINAL observation (what suggesters replay);
        ``step >= 0`` rows are the per-step metric log behind the
        experiment-curves view (Katib's ReportObservationLog keeps the
        full timestamped series the same way)."""
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO observations "
                "(experiment, namespace, trial, assignments, value, phase, step) "
                "VALUES (?, ?, ?, ?, ?, ?, ?)",
                (experiment, namespace, trial, json.dumps(assignments), value,
                 phase, step),
            )
            self._conn.commit()

    def observations(self, experiment: str, namespace: str = "default") -> list[dict]:
        """Final observation per trial (the replay surface): the step=-1
        row, or the latest step if only per-step rows exist."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT trial, assignments, value, phase, step FROM observations "
                "WHERE experiment = ? AND namespace = ? ORDER BY trial, step",
                (experiment, namespace),
            ).fetchall()
        final: dict[str, dict] = {}
        for t, a, v, ph, step in rows:
            prev = final.get(t)
            # -1 sorts first but wins; otherwise the max step wins
            if prev is None or prev["_step"] != -1:
                final[t] = {
                    "trial": t, "assignments": json.loads(a),
                    "value": v, "phase": ph, "_step": step,
                }
        return [
            {k: v for k, v in rec.items() if k != "_step"}
            for rec in final.values()
        ]

    def report_series(
        self,
        experiment: str,
        trial: str,
        assignments: dict,
        series: list[tuple[int, float]],
        namespace: str = "default",
        phase: str = "Succeeded",
    ) -> None:
        """Whole per-step metric series in ONE transaction (a row per step
        via the reconcile path would stall the workqueue on long runs)."""
        with self._lock:
            self._conn.executemany(
                "INSERT OR REPLACE INTO observations "
                "(experiment, namespace, trial, assignments, value, phase, step) "
                "VALUES (?, ?, ?, ?, ?, ?, ?)",
                [
                    (experiment, namespace, trial, json.dumps(assignments),
                     value, phase, step)
                    for step, value in series
                ],
            )
            self._conn.commit()

    def observation_log(
        self, experiment: str, namespace: str = "default"
    ) -> list[dict]:
        """EVERY observation row incl. per-step metrics, step-ordered per
        trial (the experiment-curves surface)."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT trial, assignments, value, phase, step FROM observations "
                "WHERE experiment = ? AND namespace = ? ORDER BY trial, step",
                (experiment, namespace),
            ).fetchall()
        return [
            {
                "trial": t,
                "assignments": json.loads(a),
                "value": v,
                "phase": ph,
                "step": step,
            }
            for t, a, v, ph, step in rows
        ]

    def close(self) -> None:
        with self._lock:
            self._conn.close()


def _serialize(payload: dict) -> bytes:
    return json.dumps(payload).encode()


def _deserialize(data: bytes) -> dict:
    return json.loads(data.decode())


class _Handler(grpc.GenericRpcHandler):
    def __init__(self, db: ObservationDb) -> None:
        self._db = db
        self._methods = {
            METHOD_REPORT: grpc.unary_unary_rpc_method_handler(
                self._report,
                request_deserializer=_deserialize,
                response_serializer=_serialize,
            ),
            METHOD_GET: grpc.unary_unary_rpc_method_handler(
                self._get,
                request_deserializer=_deserialize,
                response_serializer=_serialize,
            ),
            METHOD_LOG: grpc.unary_unary_rpc_method_handler(
                self._log,
                request_deserializer=_deserialize,
                response_serializer=_serialize,
            ),
        }

    def service(self, handler_call_details):
        return self._methods.get(handler_call_details.method)

    def _report(self, request: dict, context) -> dict:
        try:
            if "series" in request:
                # batched per-step log: one RPC, one transaction
                self._db.report_series(
                    experiment=request["experiment"],
                    trial=request["trial"],
                    assignments=request.get("assignments", {}),
                    series=[
                        (int(s), float(v)) for s, v in request["series"]],
                    namespace=request.get("namespace", "default"),
                    phase=request.get("phase", "Succeeded"),
                )
                return {"ok": True}
            self._db.report(
                experiment=request["experiment"],
                trial=request["trial"],
                assignments=request.get("assignments", {}),
                value=request.get("value"),
                namespace=request.get("namespace", "default"),
                phase=request.get("phase", "Succeeded"),
                step=int(request.get("step", -1)),
            )
            return {"ok": True}
        except Exception as e:  # noqa: BLE001 — surface as RPC error
            context.abort(grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}")

    def _get(self, request: dict, context) -> dict:
        try:
            obs = self._db.observations(
                request["experiment"], request.get("namespace", "default"))
            return {"observations": obs}
        except Exception as e:  # noqa: BLE001 — surface as RPC error
            context.abort(grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}")

    def _log(self, request: dict, context) -> dict:
        try:
            return {
                "observations": self._db.observation_log(
                    request["experiment"],
                    namespace=request.get("namespace", "default"),
                )
            }
        except Exception as e:  # noqa: BLE001 — surface as RPC error
            context.abort(grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}")


class DbManagerServer:
    """The katib-db-manager deployment analog: one per control plane."""

    def __init__(self, db_path: str, port: Optional[int] = None):
        self.db = ObservationDb(db_path)
        self.port = port or allocate_port()
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
        self._server.add_generic_rpc_handlers((_Handler(self.db),))
        self._server.add_insecure_port(f"127.0.0.1:{self.port}")

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.port}"

    def start(self) -> "DbManagerServer":
        self._server.start()
        return self

    def stop(self) -> None:
        self._server.stop(grace=1.0)
        self.db.close()


class DbManagerClient:
    def __init__(self, address: str):
        self._channel = grpc.insecure_channel(address)
        self._report = self._channel.unary_unary(
            METHOD_REPORT, request_serializer=_serialize,
            response_deserializer=_deserialize)
        self._get = self._channel.unary_unary(
            METHOD_GET, request_serializer=_serialize,
            response_deserializer=_deserialize)
        self._getlog = self._channel.unary_unary(
            METHOD_LOG, request_serializer=_serialize,
            response_deserializer=_deserialize)

    def report_observation(
        self,
        experiment: str,
        trial: str,
        assignments: dict,
        value: Optional[float],
        namespace: str = "default",
        phase: str = "Succeeded",
        step: int = -1,
        timeout: float = 10.0,
    ) -> None:
        self._report(
            {
                "experiment": experiment,
                "namespace": namespace,
                "trial": trial,
                "assignments": assignments,
                "value": value,
                "phase": phase,
                "step": step,
            },
            timeout=timeout,
        )

    def report_observation_series(
        self,
        experiment: str,
        trial: str,
        assignments: dict,
        series: list[tuple[int, float]],
        namespace: str = "default",
        timeout: float = 30.0,
    ) -> None:
        """Whole per-step metric curve in one RPC."""
        self._report(
            {
                "experiment": experiment,
                "namespace": namespace,
                "trial": trial,
                "assignments": assignments,
                "series": list(series),
            },
            timeout=timeout,
        )

    def get_observations(
        self, experiment: str, namespace: str = "default", timeout: float = 10.0
    ) -> list[dict]:
        return self._get(
            {"experiment": experiment, "namespace": namespace}, timeout=timeout
        )["observations"]

    def get_observation_log(
        self, experiment: str, namespace: str = "default", timeout: float = 10.0
    ) -> list[dict]:
        """Every observation incl. per-step rows (experiment curves)."""
        return self._getlog(
            {"experiment": experiment, "namespace": namespace}, timeout=timeout
        )["observations"]

    def close(self) -> None:
        self._channel.close()
