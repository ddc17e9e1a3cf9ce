"""In-pod notebook server: the workbench process a Notebook pod runs.

[upstream: kubeflow/kubeflow notebook images run Jupyter; the controller
only cares that *some* HTTP server sits behind the Service].  This is the
minimal native workbench: a persistent-namespace code executor over HTTP —
``POST /execute {"code": ...}`` evaluates in a kernel namespace that
survives across requests (the kernel semantics notebooks need), ``GET /``
reports liveness.  Each request stamps an activity heartbeat into the
pod's status dir, which is the culling signal's source of truth.

Security note: /execute runs arbitrary code *by design* — a notebook IS a
user-code execution service, isolated at the pod boundary exactly like a
Jupyter kernel is upstream.

The port's copy of ``kubeflow_tpu/ux/notebook_server.py``, device-free
like it, with the same names; it imports nothing of the reference
package. It listens with ``BurstHTTPServer``, as every HTTP server of
the port does.
"""

from __future__ import annotations

import io
import json
import os
import time
from contextlib import redirect_stdout
from http.server import BaseHTTPRequestHandler

from ..utils.net import BurstHTTPServer

ENV_NOTEBOOK_PORT = "KFT_NOTEBOOK_PORT"
ACTIVITY_FILE = "activity"


def main(ctx) -> None:
    port = int(os.environ.get(ENV_NOTEBOOK_PORT, "0"))
    kernel_ns: dict = {"__name__": "__kft_notebook__"}
    status_dir = getattr(ctx, "status_dir", None) or os.environ.get(
        "KFT_STATUS_DIR")

    def touch_activity() -> None:
        if status_dir:
            try:
                with open(os.path.join(status_dir, ACTIVITY_FILE), "w") as f:
                    f.write(str(time.time()))
            except OSError:
                pass

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            touch_activity()
            self._send(200, {"notebook": getattr(ctx, "job_name", "notebook"),
                             "alive": True})

        def do_POST(self):
            touch_activity()
            if self.path != "/execute":
                self._send(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                code = json.loads(self.rfile.read(length))["code"]
                out = io.StringIO()
                with redirect_stdout(out):
                    try:
                        result = eval(  # noqa: S307 — the product IS a kernel
                            compile(code, "<cell>", "eval"), kernel_ns)
                    except SyntaxError:
                        exec(compile(code, "<cell>", "exec"), kernel_ns)  # noqa: S102
                        result = None
                self._send(200, {"result": repr(result) if result is not None else None,
                                 "stdout": out.getvalue()})
            except Exception as e:  # noqa: BLE001 — surfaced as 400
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

    httpd = BurstHTTPServer(("127.0.0.1", port), Handler)
    # publish the bound port so tests/operators can find a 0-port server
    if status_dir:
        try:
            with open(os.path.join(status_dir, "notebook_port"), "w") as f:
                f.write(str(httpd.server_address[1]))
        except OSError:
            pass
    touch_activity()
    httpd.serve_forever()
