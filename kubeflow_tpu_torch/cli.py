"""kft — the kubectl-style CLI over the REST API server.

The reference's whole UX runs through kubectl verbs against CRDs (every
SURVEY §3 call stack starts at ``kubectl apply``); this is that surface
for the TPU platform, talking HTTP to ``controlplane/apiserver.py``:

    kft --server URL apply -f job.yaml      # create-or-update (multi-doc)
    kft get jaxjobs [-n ns] [-o yaml|json]
    kft get isvc my-svc
    kft describe jaxjob demo                # object + events
    kft delete trial demo-t0001
    kft logs demo-worker-0
    kft api-resources

The server URL comes from ``--server`` or ``$KFT_SERVER`` (a cluster
started with ``Cluster.serve_api()`` prints it).

The port's copy of ``kubeflow_tpu/cli.py``, device-free like it, with
the same names; it imports nothing of the reference package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.error
import urllib.request
from typing import Any, Optional

import yaml


class CliError(RuntimeError):
    """API error carrying the server's structured ``reason`` (and, for
    watch-cursor expiry, the server's resync ``cursor``) — callers branch
    on ``reason``, never on message text."""

    def __init__(self, msg: str, reason: str = "", cursor: Optional[int] = None):
        super().__init__(msg)
        self.reason = reason
        self.cursor = cursor


#: bearer token attached to every request (set by main() from --token /
#: $KFT_TOKEN; the apiserver's single-admin-credential authn)
_TOKEN: Optional[str] = None


def _request(method: str, url: str, body: Optional[dict] = None) -> Any:
    data = json.dumps(body).encode() if body is not None else None
    headers = {"Content-Type": "application/json"}
    if _TOKEN:
        headers["Authorization"] = f"Bearer {_TOKEN}"
    req = urllib.request.Request(
        url, data=data, method=method, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            raw = resp.read()
            ctype = resp.headers.get("Content-Type", "")
            return raw.decode() if "text/plain" in ctype else json.loads(raw)
    except urllib.error.HTTPError as e:
        reason, cursor = "", None
        try:
            payload = json.loads(e.read())
            msg = payload.get("error", str(e))
            reason = payload.get("reason", "")
            cursor = payload.get("cursor")
        except Exception:  # noqa: BLE001 — unparseable error body:
            # fall back to the raw HTTPError text
            msg = str(e)
        raise CliError(f"{method} {url}: {msg}", reason=reason,
                       cursor=cursor) from None
    except OSError as e:
        raise CliError(f"cannot reach API server at {url}: {e}") from None


def _phase_of(obj: dict) -> str:
    st = obj.get("status", {}) or {}
    if st.get("phase"):
        return str(st["phase"])
    conds = st.get("conditions") or []
    return str(conds[-1].get("type", "")) if conds else ""


def _age(obj: dict) -> str:
    ts = (obj.get("metadata", {}) or {}).get("creationTimestamp") or (
        obj.get("metadata", {}) or {}).get("creation_timestamp")
    if not ts:
        return ""
    try:
        s = int(time.time() - float(ts))
    except (TypeError, ValueError):
        return ""
    if s < 120:
        return f"{s}s"
    if s < 7200:
        return f"{s // 60}m"
    return f"{s // 3600}h"


def cmd_apply(server: str, args) -> int:
    with (sys.stdin if args.filename == "-" else open(args.filename)) as f:
        docs = [d for d in yaml.safe_load_all(f.read()) if d]
    for doc in docs:
        kind = doc.get("kind")
        if not kind:
            raise CliError("manifest document has no 'kind'")
        name = (doc.get("metadata") or {}).get("name", "?")
        ns = (doc.get("metadata") or {}).get("namespace", "default")
        try:
            _request("POST", f"{server}/apis/{kind}", doc)
            print(f"{kind.lower()}/{name} created")
        except CliError as e:
            # branch on the server's structured reason: a 422 admission
            # rejection whose MESSAGE contains "exists" must surface
            # as-is, not trigger a confusing GET+PUT
            if e.reason != "AlreadyExists":
                raise
            # create-or-update: refresh spec onto the live object (kubectl
            # apply semantics, optimistic concurrency handled by re-read)
            cur = _request("GET", f"{server}/apis/{kind}/{ns}/{name}")
            cur["spec"] = doc.get("spec", cur.get("spec"))
            _request("PUT", f"{server}/apis/{kind}/{ns}/{name}", cur)
            print(f"{kind.lower()}/{name} configured")
    return 0


def cmd_get(server: str, args) -> int:
    if getattr(args, "watch", False):
        return _watch_loop(server, args)
    if args.name:
        obj = _request(
            "GET", f"{server}/apis/{args.kind}/{args.namespace}/{args.name}")
        items = [obj]
    else:
        url = f"{server}/apis/{args.kind}"
        if args.namespace != "_all":
            url += f"?namespace={args.namespace}"
        items = _request("GET", url)["items"]
    if args.output == "json":
        print(json.dumps(items if not args.name else items[0], indent=1))
        return 0
    if args.output == "yaml":
        print(yaml.safe_dump_all(items, sort_keys=False), end="")
        return 0
    rows = [("NAMESPACE", "NAME", "PHASE", "AGE")]
    for o in items:
        md = o.get("metadata", {}) or {}
        rows.append((md.get("namespace", ""), md.get("name", ""),
                     _phase_of(o), _age(o)))
    widths = [max(len(r[i]) for r in rows) for i in range(4)]
    for r in rows:
        print("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())
    return 0


def _watch_loop(server: str, args) -> int:
    """kubectl get -w: stream events for a kind until --watch-seconds
    elapses, resuming between long-polls with the server's cursor (no
    events are lost between polls)."""
    deadline = time.time() + args.watch_seconds
    cursor = 0
    while time.time() < deadline:
        poll = max(1.0, min(30.0, deadline - time.time()))
        try:
            out = _request(
                "GET",
                f"{server}/apis/{args.kind}?watch=true&timeout={poll}"
                f"&cursor={cursor}&namespace={args.namespace}"
                if args.namespace != "_all"
                else f"{server}/apis/{args.kind}?watch=true&timeout={poll}"
                     f"&cursor={cursor}",
            )
        except CliError as e:
            if e.reason != "Expired" or e.cursor is None:
                raise
            # 410 Gone: the buffer rolled past our cursor — announce the
            # gap and resync to the server's current cursor (the kubectl
            # relist-and-rewatch analog)
            print(f"WATCH-RESYNC\t(events lost; resuming at {e.cursor})",
                  flush=True)
            cursor = e.cursor
            continue
        cursor = out["cursor"]
        for ev in out["items"]:
            md = ev["object"].get("metadata", {}) or {}
            print(f"{ev['type']}	{md.get('namespace', '')}/"
                  f"{md.get('name', '')}	{_phase_of(ev['object'])}",
                  flush=True)
    return 0


def cmd_describe(server: str, args) -> int:
    obj = _request(
        "GET", f"{server}/apis/{args.kind}/{args.namespace}/{args.name}")
    print(yaml.safe_dump(obj, sort_keys=False), end="")
    events = _request(
        "GET",
        f"{server}/apis/{args.kind}/{args.namespace}/{args.name}/events",
    )["items"]
    print("Events:")
    if not events:
        print("  <none>")
    for e in events:
        print(f"  {e.get('type', '')}\t{e.get('reason', '')}\t"
              f"{e.get('message', '')}")
    return 0


def cmd_delete(server: str, args) -> int:
    _request(
        "DELETE", f"{server}/apis/{args.kind}/{args.namespace}/{args.name}")
    print(f"{args.kind.lower()}/{args.name} deleted")
    return 0


def cmd_logs(server: str, args) -> int:
    out = _request(
        "GET", f"{server}/apis/Pod/{args.namespace}/{args.name}/logs")
    print(out, end="" if str(out).endswith("\n") else "\n")
    return 0


def cmd_api_resources(server: str, args) -> int:
    for kind in _request("GET", f"{server}/apis")["kinds"]:
        print(kind)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kft", description="kubectl-style CLI for the TPU platform")
    p.add_argument("--server", default=os.environ.get("KFT_SERVER"),
                   help="API server URL (or $KFT_SERVER)")
    p.add_argument("--token", default=os.environ.get("KFT_TOKEN"),
                   help="bearer token for a token-protected API server "
                        "(or $KFT_TOKEN)")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("apply", help="create or update from a manifest")
    sp.add_argument("-f", "--filename", required=True)
    sp.set_defaults(fn=cmd_apply)

    for verb, fn in (("get", cmd_get),):
        sp = sub.add_parser(verb)
        sp.add_argument("kind")
        sp.add_argument("name", nargs="?")
        sp.add_argument("-n", "--namespace", default="default")
        sp.add_argument("-A", "--all-namespaces", dest="namespace",
                        action="store_const", const="_all")
        sp.add_argument("-o", "--output", choices=("table", "yaml", "json"),
                        default="table")
        sp.add_argument("-w", "--watch", action="store_true",
                        help="stream events for this kind")
        sp.add_argument("--watch-seconds", type=float, default=30.0)
        sp.set_defaults(fn=fn)

    for verb, fn in (("describe", cmd_describe), ("delete", cmd_delete)):
        sp = sub.add_parser(verb)
        sp.add_argument("kind")
        sp.add_argument("name")
        sp.add_argument("-n", "--namespace", default="default")
        sp.set_defaults(fn=fn)

    sp = sub.add_parser("logs", help="pod stdout/stderr")
    sp.add_argument("name")
    sp.add_argument("-n", "--namespace", default="default")
    sp.set_defaults(fn=cmd_logs)

    sp = sub.add_parser("api-resources", help="list served kinds")
    sp.set_defaults(fn=cmd_api_resources)
    return p


def main(argv: Optional[list[str]] = None) -> int:
    global _TOKEN
    args = build_parser().parse_args(argv)
    _TOKEN = args.token
    if not args.server:
        print("kft: no API server (--server or $KFT_SERVER)", file=sys.stderr)
        return 2
    try:
        return args.fn(args.server.rstrip("/"), args)
    except CliError as e:
        print(f"kft: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
