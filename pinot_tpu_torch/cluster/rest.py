"""HTTP query endpoint: the broker REST surface.

Reference parity: Pinot's broker query REST (POST /query/sql handled by
BaseSingleStageBrokerRequestHandler) + cursor endpoints + /health and
/metrics (JSON, or Prometheus text with ?format=prometheus) and the
/debug/queries slow-query surface.  Re-design: stdlib http.server on a daemon thread serving an
in-process QueryEngine or cluster Broker — the data plane stays in-process
(SURVEY.md §2.6); this surface exists for clients/tools parity.

Port of pinot_tpu/cluster/rest.py (host only): the same endpoints, payloads
and error mapping, checked against the port's exception classes.  What the
engine answers runs on its own device (a Broker's servers, a QueryEngine's
device); each request runs on a handler thread of its own, so the engine
under it must take concurrent calls (the Broker and QueryEngine do).  No
torch value reaches json.dumps: _jsonable unwraps 0-d tensors as it unwraps
numpy scalars, and cursor pages go through it too.

Response shape follows BrokerResponse: {"resultTable": {"dataSchema":
{"columnNames": [...]}, "rows": [...]}, "numDocsScanned": ..., ...}.
"""
from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np
import torch

from pinot_tpu_torch.query.cursors import ResponseStore
from pinot_tpu_torch.query.result import ResultTable
from pinot_tpu_torch.utils.metrics import METRICS


def _jsonable(v):
    if isinstance(v, np.generic) or (isinstance(v, torch.Tensor) and v.dim() == 0):
        v = v.item()
    if isinstance(v, float) and (v != v or v in (float("inf"), float("-inf"))):
        return None
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, (tuple, list)):
        return [_jsonable(x) for x in v]
    return v


def broker_response(result: ResultTable) -> Dict[str, Any]:
    s = result.stats
    return {
        "resultTable": {
            "dataSchema": {"columnNames": list(result.columns)},
            "rows": [[_jsonable(v) for v in row] for row in result.rows],
        },
        "numRowsResultSet": len(result.rows),
        "numDocsScanned": s.num_docs_scanned,
        "numSegmentsQueried": s.num_segments_queried,
        "numSegmentsPruned": s.num_segments_pruned,
        "numSegmentsProcessed": s.num_segments_processed,
        "totalDocs": s.total_docs,
        "timeUsedMs": round(s.time_ms, 3),
        "requestId": s.query_id,
        "trace": s.trace,
        # fault surface (BrokerResponse partialResult / processingExceptions)
        "partialResult": bool(s.partial_result),
        "exceptions": list(s.exceptions),
        "numServersQueried": s.num_servers_queried,
        "numServersResponded": s.num_servers_responded,
    }


class QueryServer:
    """Serves one engine-like object (anything with .sql or .query)."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0):
        self.engine = engine
        self.cursors = ResponseStore()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def _send(self, code: int, payload: Dict[str, Any]) -> None:
                body = json.dumps(payload).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_text(self, code: int, text: str, content_type: str) -> None:
                body = text.encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    url = urllib.parse.urlsplit(self.path)
                    qs = urllib.parse.parse_qs(url.query)
                    if url.path == "/health":
                        self._send(200, {"status": "OK"})
                    elif url.path == "/metrics":
                        # a broker engine federates its servers' registries
                        # into one labeled cluster exposition; plain engines
                        # fall back to this process's registry
                        fed = getattr(outer.engine, "federated_prometheus", None)
                        if qs.get("format", [""])[0] == "prometheus":
                            self._send_text(
                                200,
                                fed() if fed is not None else METRICS.to_prometheus(),
                                "text/plain; version=0.0.4; charset=utf-8",
                            )
                        else:
                            snap = METRICS.snapshot()
                            fed_json = getattr(outer.engine, "federated_snapshot", None)
                            if fed_json is not None:
                                snap["servers"] = fed_json()
                            self._send(200, snap)
                    elif url.path == "/debug/queries":
                        slow = getattr(outer.engine, "slow_queries", None)
                        if slow is None:
                            self._send(404, {"error": "engine has no slow-query log"})
                            return
                        limit = int(qs.get("limit", ["0"])[0]) or None
                        self._send(200, {"queries": slow.snapshot(limit)})
                    elif url.path == "/debug/admission":
                        gov = getattr(outer.engine, "governor", None)
                        if gov is None:
                            self._send(404, {"error": "engine has no resource governor"})
                            return
                        self._send(200, gov.snapshot())
                    elif url.path == "/debug/perf":
                        # per-table/per-shape perf ledger (utils/perf.py):
                        # rolling rows/s, bytes/s, roofline %, compile ms,
                        # plan-cache outcomes, QPS — the `cli perf` source
                        snap_fn = getattr(outer.engine, "perf_snapshot", None)
                        if snap_fn is not None:
                            self._send(200, snap_fn())
                        else:
                            from pinot_tpu_torch.utils.perf import PERF_LEDGER

                            self._send(200, PERF_LEDGER.snapshot())
                    elif url.path == "/debug/autopilot":
                        # SLO autopilot view: knob values vs clamp bounds,
                        # last N controller decisions with triggering signal,
                        # per-table SLO state (cluster/autopilot.py)
                        snap_fn = getattr(outer.engine, "autopilot_snapshot", None)
                        if snap_fn is None:
                            self._send(404, {"error": "engine has no autopilot view"})
                            return
                        self._send(200, snap_fn())
                    elif url.path == "/debug/election":
                        # coordinator HA view: current leader + per-candidate
                        # lease/epoch/role state (cluster/election.py)
                        snap_fn = getattr(outer.engine, "election_snapshot", None)
                        if snap_fn is None:
                            self._send(404, {"error": "engine has no election view"})
                            return
                        self._send(200, snap_fn())
                    elif url.path.startswith("/cursors/"):
                        parts = url.path.strip("/").split("/")
                        cid = parts[1]
                        page = int(parts[2]) if len(parts) > 2 else 0
                        page_payload = outer.cursors.fetch(cid, page)
                        page_payload["rows"] = [[_jsonable(v) for v in row] for row in page_payload["rows"]]
                        self._send(200, page_payload)
                    else:
                        self._send(404, {"error": f"unknown path {self.path}"})
                except KeyError as e:
                    self._send(404, {"error": str(e)})
                except Exception as e:  # noqa: BLE001 - boundary
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    if self.path not in ("/query/sql", "/query"):
                        self._send(404, {"error": f"unknown path {self.path}"})
                        return
                    sql = req.get("sql", "")
                    run = getattr(outer.engine, "sql", None) or outer.engine.query
                    result = run(sql)
                    payload = broker_response(result)
                    if req.get("useCursor"):
                        cid = outer.cursors.register(result, int(req.get("pageSize", 1000)))
                        payload["cursorId"] = cid
                        payload["resultTable"]["rows"] = payload["resultTable"]["rows"][
                            : int(req.get("pageSize", 1000))
                        ]
                    self._send(200, payload)
                except Exception as e:  # noqa: BLE001 - boundary
                    from pinot_tpu_torch.analysis.plan_check import PlanCheckError
                    from pinot_tpu_torch.cluster.admission import (
                        QueryKilledError,
                        ReservationError,
                        TooManyRequestsError,
                    )
                    from pinot_tpu_torch.cluster.broker import (
                        NoReplicaAvailableError,
                        QuotaExceededError,
                        ScatterGatherError,
                    )
                    from pinot_tpu_torch.cluster.election import NotLeaderError
                    from pinot_tpu_torch.query.safety import AdmissionError, QueryTimeoutError

                    if isinstance(e, NotLeaderError):
                        # control-plane leadership moved and the bounded
                        # failover park expired: retryable 503 — the standby
                        # finishes taking over and the next attempt serves
                        self._send(503, {"error": str(e), "errorCode": "NOT_LEADER"})
                    elif isinstance(e, QuotaExceededError):
                        # the reference's 429 QUERY_QUOTA_EXCEEDED contract:
                        # throttled clients must be able to back off
                        self._send(429, {"error": str(e), "errorCode": "QUERY_QUOTA_EXCEEDED"})
                    elif isinstance(e, TooManyRequestsError):
                        # admission shed: over the cost-rate budget, rejected
                        # up front with the minted query id for correlation
                        self._send(
                            429,
                            {
                                "error": str(e),
                                "errorCode": "TOO_MANY_REQUESTS_ERROR",
                                "requestId": e.query_id,
                            },
                        )
                    elif isinstance(e, QueryKilledError):
                        # watchdog killed it mid-flight and the query did not
                        # allow partial results: retryable 503 with the reason
                        self._send(
                            503,
                            {
                                "error": str(e),
                                "errorCode": "QUERY_KILLED",
                                "requestId": e.query_id,
                                "reason": e.reason,
                            },
                        )
                    elif isinstance(e, ReservationError):
                        # HBM/host reservation refused: the tier is at
                        # capacity RIGHT NOW — retryable as queries drain.
                        # Checked before the AdmissionError base class below.
                        self._send(
                            503,
                            {
                                "error": str(e),
                                "errorCode": "SERVER_OUT_OF_CAPACITY",
                                "requestId": e.query_id,
                            },
                        )
                    elif isinstance(e, QueryTimeoutError):
                        # deadline blew anywhere in the scatter: 408, the
                        # reference's EXECUTION_TIMEOUT_ERROR contract
                        self._send(408, {"error": str(e), "errorCode": "EXECUTION_TIMEOUT_ERROR"})
                    elif isinstance(e, AdmissionError):
                        # resource admission refused up-front: retryable 503
                        self._send(
                            503,
                            {"error": str(e), "errorCode": "SERVER_RESOURCE_LIMIT_EXCEEDED"},
                        )
                    elif isinstance(e, ScatterGatherError):
                        # every replica of some segment failed and the query
                        # did not allow partial results
                        self._send(
                            500,
                            {
                                "error": str(e),
                                "errorCode": "SERVER_SCATTER_ERROR",
                                "exceptions": e.exceptions,
                            },
                        )
                    elif isinstance(e, NoReplicaAvailableError):
                        # a segment lost every live replica: retryable 503
                        # (capacity may come back), distinct from scatter
                        # failures so clients can tell "down" from "flaky"
                        self._send(503, {"error": str(e), "errorCode": "NO_REPLICA_AVAILABLE"})
                    elif isinstance(e, PlanCheckError):
                        # statically-rejected plan: a 400 with the machine
                        # code, never a tracer traceback (analysis/plan_check)
                        self._send(400, e.to_dict())
                    else:
                        self._send(500, {"error": f"{type(e).__name__}: {e}"})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "QueryServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


class PinotClient:
    """Minimal python client over the REST surface (pinot-java-client /
    pinotdb analog)."""

    def __init__(self, url: str):
        self.url = url.rstrip("/")

    def execute(self, sql: str, **kw) -> Dict[str, Any]:
        import urllib.request

        body = json.dumps({"sql": sql, **kw}).encode("utf-8")
        req = urllib.request.Request(
            self.url + "/query/sql", data=body, headers={"Content-Type": "application/json"}
        )
        with urllib.request.urlopen(req) as resp:
            return json.loads(resp.read().decode("utf-8"))

    def fetch_cursor(self, cursor_id: str, page: int) -> Dict[str, Any]:
        import urllib.request

        with urllib.request.urlopen(f"{self.url}/cursors/{cursor_id}/{page}") as resp:
            return json.loads(resp.read().decode("utf-8"))
