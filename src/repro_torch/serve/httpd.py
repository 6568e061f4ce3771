"""A thin stdlib HTTP surface over the ``Frontend``.

Counterpart of ``repro.serve.httpd``: four JSON routes over
``http.server``.  Query and status traffic is answered in the handler
threads (pure host reads); decompose and update traffic goes through
``Frontend.submit``, so the single worker thread, not the HTTP threads,
moves the graph to the device and runs the engine there (a handler
builds the request's graph in host memory).

  POST /decompose  {"n", "edges", "r", "s", "method", "hierarchy",
                    "artifact"?}        -> artifact summary + plan
  POST /query      {"artifact", "kind": "cut"|"nuclei", "c"}
  POST /update     {"artifact", "insert"?: [[u,v]..], "delete"?: ..}
  GET  /status                          -> serve.status schema

Typed rejections map to HTTP codes as in the reference: over-budget
admission is 413, queue backpressure 429, unknown artifacts 404, malformed
bodies 400.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..core.streaming import GraphDelta
from ..graph.container import make_graph
from .frontend import AdmissionError, Frontend, QueueFullError
from .router import Request
from .status import status_report, validate_status


def _decompose_summary(dec) -> Dict[str, Any]:
    kmax = int(dec.core.max()) if dec.n_r else 0
    return {"artifact": dec.name, "version": dec.version,
            "n_r": dec.n_r, "kmax": kmax, "rounds": dec.rounds,
            "plan": None if dec.plan is None else dec.plan.to_dict()}


class _Handler(BaseHTTPRequestHandler):
    frontend: Frontend  # injected by NucleusHTTPServer
    request_timeout_s: float

    # no per-request stderr log (the status endpoint is the observability
    # surface)
    def log_message(self, fmt, *args):  # noqa: A002
        pass

    def _send(self, code: int, payload: Dict[str, Any]) -> None:
        blob = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(blob)))
        self.end_headers()
        self.wfile.write(blob)

    def _body(self) -> Dict[str, Any]:
        length = int(self.headers.get("Content-Length", 0))
        if length == 0:
            return {}
        return json.loads(self.rfile.read(length))

    def do_GET(self) -> None:  # noqa: N802
        if self.path.rstrip("/") in ("", "/status"):
            self._send(200, validate_status(status_report(self.frontend)))
        else:
            self._send(404, {"error": f"unknown route {self.path!r}"})

    def do_POST(self) -> None:  # noqa: N802
        try:
            body = self._body()
        except (ValueError, json.JSONDecodeError) as e:
            self._send(400, {"error": f"malformed JSON body: {e}"})
            return
        try:
            if self.path == "/decompose":
                self._decompose(body)
            elif self.path == "/query":
                self._query(body)
            elif self.path == "/update":
                self._update(body)
            else:
                self._send(404, {"error": f"unknown route {self.path!r}"})
        except AdmissionError as e:
            self._send(413, {"error": str(e), "plan_bytes": e.plan_bytes,
                             "budget_bytes": e.budget_bytes})
        except QueueFullError as e:
            self._send(429, {"error": str(e)})
        except KeyError as e:
            self._send(404, {"error": str(e.args[0]) if e.args else str(e)})
        except (ValueError, TypeError) as e:
            self._send(400, {"error": str(e)})

    def _decompose(self, body: Dict[str, Any]) -> None:
        # missing fields are a malformed body (400), not a missing resource
        for field in ("n", "edges"):
            if field not in body:
                raise ValueError(f"decompose body requires {field!r}")
        # host memory: the worker moves it to the router's device
        graph = make_graph(int(body["n"]),
                           np.asarray(body["edges"], np.int64),
                           device="cpu")
        req = Request(graph=graph,
                      r=int(body.get("r", 2)), s=int(body.get("s", 3)),
                      method=str(body.get("method", "exact")),
                      hierarchy=str(body.get("hierarchy", "fused")),
                      backend=str(body.get("backend", "dense")),
                      delta=float(body.get("delta", 0.1)),
                      artifact=str(body.get("artifact", "")))
        dec = self.frontend.submit(req).result(self.request_timeout_s)
        self._send(200, _decompose_summary(dec))

    def _query(self, body: Dict[str, Any]) -> None:
        for field in ("artifact", "c"):
            if field not in body:
                raise ValueError(f"query body requires {field!r}")
        name, kind = str(body["artifact"]), str(body.get("kind", "cut"))
        c = int(body["c"])
        out = self.frontend.query(name, kind, c)
        dec = self.frontend.router.artifact(name)
        if kind == "cut":
            payload: Dict[str, Any] = {"cut": np.asarray(out).tolist()}
        else:
            payload = {"nuclei": {
                str(lab): {"vertices": nuc.vertices.tolist(),
                           "n_r_cliques": nuc.n_r_cliques,
                           "density": None if np.isnan(nuc.density)
                           else float(nuc.density)}
                for lab, nuc in out.items()}}
        payload.update({"artifact": name, "version": dec.version, "c": c})
        self._send(200, payload)

    def _update(self, body: Dict[str, Any]) -> None:
        if "artifact" not in body:
            raise ValueError("update body requires 'artifact'")
        delta = GraphDelta(
            insert=np.asarray(body.get("insert", []),
                              np.int64).reshape(-1, 2),
            delete=np.asarray(body.get("delete", []),
                              np.int64).reshape(-1, 2))
        req = Request(artifact=str(body["artifact"]), update=delta)
        dec = self.frontend.submit(req).result(self.request_timeout_s)
        self._send(200, _decompose_summary(dec))


class NucleusHTTPServer:
    """Own a ``ThreadingHTTPServer`` bound to a ``Frontend``.

    ``start()`` binds (port 0 = ephemeral) and serves in a daemon thread;
    ``stop()`` shuts both the HTTP loop and the frontend worker down.  The
    handler class is built per instance so two servers in one process
    never share a frontend."""

    def __init__(self, frontend: Frontend, host: str = "127.0.0.1",
                 port: int = 0, request_timeout_s: float = 300.0):
        self.frontend = frontend
        self._handler = type("BoundHandler", (_Handler,),
                             {"frontend": frontend,
                              "request_timeout_s": request_timeout_s})
        self._httpd = ThreadingHTTPServer((host, port), self._handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self._httpd.server_address[:2]

    def start(self) -> Tuple[str, int]:
        self.frontend.start()
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="nucleus-httpd")
        self._thread.start()
        return self.address

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
        self.frontend.stop()
