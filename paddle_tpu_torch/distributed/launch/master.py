"""HTTP KV master: the store the fleet planes share (the port's copy of
``KVServer`` and ``KVClient`` from ``paddle_tpu/distributed/launch/
master.py``, stdlib only).

One process runs ``KVServer``; every other talks to it through
``KVClient``: the serving directory (``serving/endpoint.py``), the KV
block pool (``serving/kvpool.py``) and the fleet telemetry transport
(``monitor/collector.py``) key their records under ``/{job}/...``. The
launcher's ``Master`` rendezvous is not ported (ROADMAP Queue 1, item 10's
rest: the port has no launcher yet).
"""
from __future__ import annotations

import json
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional


class KVServer:
    """Tiny in-memory KV over HTTP: PUT /k, GET /k, GET /prefix/ lists.
    ``port=0`` binds a free port; ``port`` / ``address`` then name it."""

    def __init__(self, port: int, host: str = "0.0.0.0"):
        store: Dict[str, bytes] = {}
        lock = threading.Lock()

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_PUT(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                with lock:
                    store[self.path] = body
                self.send_response(200)
                self.end_headers()

            def do_DELETE(self):
                with lock:
                    store.pop(self.path, None)
                self.send_response(200)
                self.end_headers()

            def do_GET(self):
                if self.path.endswith("/"):
                    with lock:
                        items = {k: v.decode() for k, v in store.items()
                                 if k.startswith(self.path)}
                    body = json.dumps(items).encode()
                    self.send_response(200)
                else:
                    with lock:
                        body = store.get(self.path)
                    if body is None:
                        self.send_response(404)
                        self.end_headers()
                        return
                    self.send_response(200)
                self.end_headers()
                self.wfile.write(body)

        self._srv = ThreadingHTTPServer((host, port), Handler)
        self.port = int(self._srv.server_address[1])
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)

    @property
    def address(self) -> str:
        """``127.0.0.1:<port>``: the endpoint a ``KVClient`` on this host
        dials."""
        return f"127.0.0.1:{self.port}"

    def start(self):
        self._thread.start()

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()


class KVClient:
    """HTTP client for KVServer. ``timeout`` is per-call: rendezvous can
    afford the lazy default, but the serving router polls this store on
    its health cadence and needs a short bound so one slow master never
    stalls placement (serving/endpoint.py passes ~1s)."""

    def __init__(self, endpoint: str, timeout: float = 5.0):
        self._base = f"http://{endpoint}"
        self._timeout = float(timeout)

    def put(self, key: str, value: str) -> bool:
        req = urllib.request.Request(f"{self._base}{key}", data=value.encode(),
                                     method="PUT")
        try:
            with urllib.request.urlopen(req, timeout=self._timeout) as r:
                return r.status == 200
        except OSError:
            return False

    def get(self, key: str) -> Optional[str]:
        try:
            with urllib.request.urlopen(f"{self._base}{key}",
                                        timeout=self._timeout) as r:
                return r.read().decode()
        except OSError:
            return None

    def delete(self, key: str) -> bool:
        req = urllib.request.Request(f"{self._base}{key}", method="DELETE")
        try:
            with urllib.request.urlopen(req, timeout=self._timeout) as r:
                return r.status == 200
        except OSError:
            return False

    def get_prefix(self, prefix: str) -> Dict[str, str]:
        try:
            with urllib.request.urlopen(f"{self._base}{prefix}",
                                        timeout=self._timeout) as r:
                return json.loads(r.read().decode())
        except OSError:
            return {}
