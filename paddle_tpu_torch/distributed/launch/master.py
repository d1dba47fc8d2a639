"""HTTP rendezvous master and node agent for multi-node elastic
membership (after ``paddle_tpu/distributed/launch/master.py``; upstream
``launch/controllers/master.py`` ``HTTPMaster`` / ``ETCDMaster`` and
``fleet/elastic/manager.py`` ``ElasticManager``).

Upstream tracks worker liveness in etcd leases; here, as in the reference
package, the master is a small threaded HTTP/JSON service with the same
semantics:

* nodes POST /register with their endpoint; once ``min_nodes`` are present
  the membership snapshot is frozen into an **epoch**: sorted endpoints,
  node ranks, world size;
* nodes POST /heartbeat on an interval; a node silent for ``ttl`` seconds is
  dropped, the epoch bumps, and ranks are reassigned over the survivors
  (scale-in). A node joining later also bumps the epoch (scale-out);
* agents watch the epoch; on change they stop the local world and relaunch
  with the new assignment, resuming from checkpoints (the reference's
  documented recovery model — no in-memory state migration).

**Single-instance semantics (a divergence from upstream's ETCDMaster):**
etcd replicates membership across a quorum; this master is ONE process. If
it dies, agents keep running their current world (heartbeats fail
transiently and are retried), but no scale events can happen until a master
is back. With ``state_path`` set, the master journals its membership epoch
and node table to disk on every change and REHYDRATES from that file on
construction: a restarted master resumes epoch numbering monotonically
(agents would mis-read a reset epoch counter as "no change") and re-admits
the previous nodes, which must confirm liveness via heartbeat within
``ttl`` or be reaped exactly like a scale-in. Run the master under a
supervisor (systemd/k8s) for availability; quorum replication is out of
scope by design.
"""
from __future__ import annotations

import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

__all__ = ["ElasticMaster", "NodeAgent"]


class ElasticMaster:
    """Threaded rendezvous/membership service."""

    def __init__(self, port: int = 0, min_nodes: int = 1,
                 max_nodes: Optional[int] = None, ttl: float = 10.0,
                 state_path: Optional[str] = None):
        self.min_nodes = min_nodes
        self.max_nodes = max_nodes or max(min_nodes, 1 << 20)
        self.ttl = ttl
        self.state_path = state_path
        self._mu = threading.Lock()
        self._nodes: Dict[str, dict] = {}  # node_id -> {endpoint, last_seen}
        self._epoch = 0
        self._assignment: Dict[str, int] = {}
        self._world: List[str] = []
        if state_path:
            self._rehydrate()

        master = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/register":
                    self._json(200, master._register(req))
                elif self.path == "/heartbeat":
                    self._json(200, master._heartbeat(req))
                else:
                    self._json(404, {"error": "unknown"})

            def do_GET(self):
                if self.path == "/world":
                    self._json(200, master._snapshot())
                else:
                    self._json(404, {"error": "unknown"})

        self._server = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        self.port = self._server.server_address[1]
        self._threads = [
            threading.Thread(target=self._server.serve_forever, daemon=True),
            threading.Thread(target=self._reaper, daemon=True),
        ]
        self._stop = threading.Event()

    # ------------------------------------------------------------ lifecycle
    def start(self):
        for t in self._threads:
            t.start()
        return self

    def shutdown(self):
        self._stop.set()
        self._server.shutdown()

    # ------------------------------------------------------------- handlers
    def _reassign_locked(self):
        """Freeze membership into a new epoch (sorted by endpoint for
        determinism); journal it when persistence is on."""
        eps = sorted((i["endpoint"], nid) for nid, i in self._nodes.items())
        self._world = [e for e, _ in eps]
        self._assignment = {nid: r for r, (_, nid) in enumerate(eps)}
        self._epoch += 1
        if self.state_path:
            self._persist_locked()

    def _persist_locked(self):
        """Write epoch + node table atomically (tmp + rename)."""
        import os

        state = {"epoch": self._epoch,
                 "nodes": {nid: i["endpoint"]
                           for nid, i in self._nodes.items()}}
        tmp = f"{self.state_path}.tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, self.state_path)

    def _rehydrate(self):
        """Resume from a journaled epoch after a master restart: epoch
        numbering stays monotonic and previous members are re-admitted
        with a fresh lease — they either confirm via heartbeat within
        ``ttl`` or get reaped like an ordinary scale-in."""
        import os

        if not os.path.exists(self.state_path):
            return
        try:
            with open(self.state_path) as f:
                state = json.load(f)
        except (OSError, ValueError):
            return  # corrupt/partial journal: start fresh
        self._epoch = int(state.get("epoch", 0))
        now = time.monotonic()
        for nid, endpoint in state.get("nodes", {}).items():
            self._nodes[nid] = {"endpoint": endpoint, "last_seen": now}
        if self._nodes:
            eps = sorted((i["endpoint"], nid)
                         for nid, i in self._nodes.items())
            self._world = [e for e, _ in eps]
            self._assignment = {nid: r for r, (_, nid) in enumerate(eps)}

    def _register(self, req):
        nid, endpoint = req["node_id"], req["endpoint"]
        with self._mu:
            if (nid not in self._nodes
                    and len(self._nodes) >= self.max_nodes):
                return {"accepted": False, "reason": "world full"}
            known = nid in self._nodes
            self._nodes[nid] = {"endpoint": endpoint,
                                "last_seen": time.monotonic()}
            if not known:
                self._reassign_locked()
            return {"accepted": True, **self._snapshot_locked(nid)}

    def _heartbeat(self, req):
        nid = req.get("node_id")
        with self._mu:
            if nid in self._nodes:
                self._nodes[nid]["last_seen"] = time.monotonic()
                return self._snapshot_locked(nid)
            return {"known": False, "epoch": self._epoch}

    def _snapshot_locked(self, nid=None):
        return {
            "known": True,
            "epoch": self._epoch,
            "ready": len(self._nodes) >= self.min_nodes,
            "world": list(self._world),
            "nnodes": len(self._nodes),
            "rank": self._assignment.get(nid),
        }

    def _snapshot(self):
        with self._mu:
            return self._snapshot_locked()

    def _reaper(self):
        while not self._stop.wait(min(self.ttl / 4, 1.0)):
            now = time.monotonic()
            with self._mu:
                dead = [nid for nid, i in self._nodes.items()
                        if now - i["last_seen"] > self.ttl]
                if dead:
                    for nid in dead:
                        del self._nodes[nid]
                    self._reassign_locked()


class NodeAgent:
    """Per-node membership client: register, heartbeat, watch the epoch.

    ``on_world(rank, world, epoch)`` style usage:

        agent = NodeAgent(url, node_id, endpoint).start()
        rank, world, epoch = agent.wait_ready()
        ... launch local workers ...
        if agent.epoch_changed(epoch): restart from checkpoint
    """

    def __init__(self, master_url: str, node_id: str, endpoint: str,
                 heartbeat_interval: float = 2.0):
        self.url = master_url.rstrip("/")
        self.node_id = node_id
        self.endpoint = endpoint
        self.interval = heartbeat_interval
        self._state = {"epoch": 0, "ready": False, "world": [], "rank": None}
        self._mu = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _call(self, path, payload=None):
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(
            self.url + path, data=data,
            headers={"Content-Type": "application/json"},
            method="POST" if data is not None else "GET")
        with urllib.request.urlopen(req, timeout=10) as r:
            return json.loads(r.read())

    def start(self):
        resp = self._call("/register", {"node_id": self.node_id,
                                        "endpoint": self.endpoint})
        if not resp.get("accepted"):
            raise RuntimeError(f"master rejected node: {resp}")
        with self._mu:
            self._state = resp
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                resp = self._call("/heartbeat", {"node_id": self.node_id})
            except Exception:
                continue  # transient master outage; keep trying
            if not resp.get("known"):
                # master dropped us (lease expiry during a stall) — re-register
                try:
                    resp = self._call("/register",
                                      {"node_id": self.node_id,
                                       "endpoint": self.endpoint})
                except Exception:
                    continue
            with self._mu:
                self._state = resp

    # ------------------------------------------------------------ queries
    def state(self):
        with self._mu:
            return dict(self._state)

    def wait_ready(self, timeout: float = 120.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            s = self.state()
            if s.get("ready"):
                return s["rank"], list(s["world"]), s["epoch"]
            time.sleep(0.2)
        raise TimeoutError("elastic master never became ready")

    def epoch_changed(self, epoch: int) -> bool:
        return self.state().get("epoch", epoch) != epoch
