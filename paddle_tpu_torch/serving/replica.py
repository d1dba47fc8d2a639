"""Supervised engine replicas for the multi-replica serving layer, after
``paddle_tpu/serving/replica.py``.

A *replica* is one serving engine behind a uniform lifecycle and stream
surface that :mod:`router <paddle_tpu_torch.serving.router>` supervises:

* :class:`InProcReplica`: an ``Engine`` + ``ServingFrontend`` pair in this
  process, built by a caller's factory so that a restart gets a FRESH
  engine and page pool. Liveness is the front end's engine thread; sudden
  death is ``ServingFrontend.poison()`` (the thread vanishes without
  finishing its tickets, as a killed process's streams go silent). A
  restart shuts the dead incarnation's host KV tier down and collects it
  before the factory builds the next, so device memory comes back. The KV
  handoff passes the payload's host tensors in-process, with no JSON.
  Over a sharded engine (tp/ep > 1) the replica lives on rank 0, and each
  other rank of its group runs :func:`follow_replica` with the same
  factory, beside the follower's ``Engine.run()`` / ``serve_forever()``
  for a lone engine: it follows each incarnation's commands and builds
  the next one when rank 0 restarts the replica, until rank 0 stops it.
  A replica rides one parallel axis: at tp > 1 and ep > 1 both sides
  refuse it with ``TypeError``.
* :class:`SubprocessReplica`: a worker process speaking the
  :class:`~paddle_tpu_torch.serving.server.ApiServer` protocol (for example
  ``examples/serve_llama_paged_torch.py --api-port 0``). Liveness is the
  process being up; readiness is its ``/readyz``; streams ride SSE on a
  reader thread a stream; ``kill()`` is a real SIGKILL; the KV handoff
  goes over ``POST /v1/kv`` in the JSON codec below.

The health surface both implement:

* **liveness** (``alive``): the process or thread exists. Only a dead
  replica gets restarted.
* **readiness** (``ready()``): fit for NEW traffic (not draining, the
  engine watchdog below its degradation threshold, queue depth in
  bounds). The payload's ``quarantined`` field is the one unreadiness
  worse than death: the engine's integrity audit proved its weights
  corrupt, so the router fences the replica (kill) and migrates its
  in-flight streams too.
* **heartbeat** (``heartbeat(plan)``): the supervisor's periodic probe; the
  ``heartbeat-drop`` fault point (keyed by replica index through the
  plan's ``rid`` selector) reports failure while the replica stays up.

Stream callbacks run on replica-owned threads (the engine thread or an SSE
reader); the router's handlers do their own locking. Nothing here is
``async``: blocking I/O runs on threads of its own, never an event loop.

The KV handoff payload (``CacheCoordinator.export_handoff``) carries, per
page, one row per pool buffer. To cross ``POST /v1/kv`` as JSON each row
becomes a ``{dtype, shape, b64}`` triple; digests, checksums and tokens
are JSON already. The reference resolves a bf16 row's dtype through
``ml_dtypes``, which the port does not use: here a bf16 row travels as its
raw 2-byte words under the dtype name ``"bfloat16"`` (the reference's own
name for it, so either side reads the other's JSON) and decodes to a torch
bf16 view of them. Decoded rows are torch tensors on the host.
"""
from __future__ import annotations

import base64
import http.client
import json
import signal
import subprocess
import threading
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["Replica", "InProcReplica", "SubprocessReplica",
           "StreamSpec", "ReplicaStream", "follow_replica",
           "encode_kv_payload", "decode_kv_payload"]


def _encode_row(a) -> Dict:
    if isinstance(a, torch.Tensor):
        a = a.detach().contiguous().cpu()
        name = str(a.dtype).replace("torch.", "")
        raw = (a.view(torch.int16) if a.dtype == torch.bfloat16 else a)
        data, shape = raw.numpy().tobytes(), list(a.shape)
    else:
        a = np.ascontiguousarray(a)
        name, data, shape = str(a.dtype), a.tobytes(), list(a.shape)
    return {"dtype": name, "shape": shape,
            "b64": base64.b64encode(data).decode("ascii")}


def _decode_row(d: Dict) -> torch.Tensor:
    # a writable buffer, which torch.from_numpy wants
    raw = bytearray(base64.b64decode(d["b64"]))
    if d["dtype"] == "bfloat16":
        words = np.frombuffer(raw, dtype=np.int16).reshape(d["shape"])
        return torch.from_numpy(words).view(torch.bfloat16)
    return torch.from_numpy(
        np.frombuffer(raw, dtype=np.dtype(d["dtype"])).reshape(d["shape"]))


def encode_kv_payload(payload: Dict) -> Dict:
    """JSON-encode a KV handoff payload: each page row (a host tensor or a
    numpy array) becomes ``{dtype, shape, b64}``."""
    out = dict(payload)
    out["pages"] = [[_encode_row(a) for a in rows]
                    for rows in payload["pages"]]
    return out


def decode_kv_payload(obj: Dict) -> Dict:
    """Inverse of :func:`encode_kv_payload`: rows come back as host
    tensors (bf16 from its raw words)."""
    out = dict(obj)
    out["pages"] = [[_decode_row(d) for d in rows] for rows in obj["pages"]]
    return out


class StreamSpec:
    """The replica-agnostic description of one stream: everything needed to
    (re)submit it anywhere, the resume-from-emitted state included."""

    __slots__ = ("prompt", "max_new_tokens", "temperature", "seed",
                 "tenant", "deadline_s", "resume_tokens", "trace",
                 "t_origin")

    def __init__(self, prompt: Sequence[int], max_new_tokens: int,
                 temperature: float = 0.0, seed: Optional[int] = None,
                 tenant: Optional[str] = None,
                 deadline_s: Optional[float] = None,
                 resume_tokens: Optional[List[int]] = None,
                 trace: Optional[str] = None,
                 t_origin: Optional[float] = None):
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.seed = seed
        self.tenant = tenant
        self.deadline_s = deadline_s
        self.resume_tokens = list(resume_tokens) if resume_tokens else None
        # the parent span context (wire string) and the ORIGINAL submit
        # time (perf_counter, this process only): both survive a
        # migration, so the resumed stream joins the same trace and its
        # TTFT counts from the first submission
        self.trace = trace
        self.t_origin = t_origin


class ReplicaStream:
    """One in-flight stream on one replica. The router owns the callbacks;
    ``cancel()`` tears the upstream down without firing ``on_broken`` (a
    cancelled stream is not a crashed one)."""

    def __init__(self, replica: "Replica", spec: StreamSpec,
                 on_chunk: Callable, on_done: Callable,
                 on_broken: Callable):
        self.replica = replica
        self.spec = spec
        self.on_chunk = on_chunk      # (stream, list[int])
        self.on_done = on_done        # (stream, failure_reason | None)
        self.on_broken = on_broken    # (stream, exc)
        self.cancelled = False
        self.closed = False
        self._impl = None  # the replica's own handle

    def cancel(self):
        self.cancelled = True
        self.replica._cancel(self)


class Replica:
    """The lifecycle and stream surface; see the module docstring."""

    def __init__(self, name: str, index: int = 0):
        self.name = name
        self.index = int(index)
        self.restarts = 0
        self._streams: set = set()
        self._lock = threading.Lock()

    # ------------------------------------------------------------ health
    def alive(self) -> bool:
        raise NotImplementedError

    def ready(self) -> Dict:
        raise NotImplementedError

    def heartbeat(self, plan=None) -> bool:
        """Supervisor probe: False means "treat me as dead". The
        ``heartbeat-drop`` fault point (``rid`` = replica index) forces a
        drop without killing anything: the router migrates anyway, and
        the resumed streams must stay bit-identical."""
        if plan is not None and plan.fire("heartbeat-drop",
                                          rid=self.index):
            return False
        return self._probe()

    def _probe(self) -> bool:
        return self.alive()

    @property
    def inflight(self) -> int:
        with self._lock:
            return len(self._streams)

    def _track(self, stream: ReplicaStream):
        with self._lock:
            self._streams.add(stream)

    def _untrack(self, stream: ReplicaStream):
        stream.closed = True
        with self._lock:
            self._streams.discard(stream)

    def streams(self) -> List[ReplicaStream]:
        with self._lock:
            return list(self._streams)

    # --------------------------------------------------------- lifecycle
    def start(self):
        raise NotImplementedError

    def kill(self):
        """Sudden death (the chaos surface): no drain, no goodbyes."""
        raise NotImplementedError

    def stop(self):
        """Graceful teardown."""
        raise NotImplementedError

    def restart(self):
        """Replace the dead replica with a fresh one (the supervisor's
        recovery arm, counted by the router's restart metric)."""
        raise NotImplementedError

    # ----------------------------------------------------------- streams
    def prepare(self, spec: StreamSpec, on_chunk, on_done,
                on_broken) -> ReplicaStream:
        """Phase 1: build the stream handle WITHOUT starting any flow, so
        the caller can attach it to a ticket before the first chunk can
        arrive. :meth:`launch` starts the flow."""
        stream = ReplicaStream(self, spec, on_chunk, on_done, on_broken)
        self._track(stream)
        return stream

    def launch(self, stream: ReplicaStream):
        raise NotImplementedError

    def submit(self, spec: StreamSpec, on_chunk, on_done,
               on_broken) -> ReplicaStream:
        """prepare + launch in one call (a single consumer's convenience;
        the router uses the two-phase form)."""
        stream = self.prepare(spec, on_chunk, on_done, on_broken)
        self.launch(stream)
        return stream

    def _cancel(self, stream: ReplicaStream):
        raise NotImplementedError

    # ------------------------------------------------ cluster handoff
    # The default is "this replica does not speak the handoff protocol":
    # export yields nothing and import adopts nothing, so a cluster that
    # pairs an older replica degrades to resume-from-emitted recompute.
    def export_kv(self, tokens: Sequence[int]) -> Optional[Dict]:
        """``tokens``' cached KV pages as a handoff payload (the prefill
        side); None when unsupported or nothing is cached."""
        return None

    def import_kv(self, payload: Dict) -> int:
        """Adopt a shipped payload into this replica's pool (the decode
        side); returns the pages adopted (0: the caller recomputes)."""
        return 0


# the word rank 0 sends a sharded replica's followers once an engine has
# stopped: build the next incarnation, or leave
_NEXT, _DONE = 1, 0


def _sharded_runner(frontend):
    """The runner of ``frontend``'s engine when it is sharded (tp/ep > 1),
    else None."""
    runner = getattr(getattr(frontend, "engine", None), "runner", None)
    return runner if runner is not None and runner.sharded else None


def _refusal(runner) -> Optional[str]:
    """Why an :class:`InProcReplica` cannot ride ``runner``'s sharded
    engine, or None. Every rank decides it alike, from the layout."""
    if runner is None or runner.tp == 1 or runner.ep == 1:
        return None
    return (f"InProcReplica over an engine at tp={runner.tp} x "
            f"ep={runner.ep}: its tp and ep groups (the ranks of one ep or "
            "one tp index) are the process's own, one a rank set "
            "(torch.distributed names such a group by its ranks), so two "
            "replicas over the same ranks would share them and mix their "
            "collectives; serve replicas at tp or ep alone, whose one axis "
            "rides the group the factory passes")


def _replica_word(runner, word: int = 0) -> int:
    """One word over the engine's group, after its last command: rank 0
    sends ``word``, a follower returns what rank 0 sent."""
    from ..distributed.collective import broadcast

    t = torch.tensor([int(word)], dtype=torch.int64,
                     device=runner.channel.dev)
    broadcast(t, runner.channel.src, group=runner.group)
    return int(t.item())


def follow_replica(factory: Callable) -> int:
    """A follower rank's side of an :class:`InProcReplica` over a sharded
    engine (tp/ep > 1): build the engine from ``factory`` (the same factory
    as rank 0's: a ``ServingFrontend``, which is not started here, or an
    ``Engine``), run rank 0's commands on this rank's shard until rank 0
    stops that engine, then build the next incarnation for a restart, until
    rank 0 stops the replica (:meth:`InProcReplica.stop`). Returns the
    engines followed. A follower whose own command raised raises
    ``ShardedEngineError``; one that rank 0 stopped on a fault waits for
    the restart. Run one such loop a replica (a thread each, when one
    process follows several replicas over groups of their own)."""
    from ..inference.runner import ShardedEngineError, collect_garbage

    n = 0
    while True:
        built = factory()
        runner = getattr(built, "engine", built).runner
        n += 1
        try:
            runner.follow()
        except ShardedEngineError as e:
            if not e.leader_stopped:
                raise
        word = _replica_word(runner)
        why = _refusal(runner)
        if why is not None:
            raise TypeError(why)
        if word != _NEXT:
            return n
        # the engine, its pool and its graphs go before the next is built
        del built
        collect_garbage()


class InProcReplica(Replica):
    """An Engine + ServingFrontend replica in this process. ``factory()``
    returns a :class:`~paddle_tpu_torch.serving.frontend.ServingFrontend`
    (started or not); restarts call it again, so each incarnation gets a
    fresh engine and page pool.

    Over a sharded engine (tp/ep > 1) this object lives on rank 0 and
    every other rank of the engine's group runs :func:`follow_replica`
    with the same factory. A restart waits for the dead incarnation's
    engine thread, stops its followers' loop (``Engine.close``) and tells
    them to build the next one; :meth:`stop` tells them to leave. Two
    replicas over the same ranks need groups of their own (the factory
    passes ``group=``), made in one order on every rank. An engine at
    tp > 1 and ep > 1 is refused with ``TypeError`` on every rank: its
    tp and ep groups are the process's, shared by every engine over the
    same ranks."""

    # the longest a sharded incarnation's engine thread may take to leave
    # before its followers are told anything (a step in flight finishes)
    JOIN_S = 120.0

    def __init__(self, factory: Callable, name: str = "inproc",
                 index: int = 0):
        super().__init__(name, index)
        self._factory = factory
        self._fe = None
        self._ended = False  # a sharded replica's followers have left

    @property
    def frontend(self):
        return self._fe

    def start(self):
        if self._fe is None:
            self._build()
        return self

    def _build(self):
        """The next incarnation from the factory, started. One whose
        sharded engine no replica can ride (:func:`_refusal`) is stopped,
        its followers told to leave, and refused with ``TypeError``."""
        fe = self._factory()
        why = _refusal(_sharded_runner(fe))
        if why is not None:
            self._end_sharded(fe, _DONE)
            raise TypeError(why)
        self._fe = fe
        self._fe.start()

    def alive(self) -> bool:
        return self._fe is not None and self._fe.alive

    def ready(self) -> Dict:
        if not self.alive():
            return {"ready": False, "alive": False}
        return self._fe.readiness()

    def kill(self):
        if self._fe is not None:
            self._fe.poison()

    def stop(self):
        if self._fe is not None:
            self._fe.shutdown()
            if not self._ended:
                self._end_sharded(self._fe, _DONE)

    def _end_sharded(self, fe, word: int):
        """Rank 0, a sharded incarnation going: once its engine thread has
        left (no command in flight), stop its followers' loop and send them
        ``word``. A no-op for an unsharded engine."""
        runner = _sharded_runner(fe)
        if runner is None:
            return
        t = fe._thread
        if t is not None:
            t.join(self.JOIN_S)
            if t.is_alive():
                raise RuntimeError(
                    f"replica {self.name!r}: the engine thread is still "
                    "running; its followers cannot be stopped safely")
        runner.stop()
        _replica_word(runner, word)
        self._ended = word == _DONE

    def restart(self):
        from ..inference.runner import collect_garbage

        if self._ended:
            raise RuntimeError(f"replica {self.name!r} was stopped: its "
                               "followers have left")
        dead, self._fe = self._fe, None
        if dead is not None:
            # the dead incarnation's host KV tier dies with it: its worker
            # is queued on a pool the fresh engine never sees. The front
            # end's loop exit does this too; a poisoned thread may still
            # be on its way out, so the supervisor makes it unconditional
            try:
                dead.engine._cache.shutdown_tier()
            except Exception:  # pragma: no cover - teardown best-effort
                pass
            dead.shutdown()
            self._end_sharded(dead, _NEXT)
            # the dead engine, its pool and its graphs are held in
            # reference cycles (an engine and its runner hold each other):
            # collect them before the factory allocates the next pool
            del dead
            collect_garbage()
        self._build()
        self.restarts += 1
        return self

    def launch(self, stream: ReplicaStream):
        spec = stream.spec

        def bridge(chunk):
            if stream.closed:
                return
            if chunk is None:
                ticket = stream._impl
                self._untrack(stream)
                stream.on_done(stream,
                               ticket.failure_reason if ticket else None)
            else:
                stream.on_chunk(stream, chunk)

        stream._impl = self._fe.submit(
            spec.prompt, spec.max_new_tokens,
            temperature=spec.temperature, seed=spec.seed,
            tenant=spec.tenant, deadline_s=spec.deadline_s,
            on_chunk=bridge, resume_tokens=spec.resume_tokens,
            trace=spec.trace, t_origin=spec.t_origin)
        return stream

    def _cancel(self, stream: ReplicaStream):
        self._untrack(stream)
        fe = self._fe
        if stream._impl is not None and fe is not None and fe.alive:
            fe.cancel(stream._impl)

    # ------------------------------------------------ cluster handoff
    def export_kv(self, tokens: Sequence[int]) -> Optional[Dict]:
        """The in-process export: the payload's rows are host tensors,
        handed over as they are (no serialization)."""
        fe = self._fe
        if fe is None or not fe.alive:
            return None
        try:
            return fe.export_kv(tokens)
        except Exception:
            return None  # a dead or poisoned engine thread: recompute

    def import_kv(self, payload: Dict) -> int:
        fe = self._fe
        if fe is None or not fe.alive or not payload:
            return 0
        try:
            return int(fe.import_kv(payload))
        except Exception:
            return 0


class SubprocessReplica(Replica):
    """A worker process behind the ApiServer HTTP protocol. ``argv`` is the
    worker's command line; the worker prints ``api: http://HOST:PORT/...``
    on stdout once bound (the ``serve_llama_paged_torch.py --api-port``
    contract)."""

    def __init__(self, argv: Sequence[str], name: str = "worker",
                 index: int = 0, env: Optional[Dict[str, str]] = None,
                 cwd: Optional[str] = None, startup_timeout_s: float = 120.0,
                 probe_timeout_s: float = 2.0):
        super().__init__(name, index)
        self.argv = list(argv)
        self.env = dict(env) if env is not None else None
        self.cwd = cwd
        self.startup_timeout_s = float(startup_timeout_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.proc: Optional[subprocess.Popen] = None
        self.host: Optional[str] = None
        self.port: Optional[int] = None

    # --------------------------------------------------------- lifecycle
    def start(self):
        self.proc = subprocess.Popen(
            self.argv, cwd=self.cwd, env=self.env,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        bound = threading.Event()
        proc = self.proc

        def pump():
            for line in proc.stdout:
                if line.startswith("api: http") and not bound.is_set():
                    # "api: http://127.0.0.1:PORT/v1/completions (...)";
                    # published once, then bound.set(): every reader
                    # waits on the event first
                    hostport = line.split("//", 1)[1].split("/", 1)[0]
                    self.host, port = hostport.rsplit(":", 1)
                    self.port = int(port)
                    bound.set()
            bound.set()  # EOF: unblock the waiter either way

        # drain stdout for the worker's lifetime, so its prints can never
        # fill the pipe and wedge it
        threading.Thread(target=pump, daemon=True,
                         name=f"replica-{self.name}-stdout").start()
        if not bound.wait(self.startup_timeout_s) or self.port is None:
            raise RuntimeError(
                f"replica {self.name!r} never printed its api endpoint "
                f"(exit={self.proc.poll()})")
        return self

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def _get_json(self, path: str):
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.probe_timeout_s)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read() or b"{}")
        finally:
            conn.close()

    def ready(self) -> Dict:
        if not self.alive():
            return {"ready": False, "alive": False}
        try:
            status, payload = self._get_json("/readyz")
        except Exception:
            return {"ready": False, "alive": True}
        payload["ready"] = status == 200
        return payload

    def _probe(self) -> bool:
        if not self.alive():
            return False
        try:
            status, _ = self._get_json("/healthz")
            return status == 200
        except Exception:
            return False

    def kill(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()  # SIGKILL: a real crash

    def stop(self):
        if self.proc is None:
            return
        if self.proc.poll() is None:
            try:
                self.proc.send_signal(signal.SIGTERM)
                self.proc.wait(timeout=60)
            except Exception:
                self.proc.kill()
        try:
            self.proc.wait(timeout=30)
        except Exception:
            pass

    def restart(self):
        self.stop()
        # the old pump ended at stdout's EOF in stop(); start() publishes
        # through a fresh pump and event
        self.host = self.port = None
        self.start()
        self.restarts += 1
        return self

    # ----------------------------------------------------------- streams
    def launch(self, stream: ReplicaStream):
        spec = stream.spec
        payload = {"prompt": spec.prompt,
                   "max_tokens": spec.max_new_tokens,
                   "temperature": spec.temperature, "stream": True}
        if spec.seed is not None:
            payload["seed"] = int(spec.seed)
        if spec.deadline_s is not None:
            payload["deadline_ms"] = 1e3 * spec.deadline_s
        if spec.resume_tokens:
            payload["resume_tokens"] = list(spec.resume_tokens)
        headers = {"Content-Type": "application/json"}
        if spec.tenant:
            headers["X-Tenant"] = spec.tenant
        if spec.trace:
            # the trace context crosses the process boundary as a header:
            # the worker's spans join THIS trace
            headers["X-Trace-Context"] = spec.trace
        conn = http.client.HTTPConnection(self.host, self.port)
        stream._impl = conn
        threading.Thread(
            target=self._pump_sse, daemon=True,
            name=f"replica-{self.name}-stream",
            args=(stream, conn, payload, headers)).start()
        return stream

    def _pump_sse(self, stream: ReplicaStream, conn, payload, headers):
        """A stream's reader thread: forward SSE chunks and classify the
        ending. ``[DONE]`` is completion; anything else (a reset socket,
        EOF mid-stream: the SIGKILL signature) is a broken transport the
        router migrates."""
        finish_reason = None
        try:
            conn.request("POST", "/v1/completions",
                         json.dumps(payload), headers)
            resp = conn.getresponse()
            if resp.status != 200:
                raise RuntimeError(
                    f"replica {self.name!r} refused stream: "
                    f"{resp.status} {resp.read()[:200]!r}")
            done = False
            while not done and not stream.cancelled:
                line = resp.readline()
                if not line:
                    break  # EOF
                line = line.decode("utf-8", "replace").strip()
                if not line.startswith("data: "):
                    continue
                data = line[6:]
                if data == "[DONE]":
                    done = True
                    break
                choice = json.loads(data)["choices"][0]
                if choice.get("finish_reason") is not None:
                    finish_reason = choice["finish_reason"]
                toks = choice.get("token_ids") or []
                if toks and not stream.closed:
                    stream.on_chunk(stream, [int(t) for t in toks])
            if stream.cancelled or stream.closed:
                return
            if not done:
                raise ConnectionError(
                    f"replica {self.name!r} stream ended without [DONE]")
            self._untrack(stream)
            stream.on_done(stream, None if finish_reason in (None, "stop")
                           else finish_reason)
        except Exception as e:
            if stream.cancelled or stream.closed:
                return
            self._untrack(stream)
            stream.on_broken(stream, e)
        finally:
            try:
                conn.close()
            except Exception:
                pass

    def _cancel(self, stream: ReplicaStream):
        self._untrack(stream)
        conn = stream._impl
        if conn is not None:
            try:
                conn.close()  # the server's disconnect-cancel frees the slot
            except Exception:
                pass

    # ------------------------------------------------ cluster handoff
    def _post_json(self, path: str, body: Dict, timeout: float):
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=timeout)
        try:
            conn.request("POST", path, json.dumps(body),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read() or b"{}")
        finally:
            conn.close()

    # a handoff is worth at most one prefill recompute: a transfer slower
    # than this is the kv-handoff-stall signature, and the caller
    # recomputes rather than wait
    KV_HANDOFF_TIMEOUT_S = 10.0

    def export_kv(self, tokens: Sequence[int]) -> Optional[Dict]:
        """The export over ``POST /v1/kv``: page rows ride base64
        (:func:`encode_kv_payload` on the worker) and come back here as
        host tensors."""
        if not self.alive():
            return None
        try:
            status, obj = self._post_json(
                "/v1/kv", {"op": "export",
                           "tokens": [int(t) for t in tokens]},
                self.KV_HANDOFF_TIMEOUT_S)
            if status != 200 or not obj.get("payload"):
                return None
            return decode_kv_payload(obj["payload"])
        except Exception:
            return None

    def import_kv(self, payload: Dict) -> int:
        if not self.alive() or not payload:
            return 0
        try:
            status, obj = self._post_json(
                "/v1/kv", {"op": "import",
                           "payload": encode_kv_payload(payload)},
                self.KV_HANDOFF_TIMEOUT_S)
            return int(obj.get("adopted", 0)) if status == 200 else 0
        except Exception:
            return 0
