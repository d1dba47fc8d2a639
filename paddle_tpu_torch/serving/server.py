"""OpenAI-compatible streaming HTTP server of the port, after
``paddle_tpu/serving/server.py``.

Pure stdlib asyncio: the protocol surface is small, and owning the socket
keeps the event loop honest (the engine lives on the front end's thread;
the loop only ever awaits).

Endpoints (the vLLM-compatible subset):

* ``POST /v1/completions``: ``prompt`` is a token-id list or a string
  (byte-level encoded into the model's vocab: these are checkpoints
  without a tokenizer); ``stream: true`` serves SSE chunks carrying the
  rendered ``text`` and the exact ``token_ids``, ending with
  ``data: [DONE]``.
* ``POST /v1/chat/completions``: messages flattened and encoded the same
  way; chunks carry ``delta.content`` (and ``token_ids``).
* ``GET /healthz``: liveness, 200 whenever the process answers.
* ``GET /readyz``: readiness, 200 only when fit for new traffic (not
  draining, engine watchdog below its degradation threshold, queue depth
  in bounds); 503 with ``Retry-After`` otherwise.
* ``GET /v1/models``: the configured model id.
* ``GET /debug/trace``: the tracer's ring (tracing mode ``on`` only).
* ``POST /v1/kv``: the KV handoff. ``{"op": "export", "tokens": [...]}``
  answers ``{"payload": ...}`` (the prompt's cached pages, encoded by
  ``replica.encode_kv_payload``, or null); ``{"op": "import", "payload":
  ...}`` adopts one and answers ``{"adopted": n}``. 400 on bad JSON or an
  unknown ``op``, 503 (``kv_handoff``) when the handoff fails. Both run in
  the executor, so the event loop goes on streaming. A payload is the
  pages' bytes (8 MiB a page at ``llama2_7b``, bf16, page size 16), so
  this route takes bodies up to 2 GiB where the others stop at 8 MiB.

Completions accept ``resume_tokens`` (tokens the stream already emitted
elsewhere): the engine re-admits prompt plus them and streams only the
continuation. 429s carry ``Retry-After`` from the queue depth;
engine-scoped faults map to 503 with the taxonomy slug, never a bare 500.

Tenancy: the ``X-Tenant`` header (or the OpenAI ``user`` field) keys
admission control and weighted fairness. Backpressure (``QueueFull``)
maps to 429, validation to 400; the taxonomy slug rides the error body.

Shutdown: SIGTERM/SIGINT sets draining, lets in-flight streams finish
inside the grace budget via ``ServingFrontend.drain`` (in an executor: it
blocks), cancels stragglers cleanly (their streams end with
``finish_reason: "cancelled"``), then closes the listener.
"""
from __future__ import annotations

import asyncio
import json
import signal
from typing import Dict, List, Optional, Tuple

from ..inference.errors import EngineError, QueueFull, RequestError
from ..observability.tracing import TRACER
from .frontend import ServingFrontend

__all__ = ["ApiServer", "encode_text", "render_tokens"]

_MAX_BODY = 8 << 20  # request bodies beyond 8 MiB are refused
_MAX_KV_BODY = 2 << 30  # but a handoff's pages may reach 2 GiB


def encode_text(text: str, vocab_size: int) -> List[int]:
    """Deterministic byte-level text→token-id encoding for checkpoints
    without a tokenizer: each UTF-8 byte maps into the vocab."""
    return [b % vocab_size for b in text.encode("utf-8")]


def render_tokens(toks: List[int]) -> str:
    """Token ids rendered as text (`` 17 4 99``): reversible, and what
    the smoke/identity tests parse back."""
    return "".join(f" {t}" for t in toks)


class ApiServer:
    """See module docstring. ``serve_forever`` blocks until SIGTERM."""

    def __init__(self, frontend: ServingFrontend, host: str = "127.0.0.1",
                 port: int = 0, model_name: str = "paddle-tpu-torch",
                 grace_s: float = 30.0):
        self.frontend = frontend
        self.host = host
        self.port = port
        self.model_name = model_name
        self.grace_s = float(grace_s)
        self._server: Optional[asyncio.AbstractServer] = None
        self._stop: Optional[asyncio.Event] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self.vocab_size = int(frontend.engine.cfg.vocab_size)
        max_pos = int(frontend.engine.cfg.max_position)
        self.default_max_tokens = min(64, max_pos // 4)

    # ------------------------------------------------------------ lifecycle
    async def start(self):
        self._stop = asyncio.Event()
        self._loop = asyncio.get_running_loop()
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self.frontend.start()
        return self

    async def serve_until_signal(self):
        """Install SIGTERM/SIGINT handlers, serve, drain on signal."""
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                loop.add_signal_handler(sig, self._stop.set)
            except NotImplementedError:  # non-unix event loops
                pass
        await self._stop.wait()
        await self.shutdown()

    async def shutdown(self):
        """Drain in-flight streams (grace-bounded), then close. The
        blocking ``frontend.drain`` runs in the default executor so the
        loop keeps pumping the very streams it is draining."""
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, self.frontend.drain, self.grace_s)
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    def request_stop(self):
        """Thread-safe stop trigger (tests / self-smoke): trampolines
        onto the event loop — asyncio.Event is not thread-safe."""
        if self._stop is not None and self._loop is not None:
            self._loop.call_soon_threadsafe(self._stop.set)

    # ------------------------------------------------------------ plumbing
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter):
        try:
            while True:
                req = await self._read_request(reader)
                if req is None:
                    break
                method, path, headers, body = req
                keep = await self._route(method, path, headers, body,
                                         writer)
                if not keep:
                    break
        except (ConnectionResetError, BrokenPipeError,
                asyncio.IncompleteReadError):
            pass  # client went away; per-request cancel already handled
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass

    async def _read_request(self, reader) -> Optional[Tuple]:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
            return None
        lines = head.decode("latin-1").split("\r\n")
        parts = lines[0].split()
        if len(parts) < 2:
            return None
        method, path = parts[0].upper(), parts[1]
        headers: Dict[str, str] = {}
        for ln in lines[1:]:
            name, _, value = ln.partition(":")
            if _:
                headers[name.strip().lower()] = value.strip()
        length = int(headers.get("content-length", "0") or "0")
        if length > (_MAX_KV_BODY if path == "/v1/kv" else _MAX_BODY):
            return None
        body = await reader.readexactly(length) if length else b""
        return method, path, headers, body

    @staticmethod
    async def _send(writer, status: int, payload: dict,
                    keep_alive: bool = True,
                    headers: Optional[Dict[str, str]] = None) -> bool:
        body = json.dumps(payload).encode()
        phrase = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  429: "Too Many Requests", 500: "Internal Server Error",
                  503: "Service Unavailable"}.get(status, "OK")
        conn = "keep-alive" if keep_alive else "close"
        extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
        writer.write(
            f"HTTP/1.1 {status} {phrase}\r\n"
            f"Content-Type: application/json\r\n{extra}"
            f"Content-Length: {len(body)}\r\nConnection: {conn}\r\n"
            f"\r\n".encode() + body)
        await writer.drain()
        return keep_alive

    def _retry_after_s(self) -> int:
        """``Retry-After`` seconds for 429/503 responses, derived from
        the queue depth the refused request would have waited behind:
        roughly one second per max_slots-wide wave still queued, clamped
        to [1, 30] so a hiccup never advertises an hour."""
        eng = self.frontend.engine
        depth = len(self.frontend.queue) + len(eng._queue)
        return max(1, min(30, -(-depth // max(1, eng.max_slots))))

    async def _route(self, method, path, headers, body, writer) -> bool:
        if method == "GET" and path in ("/healthz", "/health"):
            # liveness: answering at all means the process and the event
            # loop are up, so always 200, even draining or degraded
            return await self._send(writer, 200, {
                "status": "ok",
                "draining": bool(self.frontend.draining)})
        if method == "GET" and path == "/readyz":
            # readiness: fit for NEW traffic (not draining, watchdog below
            # its degradation threshold, queue depth in bounds)
            ready = self.frontend.readiness()
            if ready["ready"]:
                return await self._send(writer, 200, {
                    "status": "ready", **ready})
            return await self._send(
                writer, 503, {"status": "not-ready", **ready},
                headers={"Retry-After": str(self._retry_after_s())})
        if method == "GET" and path == "/v1/models":
            return await self._send(writer, 200, {
                "object": "list",
                "data": [{"id": self.model_name, "object": "model"}]})
        if method == "GET" and path == "/debug/trace":
            # live trace scrape: the tracer ring, oldest first. Served only
            # in mode "on" (flight-only records for postmortems but does
            # not expose a live feed)
            if not TRACER.live:
                return await self._send(writer, 404, _err(
                    "tracing_off",
                    f"tracing mode is {TRACER.mode!r}; start with "
                    "--trace on to serve live snapshots"))
            return await self._send(writer, 200, {
                "mode": TRACER.mode, "process": TRACER.process,
                "capacity": TRACER.capacity,
                "records": TRACER.snapshot()})
        if method == "POST" and path == "/v1/kv":
            return await self._kv(body, writer)
        if method == "POST" and path in ("/v1/completions",
                                         "/v1/chat/completions"):
            try:
                payload = json.loads(body.decode() or "{}")
            except (ValueError, UnicodeDecodeError):
                return await self._send(writer, 400, _err(
                    "invalid_json", "body is not valid JSON"))
            try:
                return await self._completions(
                    payload, headers, writer,
                    chat=path.endswith("chat/completions"))
            except (ConnectionResetError, BrokenPipeError, OSError):
                raise  # client went away — the conn handler's cleanup
            except Exception as e:  # defense in depth: a taxonomy 500,
                # never a silently dropped connection
                try:
                    return await self._send(writer, 500, _err(
                        "internal",
                        f"{type(e).__name__}: {e}"), keep_alive=False)
                except (ConnectionResetError, BrokenPipeError, OSError):
                    return False
        return await self._send(writer, 404, _err(
            "not_found", f"no route {method} {path}"))

    # --------------------------------------------------------- completions
    async def _kv(self, body, writer) -> bool:
        """``POST /v1/kv``: export the prompt's cached pages, or import a
        shipped payload; both blocking, so both run in the executor."""
        from .replica import decode_kv_payload, encode_kv_payload

        loop = asyncio.get_running_loop()
        try:
            # an import body is the pages' bytes: parse it off the loop
            payload = await loop.run_in_executor(
                None, json.loads, body.decode() or "{}")
        except (ValueError, UnicodeDecodeError):
            return await self._send(writer, 400, _err(
                "invalid_json", "body is not valid JSON"))
        try:
            op = payload.get("op")
            if op == "export":
                toks = payload.get("tokens") or []
                out = await loop.run_in_executor(
                    None, self.frontend.export_kv, toks)
                enc = None if not out else await loop.run_in_executor(
                    None, encode_kv_payload, out)
                return await self._send(writer, 200, {"payload": enc})
            if op == "import":
                shipped = payload.get("payload") or {}
                dec = {} if not shipped else await loop.run_in_executor(
                    None, decode_kv_payload, shipped)
                adopted = await loop.run_in_executor(
                    None, self.frontend.import_kv, dec)
                return await self._send(writer, 200,
                                        {"adopted": int(adopted)})
            return await self._send(writer, 400, _err(
                "validation", "op must be 'export' or 'import'"))
        except Exception as e:  # noqa: BLE001 - the caller recomputes
            # a failed handoff is a recompute on the caller's side, never
            # a wedged endpoint
            return await self._send(writer, 503, _err(
                "kv_handoff", f"{type(e).__name__}: {e}"))

    def _prompt_ids(self, payload: dict, chat: bool) -> List[int]:
        if chat:
            msgs = payload.get("messages")
            if not isinstance(msgs, list) or not msgs:
                raise ValueError("chat needs a non-empty messages list")
            ids: List[int] = []
            for m in msgs:
                content = m.get("content", "")
                if isinstance(content, list):  # OpenAI content parts
                    content = "".join(p.get("text", "") for p in content
                                      if isinstance(p, dict))
                ids.extend(encode_text(
                    f"{m.get('role', 'user')}: {content}\n",
                    self.vocab_size))
            return ids
        prompt = payload.get("prompt")
        if isinstance(prompt, str):
            return encode_text(prompt, self.vocab_size)
        if isinstance(prompt, list) and prompt \
                and all(isinstance(t, int) for t in prompt):
            return list(prompt)
        raise ValueError(
            "prompt must be a string or a list of token ids")

    async def _completions(self, payload, headers, writer,
                           chat: bool) -> bool:
        try:
            ids = self._prompt_ids(payload, chat)
        except ValueError as e:
            return await self._send(writer, 400,
                                    _err("validation", str(e)))
        tenant = headers.get("x-tenant") or payload.get("user") or None
        # trace propagation: a caller that carries a span context sends it
        # as a header, and the engine's spans for this request join the
        # caller's trace
        trace = headers.get("x-trace-context") or None
        max_tokens = int(payload.get("max_tokens",
                                     self.default_max_tokens))
        temperature = float(payload.get("temperature", 0.0))
        seed = payload.get("seed")
        stream = bool(payload.get("stream", False))
        deadline_ms = payload.get("deadline_ms")
        resume = payload.get("resume_tokens")
        if resume is not None and not (
                isinstance(resume, list)
                and all(isinstance(t, int) for t in resume)):
            return await self._send(writer, 400, _err(
                "validation", "resume_tokens must be a list of ints"))
        loop = asyncio.get_running_loop()
        chunks: asyncio.Queue = asyncio.Queue()

        def on_chunk(chunk):  # engine thread → event loop
            loop.call_soon_threadsafe(chunks.put_nowait, chunk)

        try:
            ticket = self.frontend.submit(
                ids, max_tokens, temperature=temperature,
                seed=int(seed) if seed is not None else None,
                tenant=tenant,
                deadline_s=(float(deadline_ms) / 1e3
                            if deadline_ms is not None else None),
                on_chunk=on_chunk, resume_tokens=resume, trace=trace)
        except QueueFull as e:
            # backpressure carries a when-to-come-back hint, from the
            # depth of the queue the request would have waited behind
            return await self._send(
                writer, 429, _err("queue_full", str(e)),
                headers={"Retry-After": str(self._retry_after_s())})
        except (EngineError, ValueError) as e:
            reason = getattr(e, "reason", "validation")
            if isinstance(e, EngineError) and not isinstance(
                    e, (RequestError, ValueError)):
                # engine-scoped fault at submission: the server, not
                # the request, is at fault — 503 with the taxonomy
                # slug, never a bare 500
                return await self._send(
                    writer, 503, _err(reason, str(e)),
                    headers={"Retry-After": str(self._retry_after_s())})
            return await self._send(writer, 400, _err(reason, str(e)))
        rid = f"{'chatcmpl' if chat else 'cmpl'}-{id(ticket) & 0xFFFFFF:x}"
        if stream:
            return await self._stream(ticket, rid, chat, chunks, writer)
        return await self._unary(ticket, rid, chat, chunks, writer)

    # failure reasons where the SERVER (not the request) is at fault: a
    # unary response maps these to 503 + the taxonomy slug instead of a 200
    # with a surprising finish_reason
    _ENGINE_SCOPED_REASONS = frozenset(
        {"engine", "step_fault", "unhandled", "pool_exhausted",
         "retries_exhausted"})

    async def _unary(self, ticket, rid, chat, chunks, writer) -> bool:
        while await chunks.get() is not None:
            ticket.ack()  # the server IS the consumer here: chunks are
            # accumulated on receipt, so receipt is consumption
        reason = _finish_reason(ticket)
        if reason in self._ENGINE_SCOPED_REASONS:
            return await self._send(
                writer, 503, _err(reason,
                                  "request failed on an engine-scoped "
                                  "fault; safe to retry"),
                headers={"Retry-After": str(self._retry_after_s())})
        text = render_tokens(ticket.tokens)
        if chat:
            choice = {"index": 0, "finish_reason": reason,
                      "message": {"role": "assistant", "content": text},
                      "token_ids": list(ticket.tokens)}
            obj = "chat.completion"
        else:
            choice = {"index": 0, "finish_reason": reason, "text": text,
                      "token_ids": list(ticket.tokens)}
            obj = "text_completion"
        return await self._send(writer, 200, {
            "id": rid, "object": obj, "model": self.model_name,
            "choices": [choice],
            "usage": {"prompt_tokens": int(ticket.prompt.size),
                      "completion_tokens": len(ticket.tokens)}})

    async def _stream(self, ticket, rid, chat, chunks, writer) -> bool:
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-cache\r\n"
                     b"Connection: close\r\n\r\n")
        obj = "chat.completion.chunk" if chat else "text_completion"
        try:
            await writer.drain()
            while True:
                chunk = await chunks.get()
                if chunk is None:
                    break
                if chat:
                    choice = {"index": 0, "finish_reason": None,
                              "delta": {"content": render_tokens(chunk)},
                              "token_ids": list(chunk)}
                else:
                    choice = {"index": 0, "finish_reason": None,
                              "text": render_tokens(chunk),
                              "token_ids": list(chunk)}
                writer.write(_sse({"id": rid, "object": obj,
                                   "model": self.model_name,
                                   "choices": [choice]}))
                await writer.drain()
                # the chunk reached the client's socket buffer — ack so
                # the frontend's slow-client watchdog sees progress; a
                # stalled client blocks this drain, the ack clock
                # stops, and the stream is cancelled (slot/pages freed)
                ticket.ack()
            final = {"index": 0, "finish_reason": _finish_reason(ticket),
                     "token_ids": []}
            if chat:
                final["delta"] = {}
            else:
                final["text"] = ""
            writer.write(_sse({"id": rid, "object": obj,
                               "model": self.model_name,
                               "choices": [final]}))
            writer.write(b"data: [DONE]\n\n")
            await writer.drain()
        except (ConnectionResetError, BrokenPipeError, OSError):
            # client hung up mid-stream: cancel so the engine frees the
            # slot and pages immediately (the taxonomy 'cancelled' path)
            self.frontend.cancel(ticket)
        return False  # SSE responses close the connection


def _sse(payload: dict) -> bytes:
    return b"data: " + json.dumps(payload).encode() + b"\n\n"


def _err(code: str, message: str) -> dict:
    return {"error": {"type": code, "message": message}}


def _finish_reason(ticket) -> str:
    if ticket.failure_reason:
        return ticket.failure_reason
    return "stop"
