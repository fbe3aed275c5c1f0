"""Live SSE serving gateway over a ``MultiSpinCell`` (stdlib asyncio only).

The missing streaming front door (ROADMAP item 5): ``launch/serve.py`` runs
a closed batch session; this server lets real clients attach to a LIVE
cell, stream committed tokens as rounds complete, and watch telemetry
evolve.  Raw ``asyncio.start_server`` HTTP/1.1 — no http.server, no
framework, no new dependencies.

Endpoints:

  * ``POST /v1/generate``       — submit a prompt; the response is a
    close-delimited ``text/event-stream``: one ``queued`` event (assigned
    ``rid``), a ``round`` event per protocol round that committed tokens
    for this stream, and a terminal ``done`` / ``error`` / ``retired``
    event.  Unservable requests get a structured ``422`` (pre-queue) or an
    ``error`` event (evicted at admission) — never silent queue eviction.
  * ``GET /metrics``            — Prometheus text (``MetricsHub``).
  * ``GET /v1/stats``           — JSON running aggregates + last round.
  * ``GET /v1/trace``           — Chrome trace-event JSON of the span
    tracer's buffer (load in Perfetto / ``chrome://tracing``); structured
    409 when the gateway runs with tracing off.
  * ``GET /``                   — minimal KPI dashboard (static HTML
    polling ``/v1/stats``).
  * ``GET /healthz``            — liveness.
  * ``DELETE /v1/streams/{rid}``— retire a stream mid-session (its pages
    return to the pool on a paged engine); the stream gets a ``retired``
    event.

Concurrency model: the cell steps on ONE background task (each round's
``cell.step()`` runs on a worker thread so client I/O keeps multiplexing
during real-model verification), and every cell mutation — submit, leave,
retire — is funneled through an action queue applied between rounds on the
event loop.  The cell itself is never touched from two threads at once.
Client disconnects are detected mid-stream (reader EOF or a failed write)
and retire the stream exactly like an explicit DELETE.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import time
import uuid
from collections import deque

from repro_torch.obs import trace
from repro_torch.serving.gateway.dashboard import DASHBOARD_HTML
from repro_torch.serving.gateway.telemetry import MetricsHub
from repro_torch.serving.scheduler import Request

_MAX_ALPHA = 0.999  # planning solvers need alpha strictly below 1


@dataclasses.dataclass
class GatewayConfig:
    host: str = "127.0.0.1"
    port: int = 8011               # 0 -> ephemeral (read back via .port)
    step_barrier: int = 0          # hold the FIRST round until N submissions
    idle_wait_s: float = 0.25      # poll interval while the cell is idle
    max_body_bytes: int = 1 << 20
    step_in_thread: bool = True    # run cell.step on a worker thread
    default_max_new_tokens: int = 32
    default_alpha: float = 0.8
    default_T_S: float = 0.009
    trace_spans: bool = False      # install a repro.obs tracer for the run
    trace_capacity: int = 65536    # span ring size (oldest spans drop)
    trace_device_sync: bool = False  # block_until_ready at span exits


class _Stream:
    """Server-side handle pairing a scheduler Request with its SSE queue."""

    def __init__(self, req: Request, tag: str | None):
        self.req = req
        self.rid = req.rid
        self.tag = tag
        # correlation id carried on every SSE event; span args record rids,
        # so a Perfetto search for this stream goes trace_id -> rid -> spans
        self.trace_id = f"{req.rid:x}-{uuid.uuid4().hex[:12]}"
        self.queue: asyncio.Queue = asyncio.Queue()
        self.streamed = 0            # capped tokens already sent
        self.rounds = 0              # rounds THIS stream committed tokens in
        self.terminal = False        # a done/error/retired event was queued
        self.created_s = time.monotonic()

    def push(self, event: str, data: dict, terminal: bool = False):
        if self.terminal:
            return
        self.terminal = terminal
        self.queue.put_nowait((event, data))


class _RejectCapture:
    """Listener recording admission-time rejections.  ``on_reject`` fires
    inside ``cell.step`` — possibly on the step worker thread — so it only
    appends to a plain list (atomic under the GIL); the gateway drains it
    on the event loop after the step returns."""

    def __init__(self):
        self._rids: list[int] = []

    def on_reject(self, req):
        self._rids.append(req.rid)

    def drain(self) -> list[int]:
        out, self._rids = self._rids, []
        return out


class MultiSpinGateway:
    def __init__(self, cell, config: GatewayConfig | None = None,
                 hub: MetricsHub | None = None):
        self.cell = cell
        self.config = config or GatewayConfig()
        self.hub = hub if hub is not None else MetricsHub()
        self.hub.attach(cell)
        self._rejects = cell.add_listener(_RejectCapture())
        self._streams: dict[int, _Stream] = {}
        self._actions: deque = deque()
        self._wake = asyncio.Event()
        self._next_rid = 0
        self._running = False
        self._stepped = False        # first round executed (barrier latch)
        self._server: asyncio.AbstractServer | None = None
        self._step_task: asyncio.Task | None = None
        self.port = self.config.port
        # span tracing: the gateway owns the process-global tracer for its
        # lifetime (installed in start, uninstalled in stop) so cell/engine/
        # kernel spans fire without any per-call plumbing.  If a tracer is
        # already installed (a test's ``tracing`` scope), reuse it instead
        # of stomping the caller's.
        self.tracer: trace.Tracer | None = None
        self._owns_tracer = False

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    async def start(self):
        if self.config.trace_spans:
            existing = trace.active()
            if existing is not None:
                self.tracer = existing
            else:
                self.tracer = trace.install(trace.Tracer(
                    capacity=self.config.trace_capacity,
                    device_sync=self.config.trace_device_sync))
                self._owns_tracer = True
        self._server = await asyncio.start_server(
            self._handle_connection, self.config.host, self.config.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._running = True
        self._step_task = asyncio.create_task(self._step_loop())
        return self

    async def serve_forever(self):
        async with self._server:
            await self._server.serve_forever()

    async def stop(self):
        self._running = False
        self._wake.set()
        if self._step_task is not None:
            await self._step_task
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        for st in list(self._streams.values()):
            st.push("error", {"rid": st.rid, "error": "gateway_shutdown"},
                    terminal=True)
        if self._owns_tracer:
            trace.uninstall()
            self._owns_tracer = False
        self.hub.close()

    # ------------------------------------------------------------------
    # the single cell-stepping task
    # ------------------------------------------------------------------

    def _enqueue(self, action: tuple):
        self._actions.append(action)
        self._wake.set()

    def _apply_actions(self):
        """Apply queued cell mutations on the event loop, between rounds."""
        while self._actions:
            kind, *rest = self._actions.popleft()
            if kind == "submit":
                (req,) = rest
                self.cell.submit(req)
            elif kind == "leave":
                rid, fut = rest
                outcome = self._do_leave(rid)
                if fut is not None and not fut.done():
                    fut.set_result(outcome)

    def _do_leave(self, rid: int) -> str:
        """Retire a stream wherever it lives: active set (pages returned),
        waiting queue (plain removal), or already finished (no-op)."""
        st = self._streams.get(rid)
        sched = self.cell.scheduler
        if any(r.rid == rid for r in sched.active):
            self.cell.leave(rid)
            if st:
                st.push("retired", {"rid": rid, "status": "retired"},
                        terminal=True)
            return "retired"
        for req in sched.queue:
            if req.rid == rid:
                sched.queue.remove(req)
                req.done = True
                if st:
                    st.push("retired", {"rid": rid, "status": "cancelled"},
                            terminal=True)
                return "cancelled"
        if st is not None or self._was_known(rid):
            return "done"
        return "not_found"

    def _was_known(self, rid: int) -> bool:
        return 0 <= rid < self._next_rid

    async def _step_loop(self):
        loop = asyncio.get_running_loop()
        while self._running:
            self._apply_actions()
            sched = self.cell.scheduler
            pending = len(sched.queue) + len(sched.active)
            barrier_held = (not self._stepped
                            and pending < self.config.step_barrier)
            if pending == 0 or barrier_held:
                self._wake.clear()
                try:
                    await asyncio.wait_for(self._wake.wait(),
                                           timeout=self.config.idle_wait_s)
                except asyncio.TimeoutError:
                    pass
                continue
            self._stepped = True
            if self.config.step_in_thread:
                rec = await loop.run_in_executor(None, self.cell.step)
            else:
                rec = self.cell.step()
            self._dispatch_round(rec)
            # yield so per-connection writers flush before the next round
            await asyncio.sleep(0)

    def _round_tokens(self, st: _Stream, produced: int) -> list[int]:
        """The tokens to stream this round: real committed ids when the
        backend exposes them (EngineBackend.stream_tokens), else positional
        surrogate ids (synthetic backends draw acceptance counts, not
        token values — the stream is still bit-exact in counts)."""
        fn = getattr(self.cell.backend, "stream_tokens", None)
        if fn is not None:
            toks = fn(st.rid)
            return toks[st.streamed:st.streamed + produced]
        return list(range(st.streamed, st.streamed + produced))

    def _dispatch_round(self, rec):
        """Fan one RoundRecord out to the per-stream SSE queues."""
        for rid in self._rejects.drain():
            st = self._streams.get(rid)
            if st:
                st.push("error",
                        {"rid": rid, "error": "unservable",
                         "detail": "evicted at admission: the backend can "
                                   "never serve this request"},
                        terminal=True)
        if rec is None:
            return
        drop = getattr(self.cell.backend, "drop_finished", None)
        for i, rid in enumerate(rec.rids.tolist()):
            st = self._streams.get(int(rid))
            if st is None:
                continue
            produced = st.req.generated - st.streamed
            if produced > 0:
                tokens = self._round_tokens(st, produced)
                st.streamed += produced
                # "round" counts THIS stream's committed rounds: under the
                # continuous schedule streams progress independently, so a
                # cell-global index would skip numbers per client;
                # "cell_round" keeps the global correlation key for traces
                st.push("round", {
                    "rid": st.rid,
                    "trace_id": st.trace_id,
                    "round": st.rounds,
                    "cell_round": len(self.cell.history) - 1,
                    "n": produced,
                    "tokens": tokens,
                    "generated": st.streamed,
                    "accepted_raw": int(rec.accepted[i]),
                    "draft_width": int(rec.draft_width),
                    "t_round": float(rec.t_round),
                })
                st.rounds += 1
            if st.req.done:
                st.push("done", {
                    "rid": st.rid,
                    "trace_id": st.trace_id,
                    "generated": st.req.generated,
                    "rounds": st.req.rounds,
                    "ttft_sim_s": float(st.req.first_token_time
                                        - st.req.submit_time),
                    "tag": st.tag,
                }, terminal=True)
                if drop is not None:
                    drop(st.rid)

    # ------------------------------------------------------------------
    # HTTP layer
    # ------------------------------------------------------------------

    async def _handle_connection(self, reader: asyncio.StreamReader,
                                 writer: asyncio.StreamWriter):
        try:
            try:
                method, path, headers, body = await self._read_request(reader)
            except (ValueError, asyncio.IncompleteReadError, ConnectionError):
                await self._respond(writer, 400, {"error": "bad_request"})
                return
            if method == "GET" and path == "/metrics":
                await self._respond(writer, 200, self.hub.prometheus_text(),
                                    content_type="text/plain; version=0.0.4")
            elif method == "GET" and path == "/v1/stats":
                await self._respond(writer, 200, self.hub.snapshot())
            elif method == "GET" and path == "/v1/trace":
                if self.tracer is None:
                    await self._respond(writer, 409, {
                        "error": "tracing_disabled",
                        "detail": "start the gateway with "
                                  "GatewayConfig(trace_spans=True) "
                                  "(launch: --trace-spans)"})
                else:
                    await self._respond(
                        writer, 200, self.tracer.export_chrome_trace())
            elif method == "GET" and path in ("/", "/dashboard"):
                await self._respond(writer, 200, DASHBOARD_HTML,
                                    content_type="text/html; charset=utf-8")
            elif method == "GET" and path == "/healthz":
                await self._respond(writer, 200, {
                    "ok": True, "active": len(self.cell.scheduler.active),
                    "queued": len(self.cell.scheduler.queue)})
            elif method == "POST" and path == "/v1/generate":
                await self._handle_generate(reader, writer, body)
            elif method == "DELETE" and path.startswith("/v1/streams/"):
                await self._handle_delete(writer, path)
            else:
                await self._respond(writer, 404, {"error": "not_found",
                                                  "path": path})
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _read_request(self, reader):
        line = await reader.readline()
        parts = line.decode("latin-1").split()
        if len(parts) < 3:
            raise ValueError("malformed request line")
        method, path = parts[0].upper(), parts[1]
        headers = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            k, _, v = h.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()
        n = int(headers.get("content-length", 0) or 0)
        if n > self.config.max_body_bytes:
            raise ValueError("body too large")
        body = await reader.readexactly(n) if n else b""
        return method, path, headers, body

    async def _respond(self, writer, status: int, payload,
                       content_type: str = "application/json"):
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  409: "Conflict", 422: "Unprocessable Entity",
                  500: "Internal Server Error"}.get(status, "OK")
        if isinstance(payload, (dict, list)):
            raw = json.dumps(payload).encode()
        else:
            raw = str(payload).encode()
        head = (f"HTTP/1.1 {status} {reason}\r\n"
                f"Content-Type: {content_type}\r\n"
                f"Content-Length: {len(raw)}\r\n"
                f"Connection: close\r\n\r\n").encode("latin-1")
        writer.write(head + raw)
        await writer.drain()

    # -- POST /v1/generate ----------------------------------------------

    def _parse_generate(self, body: bytes) -> tuple[Request, str | None]:
        try:
            fields = json.loads(body.decode() or "{}")
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise ValueError(f"invalid JSON body: {e}") from e
        if not isinstance(fields, dict):
            raise ValueError("body must be a JSON object")
        cfg = self.config
        prompt = fields.get("prompt")
        if prompt is not None:
            if (not isinstance(prompt, list)
                    or not all(isinstance(t, int) for t in prompt)):
                raise ValueError("'prompt' must be a list of token ids")
            if not prompt:
                raise ValueError("'prompt' must be non-empty")
        prompt_len = int(fields.get(
            "prompt_len", len(prompt) if prompt else 8))
        max_new = int(fields.get("max_new_tokens",
                                 cfg.default_max_new_tokens))
        alpha = float(fields.get("alpha", cfg.default_alpha))
        T_S = float(fields.get("T_S", cfg.default_T_S))
        if prompt_len < 1:
            raise ValueError("'prompt_len' must be >= 1")
        if max_new < 1:
            raise ValueError("'max_new_tokens' must be >= 1")
        if not 0.0 < alpha <= 1.0:
            raise ValueError("'alpha' must be in (0, 1]")
        if T_S <= 0.0:
            raise ValueError("'T_S' must be > 0")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt_len=prompt_len,
                      max_new_tokens=max_new,
                      task=str(fields.get("task", "")),
                      alpha=min(alpha, _MAX_ALPHA), T_S=T_S,
                      prompt=tuple(prompt) if prompt is not None else None)
        return req, fields.get("tag")

    async def _handle_generate(self, reader, writer, body: bytes):
        try:
            req, tag = self._parse_generate(body)
        except ValueError as e:
            await self._respond(writer, 400, {"error": "bad_request",
                                              "detail": str(e)})
            return
        # unservable-forever requests are refused BEFORE queueing, as a
        # structured HTTP error (the in-queue eviction path still exists
        # for requests that become unservable later)
        servable = getattr(self.cell.backend, "servable", None)
        if servable is not None and not servable(req):
            await self._respond(writer, 422, {
                "error": "unservable", "rid": req.rid,
                "detail": "backend can never serve this request "
                          "(prompt too long for the engine, or no rows "
                          "left on a contiguous batch)"})
            return
        st = _Stream(req, tag)
        self._streams[req.rid] = st
        try:
            writer.write(
                b"HTTP/1.1 200 OK\r\n"
                b"Content-Type: text/event-stream\r\n"
                b"Cache-Control: no-cache\r\n"
                b"Connection: close\r\n\r\n")
            await writer.drain()
            self._enqueue(("submit", req))
            st.push("queued", {"rid": req.rid, "tag": tag,
                               "trace_id": st.trace_id,
                               "scheme": self.cell.config.scheme,
                               "schedule": self.cell.config.schedule,
                               "max_new_tokens": req.max_new_tokens})
            await self._pump_stream(st, reader, writer)
        finally:
            self._streams.pop(req.rid, None)

    async def _pump_stream(self, st: _Stream, reader, writer):
        """Forward the stream's events; watch the socket for disconnect."""
        monitor = asyncio.ensure_future(reader.read())
        try:
            while True:
                getter = asyncio.ensure_future(st.queue.get())
                done, _ = await asyncio.wait(
                    {getter, monitor}, return_when=asyncio.FIRST_COMPLETED)
                if getter not in done:
                    getter.cancel()
                    # client went away mid-session: retire the stream so
                    # its batch slot frees and its pages return to the pool
                    self._enqueue(("leave", st.rid, None))
                    return
                event, data = getter.result()
                payload = (f"event: {event}\r\n"
                           f"data: {json.dumps(data)}\r\n\r\n")
                try:
                    writer.write(payload.encode())
                    await writer.drain()
                except (ConnectionError, OSError):
                    self._enqueue(("leave", st.rid, None))
                    return
                if st.terminal and st.queue.empty():
                    return
        finally:
            monitor.cancel()

    # -- DELETE /v1/streams/{rid} ---------------------------------------

    async def _handle_delete(self, writer, path: str):
        try:
            rid = int(path.rsplit("/", 1)[1])
        except ValueError:
            await self._respond(writer, 400, {"error": "bad_stream_id"})
            return
        fut = asyncio.get_running_loop().create_future()
        self._enqueue(("leave", rid, fut))
        outcome = await fut
        if outcome == "not_found":
            await self._respond(writer, 404, {"error": "not_found",
                                              "rid": rid})
        else:
            await self._respond(writer, 200, {"rid": rid,
                                              "status": outcome})


async def serve(cell, config: GatewayConfig | None = None,
                hub: MetricsHub | None = None):
    """Convenience runner: start a gateway and serve until cancelled."""
    gw = MultiSpinGateway(cell, config=config, hub=hub)
    await gw.start()
    try:
        await gw.serve_forever()
    finally:
        await gw.stop()
