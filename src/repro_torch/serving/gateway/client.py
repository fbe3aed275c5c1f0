"""Stdlib SSE client for the Multi-SPIN gateway.

Raw ``asyncio.open_connection`` HTTP/1.1 — no requests/aiohttp dependency —
mirroring the server's close-delimited SSE framing:

    client = GatewayClient("127.0.0.1", 8011)
    res = await client.generate(prompt_len=8, max_new_tokens=32)
    print(res.rid, res.tokens, res.ttft_s)

    async for ev in client.stream_generate(prompt_len=8, max_new_tokens=32):
        print(ev.event, ev.data)

    text = await client.metrics()          # GET /metrics
    stats = await client.stats()           # GET /v1/stats
    await client.delete_stream(rid)        # DELETE /v1/streams/{rid}
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import time


class GatewayError(RuntimeError):
    """Non-2xx HTTP response from the gateway (structured body attached)."""

    def __init__(self, status: int, body):
        super().__init__(f"gateway returned {status}: {body}")
        self.status = status
        self.body = body


@dataclasses.dataclass
class SSEEvent:
    event: str
    data: dict


@dataclasses.dataclass
class GenerateResult:
    rid: int | None
    tokens: list
    n_rounds: int
    per_round: list            # [(n_new_tokens, generated_so_far), ...]
    ttft_s: float | None       # send -> first round event (real wall)
    latency_s: float | None    # send -> terminal event
    done: bool
    error: str | None
    events: list               # every SSEEvent, in order


def _encode_request(method: str, path: str, host: str,
                    body: bytes | None) -> bytes:
    lines = [f"{method} {path} HTTP/1.1", f"Host: {host}",
             "Connection: close", "Accept: */*"]
    if body:
        lines += ["Content-Type: application/json",
                  f"Content-Length: {len(body)}"]
    head = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
    return head + (body or b"")


async def _read_head(reader: asyncio.StreamReader):
    """(status_code, headers) — consumes up to the blank line."""
    status_line = await reader.readline()
    if not status_line:
        raise ConnectionError("empty response from gateway")
    parts = status_line.decode("latin-1").split(None, 2)
    status = int(parts[1])
    headers = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        k, _, v = line.decode("latin-1").partition(":")
        headers[k.strip().lower()] = v.strip()
    return status, headers


async def _read_body(reader, headers) -> bytes:
    n = headers.get("content-length")
    if n is not None:
        return await reader.readexactly(int(n))
    return await reader.read()


class GatewayClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 8011):
        self.host = host
        self.port = port

    # -- plain endpoints -------------------------------------------------

    async def _call(self, method: str, path: str,
                    body: dict | None = None):
        reader, writer = await asyncio.open_connection(self.host, self.port)
        try:
            payload = (json.dumps(body).encode() if body is not None
                       else None)
            writer.write(_encode_request(method, path, self.host, payload))
            await writer.drain()
            status, headers = await _read_head(reader)
            raw = await _read_body(reader, headers)
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass
        ctype = headers.get("content-type", "")
        data = (json.loads(raw.decode() or "null")
                if "json" in ctype else raw.decode())
        if status >= 300:
            raise GatewayError(status, data)
        return data

    async def metrics(self) -> str:
        return await self._call("GET", "/metrics")

    async def stats(self) -> dict:
        return await self._call("GET", "/v1/stats")

    async def trace(self) -> dict:
        """Chrome trace-event JSON (``GET /v1/trace``); raises
        ``GatewayError`` (409) when the gateway runs with tracing off."""
        return await self._call("GET", "/v1/trace")

    async def health(self) -> dict:
        return await self._call("GET", "/healthz")

    async def delete_stream(self, rid: int) -> dict:
        return await self._call("DELETE", f"/v1/streams/{rid}")

    # -- streaming generation -------------------------------------------

    async def stream_generate(self, **fields):
        """Async generator of ``SSEEvent``s for one generation request.
        Raises ``GatewayError`` on a non-SSE (error) response.  Closing the
        generator closes the connection (mid-stream disconnect)."""
        reader, writer = await asyncio.open_connection(self.host, self.port)
        try:
            body = json.dumps(fields).encode()
            writer.write(_encode_request("POST", "/v1/generate", self.host,
                                         body))
            await writer.drain()
            status, headers = await _read_head(reader)
            if status >= 300 or "text/event-stream" not in headers.get(
                    "content-type", ""):
                raw = await _read_body(reader, headers)
                data = raw.decode()
                if "json" in headers.get("content-type", ""):
                    data = json.loads(data or "null")
                raise GatewayError(status, data)
            async for ev in _parse_sse(reader):
                yield ev
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def generate(self, disconnect_after_rounds: int | None = None,
                       **fields) -> GenerateResult:
        """Run one generation to completion, collecting streamed tokens and
        timing.  ``disconnect_after_rounds`` abandons the stream (abrupt
        close) after that many round events — the gateway must then retire
        the stream server-side."""
        t_send = time.monotonic()
        res = GenerateResult(rid=None, tokens=[], n_rounds=0, per_round=[],
                             ttft_s=None, latency_s=None, done=False,
                             error=None, events=[])
        gen = self.stream_generate(**fields)
        try:
            async for ev in gen:
                res.events.append(ev)
                if ev.event == "queued":
                    res.rid = ev.data.get("rid")
                elif ev.event == "round":
                    if res.ttft_s is None:
                        res.ttft_s = time.monotonic() - t_send
                    res.n_rounds += 1
                    res.tokens.extend(ev.data.get("tokens", []))
                    res.per_round.append((ev.data.get("n"),
                                          ev.data.get("generated")))
                    if (disconnect_after_rounds is not None
                            and res.n_rounds >= disconnect_after_rounds):
                        break
                elif ev.event == "done":
                    res.done = True
                    break
                elif ev.event in ("error", "retired"):
                    res.error = ev.data.get("error", ev.event)
                    break
        finally:
            await gen.aclose()
        res.latency_s = time.monotonic() - t_send
        return res


async def _parse_sse(reader: asyncio.StreamReader):
    """Yield SSEEvents until EOF (the server closes to end the stream)."""
    event, data_lines = "message", []
    while True:
        line = await reader.readline()
        if not line:
            return
        text = line.decode("utf-8").rstrip("\r\n")
        if not text:
            if data_lines:
                try:
                    data = json.loads("\n".join(data_lines))
                except json.JSONDecodeError:
                    data = {"raw": "\n".join(data_lines)}
                yield SSEEvent(event=event, data=data)
            event, data_lines = "message", []
            continue
        if text.startswith(":"):
            continue                       # SSE comment / keepalive
        field, _, value = text.partition(":")
        value = value.removeprefix(" ")
        if field == "event":
            event = value
        elif field == "data":
            data_lines.append(value)
