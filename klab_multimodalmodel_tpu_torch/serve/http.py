"""HTTP front-end for :class:`CaptionService` (stdlib only): the port's copy
of the JAX package's ``serve/http.py``.

Endpoints:
  * ``POST /caption`` — JSON body ``{"image_b64": <base64 of an encoded
    image file>, "prompt"?: str, "max_length"?: int, "num_beams"?: int,
    "do_sample"?: bool, "temperature"?: float, "top_k"?: int,
    "top_p"?: float, "min_length"?: int, "repetition_penalty"?: float,
    "no_repeat_ngram_size"?: int}`` -> ``{"caption": str}``.
  * ``POST /caption_stream`` — same body plus ``"chunk_size"?: int``;
    responds ``text/event-stream`` (SSE): one
    ``data: {"caption": <cumulative text>, "done": bool}`` event after
    the first generated token and then every ``chunk_size`` tokens
    (greedy/sampling only — ``num_beams`` must be 1). The connection
    closes after the ``done: true`` event; a client disconnect stops the
    stream's device work at the next chunk boundary.
  * ``GET /healthz`` — 200 ``{"status": "ok"}`` once warmup finished,
    503 before (load balancers gate on this so no request pays the first
    call's set-up).
  * ``GET /stats`` — batching/latency counters.

``ThreadingHTTPServer`` gives one thread per in-flight request; threads do
host work (JSON, base64, JPEG decode) concurrently and block on the
service's single device dispatcher for the model call.
"""

from __future__ import annotations

import base64
import binascii
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .service import CaptionService, GenParams, normalize_gen_params

# Request bodies are one base64 image + a few scalars; anything bigger is
# abuse (the body is read fully into memory before decode).
MAX_BODY_BYTES = 32 * 1024 * 1024

_GEN_FIELDS = {
    "max_length": int, "num_beams": int, "do_sample": bool,
    "temperature": float, "top_k": int, "top_p": float, "min_length": int,
    "repetition_penalty": float, "no_repeat_ngram_size": int,
}


def _gen_params(body: dict, default: GenParams) -> GenParams:
    kwargs = {}
    for name, typ in _GEN_FIELDS.items():
        if name in body:
            value = body[name]
            if typ is bool and not isinstance(value, bool):
                raise ValueError(f"{name} must be a JSON boolean")
            kwargs[name] = typ(value)
    kwargs.setdefault("max_length", default.max_length)
    kwargs.setdefault("num_beams", default.num_beams)
    return GenParams(**kwargs)


class _Handler(BaseHTTPRequestHandler):
    # Set by make_server on the handler class.
    service: CaptionService
    ready: threading.Event
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet by default; obs has the stats
        pass

    def _send(self, code: int, payload: dict) -> None:
        data = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
        if self.path == "/healthz":
            if self.ready.is_set():
                self._send(200, {"status": "ok"})
            else:
                self._send(503, {"status": "warming up"})
        elif self.path == "/stats":
            self._send(200, self.service.stats.snapshot())
        else:
            self._send(404, {"error": f"no route {self.path}"})

    def do_POST(self):  # noqa: N802
        # Read (or refuse) the body BEFORE any early return: this handler
        # speaks HTTP/1.1 keep-alive, and an unread body would be parsed as
        # the connection's next request line, corrupting every subsequent
        # request from that client.
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            length = -1
        if length < 0 or length > MAX_BODY_BYTES:
            self.close_connection = True  # can't cheaply drain; drop conn
            self._send(413, {"error": f"Content-Length must be in "
                                      f"[0, {MAX_BODY_BYTES}]"})
            return
        raw = self.rfile.read(length)
        if self.path not in ("/caption", "/caption_stream"):
            self._send(404, {"error": f"no route {self.path}"})
            return
        if not self.ready.is_set():
            self._send(503, {"error": "warming up"})
            return
        try:
            body = json.loads(raw)
            image = base64.b64decode(body["image_b64"], validate=True)
            gen = _gen_params(body, self.service.default_params)
            gen = normalize_gen_params(gen, self.service.max_gen_length)
        except (KeyError, ValueError, TypeError, binascii.Error,
                json.JSONDecodeError) as e:
            self._send(400, {"error": f"bad request: {e}"})
            return
        if self.path == "/caption_stream":
            self._stream_caption(body, image, gen)
            return
        try:
            caption = self.service.caption_bytes(
                image, prompt=body.get("prompt"), gen=gen)
        except (OSError, ValueError) as e:  # undecodable image bytes
            self._send(400, {"error": f"bad image: {e}"})
            return
        except TimeoutError as e:
            self._send(504, {"error": str(e)})
            return
        except Exception as e:  # noqa: BLE001 — model-side failure
            self._send(500, {"error": f"{type(e).__name__}: {e}"})
            return
        self._send(200, {"caption": caption})

    def _stream_caption(self, body: dict, image: bytes, gen) -> None:
        """Serve one SSE stream. Validation errors before the first event
        are ordinary JSON responses; once streaming has begun, errors
        become a final SSE ``{"error": ...}`` event (the status line is
        already on the wire)."""
        chunk_size = body.get("chunk_size")
        if chunk_size is not None and not isinstance(chunk_size, int):
            self._send(400, {"error": "chunk_size must be an integer"})
            return
        try:
            events = self.service.caption_stream_bytes(
                image, prompt=body.get("prompt"), gen=gen,
                chunk_size=chunk_size)
            # Pull the first event BEFORE committing to SSE so bad
            # images / bad params still produce a clean 400.
            first = next(events)
        except (OSError, ValueError) as e:
            self._send(400, {"error": f"bad request: {e}"})
            return
        except TimeoutError as e:
            self._send(504, {"error": str(e)})
            return
        except Exception as e:  # noqa: BLE001 — model-side failure
            self._send(500, {"error": f"{type(e).__name__}: {e}"})
            return
        # SSE has no Content-Length; close the connection when done
        # (keep-alive would make the event stream's end ambiguous).
        self.close_connection = True
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()

        def emit(payload: dict) -> None:
            self.wfile.write(
                b"data: " + json.dumps(payload).encode() + b"\n\n")
            self.wfile.flush()

        try:
            caption, done = first
            emit({"caption": caption, "done": done})
            for caption, done in events:
                emit({"caption": caption, "done": done})
        except (BrokenPipeError, ConnectionResetError):
            # Client went away: dropping the generator stops further
            # chunk jobs, so an abandoned stream stops costing device
            # work at the next chunk boundary.
            events.close()
        except Exception as e:  # noqa: BLE001 — mid-stream failure
            try:
                emit({"error": f"{type(e).__name__}: {e}", "done": True})
            except OSError:
                pass


class CaptionHTTPServer:
    """Owns the socket + service lifecycle. ``start()`` binds immediately
    (healthz answers 503), warms up in the caller's thread, then flips
    ready. ``port`` of 0 picks an ephemeral port (tests)."""

    def __init__(self, service: CaptionService, host: str = "0.0.0.0",
                 port: int = 8000):
        self.service = service
        handler = type("BoundHandler", (_Handler,), {
            "service": service, "ready": threading.Event()})
        self._handler = handler
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.httpd.daemon_threads = True
        self._serve_thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self, warmup: bool = True) -> None:
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, name="klab-serve-http",
            daemon=True)
        self._serve_thread.start()
        if warmup:
            self.service.warmup()
        self._handler.ready.set()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=10)
        self.service.close()
