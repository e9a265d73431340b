"""HTTP server on the standard library (counterpart of
localai_tpu/api/app.py, which runs on aiohttp).

``ThreadingHTTPServer``: one thread per connection. Handler threads parse
JSON, submit requests to the model's engine and relay its output queue;
they never touch a CUDA tensor — only the engine thread does. Routes live
in api/openai_routes.py and return a ``Response``: a JSON body, or an
iterator of SSE chunks streamed as ``data: ...`` lines ending with
``data: [DONE]``. A lifecycle refusal (services/errors.py: shed 429,
stall 503, deadline 504) is sent with its status, the JAX server's
envelope and ``Retry-After`` when the engine gave a hint, as
localai_tpu/api/app.py does; a stream is opened only after its first
chunk, so a refusal before the first token gets its real status, and one
after it ends the stream with the same envelope as an event.

Every request goes through the JAX server's correlation middleware: its
``X-Correlation-ID`` header is taken (or an id minted) and handed to the
route, which makes it the engine request's ``request_id`` (the first
choice's; later choices add "-c<i>" / "-p<i>"), so the engine's spans and
events carry the client's id. The request's duration goes into the
``localai_api_call`` histogram under its route, and an "http" span into
the HTTP layer's tracer (services/tracing.py::frontend_tracer), except for
/metrics, /debug/*, /healthz and /readyz. GET routes take (app, query),
POST routes (app, body, correlation id); the observability routes live in
api/localai_routes.py.
"""

from __future__ import annotations

import json
import logging
import math
import re
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Iterator, Optional
from urllib.parse import parse_qsl

from localai_tpu_torch.services.errors import ServingError
from localai_tpu_torch.services.metrics import METRICS
from localai_tpu_torch.services.tracing import frontend_tracer

log = logging.getLogger(__name__)


class ApiError(Exception):
    def __init__(self, message: str, status: int = 400,
                 etype: str = "invalid_request_error"):
        super().__init__(message)
        self.status = status
        self.etype = etype


class Response:
    """A JSON body, a text body with its ``content_type`` (a str body),
    or an SSE stream."""

    def __init__(self, body=None, status: int = 200,
                 stream: Optional[Iterator] = None,
                 content_type: str = "application/json"):
        self.body = body
        self.status = status
        self.stream = stream
        self.content_type = content_type


# observability surfaces get no "http" span: scrapes and debug pulls would
# fill the ring with their own reads of it
_TRACE_SKIP = re.compile(r"^/(metrics|debug/|healthz|readyz)")


def error_body(message: str, status: int, etype: str) -> dict:
    return {"error": {"code": status, "message": message, "type": etype}}


def serving_error_body(e: ServingError) -> dict:
    """A ServingError as the JAX server's envelope: its status and type,
    plus its retryability and retry-after hint (``body_extra``)."""
    body = {"message": str(e), "type": e.etype, "param": None,
            "code": e.status}
    body.update(e.body_extra())
    return {"error": body}


class App:
    """The served models: a ``capabilities.Capabilities`` (``run
    --models-path``: the scanned configs, each model loaded at its first
    request), or fixed models (``run --model``: name ->
    backend.runner.LoadedModel, each under a default model config)."""

    def __init__(self, models: Optional[dict] = None, caps=None):
        from localai_tpu_torch.capabilities import Capabilities

        self.caps = caps or Capabilities("", {}, load_model=None,
                                         loaded=models or {})
        self.started_at = time.time()

    @property
    def models(self) -> dict:
        """The loaded models (name -> LoadedModel)."""
        return self.caps.loaded

    def resolve(self, body: dict) -> tuple:
        """(served name, ModelConfig, LoadedModel) of a request's model:
        the body's, else the only one configured or loaded. A name with
        neither a config, a loaded model nor a model dir is a 404."""
        name = body.get("model") or ""
        known = self.caps.configs or self.models
        if not name and len(known) == 1:
            name = next(iter(known))
        if not name:
            raise ApiError("model is required")
        mc = self.caps.resolve(name)
        if self.caps.load_model is None and name not in self.models:
            raise ApiError(f"model {name} not found", 404)
        try:
            return name, mc, self.caps.load(mc)
        except FileNotFoundError as e:
            raise ApiError(f"model {name} not found: {e}", 404) from e

    def shutdown(self):
        """Stop every engine and drop the models: the per-server handler
        class holds this App in a reference cycle, which only the cycle
        collector frees, and the weights must not wait for it."""
        self.caps.shutdown()


def _handler(app: App):
    from localai_tpu_torch.api import localai_routes
    from localai_tpu_torch.api import openai_routes as routes

    gets = {"/readyz": routes.readyz, "/v1/models": routes.list_models,
            "/models": routes.list_models, **localai_routes.GETS}
    posts = {"/v1/chat/completions": routes.chat_completions,
             "/chat/completions": routes.chat_completions,
             "/v1/completions": routes.completions,
             "/completions": routes.completions,
             "/v1/edits": routes.edits, "/edits": routes.edits,
             "/v1/tokenize": routes.tokenize}

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            log.debug("%s " + fmt, self.address_string(), *args)

        def send_response(self, code, message=None):
            self._status = code          # the http span's status
            super().send_response(code, message)

        def _send_json(self, status: int, obj, headers=(),
                       content_type: str = "application/json"):
            data = (obj if isinstance(obj, str) else json.dumps(obj)).encode()
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def _send_serving_error(self, e: ServingError):
            # a lifecycle refusal (shed / deadline / stall): its status,
            # one warning (no traceback: an overload is expected), and
            # Retry-After when the engine gave a hint
            log.warning("serving error: %s -> %d %s: %s", self.path, e.status,
                        e.etype, e)
            headers = ([("Retry-After", str(math.ceil(e.retry_after_s)))]
                       if e.retry_after_s else [])
            self._send_json(e.status, serving_error_body(e), headers)

        def _write_event(self, obj):
            self.wfile.write(b"data: " + json.dumps(obj).encode() + b"\n\n")
            self.wfile.flush()

        def _send_stream(self, chunks: Iterator):
            # peek the first chunk so a request refused before its first
            # token still gets a real error status, not a 200 stream
            first = next(chunks, None)
            try:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.end_headers()
                self.close_connection = True
                if first is not None:
                    self._write_event(first)
                while True:
                    try:
                        c = next(chunks)
                    except StopIteration:
                        break
                    except ServingError as e:   # headers are out: in-stream
                        log.warning("stream ended by %s: %s", e.etype, e)
                        self._write_event(serving_error_body(e))
                        break
                    except Exception as e:   # headers are out: report in-stream
                        log.exception("stream failed")
                        self._write_event(error_body(str(e), 500, "server_error"))
                        break
                    self._write_event(c)
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()
            except OSError as e:
                # the client went away (a failed write): closing the chunks
                # cancels its request; nothing more goes into the socket
                chunks.close()
                self.close_connection = True
                log.info("stream client disconnected (%s: %s); request "
                         "cancelled", type(e).__name__, e)

        def _dispatch(self, table: dict, body: Optional[dict]):
            # the correlation middleware (module doc)
            t0, t_mono = time.perf_counter(), time.monotonic()
            rid = self.headers.get("X-Correlation-ID") or uuid.uuid4().hex
            path, _, qs = self.path.partition("?")
            self._status = 0
            try:
                self._route(table, body, path, qs, rid)
            finally:
                route = path if path in table else "unmatched"
                METRICS.observe_api_call(self.command, route,
                                         time.perf_counter() - t0)
                tr = frontend_tracer()
                if tr.enabled and not _TRACE_SKIP.match(path):
                    tr.record("http", "http", t_mono, time.monotonic(),
                              rid=rid, args={"method": self.command,
                                             "path": route,
                                             "status": self._status or 500})

        def _route(self, table: dict, body: Optional[dict], path: str,
                   qs: str, rid: str):
            fn = table.get(path)
            if fn is None:
                self._send_json(404, error_body(f"no route {path}", 404,
                                                "invalid_request_error"))
                return
            try:
                resp = (fn(app, body, rid) if body is not None
                        else fn(app, dict(parse_qsl(qs))))
                if resp.stream is not None:
                    self._send_stream(resp.stream)
                else:
                    self._send_json(resp.status, resp.body,
                                    content_type=resp.content_type)
            except ApiError as e:
                self._send_json(e.status, error_body(str(e), e.status, e.etype))
            except ServingError as e:
                self._send_serving_error(e)
            except ValueError as e:
                self._send_json(400, error_body(str(e), 400,
                                                "invalid_request_error"))
            except Exception as e:
                log.exception("handler error: %s", path)
                self._send_json(500, error_body(f"{type(e).__name__}: {e}",
                                                500, "server_error"))

        def do_GET(self):
            self._dispatch(gets, None)

        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            try:
                body = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError:
                self._send_json(400, error_body("invalid JSON body", 400,
                                                "invalid_request_error"))
                return
            if not isinstance(body, dict):
                self._send_json(400, error_body("JSON body must be an object",
                                                400, "invalid_request_error"))
                return
            self._dispatch(posts, body)

    return Handler


class _Server(ThreadingHTTPServer):
    # the listen backlog: the standard library's 5 drops the connects of a
    # burst of arrivals beyond it, which the client retries a second
    # later (a shed then takes ~1 s instead of ~20 ms); 128 is aiohttp's
    request_queue_size = 128
    daemon_threads = True


def make_server(app: App, host: str = "127.0.0.1", port: int = 8080
                ) -> ThreadingHTTPServer:
    """A bound server; run it with ``serve_forever()`` (port 0 picks a
    free port: ``server.server_address``)."""
    return _Server((host, port), _handler(app))
