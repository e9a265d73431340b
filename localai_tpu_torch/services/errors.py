"""Structured serving errors: one failure vocabulary for every layer (a
copy of localai_tpu/services/errors.py).

The engine tells a request's failure KIND on its stream
(``StreamEvent.error_kind``: shed, timeout, stall) with a crude
retry-after hint; the runner (backend/runner.py::stream) raises the
matching error below, and the HTTP layer (api/app.py) renders it as an
OpenAI-style envelope with its status code and a ``Retry-After`` header.
The port has no gRPC process split yet, so the gRPC half of the JAX
module (``wrap_backend_error``, the trailing-metadata key) is left out.
"""

from __future__ import annotations

from typing import Optional


class ServingError(RuntimeError):
    """Base: a request-level failure with an HTTP mapping."""

    status = 500
    etype = "server_error"
    retryable = False

    def __init__(self, message: str, retry_after_s: float = 0.0,
                 detail: Optional[dict] = None):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s or 0.0)
        self.detail = detail or {}

    def body_extra(self) -> dict:
        """Extra keys merged into the HTTP error object (retryability,
        the retry-after hint) so clients can react without parsing
        messages."""
        out: dict = {}
        if self.retryable:
            out["retryable"] = True
        if self.retry_after_s:
            out["retry_after"] = round(self.retry_after_s, 1)
        out.update(self.detail)
        return out


class OverloadedError(ServingError):
    """Admission control shed the request (bounded queue / queue-wait)."""

    status = 429
    etype = "overloaded"
    retryable = True


class BackendUnavailableError(ServingError):
    """The engine aborted the stream (a stalled device dispatch)."""

    status = 503
    etype = "backend_unavailable"
    retryable = True


class DeadlineExceededError(ServingError):
    """request_timeout_ms expired."""

    status = 504
    etype = "deadline_exceeded"
    retryable = False
