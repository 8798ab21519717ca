"""Typed serving exceptions — callers must be able to tell retryable
overload apart from programming errors.

Every class keeps the pre-hardening builtin it replaces as a BASE, so
existing `except RuntimeError` / `except KeyError` / `except ValueError`
call sites (and tests) keep working unchanged:

    ServiceError                      common base (mix-in, never raised)
      ServiceClosed (RuntimeError)    submit()/update after close()
      QueueFull     (RuntimeError)    admission refused — RETRYABLE; carries
                                      retry_after_ms (drain-time estimate)
        RequestShed (QueueFull)       an ADMITTED request was shed by the
                                      shed-oldest overload policy — same
                                      retryable contract, delivered through
                                      the request's Future
      KeyBusy       (RuntimeError)    register() on a key with pending work
      UnregisteredKey (KeyError)      submit()/update on an unknown key
      BadRequest    (ValueError)      malformed x / vals / matrix argument
        RoutedElsewhere (BadRequest)  a sharded-key update on a PLAIN
                                      SpmvService — the multi-shard
                                      router owns that lifecycle (neither
                                      is ported yet, so it never fires)

Retry discipline: `isinstance(e, QueueFull)` (which covers RequestShed)
means "back off retry_after_ms and resend the same request"; everything
else is terminal for that request.
"""
from __future__ import annotations


class ServiceError(Exception):
    """Mix-in base for every typed serving error."""


class ServiceClosed(ServiceError, RuntimeError):
    """The service has been close()d; no further work is accepted."""


class QueueFull(ServiceError, RuntimeError):
    """Admission control refused the request (overload) — retryable.

    retry_after_ms is the service's estimate of when capacity frees up
    (queue depth over dispatch rate, floored at one batch window).
    """

    def __init__(self, msg: str, retry_after_ms: float = 0.0):
        super().__init__(msg)
        self.retry_after_ms = float(retry_after_ms)


class RequestShed(QueueFull):
    """An admitted request was evicted by the shed-oldest policy to make
    room for newer work. Delivered through the shed request's Future."""


class KeyBusy(ServiceError, RuntimeError):
    """register() refused: the key has queued or in-flight requests."""


class UnregisteredKey(ServiceError, KeyError):
    """The request names a matrix key that was never register()ed."""

    def __str__(self) -> str:  # KeyError.__str__ repr()s the message
        return self.args[0] if self.args else ""


class BadRequest(ServiceError, ValueError):
    """Malformed request payload (wrong shape/nnz/dtype) — a programming
    error at the call site, never retryable."""


class RoutedElsewhere(BadRequest):
    """update_values/update_structure on a SHARDED key of a plain
    SpmvService: the per-shard replan lifecycle (generation-tagged swap
    per shard, siblings keep serving) lives in the multi-shard router.
    The port has neither sharded keys nor the router yet, so nothing
    raises it. Subclasses BadRequest, so `except ValueError` /
    `except BadRequest` call sites keep working unchanged."""
