"""Bounded ingestion and shared-secret auth for the stdlib HTTP surfaces
(port of ``openmp_parallel_computing_tpu.utils.httpguard``, the same
behaviour).

The HTTP handlers read request bodies of ``Content-Length`` bytes.
Unbounded, that is a one-request OOM: a crafted header commits the
process to buffering an arbitrarily large body. :func:`read_body` rejects
an oversized request from the *declared* length, before a single payload
byte is read, so memory stays bounded by the configured cap whatever the
client sends. :func:`token_ok` is the shared-secret header check for
routes that mutate state.
"""

from __future__ import annotations

import hmac

AUTH_HEADER = "X-Auth-Token"


class BodyTooLarge(ValueError):
    """Declared request body exceeds the surface's ingestion cap."""

    def __init__(self, declared: int, limit: int):
        super().__init__(f"request body {declared} B exceeds the "
                         f"{limit} B limit for this endpoint")
        self.declared = declared
        self.limit = limit


def read_body(handler, limit: int) -> bytes:
    """Read ``handler``'s request body, bounded by ``limit`` bytes.

    Raises :class:`BodyTooLarge` from the declared ``Content-Length``
    BEFORE reading any payload (the caller maps it to 413 and closes the
    connection — ``send_error`` already marks ``Connection: close``, which
    also unsticks a client mid-upload). A missing header reads as an empty
    body; a malformed one is a ``ValueError`` (caller's 400/500 path).
    The read itself is also clamped to the declared length, so a client
    that lies small cannot stream extra bytes into memory.
    """
    raw = handler.headers.get("Content-Length")
    if raw is None:
        return b""
    try:
        declared = int(raw)
    except ValueError:
        raise ValueError(f"malformed Content-Length {raw!r}") from None
    if declared < 0:
        raise ValueError(f"malformed Content-Length {raw!r}")
    if declared > limit:
        raise BodyTooLarge(declared, limit)
    return handler.rfile.read(declared)


def token_ok(handler, token: str) -> bool:
    """Constant-time shared-secret check against :data:`AUTH_HEADER`.

    An empty configured ``token`` disables the gate (single-host default,
    matching the filesystem backend which is protected by file
    permissions instead).
    """
    if not token:
        return True
    supplied = handler.headers.get(AUTH_HEADER, "")
    return hmac.compare_digest(supplied.encode(), token.encode())
