"""Versioned JSON wire format for networked diagnosis serving.

One envelope generation (:data:`PROTOCOL_VERSION`) carries three payload
kinds between :class:`~repro_torch.serve.client.LeoClient` and the HTTP
front-end:

  * **requests** — an :class:`~repro_torch.core.service.AnalyzeRequest` dict
    plus transport concerns the core schema deliberately does not know
    about: the client's *accepted Diagnosis schema range* and an optional
    per-request deadline;
  * **results** — a single ``Diagnosis`` dict or a ``{backend: dict}``
    fan-out map, stamped with the negotiated schema version and the
    server-side queue/service timings;
  * **errors** — machine-readable ``code`` + message + optional
    ``retry_after`` hint, mirrored into the HTTP status / ``Retry-After``
    header by the front-end.

Schema-version negotiation (the v1–v6 ``Diagnosis`` migration, across
the wire): the client advertises ``accept_schema`` — the newest
Diagnosis schema generation it understands.  The server answers at
``min(SCHEMA_VERSION, accept_schema)``, **downgrading** the payload by
dropping the sections newer generations added (``occupancy`` for
pre-v6, ``rewrites`` for pre-v5, ``advice`` for pre-v4,
``issue_pressure`` for pre-v3, ``sync_resources`` for pre-v2) —
exactly the inverse of the ``Diagnosis.from_dict`` forward migration,
so:

  * an old (v5) client against a v6 server receives a genuine v5 payload
    its own ``from_dict`` accepts;
  * a new (v6) client against an old (v5) server receives a v5 payload
    that its ``from_dict`` migrates forward with explicit "not recorded"
    defaults.

Either direction round-trips without either side knowing the other's
version in advance — asserted in ``tests/test_serve_net.py``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple, Union

from ..core.report import MIN_SCHEMA_VERSION, SCHEMA_VERSION, Diagnosis
from ..core.service import AnalyzeRequest

#: Envelope generation.  Bump when the *envelope* layout changes
#: incompatibly (the Diagnosis schema inside it has its own version and
#: its own negotiation).
PROTOCOL_VERSION = 1

#: Oldest envelope generation the server still decodes.
MIN_PROTOCOL_VERSION = 1

#: Machine-readable error codes carried in error envelopes.  The server
#: maps them onto HTTP statuses; the client maps them back onto
#: retry/no-retry decisions.
ERROR_CODES = {
    "bad_json": 400,
    "protocol_version": 400,
    "schema_negotiation": 400,
    "invalid_request": 400,
    "not_found": 404,
    "method_not_allowed": 405,
    "overloaded": 429,
    "internal": 500,
    "draining": 503,
    "deadline_exceeded": 504,
}


class ProtocolError(Exception):
    """A wire payload the peer cannot serve; carries the machine code
    and the HTTP status the front-end should answer with."""

    def __init__(self, code: str, message: str,
                 retry_after: Optional[float] = None):
        super().__init__(message)
        self.code = code
        self.message = message
        self.retry_after = retry_after
        self.http_status = ERROR_CODES.get(code, 500)


def negotiate_schema(accept_schema: int) -> int:
    """The Diagnosis schema version the server will answer with: the
    newest generation both sides understand."""
    if accept_schema < MIN_SCHEMA_VERSION:
        raise ProtocolError(
            "schema_negotiation",
            f"client accepts Diagnosis schema <= {accept_schema}, but the "
            f"oldest this server can emit is {MIN_SCHEMA_VERSION}")
    return min(SCHEMA_VERSION, accept_schema)


def downgrade_diagnosis_dict(data: Dict[str, Any],
                             target: int) -> Dict[str, Any]:
    """Re-shape a Diagnosis dict as an older schema generation by
    dropping the sections newer generations added (the inverse of the
    ``from_dict`` forward migration).  Shallow-copies; never mutates the
    input."""
    current = data.get("schema_version", SCHEMA_VERSION)
    if target > current:
        raise ProtocolError(
            "schema_negotiation",
            f"cannot upgrade a v{current} payload to v{target} on the "
            f"wire; upgrading is the reader's from_dict migration")
    if target < MIN_SCHEMA_VERSION:
        raise ProtocolError(
            "schema_negotiation",
            f"cannot downgrade below schema v{MIN_SCHEMA_VERSION}")
    if target == current:
        return data
    out = dict(data)
    if target < 6:
        out.pop("occupancy", None)
    if target < 5:
        out.pop("rewrites", None)
    if target < 4:
        out.pop("advice", None)
    if target < 3:
        out.pop("issue_pressure", None)
    if target < 2:
        out.pop("sync_resources", None)
    out["schema_version"] = target
    return out


# --------------------------------------------------------------------------
# Requests.
# --------------------------------------------------------------------------

@dataclass
class WireRequest:
    """A decoded request envelope: the core request plus transport
    concerns (negotiated schema, deadline)."""

    request: AnalyzeRequest
    accept_schema: int = SCHEMA_VERSION
    negotiated_schema: int = SCHEMA_VERSION
    deadline_seconds: Optional[float] = None
    protocol_version: int = PROTOCOL_VERSION


def encode_request(request: AnalyzeRequest, *,
                   accept_schema: int = SCHEMA_VERSION,
                   deadline_seconds: Optional[float] = None) -> bytes:
    """Client side: wrap an ``AnalyzeRequest`` in the envelope.  The
    request's own ``schema_version`` is deliberately NOT sent — request
    fields are stable across Diagnosis schema generations, and pinning
    the sender's constant would make every cross-version call fail
    ``validate()`` on the other side.  The envelope's ``accept_schema``
    is the version negotiation."""
    body = request.to_dict()
    body.pop("schema_version", None)
    return json.dumps({
        "protocol_version": PROTOCOL_VERSION,
        "accept_schema": accept_schema,
        "deadline_seconds": deadline_seconds,
        "request": body,
    }, sort_keys=False).encode("utf-8")


def decode_request(payload: Union[bytes, str]) -> WireRequest:
    """Server side: decode + validate an envelope, negotiating the
    response schema.  Raises :class:`ProtocolError` with the right HTTP
    status for every malformed shape."""
    try:
        data = json.loads(payload)
    except (ValueError, UnicodeDecodeError) as e:
        raise ProtocolError("bad_json", f"request body is not JSON: {e}")
    if not isinstance(data, dict):
        raise ProtocolError("bad_json", "request envelope must be an object")
    version = data.get("protocol_version")
    if not isinstance(version, int) or \
            not (MIN_PROTOCOL_VERSION <= version <= PROTOCOL_VERSION):
        raise ProtocolError(
            "protocol_version",
            f"protocol_version {version!r} outside supported range "
            f"[{MIN_PROTOCOL_VERSION}, {PROTOCOL_VERSION}]")
    accept = data.get("accept_schema", SCHEMA_VERSION)
    if not isinstance(accept, int):
        raise ProtocolError("schema_negotiation",
                            f"accept_schema must be an int, "
                            f"got {accept!r}")
    negotiated = negotiate_schema(accept)
    deadline = data.get("deadline_seconds")
    if deadline is not None and (not isinstance(deadline, (int, float))
                                 or deadline <= 0):
        raise ProtocolError("invalid_request",
                            f"deadline_seconds must be a positive number, "
                            f"got {deadline!r}")
    body = data.get("request")
    if not isinstance(body, dict):
        raise ProtocolError("invalid_request",
                            "envelope is missing the request object")
    body = dict(body)
    # the request schema rides the envelope negotiation: rebuild against
    # THIS server's generation so AnalyzeRequest.validate() checks fields,
    # not the sender's constant
    body["schema_version"] = SCHEMA_VERSION
    try:
        request = AnalyzeRequest.from_dict(body)
        request.validate()
    except (ValueError, TypeError, KeyError) as e:
        raise ProtocolError("invalid_request", str(e))
    return WireRequest(request=request, accept_schema=accept,
                       negotiated_schema=negotiated,
                       deadline_seconds=float(deadline)
                       if deadline is not None else None,
                       protocol_version=version)


# --------------------------------------------------------------------------
# Responses.
# --------------------------------------------------------------------------

@dataclass
class WireResponse:
    """A decoded response envelope (success or error)."""

    ok: bool
    kind: str = ""                      # "diagnosis" | "fanout" | "error"
    schema_version: int = SCHEMA_VERSION
    request_id: Optional[str] = None
    payload: Optional[Dict[str, Any]] = None   # raw dict(s), pre-migration
    timing: Dict[str, float] = field(default_factory=dict)
    error_code: Optional[str] = None
    error_message: Optional[str] = None
    retry_after: Optional[float] = None

    def result(self) -> Union[Diagnosis, Dict[str, Diagnosis]]:
        """Materialize typed results, running each payload through the
        reader-side ``from_dict`` migration (older-generation payloads
        gain their explicit "not recorded" defaults here)."""
        if not self.ok:
            raise ProtocolError(self.error_code or "internal",
                                self.error_message or "server error",
                                retry_after=self.retry_after)
        if self.kind == "diagnosis":
            return Diagnosis.from_dict(self.payload)
        if self.kind == "fanout":
            return {name: Diagnosis.from_dict(d)
                    for name, d in self.payload.items()}
        raise ProtocolError("bad_json",
                            f"unknown response kind {self.kind!r}")


def encode_result(result: Union[Diagnosis, Dict[str, Diagnosis]], *,
                  schema_version: int = SCHEMA_VERSION,
                  request_id: Optional[str] = None,
                  timing: Optional[Dict[str, float]] = None) -> bytes:
    """Server side: envelope a submit() result, downgraded to the
    negotiated schema."""
    if isinstance(result, Diagnosis):
        kind = "diagnosis"
        payload: Dict[str, Any] = downgrade_diagnosis_dict(
            result.to_dict(), schema_version)
    else:
        kind = "fanout"
        payload = {name: downgrade_diagnosis_dict(d.to_dict(),
                                                  schema_version)
                   for name, d in result.items()}
    return json.dumps({
        "protocol_version": PROTOCOL_VERSION,
        "ok": True,
        "kind": kind,
        "schema_version": schema_version,
        "request_id": request_id,
        "timing": timing or {},
        kind: payload,
    }, sort_keys=False).encode("utf-8")


def encode_error(code: str, message: str, *,
                 retry_after: Optional[float] = None,
                 request_id: Optional[str] = None) -> Tuple[bytes, int]:
    """Server side: (error envelope, HTTP status)."""
    payload = json.dumps({
        "protocol_version": PROTOCOL_VERSION,
        "ok": False,
        "kind": "error",
        "request_id": request_id,
        "error": {"code": code, "message": message,
                  "retry_after": retry_after},
    }, sort_keys=False).encode("utf-8")
    return payload, ERROR_CODES.get(code, 500)


def decode_response(payload: Union[bytes, str]) -> WireResponse:
    """Client side: decode either envelope shape.  Raises
    :class:`ProtocolError` only for undecodable bytes; a well-formed
    *error* envelope decodes fine and raises from :meth:`WireResponse.
    result` so the caller sees code/retry_after."""
    try:
        data = json.loads(payload)
    except (ValueError, UnicodeDecodeError) as e:
        raise ProtocolError("bad_json", f"response body is not JSON: {e}")
    if not isinstance(data, dict) or "ok" not in data:
        raise ProtocolError("bad_json", "response envelope malformed")
    if not data["ok"]:
        err = data.get("error") or {}
        return WireResponse(
            ok=False, kind="error", request_id=data.get("request_id"),
            error_code=err.get("code", "internal"),
            error_message=err.get("message", "server error"),
            retry_after=err.get("retry_after"))
    kind = data.get("kind")
    if kind not in ("diagnosis", "fanout") or kind not in data:
        raise ProtocolError("bad_json",
                            f"response kind {kind!r} malformed")
    return WireResponse(
        ok=True, kind=kind,
        schema_version=data.get("schema_version", SCHEMA_VERSION),
        request_id=data.get("request_id"),
        payload=data[kind],
        timing=data.get("timing") or {})
