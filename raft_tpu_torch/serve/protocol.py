"""Length-prefixed JSON wire protocol of the resident solver service
(port of ``raft_tpu.serve.protocol``: the same frames, requests and
responses, so a client of one daemon speaks to the other).

Framing: every message is a 4-byte big-endian unsigned length followed by
that many bytes of UTF-8 JSON (one object per frame).  Both directions
use the same framing; a frame larger than :data:`MAX_FRAME` is a
protocol error (a malformed or hostile peer must not make the daemon
allocate unbounded buffers).

Request schema (``op`` selects the kind)::

    {"op": "solve", "id": "...", "design": <name|path|dict>,
     "Hs": 8.0, "Tp": 12.0}                        -> 1 lane
    {"op": "dlc",   "id": "...", "design": ...,
     "cases": [[Hs, Tp], ...]}                     -> N lanes, one bucket
    {"op": "sweep", "id": "...", "designs": [...],
     "Hs": 8.0, "Tp": 12.0}                        -> N lanes, >= 1 buckets
    {"op": "ping"} | {"op": "stats"} | {"op": "refresh"}
                   | {"op": "shutdown"}

``design`` accepts a shipped-design alias (``"oc3"``, ``"oc4"``,
``"oc4_2"``, ``"volturnus"`` — case-insensitive, also the full YAML stem
like ``"OC3spar"``), an absolute YAML path, or an inline design dict
(the :func:`raft_tpu_torch.model.load_design` passthrough).

Any solve-kind request may additionally carry a ``"trace"`` string: the
request-scoped trace id every span of its life is recorded under
(client submit, reader parse/stage, queue wait, batch solve, delivery).
The client mints one per request when the caller didn't
(:func:`raft_tpu_torch.obs.trace.new_trace_id`); the server adopts it — so a
Perfetto trace exported on either side groups one request's spans
across processes AND threads by the same id.

Response: ``{"id": ..., "ok": true, "results": [<per-lane dict>, ...],
"health": {...}, "t_queue_s": [...], "trace": ..., "server": {...}}``
with one result row per requested lane, in request order — a multi-lane
request (``dlc``/``sweep``) answers once, after its last lane's batch
lands.  Errors: ``{"id": ..., "ok": false, "error": {"class": ...,
"detail": ...}}``.

Load shedding (the fleet router, :mod:`raft_tpu_torch.serve.router`): a
request refused by admission control answers immediately with the typed
``overloaded`` error — ``{"id": ..., "ok": false, "shed": true,
"retry_after_ms": <hint>, "error": {"class": "Overloaded", "detail":
...}}``.  Solves are pure, so a shed request is safe to re-submit after
the hint; the single-daemon server never sheds (its micro-batch queue is
its own backpressure).

The ``stats`` op answers with the live telemetry snapshot::

    {"id": ..., "ok": true, "op": "stats",
     "solver": {...},                  # per-bucket batches/occupancy,
                                       # kernel builds, arm-time knobs
     "queue": {...}, "queue_depth": {...},
     "telemetry": {
        "uptime_s": ..., "window_s": ...,
        "latency": {count, p50, p90, p99, errors, error_rate, ...},
        "queue_wait": {"<SxNxW>": {...same windowed shape...}, ...},
        "error_budget": {"requests", "errors", "error_rate"},
        "flight": {"capacity", "size", "recorded", "errors"},
        "compiles": ..., "ledger": {...}, "cache_enabled": ...}}

(the windowed quantiles are deterministic rank-walk values over the
sliding sub-window ring of :class:`raft_tpu_torch.obs.metrics.
SlidingHistogram`).  ``compiles`` counts the kernel libraries this
process built (the JAX daemon's counts its executables), ``ledger`` is
:func:`raft_tpu_torch.obs.ledger.stat` and ``cache_enabled`` the cache
switch.  ``refresh`` answers ``staged_lanes_dropped`` and
``executables_evicted`` (the kernel libraries evicted from the registry's
memo).
"""
from __future__ import annotations

import json
import os
import struct

#: hard per-frame cap (requests are small; responses carry (6,) stats per
#: lane, not spectra — 32 MiB is orders of magnitude of headroom)
MAX_FRAME = 32 * 1024 * 1024

_LEN = struct.Struct(">I")

#: shipped-design aliases -> YAML stems in the shipped designs' directory
#: (:data:`raft_tpu_torch.cli.DESIGNS`, read as data files)
DESIGN_ALIASES = {
    "oc3": "OC3spar",
    "oc3spar": "OC3spar",
    "oc4": "OC4semi",
    "oc4semi": "OC4semi",
    "oc4_2": "OC4semi_2",
    "oc4semi_2": "OC4semi_2",
    "volturnus": "VolturnUS-S",
    "volturnus-s": "VolturnUS-S",
}

OPS = ("solve", "dlc", "sweep", "ping", "stats", "refresh", "shutdown")


class ProtocolError(ValueError):
    """Malformed frame or request — the connection answers with an error
    response (and stays up: one bad request must not drop a client whose
    other requests are already queued)."""


class PeerClosed(ConnectionError):
    """The peer closed the stream mid-frame (or before one started)."""


class Overloaded(RuntimeError):
    """Typed load-shed signal: the fleet refused admission (capacity or
    error budget).  Carried on the wire as ``error.class == "Overloaded"``
    plus a top-level ``retry_after_ms`` hint — solves are pure, so the
    client may simply re-submit after the hint."""


def send_msg(sock, obj) -> None:
    """Serialize ``obj`` and write one length-prefixed frame."""
    payload = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(payload) > MAX_FRAME:
        raise ProtocolError(f"frame of {len(payload)} bytes exceeds "
                            f"MAX_FRAME={MAX_FRAME}")
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise PeerClosed(f"peer closed after {len(buf)}/{n} bytes")
        buf.extend(chunk)
    return bytes(buf)


def recv_msg(sock):
    """Read one length-prefixed JSON frame; raises :class:`PeerClosed` on
    EOF at a frame boundary, :class:`ProtocolError` on an oversized or
    non-JSON frame."""
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if n > MAX_FRAME:
        raise ProtocolError(f"peer announced a {n}-byte frame "
                            f"(MAX_FRAME={MAX_FRAME})")
    data = _recv_exact(sock, n)
    try:
        return json.loads(data.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"undecodable frame: {e}") from None


def resolve_design(spec):
    """A request's ``design`` field -> something
    :func:`raft_tpu_torch.model.load_design` accepts, plus a short stable
    label for metrics/logs.  Aliases resolve to the shipped YAMLs."""
    if isinstance(spec, dict):
        return spec, "<inline>"
    if not isinstance(spec, str) or not spec:
        raise ProtocolError(f"design must be a name, path, or dict; got "
                            f"{type(spec).__name__}")
    stem = DESIGN_ALIASES.get(spec.strip().lower())
    if stem is not None:
        from raft_tpu_torch.cli import DESIGNS

        return str(DESIGNS / (stem + ".yaml")), stem
    if os.path.isfile(spec):
        return spec, os.path.splitext(os.path.basename(spec))[0]
    raise ProtocolError(
        f"unknown design {spec!r}: not a shipped alias "
        f"({sorted(set(DESIGN_ALIASES))}) nor an existing YAML path")


def _sea_state(obj, key_hs="Hs", key_tp="Tp"):
    try:
        Hs, Tp = float(obj[key_hs]), float(obj[key_tp])
    except KeyError as e:
        raise ProtocolError(f"request is missing {e.args[0]!r}") from None
    except (TypeError, ValueError):
        raise ProtocolError(
            f"{key_hs}/{key_tp} must be numbers; got "
            f"{obj.get(key_hs)!r}/{obj.get(key_tp)!r}") from None
    if not (Hs >= 0.0):          # NaN fails this too
        raise ProtocolError(f"Hs must be >= 0, got {Hs!r}")
    return Hs, Tp


def parse_request(obj) -> dict:
    """Validate one inbound request object; returns a normalized dict
    ``{"op", "id", "lanes": [(design, label, Hs, Tp), ...]}`` (``lanes``
    empty for the control ops).  Raises :class:`ProtocolError` with a
    client-facing message on anything malformed."""
    if not isinstance(obj, dict):
        raise ProtocolError(f"request must be a JSON object, got "
                            f"{type(obj).__name__}")
    op = obj.get("op")
    if op not in OPS:
        raise ProtocolError(f"unknown op {op!r}; have {OPS}")
    tr = obj.get("trace")
    if tr is not None and not isinstance(tr, str):
        raise ProtocolError(f"'trace' must be a string; got "
                            f"{type(tr).__name__}")
    out = {"op": op, "id": obj.get("id"), "lanes": [],
           "trace": tr or None}
    if op in ("ping", "stats", "refresh", "shutdown"):
        return out
    if out["id"] is None:
        raise ProtocolError(f"{op!r} request needs an 'id'")
    if op == "solve":
        design, label = resolve_design(obj.get("design"))
        Hs, Tp = _sea_state(obj)
        out["lanes"] = [(design, label, Hs, Tp)]
    elif op == "dlc":
        design, label = resolve_design(obj.get("design"))
        cases = obj.get("cases")
        if not isinstance(cases, list) or not cases:
            raise ProtocolError("'dlc' needs a non-empty 'cases' list of "
                                "[Hs, Tp] rows")
        for row in cases:
            if not isinstance(row, (list, tuple)) or len(row) != 2:
                raise ProtocolError(f"'dlc' case rows are [Hs, Tp]; got "
                                    f"{row!r}")
            Hs, Tp = _sea_state({"Hs": row[0], "Tp": row[1]})
            out["lanes"].append((design, label, Hs, Tp))
    else:                                    # sweep
        designs = obj.get("designs")
        if not isinstance(designs, list) or not designs:
            raise ProtocolError("'sweep' needs a non-empty 'designs' list")
        Hs, Tp = _sea_state(obj)
        for spec in designs:
            design, label = resolve_design(spec)
            out["lanes"].append((design, label, Hs, Tp))
    return out


def error_response(req_id, exc) -> dict:
    return {"id": req_id, "ok": False,
            "error": {"class": type(exc).__name__,
                      "detail": str(exc)[-500:]}}


def overloaded_response(req_id, retry_after_ms: float,
                        detail: str = "") -> dict:
    """The typed shed response (see the module docstring): an
    ``Overloaded`` error frame with a ``retry_after_ms`` hint."""
    return {"id": req_id, "ok": False, "shed": True,
            "retry_after_ms": round(float(retry_after_ms), 3),
            "error": {"class": "Overloaded",
                      "detail": detail or "fleet admission refused; "
                                          "retry after the hint"}}
