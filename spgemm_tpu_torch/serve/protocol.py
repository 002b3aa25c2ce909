"""spgemmd wire protocol: versioned newline-delimited JSON over a unix domain
socket and, knob-gated, the same bytes over TCP (the port's copy of the JAX
package's `serve/protocol.py`, so a client of either package talks to a
daemon of either).

One request per line, one response line per request; a connection may
carry any number of requests.  Requests are `{"v": <version>, "op": <op>,
...}`, responses `{"v": 4, "ok": true, ...}` or `{"v": 4, "ok": false,
"error": {"code": <code>, "message": <text>}}`.  A malformed line gets a
structured bad-request answer and never reaches past the connection
handler.

Ops:
  submit   {folder, options?, tenant?, trace?} -> {id, state, queued, trace}
  status   {id}                -> {job: <snapshot>}
  wait     {id, timeout?}      -> {job: <snapshot>}, when the job is terminal
                                  or the wait (at most the daemon's
                                  MAX_WAIT_SLICE_S) ran out
  stats    {}                  -> daemon-wide state (degrade, queue, slice,
                                  journal, plan cache, delta, warm store,
                                  flight recorder, event log, the profiling
                                  digest, the SLO report)
  metrics  {}                  -> {text: Prometheus text-format 0.0.4,
                                  content_type}
  trace    {}                  -> {spans, trace_events: the flight recorder
                                  as trace_event JSON}
  events   {n?}                -> {events: the newest n event records,
                                  log: the event log's stats}
  profile  {}                  -> {profile: the profiling report -- build
                                  records, device memory watermark,
                                  estimator and delta accountability}
  slo      {}                  -> {slo: the SLO report -- objectives,
                                  per-tenant quantiles, error ratio,
                                  queue-wait share, burn state}
  shutdown {}                  -> {stopping: true}

The version rules are the JAX package's: a client stamps version_for(msg),
the lowest version carrying its optional fields (tenant: v2, trace: v3),
and after a version-mismatch answer retries once at the best version both
speak, with the newer fields stripped (strip_for_version).

CHAIN_BACKENDS are the port's backends.  The daemon also takes the JAX
package's names `xla` and `pallas` and runs both as `exact`
(BACKEND_ALIASES): both are the exact fold there, so a JAX client's submit
stays valid.  Imports the standard library and the knob registry only.
"""

from __future__ import annotations

import json
import os
import re
import tempfile

from spgemm_tpu_torch.utils import knobs

PROTOCOL_VERSION = 4

# versions the daemon speaks: v2 added the submit `tenant`, v3 the submit
# `trace`, v4 the fleet router's response fields only
ACCEPTED_VERSIONS = (1, 2, 3, 4)

# The declarative wire registry, one table per direction: op -> field ->
# the lowest protocol version whose daemons understand it.  The PRO lint
# rule (analysis/protorules.py) holds every literal wire-field key at the
# call sites to these tables, the DRF audit flags a declared field no site
# references, version_for()/strip_for_version() derive from them, and
# ARCHITECTURE.md's generated protocol table renders them.

# fields any message may carry regardless of op (the envelope)
ENVELOPE_FIELDS = {"v": 1, "op": 1, "ok": 1, "error": 1}

REQUEST_FIELDS: dict[str, dict[str, int]] = {
    "submit": {"folder": 1, "options": 1, "tenant": 2, "trace": 3},
    "status": {"id": 1},
    "wait": {"id": 1, "timeout": 1},
    "stats": {},
    "metrics": {},
    "trace": {},
    "profile": {},
    "events": {"n": 1},
    "slo": {},
    "shutdown": {},
}

# response fields are never stripped (the daemon answers at its own version
# and old clients ignore unknown keys), so a min version here documents the
# introduction point rather than driving negotiation.  stats' `device` (the
# card the daemon runs on) and `serve` (its SERVE_COUNTERS) are the port's
# own: its daemons answer at v4 from the start.
RESPONSE_FIELDS: dict[str, dict[str, int]] = {
    "submit": {"id": 1, "state": 1, "queued": 1, "trace": 3, "backend": 4},
    "status": {"job": 1, "backend": 4},
    "wait": {"job": 1, "backend": 4},
    "stats": {"daemon": 1, "uptime_s": 1, "device": 4, "degraded": 1,
              "degrade_reason": 1, "backend_probe": 1, "queue_cap": 1,
              "job_timeout_s": 1, "jobs": 1, "jobs_terminal": 1, "serve": 4,
              "slices": 2, "slices_degraded": 2, "tenants": 2,
              "tenant_inflight_cap": 2, "placement": 2, "journal": 1,
              "failpoints": 1, "trace": 3, "events": 3, "profile": 3,
              "slo": 3, "flight_dir": 3, "plan_cache": 1, "delta": 1,
              "warm": 1, "tune": 3, "socket": 1, "backends": 4},
    "metrics": {"content_type": 1, "text": 1},
    "trace": {"spans": 1, "trace_events": 1},
    "profile": {"profile": 1},
    "events": {"events": 1, "log": 1},
    "slo": {"slo": 1},
    "shutdown": {"stopping": 1},
}

# each post-v1 optional request field -> the version that carries it
FIELD_MIN_VERSION: dict[str, int] = {
    f: v for fields in REQUEST_FIELDS.values() for f, v in fields.items() if v > 1
}


def version_for(msg: dict) -> int:
    """The lowest protocol version carrying every optional field in msg."""
    return max([1, *(v for field, v in FIELD_MIN_VERSION.items()
                     if msg.get(field) is not None)])


def strip_for_version(msg: dict, version: int) -> dict:
    """msg without the fields a daemon of `version` would not understand."""
    return {k: v for k, v in msg.items() if FIELD_MIN_VERSION.get(k, 1) <= version}


def accepted_from_error(message: str) -> tuple[int, ...]:
    """The versions a daemon's version-mismatch answer names; empty for any
    other message.  Anchored at the message's start: other answers echo
    client values, which must not be read as a downgrade."""
    if not message.startswith("protocol version mismatch"):
        return ()
    m = re.search(r"accepts ((?:v\d+/?)+)", message)
    if not m:
        return ()
    return tuple(int(part[1:]) for part in m.group(1).split("/") if part)


# the tenant of every submit that names none
DEFAULT_TENANT = "default"
TENANT_MAX_LEN = 64

OPS = tuple(REQUEST_FIELDS)

# server-side bound on one request line: a peer streaming bytes without a
# newline exhausts this, not the daemon's memory
MAX_LINE_BYTES = 1 << 20

# the port's multiply backends a submit may name
CHAIN_BACKENDS = ("exact", "hybrid", "mxu")
# the JAX package's backend names the daemon also takes, and what it runs
BACKEND_ALIASES = {"xla": "exact", "pallas": "exact"}

# the structured error codes: code -> doc (the JAX package's registry)
ERROR_CODES: dict[str, str] = {
    "bad-request": "unparsable line, unknown op, bad version, or a "
                   "field that failed admission validation",
    "queue-full": "admission control rejection "
                  "(SPGEMM_TPU_SERVE_QUEUE_CAP jobs already queued)",
    "tenant-cap": "per-tenant in-flight cap rejection "
                  "(SPGEMM_TPU_SERVE_TENANT_INFLIGHT)",
    "too-many-connections": "concurrent-connection bound hit",
    "unknown-job": "status/wait for a job id the daemon does not know",
    "shutting-down": "submit refused while the daemon drains",
    "internal-error": "handler crash (the daemon survives it)",
    "daemon-unavailable": "client-side: no daemon reachable after the "
                          "bounded connect-retry window "
                          "(ECONNREFUSED/ENOENT through a restart "
                          "rollout, retried with capped backoff, then "
                          "THIS, structured, instead of a raw OSError)",
    "job-timeout": "job reaped past SPGEMM_TPU_SERVE_JOB_TIMEOUT "
                   "(in a failed job's error dict)",
    "executor-died": "executor thread died or wedged mid-job "
                     "(in a failed job's error dict)",
    "job-error": "the chain runner raised "
                 "(in a failed job's error dict)",
    "backend-lost": "fleet router: the backend holding the job died and "
                    "the one idempotent re-submit to a healthy peer was "
                    "not possible (already retried, or no healthy peer)",
    "no-backend": "fleet router: no healthy backend available for "
                  "placement (all dead, degraded, or still unprobed)",
}

E_BAD_REQUEST = "bad-request"
E_QUEUE_FULL = "queue-full"
E_TENANT_CAP = "tenant-cap"
E_BUSY = "too-many-connections"
E_UNKNOWN_JOB = "unknown-job"
E_SHUTTING_DOWN = "shutting-down"
E_INTERNAL = "internal-error"
E_UNAVAILABLE = "daemon-unavailable"  # minted by the client, never the daemon
E_JOB_TIMEOUT = "job-timeout"
E_EXECUTOR_DIED = "executor-died"
E_JOB_ERROR = "job-error"
# minted by the fleet router (fleet/router.py), never a daemon
E_BACKEND_LOST = "backend-lost"
E_NO_BACKEND = "no-backend"


def protocol_table_md() -> str:
    """The generated wire-contract table for ARCHITECTURE.md (the DOC rule
    diffs the committed block against this; regenerate with
    `python -m spgemm_tpu_torch.analysis --write-protocol-table`)."""
    def cell(fields: dict[str, int]) -> str:
        if not fields:
            return "—"
        return ", ".join(f"`{name}`" + (f" (v{v}+)" if v > 1 else "")
                         for name, v in fields.items())

    lines = [f"Protocol v{PROTOCOL_VERSION} (accepts "
             f"{'/'.join(f'v{a}' for a in ACCEPTED_VERSIONS)}); every "
             f"message also carries the envelope fields "
             f"{', '.join(f'`{f}`' for f in ENVELOPE_FIELDS)}.",
             "",
             "| op | request fields | response fields |",
             "|---|---|---|"]
    for op in OPS:
        lines.append(f"| `{op}` | {cell(REQUEST_FIELDS[op])} "
                     f"| {cell(RESPONSE_FIELDS[op])} |")
    lines += ["", "| error code | meaning |", "|---|---|"]
    for code, doc in ERROR_CODES.items():
        lines.append(f"| `{code}` | {doc} |")
    return "\n".join(lines)


# tenant names are label values: a bounded charset, no quotes or whitespace
_TENANT_RE = re.compile(r"^[A-Za-z0-9._:-]+$")


def valid_tenant(tenant) -> bool:
    """True iff tenant is an acceptable wire tenant name."""
    return (isinstance(tenant, str) and 0 < len(tenant) <= TENANT_MAX_LEN
            and _TENANT_RE.match(tenant) is not None)


# 128-bit trace context in lowercase hex (the v3 submit field)
TRACE_HEX_LEN = 32
_TRACE_RE = re.compile(r"^[0-9a-f]{32}$")


def valid_trace(trace) -> bool:
    """True iff trace is a well-formed wire trace context."""
    return isinstance(trace, str) and _TRACE_RE.match(trace) is not None


def mint_trace() -> str:
    """A fresh 128-bit trace context."""
    return os.urandom(TRACE_HEX_LEN // 2).hex()


class ProtocolError(Exception):
    """A request that cannot be dispatched; carries the structured code."""

    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code
        self.message = message


def default_socket_path() -> str:
    """SPGEMM_TPU_SERVE_SOCKET, or <tmpdir>/spgemmd-<uid>.sock."""
    configured = knobs.get("SPGEMM_TPU_SERVE_SOCKET")
    if configured:
        return configured
    return os.path.join(tempfile.gettempdir(), f"spgemmd-{os.getuid()}.sock")


def parse_addr(spec: str):
    """One wire address into ("tcp", host, port) or ("unix", path):
    `tcp:HOST:PORT` (IPv6 hosts split at their last colon; port 0 binds an
    ephemeral port), `unix:PATH` or a bare path.  ValueError, naming the
    spec, on anything else: a typo must never fall back to a default."""
    if not isinstance(spec, str) or not spec:
        raise ValueError(f"empty wire address spec {spec!r}")
    if spec.startswith("tcp:"):
        host, sep, port = spec[4:].rpartition(":")
        if not sep or not host:
            raise ValueError(f"bad tcp address {spec!r} (want tcp:HOST:PORT)")
        try:
            port_no = int(port)
        except ValueError:
            raise ValueError(f"bad tcp port in {spec!r} (want tcp:HOST:PORT)") from None
        if not 0 <= port_no <= 65535:
            raise ValueError(f"tcp port out of range in {spec!r}")
        return ("tcp", host.strip("[]"), port_no)
    if spec.startswith("unix:"):
        path = spec[5:]
        if not path:
            raise ValueError(f"empty unix path in {spec!r}")
        return ("unix", path)
    return ("unix", spec)


def format_addr(parsed) -> str:
    """The canonical spec of a parse_addr() result: a backend's stable name
    in the router's labels and log lines."""
    if parsed[0] == "tcp":
        return f"tcp:{parsed[1]}:{parsed[2]}"
    return f"unix:{parsed[1]}"


def default_addr() -> str:
    """The client's default target: SPGEMM_TPU_SERVE_ADDR when exported,
    else the unix socket path."""
    return knobs.get("SPGEMM_TPU_SERVE_ADDR") or default_socket_path()


def encode(msg: dict) -> bytes:
    """One wire line for msg (compact JSON and a newline)."""
    return json.dumps(msg, separators=(",", ":")).encode() + b"\n"


def ok(**fields) -> dict:
    return {"v": PROTOCOL_VERSION, "ok": True, **fields}


def error(code: str, message: str, **fields) -> dict:
    return {"v": PROTOCOL_VERSION, "ok": False,
            "error": {"code": code, "message": message}, **fields}


def parse_request(line: str) -> dict:
    """Decode and validate one request line; ProtocolError on anything the
    dispatcher cannot act on."""
    try:
        msg = json.loads(line)
    except ValueError as e:
        raise ProtocolError(E_BAD_REQUEST, f"request is not valid JSON: {e}") from None
    if not isinstance(msg, dict):
        raise ProtocolError(E_BAD_REQUEST, "request must be a JSON object")
    v = msg.get("v")
    if v not in ACCEPTED_VERSIONS:
        raise ProtocolError(
            E_BAD_REQUEST,
            f"protocol version mismatch: daemon speaks v{PROTOCOL_VERSION} "
            f"(accepts {'/'.join(f'v{a}' for a in ACCEPTED_VERSIONS)}), "
            f"request carries v={v!r}")
    op = msg.get("op")
    if op not in OPS:
        raise ProtocolError(E_BAD_REQUEST,
                            f"unknown op {op!r} (expected one of {'|'.join(OPS)})")
    return msg


def read_lines(sock, bufsize: int = 65536, max_line: int | None = None):
    """Yield decoded lines from a socket until EOF; bytes after the last
    newline at close are not a request.  max_line bounds the pending
    buffer: past it, ProtocolError(bad-request)."""
    buf = b""
    while True:
        chunk = sock.recv(bufsize)
        if not chunk:
            return
        buf += chunk
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            yield line.decode("utf-8", errors="replace")
        if max_line is not None and len(buf) > max_line:
            raise ProtocolError(E_BAD_REQUEST,
                                f"request line exceeds {max_line} bytes without a newline")
