"""spgemm-router: one front door for a fleet of spgemmd backends (`cli
route`; the port's copy of the JAX package's `fleet/router.py`).

One resident process speaks the spgemmd wire protocol on its own listener
(TCP or unix, protocol.parse_addr) and fronts N backends:

  * health: a poll thread reads every backend's `stats` op each
    SPGEMM_TPU_ROUTER_POLL_S seconds: queue depth, widest slice, the
    degraded flag, and the gossiped price book (fleet/pricebook.py).  A
    backend that fails its poll, or reports degraded, leaves placement; a
    later healthy poll brings it back.
  * placement: a submit is priced by the replicated price book: a large
    job to the widest backend, a cheap one to the least loaded, and a
    first contact round-robins per tenant.
  * fleet tenant fairness: per-tenant round-robin plus a fleet-wide
    in-flight cap (SPGEMM_TPU_SERVE_TENANT_INFLIGHT x healthy backends) on
    top of each daemon's own fair queue.
  * proxying: status and wait follow the job to its backend (the snapshot
    comes back under the fleet job id, with a `backend` field); `metrics`
    joins the router's families with every backend's scrape under an
    injected backend= label; `profile` and `slo` nest each backend's
    report.  The client-minted trace context passes through untouched and
    the router's own `router_submit` span carries it, so `trace-dump
    --merge` stitches client, router and backend.
  * failover: a job whose backend dies is re-submitted once to a healthy
    peer (the stored submit message is its fingerprint: the same folder
    bytes, options and output path give the same bytes), counted on
    spgemm_router_failovers_total; otherwise the caller gets a structured
    `backend-lost`, never a hang.

The router holds no queue: a submit is forwarded at once (admission is each
backend's SPGEMM_TPU_SERVE_QUEUE_CAP), so a router restart loses only the
fleet-id -> backend-id map.  Imports neither torch nor numpy: the daemons
own the card, the router owns only sockets.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import socket
import sys
import threading
import time

from spgemm_tpu_torch.fleet.pricebook import PriceBook
from spgemm_tpu_torch.obs import events as obs_events
from spgemm_tpu_torch.obs import metrics as obs_metrics
from spgemm_tpu_torch.obs import trace as obs_trace
from spgemm_tpu_torch.serve import client, placement, protocol
from spgemm_tpu_torch.utils import knobs

log = logging.getLogger("spgemm-router")

# the router's default front door; tests and the smokes bind
# tcp:127.0.0.1:0 for an ephemeral port
DEFAULT_LISTEN = "tcp:127.0.0.1:7463"


def _label_scrape(text: str, backend: str) -> str:
    """Inject `backend="..."` into every sample line of one backend's
    Prometheus scrape (comment lines dropped: HELP and TYPE would repeat
    across backends, and samples without them are legal text-format
    0.0.4)."""
    esc = backend.replace("\\", "\\\\").replace('"', '\\"')
    out = []
    for line in text.splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        try:
            series, value = line.rsplit(" ", 1)
        except ValueError:
            continue
        if series.endswith("}") and "{" in series:
            i = series.index("{")
            body = series[i + 1:-1]
            inner = f'backend="{esc}"' + ("," + body if body else "")
            series = f"{series[:i]}{{{inner}}}"
        else:
            series = f'{series}{{backend="{esc}"}}'
        out.append(f"{series} {value}")
    return "\n".join(out)


class Router:
    """The resident fleet router (one a process)."""

    MAX_CONNS = 128          # the daemon's admission bound
    CONN_IDLE_TIMEOUT_S = 600.0
    POLL_TIMEOUT_S = 5.0     # one backend stats poll or forward probe
    FORWARD_RETRY_S = 1.0    # rides out a backend restart briefly

    def __init__(self, listen: str | None = None, backends: list[str] | None = None,
                 poll_s: float | None = None):
        self.listen_spec = listen or DEFAULT_LISTEN
        self._listen_parsed = protocol.parse_addr(self.listen_spec)
        if backends is None:
            raw = knobs.get("SPGEMM_TPU_ROUTER_BACKENDS") or ""
            backends = [b.strip() for b in raw.split(",") if b.strip()]
        if not backends:
            raise ValueError("spgemm-router needs at least one backend "
                             "(--backends or SPGEMM_TPU_ROUTER_BACKENDS)")
        self._poll_s = poll_s if poll_s is not None else knobs.get("SPGEMM_TPU_ROUTER_POLL_S")
        # backend name (the canonical address) -> its state, written by the
        # poll thread (health) and the conn threads (mark-down on a failed
        # forward)
        self._backends: dict[str, dict] = {}  # spgemm-lint: guarded-by(_lock)
        for spec in backends:
            name = protocol.format_addr(protocol.parse_addr(spec))
            if name in self._backends:
                raise ValueError(f"duplicate backend {spec!r}")
            self._backends[name] = {"spec": spec, "up": False, "degraded": False, "depth": 0,
                                    "width": 1, "jobs_total": 0, "last_seen": 0.0,
                                    "last_error": "unprobed"}
        self.book = PriceBook()
        # fleet id -> the routed job; its forwarded submit message rides along
        # so that a failover re-submits it verbatim
        self._jobs: dict[str, dict] = {}      # spgemm-lint: guarded-by(_lock)
        self._tenant_rr: dict[str, int] = {}  # spgemm-lint: guarded-by(_lock)
        self._failovers = 0                   # spgemm-lint: guarded-by(_lock)
        self._next_id = 1                     # spgemm-lint: guarded-by(_lock)
        self._conn_count = 0                  # spgemm-lint: guarded-by(_lock)
        self._started_at = time.time()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._listener: socket.socket | None = None
        self.port: int | None = None
        self._threads: list[threading.Thread] = []

    # ---------------------------------------------------------- lifecycle --
    def start(self) -> None:
        """Bind the front door, poll every backend once (so the first submit
        has health and prices), and start the accept and poll threads."""
        with self._lock:
            backend_names = sorted(self._backends)
        obs_events.emit("router_start", listen=self.listen_spec, backends=backend_names,
                        poll_s=self._poll_s)
        if self._listen_parsed[0] == "tcp":
            self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._listener.bind((self._listen_parsed[1], self._listen_parsed[2]))
            self.port = self._listener.getsockname()[1]
        else:
            path = self._listen_parsed[1]
            if os.path.exists(path):
                peer = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                try:
                    peer.settimeout(1.0)
                    peer.connect(path)
                except OSError:
                    os.unlink(path)  # stale: nothing listens behind it
                else:
                    peer.close()
                    raise RuntimeError(f"a router/daemon is already serving on {path}")
            self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._listener.bind(path)
        self._listener.listen(16)
        # accept() wakes to check the stop flag, as the daemon's loop does
        self._listener.settimeout(0.2)
        self._poll_once()
        for target, name in ((self._accept_loop, "router-accept"),
                             (self._poll_loop, "router-poll")):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        log.info("spgemm-router serving on %s (%d backend(s): %s; poll %gs)",
                 self.listen_spec + (f" [port {self.port}]" if self.port is not None else ""),
                 len(backend_names), ",".join(backend_names), self._poll_s)

    def serve_forever(self) -> None:
        self.start()
        try:
            while not self._stop.wait(0.5):
                pass
        finally:
            self.stop()

    def stop(self) -> None:
        """Drain: stop accepting, let the conn threads finish their request
        (they are synchronous proxies; no job state lives here), flush the
        event log, unlink a unix front door."""
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=5.0)
        obs_events.LOG.flush(timeout=2.0)
        if self._listen_parsed[0] == "unix":
            try:
                os.unlink(self._listen_parsed[1])
            except OSError:
                pass

    # --------------------------------------------------------- health poll --
    def _poll_loop(self) -> None:
        while not self._stop.wait(self._poll_s):
            self._poll_once()

    def _poll_once(self) -> None:
        """Refresh every backend's health, depth and width and merge its
        gossiped price book.  The network calls run outside the lock; only
        the write-back takes it."""
        with self._lock:
            targets = [(name, b["spec"]) for name, b in self._backends.items()]
        for name, spec in targets:
            if self._stop.is_set():
                return
            try:
                st = client.request({"op": "stats"}, spec, timeout=self.POLL_TIMEOUT_S,
                                    retry_total_s=0.0)
            except (client.ServeError, OSError) as e:
                self._mark_down(name, repr(e))
                continue
            self.book.merge(st.get("placement"))
            degraded = bool(st.get("degraded"))
            depth = (st.get("jobs") or {}).get("depth", 0)
            width = max([s.get("width", 1) for s in (st.get("slices") or [])] or [1])
            with self._lock:
                b = self._backends[name]
                was_healthy = b["up"] and not b["degraded"]
                b.update(up=True, degraded=degraded, depth=depth, width=width,
                         last_seen=time.time(), last_error=None)
            if not degraded and not was_healthy:
                obs_events.emit("router_backend_up", backend=name)
            elif degraded and was_healthy:
                obs_events.emit("router_backend_down", backend=name,
                                reason="backend reports degraded")

    def _mark_down(self, name: str, reason: str) -> None:
        with self._lock:
            b = self._backends[name]
            was_healthy = b["up"] and not b["degraded"]
            b["up"] = False
            b["last_error"] = reason
        if was_healthy:
            obs_events.emit("router_backend_down", backend=name, reason=reason)

    def _healthy(self) -> list[tuple[str, dict]]:
        """(name, a copy of its state) for every placeable backend."""
        with self._lock:
            return [(name, dict(b)) for name, b in self._backends.items()
                    if b["up"] and not b["degraded"]]

    # ----------------------------------------------------------- transport --
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # the listener closed at shutdown
            with self._lock:
                admit = self._conn_count < self.MAX_CONNS
                if admit:
                    self._conn_count += 1
            if not admit:
                try:
                    conn.sendall(protocol.encode(protocol.error(
                        protocol.E_BUSY,
                        f"too many concurrent connections ({self.MAX_CONNS}); retry shortly")))
                except OSError:
                    pass
                conn.close()
                continue
            conn.settimeout(self.CONN_IDLE_TIMEOUT_S)
            threading.Thread(target=self._handle_conn, args=(conn,), name="router-conn",
                             daemon=True).start()

    def _handle_conn(self, conn: socket.socket) -> None:
        try:
            for line in protocol.read_lines(conn, max_line=protocol.MAX_LINE_BYTES):
                if not line.strip():
                    continue
                try:
                    msg = protocol.parse_request(line)
                except protocol.ProtocolError as e:
                    resp = protocol.error(e.code, e.message)
                else:
                    try:
                        resp = self._dispatch(msg)
                    except protocol.ProtocolError as e:
                        resp = protocol.error(e.code, e.message)
                    except client.ServeError as e:
                        # a backend's structured refusal (queue-full,
                        # tenant-cap, unknown-job after a backend lost its
                        # jobs) passes through as it came
                        resp = protocol.error(e.code, e.message)
                    except Exception as e:  # noqa: BLE001 -- the router survives any handler crash
                        log.warning("request handler failed: %r", e)
                        resp = protocol.error(protocol.E_INTERNAL, repr(e))
                conn.sendall(protocol.encode(resp))
        except protocol.ProtocolError as e:
            # an oversized line: answered once, then the connection drops
            try:
                conn.sendall(protocol.encode(protocol.error(e.code, e.message)))
            except OSError:
                pass
        except OSError:
            pass  # the peer left mid-conversation, or idled out
        finally:
            conn.close()
            with self._lock:
                self._conn_count -= 1

    def _dispatch(self, msg: dict) -> dict:
        op = msg["op"]
        if op == "submit":
            return self._op_submit(msg)
        if op == "status":
            return self._op_status(msg)
        if op == "wait":
            return self._op_wait(msg)
        if op == "stats":
            return self._op_stats()
        if op == "metrics":
            return self._op_metrics()
        if op == "trace":
            return self._op_trace()
        if op == "profile":
            return self._op_profile()
        if op == "events":
            return self._op_events(msg)
        if op == "slo":
            return self._op_slo()
        return self._op_shutdown()

    # ----------------------------------------------------------- placement --
    def _place(self, folder, tenant: str) -> list[tuple[str, str]]:
        """The (name, spec) candidates for one submit, in order: a priced
        large job to the widest backend first, a priced cheap one to the
        least loaded narrowest, a first contact round-robin per tenant.
        ProtocolError(no-backend) when nothing is placeable."""
        healthy = self._healthy()
        if not healthy:
            with self._lock:
                total = len(self._backends)
            raise protocol.ProtocolError(protocol.E_NO_BACKEND,
                                         f"no healthy backend among {total} "
                                         "(all dead, degraded, or unprobed)")
        mass = self.book.lookup(folder) if isinstance(folder, str) else None
        if mass is None:
            # a first contact: each tenant's stream round-robins on its own
            healthy.sort(key=lambda row: row[0])
            with self._lock:
                cursor = self._tenant_rr.get(tenant, 0)
                self._tenant_rr[tenant] = cursor + 1
            k = cursor % len(healthy)
            ordered = healthy[k:] + healthy[:k]
        elif mass >= placement.LARGE_MASS_PAIRS:
            ordered = sorted(healthy, key=lambda row: (-row[1]["width"], row[1]["depth"],
                                                       row[0]))
        else:
            ordered = sorted(healthy, key=lambda row: (row[1]["depth"], row[1]["width"],
                                                       row[0]))
        return [(name, b["spec"]) for name, b in ordered]

    def _tenant_inflight(self, tenant: str) -> int:
        with self._lock:
            return sum(1 for j in self._jobs.values()
                       if j["tenant"] == tenant and not j["terminal"])

    def _forward_submit(self, fwd: dict, candidates) -> tuple[dict, str]:
        """Try each candidate in placement order: one that cannot be reached
        is marked down and skipped, a structured refusal propagates
        (ServeError).  (the backend's answer, its name)."""
        last_err = None
        for name, spec in candidates:
            try:
                answer = client.request(fwd, spec, retry_total_s=self.FORWARD_RETRY_S)
            except client.ServeError as e:
                if e.code != protocol.E_UNAVAILABLE:
                    raise
                self._mark_down(name, e.message)
                last_err = e
                continue
            except OSError as e:
                self._mark_down(name, repr(e))
                last_err = e
                continue
            return answer, name
        raise protocol.ProtocolError(protocol.E_NO_BACKEND,
                                     f"every placeable backend refused the connection "
                                     f"(last: {last_err!r})")

    # ---------------------------------------------------------------- ops --
    def _op_submit(self, msg: dict) -> dict:
        if self._stop.is_set():
            return protocol.error(protocol.E_SHUTTING_DOWN, "router is shutting down")
        folder = msg.get("folder")
        if not isinstance(folder, str) or not folder:
            return protocol.error(protocol.E_BAD_REQUEST, "submit requires a non-empty `folder`")
        tenant = msg.get("tenant", protocol.DEFAULT_TENANT)
        if not protocol.valid_tenant(tenant):
            return protocol.error(protocol.E_BAD_REQUEST,
                                  f"tenant must be 1-{protocol.TENANT_MAX_LEN} chars of "
                                  f"[A-Za-z0-9._:-], got {tenant!r}")
        trace_in = msg.get("trace")
        if trace_in is not None and not protocol.valid_trace(trace_in):
            return protocol.error(protocol.E_BAD_REQUEST,
                                  f"trace must be {protocol.TRACE_HEX_LEN} lowercase hex "
                                  f"chars, got {trace_in!r}")
        candidates = self._place(folder, tenant)
        # the fleet's tenant cap on top of each daemon's: the per-daemon
        # in-flight cap times the healthy backends
        per_daemon_cap = knobs.get("SPGEMM_TPU_SERVE_TENANT_INFLIGHT")
        if per_daemon_cap is not None:
            fleet_cap = per_daemon_cap * len(candidates)
            if self._tenant_inflight(tenant) >= fleet_cap:
                return protocol.error(protocol.E_TENANT_CAP,
                                      f"tenant {tenant!r} already has {fleet_cap} job(s) "
                                      "in flight across the fleet")
        # the request goes on as it came, but for the envelope version
        # (client.request stamps its own): trace, tenant and options reach
        # the backend unchanged
        fwd = {k: v for k, v in msg.items() if k != "v"}
        t0 = time.perf_counter()
        resp, name = self._forward_submit(fwd, candidates)
        with self._lock:
            fleet_id = f"r{self._next_id}"
            self._next_id += 1
            self._jobs[fleet_id] = {"backend": name, "backend_id": resp.get("id"), "msg": fwd,
                                    "tenant": tenant, "trace": resp.get("trace") or trace_in,
                                    "failovers": 0, "terminal": None}
            self._backends[name]["jobs_total"] += 1
            self._backends[name]["depth"] += 1  # optimistic; the next poll corrects it
            trace_id = self._jobs[fleet_id]["trace"]
        # the router's span under the client's trace context, between the
        # client_submit span and the backend's job spans in a merged trace
        with obs_trace.RECORDER.tagged(trace_id=trace_id, tenant=tenant, backend=name):
            obs_trace.RECORDER.point("router_submit", time.perf_counter() - t0)
        resp["id"] = fleet_id
        resp["backend"] = name
        return resp

    def _job(self, msg: dict) -> dict:
        jid = msg.get("id")
        with self._lock:
            job = self._jobs.get(jid) if isinstance(jid, str) else None
            if job is None:
                raise protocol.ProtocolError(
                    protocol.E_UNKNOWN_JOB,
                    f"unknown job id {jid!r} (the router's job map is process-local; "
                    "resubmit after a router restart)")
            return dict(job, fleet_id=jid)

    def _failover(self, fleet_id: str, dead: str) -> str | None:
        """Re-submit a lost job once to a healthy peer (its forwarded submit
        message is its fingerprint: the same folder bytes, options and
        output).  The new backend's name, or None when the job cannot fail
        over (already retried, terminal, or no healthy peer)."""
        with self._lock:
            job = self._jobs[fleet_id]
            if job["failovers"] >= 1 or job["terminal"]:
                return None
            fwd = dict(job["msg"])
        self._mark_down(dead, "died mid-job")
        candidates = [(name, b["spec"]) for name, b in self._healthy() if name != dead]
        if not candidates:
            obs_events.emit("router_failover", job=fleet_id, dead=dead, outcome="backend-lost")
            return None
        try:
            answer, name = self._forward_submit(fwd, candidates)
        except (protocol.ProtocolError, client.ServeError):
            obs_events.emit("router_failover", job=fleet_id, dead=dead, outcome="backend-lost")
            return None
        with self._lock:
            job = self._jobs[fleet_id]
            job["backend"] = name
            job["backend_id"] = answer.get("id")
            job["failovers"] += 1
            self._backends[name]["jobs_total"] += 1
            self._failovers += 1
            trace_id = job["trace"]
        obs_events.emit("router_failover", job=fleet_id, dead=dead, to=name,
                        outcome="resubmitted", trace=trace_id)
        log.warning("job %s failed over %s -> %s", fleet_id, dead, name)
        return name

    def _proxy_job_op(self, msg: dict, fwd: dict, retried: bool = False) -> dict:
        """Forward one status or wait to the job's backend; a dead backend
        triggers the one failover, then one retry of the op on the new
        backend."""
        job = self._job(msg)
        fwd = dict(fwd, id=job["backend_id"])
        try:
            # the read outlasts a backend's longest wait slice
            resp = client.request(fwd, self._backend_spec(job["backend"]),
                                  timeout=self.POLL_TIMEOUT_S + 30.0,
                                  retry_total_s=self.FORWARD_RETRY_S)
        except (client.ServeError, OSError) as e:
            # a killed backend shows as daemon-unavailable on reconnect or a
            # reset mid-read: either way it is gone and the job fails over
            if isinstance(e, client.ServeError) and e.code != protocol.E_UNAVAILABLE \
                    or retried:
                raise
            if self._failover(job["fleet_id"], job["backend"]) is None:
                return protocol.error(protocol.E_BACKEND_LOST,
                                      f"backend {job['backend']} died holding job "
                                      f"{job['fleet_id']} and no healthy peer could take "
                                      "the re-submit")
            return self._proxy_job_op(msg, fwd, retried=True)
        snap = resp.get("job")
        if isinstance(snap, dict):
            snap["id"] = job["fleet_id"]
            if snap.get("state") in ("done", "failed"):
                with self._lock:
                    live = self._jobs.get(job["fleet_id"])
                    if live is not None and not live["terminal"]:
                        live["terminal"] = snap["state"]
        resp["backend"] = job["backend"]
        return resp

    def _backend_spec(self, name: str) -> str:
        with self._lock:
            return self._backends[name]["spec"]

    def _op_status(self, msg: dict) -> dict:
        return self._proxy_job_op(msg, {"op": "status"})

    def _op_wait(self, msg: dict) -> dict:
        fwd = {"op": "wait"}
        if msg.get("timeout") is not None:
            fwd["timeout"] = msg["timeout"]
        return self._proxy_job_op(msg, fwd)

    def _op_stats(self) -> dict:
        with self._lock:
            backends = {name: {k: b[k] for k in ("up", "degraded", "depth", "width",
                                                  "jobs_total", "last_seen", "last_error")}
                        for name, b in self._backends.items()}
            jobs = {"routed": len(self._jobs),
                    "inflight": sum(1 for j in self._jobs.values() if not j["terminal"]),
                    "failovers": self._failovers}
            tenants = {}
            for j in self._jobs.values():
                row = tenants.setdefault(j["tenant"], {"jobs": 0, "inflight": 0})
                row["jobs"] += 1
                row["inflight"] += 0 if j["terminal"] else 1
        return protocol.ok(daemon="spgemm-router",
                           uptime_s=round(time.time() - self._started_at, 3),
                           backends=backends, jobs=jobs, tenants=tenants,
                           placement=self.book.stats(), events=obs_events.LOG.stats(),
                           trace=obs_trace.RECORDER.stats())

    def _op_metrics(self) -> dict:
        """The router's own families, then every live backend's scrape with
        a `backend=` label injected: one scrape for the fleet."""
        with self._lock:
            rows = [(name, dict(b)) for name, b in self._backends.items()]
            failovers = self._failovers
        samples = []
        for name, b in rows:
            labels = {"backend": name}
            samples += [("spgemm_router_backend_up", labels, int(b["up"] and not b["degraded"])),
                        ("spgemm_router_backend_queue_depth", labels, b["depth"]),
                        ("spgemm_router_jobs_total", labels, b["jobs_total"])]
        samples.append(("spgemm_router_failovers_total", {}, failovers))
        parts = [obs_metrics.render(samples)]
        for name, b in rows:
            if not b["up"]:
                continue
            try:
                resp = client.request({"op": "metrics"}, b["spec"], timeout=self.POLL_TIMEOUT_S,
                                      retry_total_s=0.0)
            except (client.ServeError, OSError) as e:
                self._mark_down(name, repr(e))
                continue
            parts.append(_label_scrape(resp.get("text") or "", name))
        return protocol.ok(content_type="text/plain; version=0.0.4; charset=utf-8",
                           text="\n".join(p for p in parts if p) + "\n")

    def _op_trace(self) -> dict:
        events = obs_trace.to_trace_events()
        return protocol.ok(spans=len(events), trace_events=events)

    def _op_profile(self) -> dict:
        return protocol.ok(profile=self._fan_in("profile"))

    def _op_slo(self) -> dict:
        return protocol.ok(slo=self._fan_in("slo"))

    def _fan_in(self, op: str) -> dict:
        """One op asked of every live backend; one that fails gives an error
        row rather than failing the whole answer."""
        with self._lock:
            rows = [(name, b["spec"]) for name, b in self._backends.items() if b["up"]]
        out = {}
        for name, spec in rows:
            try:
                answer = client.request({"op": op}, spec, timeout=self.POLL_TIMEOUT_S,
                                        retry_total_s=0.0)
            except (client.ServeError, OSError) as e:
                out[name] = {"error": repr(e)}
                continue
            out[name] = answer.get(op)
        return out

    def _op_events(self, msg: dict) -> dict:
        n = msg.get("n", 50)
        try:
            n = int(n)
        except (TypeError, ValueError):
            return protocol.error(protocol.E_BAD_REQUEST, f"n must be an integer, got {n!r}")
        return protocol.ok(events=obs_events.LOG.tail(n), log=obs_events.LOG.stats())

    def _op_shutdown(self) -> dict:
        self._stop.set()
        return protocol.ok(stopping=True)


def main(argv: list[str] | None = None) -> int:
    """`cli route`: run the fleet router in the foreground."""
    p = argparse.ArgumentParser(
        prog="spgemm_tpu_torch route",
        description="spgemm-router: one front door for N spgemmd backends -- health polls, "
                    "placement by the estimator's price, fleet tenant fairness, one scrape, "
                    "trace passthrough, one-shot failover")
    p.add_argument("--listen", default=None, metavar="ADDR",
                   help=f"front-door address: tcp:HOST:PORT or a unix socket path (default "
                        f"{DEFAULT_LISTEN}; tcp port 0 binds an ephemeral port and logs it)")
    p.add_argument("--backends", default=None, metavar="LIST",
                   help="comma-joined backend addresses (default: SPGEMM_TPU_ROUTER_BACKENDS)")
    p.add_argument("--poll-s", type=float, default=None, metavar="S",
                   help="backend poll cadence (default: SPGEMM_TPU_ROUTER_POLL_S)")
    p.add_argument("--verbose", "-v", action="store_true")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO if args.verbose else logging.WARNING,
                        format="%(name)s %(message)s")
    backends = None
    if args.backends is not None:
        backends = [b.strip() for b in args.backends.split(",") if b.strip()]
    try:
        router = Router(listen=args.listen, backends=backends, poll_s=args.poll_s)
    except ValueError as e:
        print(f"spgemm-router: {e}", file=sys.stderr)
        return 1

    # spgemmd's contract: the handler only sets the flag; serve_forever's
    # finally drains, and main returns 0
    def _on_signal(signum, frame):  # noqa: ARG001 -- signal handler shape
        router._stop.set()

    for signum in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(signum, _on_signal)
        except (ValueError, OSError):
            pass  # not the main thread: Ctrl-C still works
    try:
        router.serve_forever()
    except KeyboardInterrupt:
        router.stop()
    except RuntimeError as e:
        print(f"spgemm-router: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
