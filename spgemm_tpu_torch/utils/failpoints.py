"""Registry of named fault-injection sites, armed by one env knob (the port's
copy of the JAX package's `utils/failpoints.py`, with the same sites).

Every site is declared here once (name, kind, module, doc), and
`check("name")` at the site is its whole wiring.  `SPGEMM_TPU_FAILPOINTS`
arms them: comma-joined `name[:prob][:count]` terms.  `prob` (default 1)
fires the point on that fraction of checks, from an RNG seeded by the
(spec, name) pair, so a spec replays the same trigger sequence; `count`
(default unlimited) bounds the triggers.  Unset, a check is one registry
lookup and one env read.

Kinds, what a trigger does at the site:

  raise   raise FailpointTriggered (the site's error path)
  hang    block until the point is disarmed (the env cleared or changed) or
          HANG_MAX_S passes: a card that hangs, which the daemon's watchdog
          exists for
  corrupt check() returns True and the site takes its own corruption path
  delay   sleep DELAY_S, then go on

No trigger changes a result: a triggered site fails loudly or slowly, never
wrongly.  Imports the standard library, the knob registry and the event log only (a
trigger emits `failpoint_trigger`).
"""

from __future__ import annotations

import logging
import random
import threading
import time
import zlib
from dataclasses import dataclass

from spgemm_tpu_torch.obs import events
from spgemm_tpu_torch.utils import knobs

log = logging.getLogger("spgemm_tpu_torch.failpoints")

# a hang releases when disarmed; this backstop keeps a forgotten spec from
# pinning a thread for ever
HANG_MAX_S = 3600.0
# one delay-kind trigger sleeps this long
DELAY_S = 0.25
# a hang polls the arming spec at this cadence
HANG_POLL_S = 0.05


class FailpointTriggered(RuntimeError):
    """A raise-kind failpoint fired; names the point."""

    def __init__(self, name: str):
        super().__init__(f"failpoint {name} triggered")
        self.point = name


@dataclass(frozen=True)
class Failpoint:
    """One registered injection site: kind is 'raise' | 'hang' | 'corrupt' |
    'delay'; module is the site's module in the package."""

    name: str
    kind: str
    module: str
    doc: str


_FAILPOINTS = (
    Failpoint("plan.build", "raise", "ops/spgemm.py",
              "The plan build fails (a chain's error path: a structured "
              "job-error in the daemon, never a wedge)."),
    Failpoint("plan.ensure_exact", "raise", "ops/symbolic.py",
              "A deferred plan's exact join fails when forced (the plan-ahead "
              "worker or the dispatching thread, whichever forces it)."),
    Failpoint("kernel.dispatch", "raise", "ops/spgemm.py",
              "A multiply's launches fail before the first one (the failover "
              "and job-error paths)."),
    Failpoint("delta.diff", "corrupt", "ops/delta.py",
              "The delta diff reports a lineage it cannot prove: the multiply "
              "takes its counted full fallback."),
    Failpoint("delta.splice", "raise", "ops/spgemm.py",
              "The delta splice fails after the sub-plan ran."),
    Failpoint("warm.load", "corrupt", "ops/warmstore.py",
              "A warm-store entry loads as corrupt: counted warm_corrupt, "
              "removed, the caller goes on cold."),
    Failpoint("warm.flush", "raise", "ops/warmstore.py",
              "The warm flush raises midway; flush() must still not raise."),
    Failpoint("serve.journal", "corrupt", "serve/daemon.py",
              "One journal append writes a torn record (half a frame): replay "
              "must truncate there and count it."),
    Failpoint("serve.accept", "delay", "serve/daemon.py",
              "The accept loop stalls after one accept; clients' connect retry "
              "covers it."),
    Failpoint("serve.readline", "raise", "serve/daemon.py",
              "A connection handler dies mid-request; the socket must still "
              "close and the connection slot free."),
    Failpoint("serve.executor", "hang", "serve/daemon.py",
              "The executor hangs after it picks a job up, before the runner: "
              "reap, wedge, degrade, re-probe."),
    Failpoint("serve.heartbeat", "hang", "serve/daemon.py",
              "The chain's heartbeat hangs between multiplies: no beat reaches "
              "the watchdog and the wedge grace runs out."),
    Failpoint("tune.trial", "raise", "tune/tuner.py",
              "An autotuner trial leg dies before it measures: the leg is "
              "discarded with no revert, and no real job's result, SLO window "
              "or admission is touched."),
)

REGISTRY: dict[str, Failpoint] = {f.name: f for f in _FAILPOINTS}


class _Arm:
    """Arming state of one point under the current spec: probability, the
    triggers left (None = unlimited) and the (spec, name)-seeded RNG."""

    def __init__(self, name: str, prob: float, count: int | None, spec: str):
        self.prob = prob
        self.remaining = count
        self.rng = random.Random(zlib.crc32(f"{spec}|{name}".encode()))


_LOCK = threading.Lock()
_RAW: str | None = None          # spgemm-lint: guarded-by(_LOCK)
_ARMS: dict[str, _Arm] = {}      # spgemm-lint: guarded-by(_LOCK)
_TRIGGERED: dict[str, int] = {}  # spgemm-lint: guarded-by(_LOCK)


def _parse_spec(spec: str) -> dict[str, tuple[float, int | None]]:
    """`name[:prob][:count]` terms -> {name: (prob, count)}; a bad term
    raises naming the knob (a spec that armed nothing would inject
    nothing)."""
    out: dict[str, tuple[float, int | None]] = {}
    for term in spec.split(","):
        term = term.strip()
        if not term:
            continue
        parts = term.split(":")
        name = parts[0].strip()
        if name not in REGISTRY:
            raise ValueError(f"SPGEMM_TPU_FAILPOINTS names unknown failpoint {name!r} "
                             f"(registered: {', '.join(sorted(REGISTRY))})")
        if len(parts) > 3:
            raise ValueError(f"SPGEMM_TPU_FAILPOINTS term {term!r} has more than "
                             "name:prob:count fields")
        try:
            prob = float(parts[1]) if len(parts) > 1 and parts[1] else 1.0
            count = int(parts[2]) if len(parts) > 2 and parts[2] else None
        except ValueError:
            raise ValueError(f"SPGEMM_TPU_FAILPOINTS term {term!r}: prob must be a "
                             "number, count an integer") from None
        if not 0.0 <= prob <= 1.0 or (count is not None and count < 1):
            raise ValueError(f"SPGEMM_TPU_FAILPOINTS term {term!r}: need "
                             "0 <= prob <= 1 and count >= 1")
        out[name] = (prob, count)
    return out


def _arm_for(name: str) -> _Arm | None:
    """The arm of `name` under the knob's current value, parsed again when
    the spec changed.  None = not armed."""
    global _RAW
    spec = knobs.get("SPGEMM_TPU_FAILPOINTS")
    with _LOCK:
        if spec != _RAW:
            # parse before committing _RAW, so a malformed spec raises at
            # every check, not only the first
            arms = {pname: _Arm(pname, prob, count, spec)
                    for pname, (prob, count) in (_parse_spec(spec) if spec else {}).items()}
            _RAW = spec
            _ARMS.clear()
            _ARMS.update(arms)
        return _ARMS.get(name)


def check(name: str) -> bool:
    """The one call a site makes.  False on the unarmed path; on a trigger
    it raises ('raise'), blocks until disarmed ('hang'), sleeps ('delay'),
    or returns True ('corrupt': the site takes its corruption path)."""
    fp = REGISTRY[name]  # an unregistered name is a KeyError
    if not knobs.get("SPGEMM_TPU_FAILPOINTS"):
        return False
    arm = _arm_for(name)
    if arm is None:
        return False
    with _LOCK:
        if arm.remaining is not None and arm.remaining <= 0:
            return False
        if arm.prob < 1.0 and arm.rng.random() >= arm.prob:
            return False
        if arm.remaining is not None:
            arm.remaining -= 1
        _TRIGGERED[name] = _TRIGGERED.get(name, 0) + 1
    events.emit("failpoint_trigger", point=name, action=fp.kind)
    log.warning("failpoint %s triggered (%s)", name, fp.kind)
    if fp.kind == "raise":
        raise FailpointTriggered(name)
    if fp.kind == "hang":
        _hang(name)
        return False
    if fp.kind == "delay":
        # spgemm-lint: blk-ok(chaos injection: the delay IS the injected fault, armed only under SPGEMM_TPU_FAILPOINTS -- blocking wherever the site sits, locks included, is the point)
        time.sleep(DELAY_S)
        return False
    return True  # corrupt


def _hang(name: str) -> None:
    """Block until the point is disarmed or HANG_MAX_S passes."""
    deadline = time.monotonic() + HANG_MAX_S
    while time.monotonic() < deadline:
        if not knobs.get("SPGEMM_TPU_FAILPOINTS") or _arm_for(name) is None:
            return
        # spgemm-lint: blk-ok(chaos injection: the hang IS the injected wedge the watchdog must detect, armed only under SPGEMM_TPU_FAILPOINTS)
        time.sleep(HANG_POLL_S)


def triggered() -> dict[str, int]:
    """Triggers per point since the process started (or clear())."""
    with _LOCK:
        return dict(_TRIGGERED)


def armed() -> dict[str, dict]:
    """Per armed point under the current spec: kind, prob and the triggers
    left."""
    _arm_for(next(iter(REGISTRY)))  # parse the current value
    with _LOCK:
        return {name: {"kind": REGISTRY[name].kind, "prob": arm.prob,
                       "remaining": arm.remaining}
                for name, arm in _ARMS.items()}


def clear() -> None:
    """Zero the trigger counts and drop the parsed arms (the env knob is the
    caller's to clear)."""
    global _RAW
    with _LOCK:
        _RAW = None
        _ARMS.clear()
        _TRIGGERED.clear()
