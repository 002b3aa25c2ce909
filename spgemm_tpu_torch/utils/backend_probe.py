"""CUDA liveness probe for the CLI's --failover (the port's counterpart of
the JAX package's `utils/backend_probe.py`).

A card can fail by hanging in its initialization or its first operation
rather than by raising, which no handler in this process could escape.  So
the probe runs a small product on the card in a subprocess with a time
limit.  It runs only on request: the CLI asks for it under --failover
before the chain, and chain.chain_product(failover=True) after a multiply
raised, to tell a lost card from a fault of the program.  Without failover
a missing card raises, as every entry point does
(ops/device.resolve_device).
"""

from __future__ import annotations

import subprocess
import sys

from spgemm_tpu_torch.utils import knobs

_PROBE = """
import torch
if not torch.cuda.is_available():
    print("cpu")
    raise SystemExit(0)
x = torch.ones((64, 64), device="cuda")
(x @ x).sum().item()
torch.cuda.synchronize()
print("cuda")
"""


def probe_default_backend(timeout_s: float | None = None) -> str:
    """'ok' (the card computed), 'cpu' (torch sees no card), 'timeout' (the
    subprocess hung past SPGEMM_TPU_PROBE_TIMEOUT, default 150 s) or
    'error' (it crashed)."""
    if timeout_s is None:
        timeout_s = knobs.get("SPGEMM_TPU_PROBE_TIMEOUT")
    try:
        proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                              text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return "timeout"
    if proc.returncode != 0:
        return "error"
    lines = proc.stdout.split()
    return "ok" if lines and lines[-1] == "cuda" else "cpu"


_ERROR_PROBES = 2  # an 'error' may be transient: probe once more


def failover_to_cpu(context: str) -> bool:
    """Probe the card; True when it is unusable, after one line on stderr
    saying so (the caller then runs on the CPU).  An 'error' is probed once
    more (it may be transient); a 'timeout' is not (a hang persists, and
    each probe costs the whole limit)."""
    outcome = "error"
    for _ in range(_ERROR_PROBES):
        outcome = probe_default_backend()
        if outcome in ("ok", "cpu", "timeout"):
            break
    if outcome == "ok":
        return False
    print(f"{context}: CUDA device unusable (probe: {outcome}); falling back to cpu",
          file=sys.stderr, flush=True)
    return True
