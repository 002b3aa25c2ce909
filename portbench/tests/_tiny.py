"""Tiny cells for the CPU tests: the benchmark's own BENCHMARK.json with its
configurations cut to a few tiles, so a whole run takes under a second on the
CPU through the port's plain versions."""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY = {
    "report-medium": {"kind": "banded", "n": 5, "block_dim": 12, "bandwidth": 2, "k": 4},
}


def bench(tmp: Path) -> Path:
    """A copy of BENCHMARK.json whose configuration files are tiny copies
    of the real ones; returns its path."""
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    for conf in b["configs"]:
        cfg = json.loads((REPO / conf["file"]).read_text())
        cfg = copy.deepcopy(cfg)
        cfg["structure"] = dict(TINY[conf["name"]])
        path = tmp / f"{conf['name']}.json"
        path.write_text(json.dumps(cfg))
        conf["file"] = str(path)
    out = tmp / "BENCHMARK.json"
    out.write_text(json.dumps(b))
    return out


def cell(tmp: Path, name: str):
    from portbench import harness
    return harness.load_cell(name, bench(tmp))


def run(tmp: Path, name: str, monkeypatch, seconds: float = 0.3, seed: int = 2 ** 31 + 12345,
        trace: bool = False, backend: str | None = None):
    """One run of a tiny cell on the CPU, the harness's look for a card
    skipped: (result, check lines)."""
    import time

    import torch
    from portbench import harness
    c = cell(tmp, name)
    for key, value in harness.program_env(c.config, trace).items():
        monkeypatch.setenv(key, value)
    return harness.run(c, seed, seconds, trace, torch.device("cpu"), time.time(), backend)
