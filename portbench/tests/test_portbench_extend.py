"""A later change adds a cell with files alone: here a loop of its own
(`loops/<name>.py`), a mix that names it (`traffic/<name>.json`) and a
cell in BENCHMARK.json, beside a copy of the benchmark, with no file of
it edited."""

import json
import shutil
import time

import torch
from _tiny import REPO, bench

FIXED = '''"""A fixed number of requests, one at a time."""
import time


def run(driver, seed, seconds, reservoir, spans=False):
    from portbench.harness import Loop, sync
    loop = Loop()
    loop.start = time.perf_counter()
    for i in range(int(driver.mix["requests"])):
        driver.draw(seed, i)
        loop.attempted += 1
        t0 = time.perf_counter()
        results = driver.request()
        sync(driver.device)
        loop.latencies.append(time.perf_counter() - t0)
        loop.completed += 1
        reservoir.offer(i, results)
    loop.end = time.perf_counter()
    loop.extra["requests"] = loop.completed
    return loop
'''


def test_a_new_loop_and_mix_need_no_edit(tmp_path, monkeypatch):
    from portbench import harness
    copy = tmp_path / "portbench"
    shutil.copytree(REPO / "portbench", copy, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    (copy / "loops" / "fixed.py").write_text(FIXED)
    (copy / "traffic" / "fixed3.json").write_text(json.dumps(
        {"loop": "fixed", "requests": 3, "request": "chain_product", "values": "fresh",
         "why": "three requests"}))
    path = bench(tmp_path)
    b = json.loads(path.read_text())
    b["workloads"].append({"name": "medium.fixed3", "config": "report-medium",
                           "traffic": "fixed3", "chips": 1, "why": "three requests"})
    for m in b["end_to_end"]:
        if m["name"] == "chain_s":
            m["workloads"].append("medium.fixed3")
    path.write_text(json.dumps(b))
    assert all(p.read_bytes() == data for p, data in before.items())

    monkeypatch.setattr(harness, "ROOT", copy)
    cell = harness.load_cell("medium.fixed3", path)
    for key, value in harness.program_env(cell.config, False).items():
        monkeypatch.setenv(key, value)
    result, _ = harness.run(cell, 2 ** 40 + 3, 60.0, False, torch.device("cpu"), time.time())
    assert result["correct"] is True
    assert result["attempted"] == 3
    assert set(result["metrics"]) == {"chain_s", "device_peak_gib", "setup_s"}
