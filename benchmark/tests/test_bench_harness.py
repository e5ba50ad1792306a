"""The harness: data-driven lookup, the refusal without a card, the
manifest's names, and the reduction of a trace."""

import json
import os
import re
import subprocess
import sys
import time

import pytest
import torch

from benchmark.lib import trace
from benchmark.lib.compare import Reservoir
from benchmark.lib.harness import run_cell
from benchmark.lib.manifest import Manifest
from conftest import REPO

CPU = torch.device("cpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH_CHARS = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_a_new_cell_traffic_and_reader_are_found(small_root):
    bench = small_root / "benchmark"
    (bench / "traffic" / "q30.file.json").write_text(json.dumps({
        "driver": "file_roundtrip", "quality": [30, 30, 30], "pool": 2,
        "warmup": 2, "sample": 2}))
    (bench / "layer_metrics" / "requests.compress.py").write_text(
        "def read(t):\n    s = t.span('compress')\n"
        "    return None if s is None else float(s.count)\n")
    manifest = json.loads((small_root / "BENCHMARK.json").read_text())
    manifest["workloads"].append({
        "name": "still4k.q30.file", "config": "still4k",
        "traffic": "q30.file", "chips": 1, "why": "a test cell"})
    manifest["per_layer"].append({
        "name": "requests.compress", "unit": "requests", "better": "higher",
        "source": "program_span", "layer": "engine/pipeline.py",
        "moves": "frames_per_s", "workloads": ["still4k.q30.file"]})
    for m in manifest["end_to_end"]:
        if "still992.q50.file" in m.get("workloads", []):
            m["workloads"].append("still4k.q30.file")
    (small_root / "BENCHMARK.json").write_text(json.dumps(manifest))

    m = Manifest(small_root)
    plain = run_cell(m, "still4k.q30.file", 11, 0.3, False, CPU,
                     time.perf_counter())
    assert plain.correct
    assert set(plain.metrics) == {"frames_per_s", "compress_ms_p95",
                                  "decompress_ms_p95", "setup_s"}
    traced = run_cell(m, "still4k.q30.file", 12, 0.3, True, CPU,
                      time.perf_counter())
    assert traced.correct
    assert traced.metrics["requests.compress"][0] == traced.attempted


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "still992.q50.file",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout == ""


def test_manifest_keeps_the_contract():
    raw = (REPO / "BENCHMARK.json").read_text()
    assert len(raw.encode()) <= 64 * 1024
    b = json.loads(raw)
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert all(PATH_CHARS.match(p) for p in b["paths"])
    assert all(1 <= len(w) <= 200 and "\n" not in w for w in b["command"])
    for path in b["paths"]:
        for f in (REPO / path).rglob("*"):
            if "__pycache__" not in f.parts:
                assert PATH_CHARS.match(str(f.relative_to(REPO))), f

    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["reduced"]) <= 16
        assert 1 <= len(c["source"]) <= 200 and "\n" not in c["source"]
        assert (REPO / c["file"]).is_file()
        assert any(c["file"].startswith(p + "/") for p in b["paths"])
        assert json.loads((REPO / c["file"]).read_text())["name"] == c["name"]
    cells = {w["name"]: w for w in b["workloads"]}
    assert len(cells) == len(b["workloads"])
    m = Manifest(REPO)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert m.driver(m.traffic(w["traffic"])["driver"])
    assert {w["config"] for w in b["workloads"]} == set(configs)
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == \
        len(cells)

    e2e = {x["name"]: x for x in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = [x["name"] for x in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names)
    for x in b["end_to_end"]:
        assert set(x) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    for x in b["per_layer"]:
        assert set(x) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert x["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(x["layer"]) <= 200 and "\n" not in x["layer"]
        assert x["moves"] in e2e
        assert m.reader(x["name"])
        for cell in x.get("workloads", cells):
            assert cell in cells
            assert cell in e2e[x["moves"]].get("workloads", cells)
    for x in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"])
        assert x["better"] in ("lower", "higher")
        if x["name"].endswith("_roofline"):
            assert x["unit"] == "%"
    for cell in cells:
        reported = [x["name"] for x in m.metrics("end_to_end", cell)]
        assert "setup_s" in reported and len(reported) >= 2
        assert m.metrics("per_layer", cell)


def test_trace_summary_charges_operations_to_spans():
    ms = 1_000_000
    spans = [("compress", 0, 0, 10 * ms), ("parse", 1, 0, 2 * ms),
             ("decompress", 0, 10 * ms, 20 * ms)]
    ops = [("Memcpy HtoD (Pageable -> Device)", 2 * ms, 4 * ms, 1 * ms),
           ("void k1<int>(int)", 4 * ms, 6 * ms, 3 * ms),
           ("k2", 12 * ms, 13 * ms, 11 * ms),
           ("k2", 13 * ms, 14 * ms, 11 * ms + 1)]
    work = {"compress": [3.35e9, 0.0, 1]}
    s = trace.summarise(ops, spans, 0, 20 * ms, 1, work,
                        {"bytes_per_s": 3.35e12, "f32_per_s": 67e12})
    assert s.window_s == pytest.approx(0.020)
    assert s.busy_s == pytest.approx(0.006)
    assert s.kernels == 3
    c = s.span("compress")
    assert (c.count, c.device_s, c.copy_s, c.kernels) == pytest.approx(
        (1, 0.004, 0.002, 1))
    assert s.span("decompress").device_s == pytest.approx(0.002)
    assert dict(s.idle_top) == pytest.approx(
        {"parse": 0.002, "compress": 0.004, "decompress": 0.008})
    assert dict(s.device_top)["k1<int>(int)"] == pytest.approx(0.002)

    from benchmark.lib.readers import roofline_pct
    assert roofline_pct(s, "compress") == pytest.approx(100 * 1e-3 / 0.004)
    assert roofline_pct(s, "decompress") is None


def test_reservoir_claim_draws_the_sample_that_offer_draws():
    a, b = Reservoir(8, 2 ** 31 + 12345), Reservoir(8, 2 ** 31 + 12345)
    for item in range(3000):
        a.offer(item)
        slot = b.claim()
        if slot is not None:
            b.put(slot, item)
    assert a.items == b.items and len(a.items) == 8
    assert a.items != list(range(8))  # later items replaced early ones
