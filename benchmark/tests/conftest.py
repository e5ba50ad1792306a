"""Fixtures of the benchmark's CPU tests: a copy of the benchmark at a size
the CPU runs in a second (the harness, the drivers and the reference
unchanged; the configurations and pools made small)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

SMALL = {"still4k": (128, 192), "still992": (128, 192),
         "video1080": (32, 64)}


def make_small(dst: Path) -> Path:
    """Copy ``BENCHMARK.json`` and ``benchmark/`` to ``dst`` with small
    configurations (stills 128 x 192, video 32 x 64) and pools (3 stills, a
    job of 16 frames in batches of 4)."""
    shutil.copy(REPO / "BENCHMARK.json", dst)
    shutil.copytree(REPO / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, (h, w) in SMALL.items():
        path = dst / "benchmark" / "configs" / f"{name}.json"
        c = json.loads(path.read_text())
        c["height"], c["width"] = h, w
        c["content"]["r_max"] = 40
        if "pan" in c["content"]:
            c["content"]["pan"] = [8, 16]
        path.write_text(json.dumps(c))
    for path in (dst / "benchmark" / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        if "batch" in t:
            t.update(pool=16, batch=4, warmup=4)
        else:
            t.update(pool=3, warmup=3)
        path.write_text(json.dumps(t))
    return dst


@pytest.fixture
def small_root(tmp_path):
    return make_small(tmp_path)
