"""The benchmark of ``myyuv_tpu_torch`` on one CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Makes the cell's inputs from the seed, warms up, drives the program for
``--seconds`` seconds, checks what it produced against the plain reference
in ``benchmark/reference/`` and prints one JSON line: the cell's end-to-end
metrics (``--trace 0``) or its per-layer metrics from a ``torch.profiler``
trace of the window (``--trace 1``). Exits non-zero, printing no result,
without a CUDA card, with fewer cards than the cell asks for, or when JAX or
the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "myyuv_tpu")


def forbidden_modules():
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from benchmark.lib.harness import run_cell
    from benchmark.lib.manifest import Manifest

    manifest = Manifest(ROOT)
    spec = manifest.cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < spec["chips"]:
        print(f"{args.workload} needs {spec['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t_card = time.perf_counter() - T_START
    result = run_cell(manifest, args.workload, args.seed, args.seconds,
                      bool(args.trace), device, T_START)
    # asked after the window, so that nvidia-smi's time is not set-up's
    print(f"card: {power_limit()}", file=sys.stderr)
    print(f"set-up to the card: {t_card:.3f} s (imports, the card "
          "selected)", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for note in result.notes:
        print(note, file=sys.stderr)
    for name, value, limit in result.checks:
        print(f"check {name} = {value} (limit {limit})", file=sys.stderr)
    sys.stderr.flush()
    line = {"correct": result.correct, "attempted": result.attempted,
            "failed": result.failed,
            "metrics": {k: {"value": v, "unit": u}
                        for k, (v, u) in result.metrics.items()},
            "device": result.device}
    if result.breakdown is not None:
        line["breakdown"] = result.breakdown
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit in result.checks}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
