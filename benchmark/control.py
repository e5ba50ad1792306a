"""Readings of the output check on many seeds in one process: the program
as it is (``--precision exact``, the lower readings) or with its own
lower-precision path switched on (``--precision fast``, F1 and F2 in place of
the exact transforms: the control, which the check has to fail).

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3
                                 --seconds 5 --precision fast

Prints one JSON line a seed: the seed, ``correct``, the frames of its window
and each number compared with its limit. The benchmark's own runs never run
this. Needs a CUDA card.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--precision", choices=("exact", "fast"),
                    default="fast")
    args = ap.parse_args(argv)

    import torch
    from benchmark.lib.harness import run_cell
    from benchmark.lib.manifest import Manifest

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    manifest = Manifest(ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        result = run_cell(manifest, args.workload, seed, args.seconds, False,
                          device, time.perf_counter(), args.precision)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "precision": args.precision, "correct": result.correct,
            "attempted": result.attempted, "failed": result.failed,
            "checks": {n: {"value": v, "limit": lim}
                       for n, v, lim in result.checks}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
