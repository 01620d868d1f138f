"""Run one cell of the benchmark and print its result as the last line.

    python3 amgbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is a ``workloads`` entry of ``BENCHMARK.json`` at the root of
the checkout.  A run needs as many CUDA cards as the cell asks for and
fails without them; it never falls back to the CPU.  Progress goes to
standard error, whose last lines are the numbers compared with their
limits; the result is one JSON object on the last line of standard
output.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the program's caches live in the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, str(ROOT / ".amgbench_cache" / sub))
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from amgbench import harness, spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        harness.log(f"{cell.name} needs {cell.chips} CUDA card(s); "
                    f"available: {torch.cuda.is_available()}, count "
                    f"{torch.cuda.device_count()}")
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), T_START, device="cuda")
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"modules of JAX or the JAX package were loaded: {bad}")
        return 3
    for name, num in result["checks"].items():
        harness.log(f"check {name} {num['value']!r} limit {num['limit']!r}")
    sys.stdout.flush()
    print(json.dumps(_finite(result)), flush=True)
    return 0


def _finite(obj):
    """``obj`` with every infinite or NaN number as null (strict JSON)."""
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


if __name__ == "__main__":
    sys.exit(main())
