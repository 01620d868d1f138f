"""Readings that set a cell's limits: the program and its control, seed by seed.

    python3 amgbench/control.py --workload <cell> --seeds 1 2 ... [--device cuda]

In one process the cell's set-up runs once; then for each seed the first
request of that seed's window (x* of ``(seed, 1)``) is solved twice: by
the configuration's ``solve`` (the program as the cell runs it) and by
its ``control`` (the program's own float32 path, the precision below
the float64 the configuration states).  Each answer is compared with the
plain reference as a run compares it.  Where the configuration checks
the hierarchy (``galerkin``), its numbers are read with the seed's probe
vectors twice too: on the program's coarse operators and restrictions,
and on the reference's product of the operands rounded to bfloat16 in
their place.  One JSON line a seed gives both readings of each number;
the last line the largest program reading (the lower reading of a
limit) and the smallest control reading (the upper one) of each.  For
cells whose operator does not change with the seed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def readings(cell, seeds, device):
    """Yield ``(seed, {number: (program, control)})``."""
    import torch

    from amgbench import fields, harness
    from amgbench.reference import checks, operator
    from amgbench.reference.checks import galerkin, relres

    config = cell.config
    if int(cell.traffic.get("new_operator_every", 0)):
        raise ValueError("control.py takes cells with one operator")
    reqs = harness.Requests(config, cell.traffic, seeds[0], device)
    solver, secs = harness.build_solver(config, reqs.op, device)
    harness.log(f"{cell.name}: constructor {secs:.3f} s")
    k = reqs.field(0)
    ref = operator(config["operator"], config["dtype"],
                   None if k is None else k.cpu().numpy())
    hierarchy = (harness.read_hierarchy(solver)
                 if checks.wants_hierarchy(config) else None)
    for s in seeds:
        reqs.seed = int(s)
        x_star = reqs.solution(1)
        b = reqs.make(1)
        out = {}
        pair = []
        for entry in (config["solve"], config["control"]):
            x, _info = harness.call_solve(solver, entry, b)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            pair.append(relres.relres(ref, x_star.cpu().numpy(),
                                      x.double().cpu().numpy()))
        out["relres_max"] = tuple(pair)
        if hierarchy is not None:
            probes = config["checks"]["galerkin"]["probes"]
            seed = fields.stream_seed(s, fields.PROBES)
            prog = galerkin.readings(hierarchy, seed, probes)
            ctrl = galerkin.readings(hierarchy, seed, probes, control=True)
            out["galerkin_max"] = (prog[0], ctrl[0])
            out["transpose_max"] = (prog[1], ctrl[1])
        yield s, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from amgbench import spec

    cell = spec.load_cell(args.workload)
    rows = []
    for s, out in readings(cell, args.seeds, args.device):
        rows.append(out)
        print(json.dumps({"seed": s, **out}), flush=True)
    print(json.dumps({
        "workload": cell.name,
        **{name: {"lower": max(r[name][0] for r in rows),
                  "upper": min(r[name][1] for r in rows)}
           for name in rows[0]},
        "seconds": time.perf_counter() - T_START}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
