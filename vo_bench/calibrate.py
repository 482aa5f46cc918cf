"""Readings that set the benchmark's fixed numbers, on the card, in one process:

    python3 -m vo_bench.calibrate sweep --workload turn_robust.live --rates 40 60 80 --seconds 8
    python3 -m vo_bench.calibrate readings --workload default.replay --seeds 1 2 3 \
        [--system program|control] [--every 1] --seconds 6

``sweep``: the live loop at each fixed rate (the traffic's own rate replaced), its
latency percentiles and how far latency grows from the window's second quarter to its
last (a backlog that grows means the rate is above what the loop sustains).
``readings``: the check's ``pose_gap``, ``map_gap`` and the frames it compared, one short run a seed,
for the program or for the control (the reference in TF32 in the program's place). The
benchmark's own runs never run either. Each writes one JSON file (``--out``).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

from vo_bench import run, stats


def sweep(args) -> dict:
    spec = run.find_cell(args.workload)
    out = []
    for r in args.rates:
        s = copy.deepcopy(spec)
        s["traffic"]["rate_hz"] = r
        t = time.perf_counter()
        res = run.run_cell(s, args.seed, args.seconds, False, t_start=t)
        lat = res["_notes"]
        row = {"rate_hz": r, "correct": res["correct"],
               "p50_ms": res["metrics"]["latency_p50_ms"]["value"],
               "p95_ms": lat["latency_p95_ms"],
               "max_ms": lat["latency_max_ms"], "growth_ms": lat["growth_ms"],
               "poses": lat["poses"]}
        print(json.dumps(row), file=sys.stderr, flush=True)
        out.append(row)
    return {"workload": args.workload, "seed": args.seed, "seconds": args.seconds, "rates": out}


def readings(args) -> dict:
    spec = run.find_cell(args.workload)
    if args.every:
        # the control's eager window is some ten times slower than the program's: sample
        # more boundaries, so that it compares as many frames as a run does
        spec["traffic"]["check"]["every"] = args.every
    out = []
    for seed in args.seeds:
        t = time.perf_counter()
        res = run.run_cell(spec, seed, args.seconds, False, system=args.system, t_start=t)
        row = {"seed": seed, "pose_gap": res["checks"]["pose_gap"]["value"],
               "map_gap": res["checks"]["map_gap"]["value"],
               "frames": res["checks"]["frames_compared"]["value"],
               "by_kind": res["_notes"]["check"].get("by_kind"),
               "error": res["_notes"]["check"].get("error"),
               "metrics": {k: v["value"] for k, v in res["metrics"].items()},
               "run_s": time.perf_counter() - t}
        print(json.dumps(row), file=sys.stderr, flush=True)
        out.append(row)
    summary = {k: {"max": max(r[k] for r in out), "min": min(r[k] for r in out)}
               for k in ("pose_gap", "map_gap")}
    return {"workload": args.workload, "system": args.system, "seconds": args.seconds,
            "runs": out, **summary}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="readings that set the benchmark's numbers")
    sub = ap.add_subparsers(dest="what", required=True)
    a = sub.add_parser("sweep")
    a.add_argument("--workload", required=True)
    a.add_argument("--rates", type=float, nargs="+", required=True)
    a.add_argument("--seed", type=int, default=2147483701)
    a.add_argument("--seconds", type=float, default=8.0)
    b = sub.add_parser("readings")
    b.add_argument("--workload", required=True)
    b.add_argument("--seeds", type=int, nargs="+", required=True)
    b.add_argument("--system", choices=("program", "control"), default="program")
    b.add_argument("--seconds", type=float, default=6.0)
    b.add_argument("--every", type=int, default=0, help="sample every n-th boundary")
    for p in (a, b):
        p.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(run.ROOT, "build", "torch_extensions"))
    res = sweep(args) if args.what == "sweep" else readings(args)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(res, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
