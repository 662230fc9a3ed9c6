"""Find a serve cell's knee: the highest rate of submissions whose
backlog does not grow over a window.

    python3 -m portbench.knee --workload <serve cell> --seed <n> --seconds <s> --rates 100,200,300

runs the cell's driver once per rate in one process and prints, per rate,
the submissions resolved a second, the median and 95th percentile from due
to resolved, the backlog (submissions pending) sampled once a second, and
the generator's worst lateness.  Backlog that climbs through the window
means the rate is past the knee.  The cell's traffic file then takes four
fifths of the highest rate that held.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import sys

from portbench import core
from portbench.run import run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    cell = core.load_cell(args.workload)
    for k, rate in enumerate(float(r) for r in args.rates.split(",")):
        rec = run_cell(cell, args.seed + k, args.seconds, False, "cuda", rate=rate)["rec"]
        lat = [x for x in rec["latencies_s"] if not math.isinf(x)]
        print(json.dumps({
            "rate": rate, "submissions": rec["attempted"], "failed": rec["failed"],
            "resolved_per_s": len(lat) / rec["window_s"],
            "p50_ms": 1e3 * statistics.median(lat) if lat else None,
            "p95_ms": 1e3 * core.p95(rec["latencies_s"]) if lat else None,
            "backlog": rec["backlog"], "late_max_s": max(rec["lateness_s"] or [0.0]),
            "correct": all(c.ok for c in rec["checks"]),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
