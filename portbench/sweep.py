"""Find the highest rate an open-loop cell sustains, by a sweep on the card.

    python3 portbench/sweep.py --workload <cell> --seed <n> --seconds 10 \\
        --rates 4000,8000,12000

Runs the cell's traffic at each rate in turn (one process; each rate a fresh
service and window through the same harness as a run) and prints, a line a
rate, the 50th and 95th percentile latency, the late share of the last
tenth of the queries against the first, and whether the queue held.  A rate
is sustained when the p95 stays under ``--p95-limit-ms`` and the last
tenth's median latency is under twice the first tenth's (no growing
backlog).  The cell's rate is then set, in its traffic file, at 0.8 of the
highest sustained rate; the benchmark's own runs never run this.
"""
import argparse
import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--p95-limit-ms", type=float, default=50.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np

    from portbench import harness

    base = harness.load_cell(args.workload)
    for rate in (float(r) for r in args.rates.split(",")):
        cell = copy.deepcopy(base)
        cell.traffic["loop"]["rate_per_s"] = rate
        cell.end_to_end = [{"name": "query_p95_ms", "unit": "ms"}]
        lat = []
        harness_run = harness.run_cell(cell, args.seed, args.seconds, False,
                                       device="cuda", keep_latencies=lat)
        lat = np.asarray(lat[0])
        tenth = max(1, lat.size // 10)
        first, last = np.median(lat[:tenth]), np.median(lat[-tenth:])
        p95 = float(np.percentile(lat, 95))
        held = p95 < args.p95_limit_ms and last < 2 * first
        print(json.dumps({"rate": rate, "p50_ms": float(np.percentile(lat, 50)),
                          "p95_ms": p95, "first_tenth_ms": float(first),
                          "last_tenth_ms": float(last), "sustained": bool(held),
                          "correct": harness_run["correct"],
                          "cache_hits_checked": harness_run["info"]["checked_from_cache"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
