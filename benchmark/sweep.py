"""The served search's knee: one set-up, then open-loop Poisson arrivals at
each rate in turn, on the card.

    python3 benchmark/sweep.py --workload search.sgpt-5.8b.nq-poisson --seed 7 \
        --rates 50,100,200 [--seconds 10] [--limit-ms 50] [--out FILE]

Prints one JSON line a rate: p50 and p95 over every request (timed from when
it was due), the median latency of the last third of the arrivals over that
of the first third (a backlog that grows through the run reads well above
1), the seconds from the last arrival until the last answer, how late the
generator ran, and K5's launches. Then the knee: the highest rate whose p95
meets the limit with no growing backlog (a ratio under 1.5), or, where no
rate meets the limit, the highest rate with no growing backlog.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402
from benchmark.metrics._percentile import percentile  # noqa: E402

GROWTH = 1.5


def one_rate(drv, rate: float, seconds: float) -> dict:
    drv.mix["rate_qps"] = rate
    c0 = drv.counters()
    run = drv.run_arrivals(drv._arrivals(seconds), drain_s=drv.mix["drain_s"])
    c1 = drv.counters()
    reqs = run["requests"]
    lat = [None if r["result"] is None else 1e3 * (r["done"] - r["due"]) for r in reqs]
    third = max(1, len(lat) // 3)
    head = [x for x in lat[:third] if x is not None]
    tail = [x for x in lat[-third:] if x is not None]
    done = [r["done"] for r in reqs if r["done"] is not None]
    return {"rate_qps": rate, "requests": len(reqs), "failed": sum(x is None for x in lat),
            "p50_ms": percentile(lat, 50), "p95_ms": percentile(lat, 95),
            "growth": (statistics.median(tail) / statistics.median(head)
                       if head and tail else None),
            "drain_s": (max(done) - run["t_last"]) if done else None,
            "late_ms_max": max(1e3 * (r["sent"] - r["due"]) for r in reqs),
            "k5_launches": c1["k5_launches"] - c0["k5_launches"],
            "queries_served": c1["queries_served"] - c0["queries_served"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--limit-ms", type=float, default=50.0)
    ap.add_argument("--out")
    args = ap.parse_args()
    harness.set_environment()
    spec = harness.cell(harness.load_json(harness.ROOT / "BENCHMARK.json"), args.workload)
    drv = harness.driver_class(spec["mix"])(spec["config"], spec["mix"], args.seed, "cuda",
                                            check_params=spec["check"])
    drv.setup(1.0)
    rows = []
    for rate in (float(r) for r in args.rates.split(",")):
        rows.append(one_rate(drv, rate, args.seconds))
        print(json.dumps(rows[-1]), flush=True)
    drv.release()
    steady = [r for r in rows if r["failed"] == 0 and r["growth"] is not None
              and r["growth"] < GROWTH]
    meets = [r for r in steady if r["p95_ms"] is not None and r["p95_ms"] <= args.limit_ms]
    knee = max(meets or steady, key=lambda r: r["rate_qps"], default=None)
    summary = {"knee_qps": knee and knee["rate_qps"], "meets_limit": bool(meets),
               "limit_ms": args.limit_ms, "rates": rows}
    print(json.dumps({"knee_qps": summary["knee_qps"], "meets_limit": summary["meets_limit"]}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
