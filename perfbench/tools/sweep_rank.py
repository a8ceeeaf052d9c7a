"""The knee of the ranking cell: the open loop of ``dlrm-criteo.rank`` at
each of ``--rates`` (requests a second) over one engine, each for
``--seconds``, printing a JSON line a rate: requests, completed, shed,
p50 and p99 from the due time, the generator's lag, the backlog of
requests in flight in the window's first half (its largest) and over its
last tenth (its mean). The knee is the highest rate at which every request
completes, none is shed and the backlog at the end is no larger than in
the first half.

    python3 perfbench/tools/sweep_rank.py --seed 1 --seconds 10 --rates 2000,4000,8000
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import harness  # noqa: E402
from perfbench.traffic import open_loop, scoring  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args()
    run = harness.Run("dlrm-criteo.rank", args.seed, args.seconds, False,
                      torch.device("cuda", 0), time.perf_counter())
    _, engine, pool = scoring.setup(run)
    print(json.dumps({"setup_s": time.perf_counter() - run.t_start}),
          flush=True)
    for k, rate in enumerate(float(r) for r in args.rates.split(",")):
        p = dict(run.params, rate_per_s=rate)
        a = open_loop.arrivals(args.seed + k, p, args.seconds, pool.shape[0])
        out = open_loop.drive(engine, pool, a, p, args.seconds, set())
        lat, n = out["lat_ms"], a["due"].size
        t = np.array([x for x, _ in out["backlog"]])
        b = np.array([y for _, y in out["backlog"]])
        c = out["counts"]
        print(json.dumps({
            "rate": rate, "requests": int(n),
            "completed": int(n - out["shed"] - out["wrong"]),
            "shed": out["shed"], "wrong": out["wrong"],
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "lag_p99_ms": float(np.nanpercentile(out["lag_ms"], 99)),
            "backlog_first_half_max": int(b[t < args.seconds / 2].max())
            if b.size else 0,
            "backlog_last_tenth_mean": float(b[t > 0.9 * args.seconds].mean())
            if (t > 0.9 * args.seconds).any() else 0.0,
            "drain_s": out["drain_s"],
            "occupancy": c["valid"] / max(c["padded"], 1),
            "dispatches": c["dispatches"]}), flush=True)


if __name__ == "__main__":
    main()
