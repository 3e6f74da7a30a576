"""Runs of one cell, each a process of its own, and the spread of each metric.

    python -m portbench.tools.sets --workload e8-mux-live --seeds 1,2,3,4,5,6 \
        --seconds 20 [--trace 1] [--out chiprun_out/sets.jsonl]

Runs ``python -m portbench.run`` once a seed, one after the other, appends
each run's result (its last standard-output line, with its exit code, wall
time and compared numbers) to ``--out`` as a JSON line, and prints a line a
run and, at the end, each metric's spread: the distance between the first
and the third quartile (``statistics.quantiles(values, n=4)``) as a share of
the median, the measure the bounds of ``BENCHMARK.json`` are set from.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def spread(values) -> float:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    values = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        cmd = [sys.executable, "-m", "portbench.run", "--workload", args.workload,
               "--seed", str(seed), "--seconds", str(args.seconds), "--trace", str(args.trace)]
        t = time.perf_counter()
        p = subprocess.run(cmd, capture_output=True, text=True)
        wall = time.perf_counter() - t
        lines = p.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1])
        except (IndexError, ValueError):
            result = None
        rec = {"cell": args.workload, "seed": seed, "seconds": args.seconds,
               "trace": args.trace, "rc": p.returncode, "wall": wall,
               "result": result, "stderr_tail": p.stderr[-1500:]}
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if result is None:
            print(f"{args.workload} seed={seed} rc={p.returncode} no result:\n"
                  f"{p.stderr[-1500:]}", flush=True)
            continue
        m = {k: v["value"] for k, v in result["metrics"].items()}
        for k, v in m.items():
            values.setdefault(k, []).append(v)
        info = [ln for ln in p.stderr.splitlines() if ln.startswith(("hops ", "steps ",
                                                                        "clips "))]
        print(f"{args.workload} seed={seed} s={args.seconds:g} tr={args.trace} "
              f"rc={p.returncode} wall={wall:.1f} correct={result['correct']} {m} "
              f"{ {c: x['value'] for c, x in result.get('compared', {}).items()} } "
              f"{info[-1] if info else ''}", flush=True)
    for k, v in values.items():
        if len(v) >= 4:
            print(f"spread {args.workload} {k}: median {statistics.median(v)!r} "
                  f"IQR/median {spread(v)!r} over {len(v)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
