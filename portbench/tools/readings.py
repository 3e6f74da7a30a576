"""A cell's driver run in one process with its set-up or traffic changed, on
the chip: the sweep that sets a live cell's load, and witnesses beside the
output check's readings.

    python -m portbench.tools.readings --workload e8-mux-live --seeds 1 \
        --seconds 20 --traffic '{"calls": 6}' --traffic '{"calls": 8}'
    python -m portbench.tools.readings --workload e8-train --seeds 1,2,3 \
        --seconds 1 --setup '{"bf16": false}'

For each ``--traffic`` (the traffic file's keys replaced by the JSON given;
none: the file as it is) and each seed, runs the driver once (set-up, a
window of ``--seconds``, the check) with the workload's ``setup`` keys
replaced by ``--setup``, and prints a JSON line with the end-to-end
numbers, the counts (``backlog_grows`` for a live cell), the numbers
compared and the driver's info lines.  A live cell's load is set once from
such a sweep (about four fifths of the highest load whose ``hop_p95_ms``
stays within a hop with no growing backlog) and fixed in its traffic file.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--setup", default="{}")
    ap.add_argument("--traffic", action="append", default=None)
    args = ap.parse_args(argv)
    import torch

    from portbench.harness import Manifest, make_context, module

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0" if torch.cuda.is_available() else "cpu")
    manifest = Manifest()
    driver = module("drivers", manifest.workload(args.workload)["driver"])
    for traffic in args.traffic or ["{}"]:
        for seed in (int(s) for s in args.seeds.split(",")):
            ctx = make_context(manifest, args.workload, seed, args.seconds, False, device)
            ctx.workload = dict(ctx.workload, setup=dict(ctx.workload["setup"],
                                                         **json.loads(args.setup)))
            ctx.traffic = dict(ctx.traffic, **json.loads(traffic))
            out = driver.run(ctx)
            print(json.dumps({"workload": args.workload, "seed": seed, "setup": args.setup,
                              "traffic": traffic, "e2e": out["e2e"], "counts": out["counts"],
                              "compared": out["compared"], "info": out["info"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
