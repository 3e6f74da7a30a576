"""Readings of the output check's control and planted faults, on the chip.

    python -m portbench.tools.control --workload <cell> --seeds 1,2,3 \
        --seconds S --variant tf32 [--variant fp8] [--variant half_batch]

For each seed and variant, the cell's driver puts the plain reference at a
lower precision (``tf32``, ``bf16``, ``fp8``), or at fp32 with a fault
planted (``half_batch``: the training reference on the first half of each
batch's rows), in the program's place, on the inputs a run of that seed
makes, and prints the numbers it reads against the fp32 reference: one
JSON line each.  The limits of ``portbench/workloads/<cell>.json`` are set
between these readings and the program's own.
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
    ap.add_argument("--variant", action="append", required=True)
    args = ap.parse_args(argv)
    import torch

    from portbench.harness import Manifest, make_context, module

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0" if torch.cuda.is_available() else "cpu")
    manifest = Manifest()
    driver = module("drivers", manifest.workload(args.workload)["driver"])
    for seed in (int(s) for s in args.seeds.split(",")):
        for variant in args.variant:
            ctx = make_context(manifest, args.workload, seed, args.seconds, False, device)
            if variant == "half_batch":
                got = driver.control(ctx, "fp32", half_batch=True)
            else:
                got = driver.control(ctx, variant)
            print(json.dumps({"workload": args.workload, "seed": seed, "variant": variant,
                              **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
