"""Benchmark of cleanumamba_tpu_torch, the PyTorch and CUDA port, on NVIDIA GPUs.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Builds the cell's weights and traffic from
the seed on the card, warms every shape the cell uses, measures for
``--seconds``, checks the outputs against the plain reference
(``portbench/reference``), and prints one JSON object as the last line of
standard output: the cell's end-to-end metrics (``--trace 0``) or its
per-layer metrics read from a ``torch.profiler`` trace (``--trace 1``).
The numbers compared and their limits are the last lines of standard error.
Exits non-zero, with no result, when there is no CUDA device (or fewer than
the cell asks for) and when JAX or the JAX package is loaded.
"""

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# JAX and the JAX package may not be loaded by a run (compared by the whole
# top-level module name: the port's name begins with the JAX package's)
BANNED = ("jax", "jaxlib", "flax", "cleanumamba_tpu")


def banned_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def prepare_environment(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout, and
    no JAX pulled in by a library."""
    cache = os.path.join(root, ".portbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.getcwd()
    prepare_environment(root)
    from portbench.harness import Manifest, run_cell

    manifest = Manifest()
    chips = manifest.cell(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"portbench: {args.workload} seed {args.seed} on {power_limit()}", file=sys.stderr)
    result, lines = run_cell(manifest, args.workload, args.seed, args.seconds,
                             bool(args.trace), torch.device("cuda:0"), T0)
    found = banned_modules()
    if found:
        print(f"portbench: loaded {', '.join(found)}: the run may not load JAX or the JAX "
              "package", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
