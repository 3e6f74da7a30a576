#!/usr/bin/env python3
"""Probe of the first multi-threaded fp32 ``torch.exp`` of a CPU process.

    python scripts/torch_first_exp_probe.py                     # 40 rounds of 8 processes
    python scripts/torch_first_exp_probe.py --variant package   # after importing ops/scan.py
    python scripts/torch_first_exp_probe.py --rounds 10 --procs 8 --variant threads1

Starts ``--procs`` fresh processes at once, ``--rounds`` times.  Each
computes, as its first torch computation, the plain chunked selective scan
at (B 2, L 37, d_inner 200, d_state 8) op by op (the chunk's ``dt * A``,
``exp``, the pair scan, the read-out), holds every op's output against the
same op in float64 on the op's own fp32 inputs and the result against a
float64 sequential scan, and prints one JSON line.  The parent counts the
processes in which some op was off by more than 1e-5 of its max, and names
the ops.  Variants, each in the child before that computation:

- ``base``: nothing (imports torch and numpy only);
- ``package``: imports ``cleanumamba_tpu_torch.ops.scan`` (its
  import-time warm-up of exp);
- ``warm_exp`` / ``warm_sin``: one ``exp`` / ``sin`` of 102,400 zeros;
- ``threads1``: one torch thread;
- ``exp64``: every exp taken in float64.

Runs on the CPU only; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (2, 37, 200, 8)
TOL = 1e-5


def inputs(seed: int = sum(SHAPE)):
    """The scan's inputs at ``SHAPE`` as float32 numpy arrays, from ``seed``."""
    import numpy as np

    Bsz, L, di, ds = SHAPE
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return dict(u=f(Bsz, L, di), dt=np.abs(f(Bsz, L, di)) * 0.1, A=-np.abs(f(di, ds)),
                B=f(Bsz, L, ds), C=f(Bsz, L, ds), D=f(di), h0=f(Bsz, di, ds) * 0.5)


def float64_scan(a):
    """The oracle: the sequential selective scan of :func:`inputs`'s arrays
    in float64; returns (y, h_last)."""
    import numpy as np

    u, dt, A, B, C, D, h = (a[k].astype(np.float64) for k in ("u", "dt", "A", "B", "C", "D",
                                                             "h0"))
    ys = []
    for s in range(u.shape[1]):
        h = np.exp(dt[:, s, :, None] * A) * h + (dt[:, s] * u[:, s])[..., None] * B[:, s, None]
        ys.append(np.einsum("bis,bs->bi", h, C[:, s]))
    return np.stack(ys, 1) + u * D, h


def child(variant: str) -> None:
    import numpy as np
    import torch

    if variant == "package":
        sys.path.insert(0, ROOT)
        import cleanumamba_tpu_torch.ops.scan  # noqa: F401
    elif variant == "warm_exp":
        torch.exp(torch.zeros(102400))
    elif variant == "warm_sin":
        torch.sin(torch.zeros(102400))
    elif variant == "threads1":
        torch.set_num_threads(1)
    exp = (lambda x: torch.exp(x.double()).float()) if variant == "exp64" else torch.exp

    L = SHAPE[1]
    a = inputs()
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    d = lambda x: x.numpy().astype(np.float64)  # noqa: E731
    ops = []

    def rec(name, out, ref):
        out = d(out)
        ops.append((name, float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))))

    h, ys = t["h0"], []
    for t0 in range(0, L, 32):
        sl = slice(t0, t0 + 32)
        dtc = t["dt"][:, sl]
        prod = dtc[..., None] * t["A"]
        rec(f"c{t0}:dt*A", prod, d(dtc)[..., None] * d(t["A"]))
        aa = exp(prod)
        rec(f"c{t0}:exp", aa, np.exp(d(prod)))
        du = dtc * t["u"][:, sl]
        bb = du[..., None] * t["B"][:, sl][:, :, None, :]
        rec(f"c{t0}:du*B", bb, d(du)[..., None] * d(t["B"][:, sl])[:, :, None, :])
        k = 1
        while k < aa.shape[1]:
            nb = torch.cat([bb[:, :k], aa[:, k:] * bb[:, :-k] + bb[:, k:]], dim=1)
            rec(f"c{t0}:scan{k}", nb, np.concatenate(
                [d(bb)[:, :k], d(aa)[:, k:] * d(bb)[:, :-k] + d(bb)[:, k:]], 1))
            aa, bb = torch.cat([aa[:, :k], aa[:, k:] * aa[:, :-k]], dim=1), nb
            k *= 2
        h_t = aa * h[:, None] + bb
        y = torch.einsum("btis,bts->bti", h_t, t["C"][:, sl])
        rec(f"c{t0}:readout", y, np.einsum("btis,bts->bti", d(h_t), d(t["C"][:, sl])))
        ys.append(y)
        h = h_t[:, -1]
    y = torch.cat(ys, 1) + t["u"] * t["D"]

    ref, _ = float64_scan(a)
    print(json.dumps({"y": float(np.abs(d(y) - ref).max() / np.abs(ref).max()),
                      "bad_ops": [o for o in ops if o[1] > TOL],
                      "threads": torch.get_num_threads()}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--procs", type=int, default=8, help="processes started at once")
    ap.add_argument("--variant", default="base",
                    choices=["base", "package", "warm_exp", "warm_sin", "threads1", "exp64"])
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.variant)
        return 0
    rows = []
    for _ in range(args.rounds):
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--child",
                                   "--variant", args.variant], stdout=subprocess.PIPE, text=True)
                 for _ in range(args.procs)]
        for p in procs:
            out, _ = p.communicate(timeout=600)
            if p.returncode != 0:
                raise RuntimeError(f"a probe process exited {p.returncode}")
            rows.append(json.loads(out.strip().splitlines()[-1]))
    bad = [r for r in rows if r["bad_ops"] or r["y"] > TOL]
    print(json.dumps({"variant": args.variant, "processes": len(rows), "wrong": len(bad),
                      "ops": sorted({o[0] for r in bad for o in r["bad_ops"]}),
                      "worst_y": max(r["y"] for r in rows),
                      "threads": sorted({r["threads"] for r in rows})}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
