"""Nothing a run loads has the top-level name ``jax``, ``jaxlib``, ``flax`` or
``cleanumamba_tpu`` (compared whole: the port's name begins with the JAX
package's), and the plain reference loads nothing of the program."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from portbench.harness import ROOT

BANNED = {"jax", "jaxlib", "flax", "cleanumamba_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    code = ("import torch\n"
            "torch.set_num_threads(1)\n"
            "import portbench.run\n"
            "from portbench.tests import tiny\n"
            "for cell in ('e8-mux-live', 'e8-offline', 'e8-train'):\n"
            "    tr = {'e8-mux-live': {'calls': 1, 'call_seconds': [0.1, 0.2]},\n"
            "          'e8-offline': {'items': 1, 'seconds': 0.5},\n"
            "          'e8-train': {'items': 3, 'batch': 1, 'seconds': 0.3}}.get(cell)\n"
            "    tiny.run(tiny.context(cell, seconds=0.2, traffic=tr))\n")
    mods = _loaded(code)
    assert "cleanumamba_tpu_torch" in mods
    assert not mods & BANNED


def test_the_reference_loads_nothing_of_the_program():
    mods = _loaded("import portbench.reference.model, portbench.reference.train, "
                   "portbench.weights, portbench.traffic.audio, portbench.counts.k5")
    assert not mods & (BANNED | {"cleanumamba_tpu_torch"})


def test_the_run_refuses_a_loaded_jax_package():
    from portbench import run

    assert set(run.BANNED) == BANNED
    sys.modules.setdefault("cleanumamba_tpu", type(sys)("cleanumamba_tpu"))
    try:
        assert "cleanumamba_tpu" in run.banned_modules()
    finally:
        del sys.modules["cleanumamba_tpu"]


def test_without_a_card_the_run_exits_with_no_result():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "e8-offline",
                          "--seed", str(2 ** 31 + 11), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
