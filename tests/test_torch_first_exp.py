"""The plain scan is never a process's first multi-threaded fp32 exp
(``ops/scan.py::_warm_transcendentals``).

The first multi-threaded fp32 ``torch.exp`` of a CPU process can come out
~1e-4 wrong in a small share of processes started together, and every later
call is right.  ``ops/scan.py`` therefore runs exp (and log, tanh and
sigmoid, which share its thread-split kernels) once on one thread and once
over every thread when it is imported.  These tests pin the warm-up,
and run the plain scan as the first computation of fresh processes that
import no JAX, each held against the float64 oracle of
``scripts/torch_first_exp_probe.py``.
"""

import functools
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RECORD = """
import json, torch
calls = []
real = torch.exp
def spy(x, *a, **k):
    calls.append([x.numel(), torch.get_num_threads()])
    return real(x, *a, **k)
torch.exp = spy
import cleanumamba_tpu_torch.ops.scan
print(json.dumps(calls))
"""

_RECORD_ALL = """
import json, torch
calls = {}
for name in ("exp", "log", "tanh", "sigmoid"):
    def spy(x, *a, _name=name, _real=getattr(torch, name), **k):
        calls.setdefault(_name, []).append([x.numel(), torch.get_num_threads()])
        return _real(x, *a, **k)
    setattr(torch, name, spy)
import cleanumamba_tpu_torch.ops.scan
print(json.dumps(calls))
"""

_FIRST_SCAN = """
import json, sys
import numpy as np
sys.path.insert(0, "scripts")
from torch_first_exp_probe import float64_scan, inputs
import torch
from cleanumamba_tpu_torch.ops import scan

a = inputs(49)
y, h = scan.selective_scan(**{k: torch.from_numpy(v) for k, v in a.items()})
ref, h_ref = float64_scan(a)
print(json.dumps([float(np.abs(y.numpy() - ref).max() / np.abs(ref).max()),
                  float(np.abs(h.numpy() - h_ref).max() / np.abs(h_ref).max())]))
"""


def _env(threads):
    env = dict(os.environ, OMP_NUM_THREADS=str(threads))
    env["PYTHONPATH"] = os.pathsep.join([ROOT, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    return env


def test_importing_the_scan_runs_exp_on_one_thread_then_over_every_thread():
    r = subprocess.run([sys.executable, "-c", _RECORD], cwd=ROOT, env=_env(4),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    calls = json.loads(r.stdout.strip().splitlines()[-1])
    assert len(calls) == 2
    (small, threads), (large, _) = calls
    assert threads == 4
    assert small <= 32768  # one thread
    assert large >= 32768 * threads  # a share for every thread


@functools.cache
def _warm_calls():
    r = subprocess.run([sys.executable, "-c", _RECORD_ALL], cwd=ROOT, env=_env(4),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["log", "tanh", "sigmoid"])
def test_importing_the_scan_warms_log_tanh_and_sigmoid_too(name):
    """The softplus, the gates and the loss's log go through the same
    thread-split kernels as exp: each is run once on one thread, then over
    every thread, at import."""
    calls = _warm_calls()[name]
    assert len(calls) == 2
    (small, threads), (large, _) = calls
    assert threads == 4
    assert small <= 32768
    assert large >= 32768 * threads


def test_the_first_scan_of_fresh_processes_matches_float64():
    """Four processes at once, each with four threads, each computing the
    plain scan as its first torch computation: y and h_last within 1e-5 of
    the float64 oracle's max."""
    procs = [subprocess.Popen([sys.executable, "-c", _FIRST_SCAN], cwd=ROOT, env=_env(4),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        y_err, h_err = json.loads(out.strip().splitlines()[-1])
        assert y_err <= 1e-5 and h_err <= 1e-5, (y_err, h_err)
