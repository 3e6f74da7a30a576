"""Live calls: the generator of every traffic file of ``"kind": "live"``.

Parameters (the traffic file):

- ``calls``: concurrent calls (lines); ``hop_ms`` and ``sample_rate``: each
  call sends ``hop_ms * sample_rate / 1000`` samples every ``hop_ms`` on its
  own real-time schedule;
- ``call_seconds``: ``[lo, hi]``, each call lasts a duration from the fixed
  set of ``durations`` quantiles of the log-uniform distribution on
  [lo, hi], dealt out to the lines in an order drawn from the seed; when a
  call ends the next opens on its line at once.  The first call of each
  line is already running when the window opens: it has a share
  ``(k + 0.5) / calls`` of its duration left, k in an order drawn from the
  seed.  ``null``: one call a line for the whole run;
- every call's phase, its offset within a hop, is drawn uniformly from
  [0, hop) from the seed, as independent callers' clocks fall: a new call
  on a line arrives at its own phase, so the calls' collisions change
  through a window;
- ``jitter_ms``: each hop reaches the server after a network delay drawn
  uniformly from [0, jitter_ms) from the seed, hop by hop (0 or absent:
  none).  Over a hop's length, the jitter makes every period's arrivals
  independent, as packets of calls over a network arrive; with phases alone
  a seed's collisions would hold for whole calls, and the seed would change
  the load;
- ``snr_db``: the SNR range of the noisy speech (``audio.speech_like``).

A call's audio is whole hops; the program sees only the hops.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np

from portbench.traffic.audio import speech_like

PRIME_HOPS = 3  # hops a session takes before its first output (frame_length 766 < 3 * 256)


@dataclasses.dataclass
class Call:
    line: int
    hops: int
    audio: np.ndarray = None  # (hops * hop,) fp32
    phase: float = 0.0  # offset within a hop, seconds
    delay: np.ndarray = None  # (hops,) the network's delay of each hop, seconds


def hop_samples(traffic: dict) -> int:
    return int(round(traffic["hop_ms"] * traffic["sample_rate"] / 1000))


def plan(traffic: dict, rng: np.random.Generator, seconds: float) -> List[List[Call]]:
    """The calls of each line, enough to last past ``seconds`` of window,
    each with its phase."""
    n, hop_s = traffic["calls"], traffic["hop_ms"] / 1000.0
    window_hops = math.ceil(seconds / hop_s) + 1
    if traffic.get("call_seconds") is None:
        lines = [[Call(j, PRIME_HOPS + window_hops)] for j in range(n)]
    else:
        lines = _durations(traffic, rng, n, hop_s, window_hops)
    jitter_s = traffic.get("jitter_ms", 0) / 1000.0
    for calls in lines:
        for c in calls:
            c.phase = float(rng.uniform(0.0, hop_s))
            if jitter_s > 0:
                c.delay = rng.uniform(0.0, jitter_s, c.hops)
    return lines


def _durations(traffic: dict, rng: np.random.Generator, n: int, hop_s: float,
               window_hops: int) -> List[List[Call]]:
    """Each line's calls, of the durations dealt in an order drawn from ``rng``."""
    lo, hi = traffic["call_seconds"]
    m = traffic["durations"]
    qs = lo * (hi / lo) ** ((np.arange(m) + 0.5) / m)
    order = rng.permutation(m)
    left = (rng.permutation(n) + 0.5) / n
    lines, k = [], 0
    for j in range(n):
        calls, covered = [], 0
        first = True
        while covered < window_hops:
            d = qs[order[k % m]]
            k += 1
            hops = max(PRIME_HOPS + 1, int(round(d / hop_s)))
            if first:
                hops = max(PRIME_HOPS + 1, int(round(hops * left[j])))
                covered += hops - PRIME_HOPS  # its first hops are fed in set-up
                first = False
            else:
                covered += hops
            calls.append(Call(j, hops))
        lines.append(calls)
    return lines


def fill_audio(lines: List[List[Call]], traffic: dict, gen) -> None:
    """Every call's noisy audio: one stream a line, drawn on ``gen``'s device
    in one call, cut into the line's calls."""
    hop = hop_samples(traffic)
    total = max(sum(c.hops for c in calls) for calls in lines) * hop
    _, noisy = speech_like(gen, len(lines), total, traffic["sample_rate"], traffic["snr_db"])
    noisy = noisy.cpu().numpy()
    for j, calls in enumerate(lines):
        at = 0
        for c in calls:
            c.audio = np.ascontiguousarray(noisy[j, at:at + c.hops * hop])
            at += c.hops * hop
