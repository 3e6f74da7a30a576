"""A seeded pool of (clean, noisy) items: the generator of every traffic file
of ``"kind": "pool"``.

Parameters: ``items`` in the pool, ``batch`` rows an item, ``seconds`` of
audio a row at ``sample_rate``, ``snr_db`` (``audio.speech_like``).  The
window cycles through the pool in order; every row of the pool differs.
"""

from __future__ import annotations

import torch

from portbench.traffic.audio import speech_like


def length(traffic: dict) -> int:
    return int(round(traffic["seconds"] * traffic["sample_rate"]))


def make_pool(traffic: dict, gen: torch.Generator):
    """(clean, noisy), each (items, batch, length) fp32 on ``gen``'s device,
    drawn in one call."""
    n, b = traffic["items"], traffic["batch"]
    clean, noisy = speech_like(gen, n * b, length(traffic), traffic["sample_rate"],
                               traffic["snr_db"])
    shape = (n, b, length(traffic))
    return clean.reshape(shape), noisy.reshape(shape)
