"""Objective speech-quality evaluation (port of ``cleanumamba_tpu/eval``; the
reference's src/util/python_eval.py + denoise_eval.py equivalents).

PESQ uses the ITU-T P.862 C implementation (pip ``pesq``) when it is
installed and the from-scratch ``eval/pesq_p862.py`` otherwise, the same
choice as the JAX package.  STOI is a self-contained numpy implementation of
Taal et al. 2011.  ``validate`` runs the offline forward on the params'
device and the metrics on the host.
"""

from cleanumamba_tpu_torch.eval.metrics import (
    composite_scores,
    eval_waveform,
    llr,
    segmental_snr,
    si_sdr,
    stoi,
    wss,
)
from cleanumamba_tpu_torch.eval.validate import validate

__all__ = [
    "eval_waveform",
    "stoi",
    "segmental_snr",
    "llr",
    "wss",
    "si_sdr",
    "composite_scores",
    "validate",
]
