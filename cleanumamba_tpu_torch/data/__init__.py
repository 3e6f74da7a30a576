"""Data pipeline of the port: host-side wav IO, paired clean/noisy datasets and
the prefetching loader (the port's own copies of the JAX package's numpy-only
``data/{dataset,wavio,native_loader}.py`` and ``native/wavloader.cpp``), and
synthetic batches made on the device (``synth_device.py``)."""

from cleanumamba_tpu_torch.data.dataset import (
    CleanNoisyPairDataset,
    NoisyOnlyDataset,
    SyntheticDenoiseDataset,
    make_loader,
    make_training_loader,
)

__all__ = [
    "CleanNoisyPairDataset",
    "SyntheticDenoiseDataset",
    "NoisyOnlyDataset",
    "make_loader",
    "make_training_loader",
]
