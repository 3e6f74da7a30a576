"""The benchmark of cleanumamba_tpu_torch on NVIDIA GPUs (``python -m portbench.run``)."""
