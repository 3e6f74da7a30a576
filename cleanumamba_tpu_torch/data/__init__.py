"""On-device synthetic data (the host datasets are the JAX package's
jax-free ``cleanumamba_tpu.data``, reused as they are)."""
