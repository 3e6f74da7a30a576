"""The Mamba-bottleneck CleanUMamba model (offline forward, init, mixer)."""
