"""Plain PyTorch ops (channels-last ``(B, L, C)``) and, under ``cuda/``,
the hand-written Hopper kernels with their device dispatch."""
