"""Training: schedule, optimizer, train step, checkpoints."""
