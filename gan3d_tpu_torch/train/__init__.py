"""Training: losses, Adam, the fused step, checkpoints and the trainer."""
