"""Training: optimizer and train step, metrics, checkpoints, the trainer."""
