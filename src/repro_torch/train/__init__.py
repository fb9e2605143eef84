"""Training: the train step, checkpoints and compressed gradient sums."""
