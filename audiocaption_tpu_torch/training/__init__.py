"""Training: the train step, checkpoints and weight averaging."""
