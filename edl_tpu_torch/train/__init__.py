"""Training: the train-step factories and optimizers."""
