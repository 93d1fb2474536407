"""Training: the trainer and its metrics writers."""
