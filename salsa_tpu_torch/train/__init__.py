"""Training: losses, schedules, the optimizer, the trainer, msgpack checkpoints and
the tuned threshold."""
