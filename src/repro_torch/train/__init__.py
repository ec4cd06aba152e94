"""Training: the step, checkpoints and the fault-tolerant runner."""
